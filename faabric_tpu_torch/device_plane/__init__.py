"""The device collective plane of an MPI world.

Counterpart of ``faabric_tpu/device_plane/``: the rung above the MPI
world's host ladder. Worlds whose ranks all resolve onto one device run
allreduce, allgather, reduce_scatter and the ring permute there instead
of through the host queues.

- :mod:`registry` — the registration handshake's rows and the
  deterministic plane verdict (``MeshMismatch`` → host ladder).
- :mod:`plane` — :class:`DevicePlane`: the per-world rendezvous, the
  residency-aware zero-host-copy path for device tensors, the
  eligibility and fallback ladder, and ``ring_permute``.
- :mod:`copies` — host↔device copy accounting.
- :mod:`ring` — the ring permute's body (the hand-written CUDA kernel)
  and the ``device-ring`` schedule-runner execution target.

Entry point: ``MpiWorld.activate_device_plane(rank, ...)``, a collective
call every rank makes once after the world forms.
"""

from faabric_tpu_torch.device_plane.copies import (
    count_copy,
    device_copy_totals,
    reset_device_copy_totals,
)
from faabric_tpu_torch.device_plane.plane import (
    DEVICE_PLANE_TIMEOUT_S,
    DevicePlane,
    device_planes_summary,
    is_device_payload,
)
from faabric_tpu_torch.device_plane.registry import (
    DevicePlaneFallback,
    MeshMismatch,
    registration_row,
    resolve_local_device,
    resolve_mesh,
)
from faabric_tpu_torch.device_plane.ring import ensure_registered

# Registers the device-ring schedule execution target. Unlike the
# reference, a failure here raises: a silently missing target would
# send every annotated ring phase to the host steps.
ensure_registered()

__all__ = [
    "DEVICE_PLANE_TIMEOUT_S",
    "DevicePlane",
    "DevicePlaneFallback",
    "MeshMismatch",
    "count_copy",
    "device_copy_totals",
    "device_planes_summary",
    "is_device_payload",
    "registration_row",
    "reset_device_copy_totals",
    "resolve_local_device",
    "resolve_mesh",
]
