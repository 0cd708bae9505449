"""Ring permute on the device plane, and the ``device-ring`` schedule target.

Counterpart of ``faabric_tpu/device_plane/pallas_ring.py``. The
reference's per-shard body is a Pallas remote-DMA kernel on a TPU mesh
and ``lax.ppermute`` elsewhere; here :func:`permute_body` is one launch
of the hand-written ring-permute kernel (``ops/csrc/ring_permute.cu``)
over the shards of every local rank, or its plain version for CPU
tensors (``ops/ring_permute.py``).

:class:`DeviceRingTarget` is a schedule-runner execution target
(``mpi/schedule.py`` ``register_step_target``): when a verified
schedule's phase is annotated ``target="device-ring"`` and the world's
device plane is active, the runner hands the phase's SEND/RECV steps
here and each permute round executes as ONE ``DevicePlane.ring_permute``
step instead of 2(n−1) host messages. It declines (returns None) on any
structural or eligibility mismatch, and the host steps then run. The
reference's ``FAABRIC_PALLAS_RING`` knob guards a remote DMA that a
given TPU may not run; the port's kernel always runs for tensors on the
card, so it has no such knob.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from faabric_tpu_torch.device_plane.registry import DevicePlaneFallback
from faabric_tpu_torch.mpi.schedule import (
    RECV,
    SEND,
    get_registered_target,
    register_step_target,
)
from faabric_tpu_torch.ops.ring_permute import ring_permute

logger = logging.getLogger(__name__)


def permute_body(shards: list[torch.Tensor], shift: int) -> list[torch.Tensor]:
    """The ring hop of one round: every rank's shard (rank order) moves
    to rank ``(r + shift) % n``. Returns the n outputs, which the
    caller owns and which alias no input."""
    return ring_permute(shards, shift)


class DeviceRingTarget:
    """Executes an annotated permute phase on the device plane.

    ``try_run`` returns the number of leading steps it executed, or None
    to decline (the runner then executes the phase's host steps). The
    verdict must be world-symmetric or ranks desync: every input it
    consults — the spec annotation, the step structure, the payload
    dtype and size, the plane's activation — is identical on every rank
    of a verified permute schedule, and a mid-phase plane disable
    surfaces in every rank's round together, after which all ranks
    finish the remaining pairs on the host path.
    """

    name = "device-ring"

    def try_run(self, world, rank: int, sched, phase: str, steps,
                env: dict, resolver):
        if not sched.spec.get("ring_uniform"):
            return None
        plane = world.device_plane()
        if plane is None or plane.n != world.size:
            return None
        pairs = self._parse_pairs(steps, rank, world.size)
        if not pairs:
            return None
        # Single-key legs only (a multi-key leg would need host
        # concatenation), and eligibility from the FIRST pair's payload:
        # later pairs' send keys are filled by earlier recvs during
        # execution, and ring_uniform makes their dtype and size equal
        if any(len(s.keys) != 1 or len(r.keys) != 1 for s, r, _ in pairs):
            return None
        first = env.get(pairs[0][0].keys[0])
        if first is None or not plane.eligible("ring_permute", first, None):
            return None

        done = 0
        for send_st, recv_st, shift in pairs:
            payload = env[send_st.keys[0]]
            if not isinstance(payload, (np.ndarray, torch.Tensor)):
                payload = np.asarray(payload)
            try:
                out = plane.ring_permute(rank, payload.reshape(-1), shift)
            except DevicePlaneFallback:
                logger.warning(
                    "device-ring target fell back to host steps at pair "
                    "%d/%d (world %s)", done // 2, len(pairs), world.id)
                return done if done else None
            env[recv_st.keys[0]] = out.reshape(-1)
            done += 2
        return done

    @staticmethod
    def _parse_pairs(steps, rank: int, n: int):
        """Decompose a phase group into (send, recv, shift) permute
        pairs; [] when the structure is not a pure uniform-shift ring
        (any FOLD/COPY, odd step count, inconsistent neighbours)."""
        if len(steps) < 2 or len(steps) % 2:
            return []
        pairs = []
        for i in range(0, len(steps), 2):
            s, r = steps[i], steps[i + 1]
            if s.op != SEND or r.op != RECV:
                return []
            shift = (s.peer - rank) % n
            if shift == 0 or (rank - r.peer) % n != shift:
                return []
            pairs.append((s, r, shift))
        return pairs


def ensure_registered() -> None:
    """Register the target once (importing the device plane does so)."""
    if get_registered_target(DeviceRingTarget.name) is None:
        register_step_target(DeviceRingTarget())
