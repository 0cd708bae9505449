"""Host↔device copy accounting.

Counterpart of ``faabric_tpu/device_plane/copies.py``, whole. "Zero host
copies for a device-resident collective" is the device plane's
invariant, and this module is what makes it countable: every byte the
plane moves across the host↔device boundary is stamped here, in both
directions, with why it moved:

- ``h2d`` / ``input``    — a host (numpy) contribution placed on the
  card before a collective;
- ``d2h`` / ``readback`` — a collective result read back to a host
  buffer;
- ``d2h`` / ``staging``  — a device tensor that could not ride the
  device rung (ineligible op or dtype, inactive plane, mixed-residency
  round) staged to the host exactly once before the host ladder runs.

Two surfaces: the metrics registry (``faabric_device_copy_total`` and
``faabric_device_copy_bytes_total`` with ``direction`` and ``reason``
labels) and an always-on process-local totals table that
``DevicePlane.summary()`` and the zero-copy assertions read.
"""

from __future__ import annotations

import threading

from faabric_tpu_torch.telemetry import get_metrics

H2D = "h2d"
D2H = "d2h"

_metrics = get_metrics()

# (direction, reason) → [count, bytes]
_totals: dict = {}
_totals_lock = threading.Lock()


def count_copy(direction: str, nbytes: int, reason: str) -> None:
    """Stamp one host↔device transfer of ``nbytes`` bytes."""
    labels = {"direction": direction, "reason": reason}
    _metrics.counter("faabric_device_copy_total",
                     "Host<->device transfers performed by the device plane",
                     **labels).inc()
    _metrics.counter("faabric_device_copy_bytes_total",
                     "Bytes moved across the host<->device boundary by the "
                     "device plane", **labels).inc(int(nbytes))
    with _totals_lock:
        t = _totals.setdefault((direction, reason), [0, 0])
        t[0] += 1
        t[1] += int(nbytes)


def device_copy_totals() -> dict:
    """Process-wide snapshot: per-(direction, reason) counts and bytes
    plus roll-ups."""
    with _totals_lock:
        rows = {f"{d}.{r}": {"count": t[0], "bytes": t[1]}
                for (d, r), t in _totals.items()}
        count = sum(t[0] for t in _totals.values())
        nbytes = sum(t[1] for t in _totals.values())
    return {"count": count, "bytes": nbytes, "by_reason": rows}


def reset_device_copy_totals() -> None:
    """Zero the local totals (the registry's counters are monotonic and
    stay)."""
    with _totals_lock:
        _totals.clear()
