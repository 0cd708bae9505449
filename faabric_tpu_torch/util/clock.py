"""Wall-clock and timing helpers (counterpart of ``faabric_tpu/util/clock.py``).

The PROF_START/PROF_END macros' ``prof`` context manager now delegates
into the telemetry span tracer (``telemetry/tracer.py``): every
``prof`` label becomes a ``prof/<label>`` span, so legacy call sites
show up in the Chrome trace and the Prometheus-era summaries without
change. ``prof_summary`` (the TRACE_ALL analog) returns the tracer's
text summary — enabled via FAABRIC_TRACING=1 or the legacy
FAABRIC_SELF_TRACING=1.
"""

from __future__ import annotations

import time


def get_global_clock_epoch() -> float:
    return time.time()


def epoch_millis() -> int:
    return int(time.time() * 1000)


def now() -> float:
    return time.monotonic()


def prof(label: str):
    """Timing bracket; a no-op singleton while tracing is disabled."""
    from faabric_tpu_torch.telemetry import tracer

    return tracer.span("prof", label)


def prof_summary() -> str:
    from faabric_tpu_torch.telemetry import tracer

    return tracer.text_summary()


def prof_reset() -> None:
    from faabric_tpu_torch.telemetry import tracer

    tracer.reset_tracing()


def is_tracing_enabled() -> bool:
    from faabric_tpu_torch.telemetry import tracer

    return tracer.tracing_enabled()
