"""Span tracer: nestable, thread-/async-safe timing spans with Chrome
``trace_event`` export.

A span carries (subsystem, label, attrs); nesting is tracked through a
``contextvars.ContextVar``, so spans opened on different threads (each
thread starts with an empty context) or interleaved asyncio tasks never
corrupt each other's stacks. Completed spans land in a bounded ring
buffer as Chrome "X" (complete) events — load the ``chrome_trace()``
dump in ``chrome://tracing`` or Perfetto and the per-thread nesting
renders as flame graphs. Aggregate totals are kept separately (complete
even after the ring buffer wraps) and feed ``text_summary()``, the
successor of ``util.clock.prof_summary``.

Enablement: ``FAABRIC_TRACING=1`` (or the legacy
``FAABRIC_SELF_TRACING=1``) at process start, or ``set_tracing(True)``
programmatically (tests, targeted capture). Disabled mode is a
zero-allocation fast path: ``span(...)`` returns one shared no-op
context manager.

Timestamps: wall-clock-anchored microseconds (``wall_epoch +
monotonic_delta``), so traces captured by co-located processes (the
multi-process bulk plane) line up on one Perfetto timeline.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import random
import threading
import time
from collections import deque

_current: contextvars.ContextVar = contextvars.ContextVar(
    "faabric_current_span", default=None)

# ---------------------------------------------------------------------------
# Trace context: span identity + cross-host propagation
# ---------------------------------------------------------------------------
# Span ids are process-unique JSON-safe ints: a random per-process tag in
# the high bits (kills cross-host collisions without coordination) and a
# monotonic counter below. Kept under 2^53 so they survive any JSON
# round-trip (JS number precision).
_PROC_TAG = (random.getrandbits(21) ^ (os.getpid() & 0xFFFFF)) & 0x1FFFFF
_span_ids = itertools.count(1)


def _new_span_id() -> int:
    return (_PROC_TAG << 32) | (next(_span_ids) & 0xFFFFFFFF)


def encode_trace_context(trace_id: int, span_id: int) -> str:
    """Compact wire form carried in message headers (``_tc`` key):
    ``<trace_id hex>.<span_id hex>``."""
    return f"{trace_id:x}.{span_id:x}"


def decode_trace_context(text) -> tuple[int, int] | None:
    """Inverse of :func:`encode_trace_context`; None on anything
    malformed (a corrupt header must degrade to an unlinked span, not an
    exception on the server's handler path)."""
    if not isinstance(text, str) or "." not in text:
        return None
    head, _, tail = text.partition(".")
    try:
        trace_id, span_id = int(head, 16), int(tail, 16)
    except ValueError:
        return None
    if trace_id <= 0 or span_id <= 0:
        return None
    return trace_id, span_id


def current_trace_context() -> str | None:
    """The active span's (trace id, span id) in wire form, or None when
    no span is open (or tracing is off). Attach this to outbound message
    headers; the receiving side opens its handler span with
    ``remote=...`` so the merged trace shows the causal parent→child
    link across hosts."""
    span = _current.get()
    if span is None:
        return None
    return encode_trace_context(span.trace_id, span.span_id)


def flow_id_for(group_id: int, send_idx: int, recv_idx: int,
                channel: int, seq: int) -> int:
    """Deterministic flow-event id both ends of a PTP message can derive
    independently (the bulk plane's fixed frame header has no room for a
    trace context; the sequence tuple IS the message identity). Plain
    multiply-xor mix — Python's hash() is salted per process and would
    never match across hosts."""
    h = (group_id & 0xFFFFFFFFFFFF) * 0x9E3779B1
    h ^= (send_idx + 1) * 0x85EBCA77
    h ^= (recv_idx + 1) * 0xC2B2AE3D
    h ^= (channel + 1) * 0x27D4EB2F
    h ^= (seq + 2) * 0x165667B1
    return h & ((1 << 53) - 1)


class _NullSpan:
    """Shared no-op span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "subsystem", "label", "attrs", "_t0", "_token",
                 "span_id", "trace_id", "parent_span_id", "_remote")

    def __init__(self, tracer: "Tracer", subsystem: str, label: str,
                 attrs: dict, remote: tuple[int, int] | None = None) -> None:
        self._tracer = tracer
        self.subsystem = subsystem
        self.label = label
        self.attrs = attrs
        self._remote = remote

    def __enter__(self):
        self.span_id = _new_span_id()
        parent = _current.get()
        if parent is not None:
            self.attrs.setdefault(
                "parent", f"{parent.subsystem}/{parent.label}")
            self.trace_id = parent.trace_id
            self.parent_span_id = parent.span_id
        elif self._remote is not None:
            # Cross-host continuation: the sender's (trace, span) ids
            # arrived in the message header — the merged /trace links
            # this handler span to its remote parent instead of showing
            # a per-host island
            self.trace_id, self.parent_span_id = self._remote
            self.attrs["remote_parent"] = True
        else:
            self.trace_id = self.span_id  # root mints the trace id
            self.parent_span_id = 0
        self._token = _current.set(self)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        end = time.monotonic()
        _current.reset(self._token)
        self._tracer._record(self, self._t0, end)
        return False


class Tracer:
    def __init__(self, enabled: bool, maxlen: int) -> None:
        self._enabled = enabled
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=maxlen)
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._tid_names: dict[int, str] = {}
        self._pid = os.getpid()
        self.process_label = f"faabric-{self._pid}"
        # Wall anchor for cross-process alignment of monotonic stamps
        self._wall0 = time.time() - time.monotonic()

    # -- span creation --------------------------------------------------
    def span(self, subsystem: str, label: str, **attrs):
        if not self._enabled:
            return NULL_SPAN
        return _Span(self, subsystem, label, attrs)

    def span_from_remote(self, subsystem: str, label: str,
                         context, **attrs):
        """A span whose parent is a REMOTE span: ``context`` is the wire
        form produced by :func:`current_trace_context` on the sending
        host (or None/garbage → plain span). A locally-nested span keeps
        its local parent; the remote link only applies at the root of
        this host's handling."""
        if not self._enabled:
            return NULL_SPAN
        return _Span(self, subsystem, label, attrs,
                     remote=decode_trace_context(context))

    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = on

    # -- recording ------------------------------------------------------
    def _record(self, span: _Span, t0: float, t1: float) -> None:
        tid = threading.get_ident()
        attrs = span.attrs
        attrs["span_id"] = span.span_id
        attrs["trace_id"] = span.trace_id
        if span.parent_span_id:
            attrs["parent_span_id"] = span.parent_span_id
        event = {
            "name": span.label,
            "cat": span.subsystem,
            "ph": "X",
            "ts": (self._wall0 + t0) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": self._pid,
            "tid": tid,
            "args": attrs,
        }
        key = f"{span.subsystem}/{span.label}"
        with self._lock:
            self._events.append(event)
            self._totals[key] = self._totals.get(key, 0.0) + (t1 - t0)
            self._counts[key] = self._counts.get(key, 0) + 1
            # Last-write-wins: CPython recycles thread idents, so the
            # row label should follow the ident's CURRENT owner
            self._tid_names[tid] = threading.current_thread().name

    def _emit(self, event: dict) -> None:
        tid = threading.get_ident()
        event["pid"] = self._pid
        event["tid"] = tid
        with self._lock:
            self._events.append(event)
            self._tid_names[tid] = threading.current_thread().name

    def instant(self, subsystem: str, label: str, **attrs) -> None:
        """A zero-duration marker event (Chrome 'i' phase) — fault
        firings, state transitions."""
        if not self._enabled:
            return
        event = {"name": label, "cat": subsystem, "ph": "i", "s": "t",
                 "ts": (self._wall0 + time.monotonic()) * 1e6}
        if attrs:
            event["args"] = attrs
        self._emit(event)

    def flow_start(self, flow: int, name: str = "msg", **attrs) -> None:
        """Flow-arrow origin: emitted INSIDE a send span so Perfetto
        binds the arrow tail to it. The matching flow_end on the
        receiving host (same deterministic id) draws the cross-process
        send→recv edge."""
        if not self._enabled:
            return
        event = {"name": name, "cat": "flow", "ph": "s", "id": flow,
                 "ts": (self._wall0 + time.monotonic()) * 1e6}
        if attrs:
            event["args"] = attrs
        self._emit(event)

    def flow_end(self, flow: int, name: str = "msg", **attrs) -> None:
        if not self._enabled:
            return
        event = {"name": name, "cat": "flow", "ph": "f", "bp": "e",
                 "id": flow,
                 "ts": (self._wall0 + time.monotonic()) * 1e6}
        if attrs:
            event["args"] = attrs
        self._emit(event)

    # -- export ---------------------------------------------------------
    def trace_events(self) -> list[dict]:
        """Completed spans plus process/thread-name metadata records."""
        with self._lock:
            events = list(self._events)
            tid_names = dict(self._tid_names)
        meta: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": self.process_label},
        }]
        for tid, name in tid_names.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                         "tid": tid, "args": {"name": name}})
        return meta + events

    def chrome_trace(self) -> dict:
        return {"traceEvents": self.trace_events(),
                "displayTimeUnit": "ms"}

    def chrome_trace_json(self) -> str:
        return json.dumps(self.chrome_trace())

    def summary_data(self) -> dict[str, dict]:
        with self._lock:
            return {k: {"total_s": self._totals[k],
                        "count": self._counts[k]}
                    for k in self._totals}

    def text_summary(self) -> str:
        with self._lock:
            lines = ["--- PROF summary ---"]
            for key in sorted(self._totals):
                lines.append(
                    f"{key:<40} total={self._totals[key] * 1000:.2f}ms "
                    f"n={self._counts[key]}")
            return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._totals.clear()
            self._counts.clear()
            self._tid_names.clear()


def _env_enabled() -> bool:
    return (os.environ.get("FAABRIC_TRACING", "0") == "1"
            or os.environ.get("FAABRIC_SELF_TRACING", "0") == "1")


_tracer: Tracer | None = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                maxlen = int(os.environ.get("FAABRIC_TRACE_BUFFER", 65536))
                _tracer = Tracer(_env_enabled(), maxlen)
    return _tracer


# -- module-level conveniences (the API instrumentation sites use) ------
def span(subsystem: str, label: str, **attrs):
    return get_tracer().span(subsystem, label, **attrs)


def span_from_remote(subsystem: str, label: str, context, **attrs):
    return get_tracer().span_from_remote(subsystem, label, context, **attrs)


def instant(subsystem: str, label: str, **attrs) -> None:
    get_tracer().instant(subsystem, label, **attrs)


def flow_start(flow: int, name: str = "msg", **attrs) -> None:
    get_tracer().flow_start(flow, name, **attrs)


def flow_end(flow: int, name: str = "msg", **attrs) -> None:
    get_tracer().flow_end(flow, name, **attrs)


def tracing_enabled() -> bool:
    return get_tracer().enabled()


def set_tracing(on: bool) -> None:
    get_tracer().set_enabled(on)


def set_process_label(label: str) -> None:
    get_tracer().process_label = label


def trace_events() -> list[dict]:
    return get_tracer().trace_events()


def chrome_trace() -> dict:
    return get_tracer().chrome_trace()


def chrome_trace_json() -> str:
    return get_tracer().chrome_trace_json()


def text_summary() -> str:
    return get_tracer().text_summary()


def summary_data() -> dict[str, dict]:
    return get_tracer().summary_data()


def reset_tracing() -> None:
    get_tracer().reset()
