"""Post-mortem flight recorder: a fixed-size ring of recent telemetry
events per process, dumped to disk when something dies.

The black-box model: every process continuously records compact events
(remote sends, fault firings, group aborts, requeues, executor
exceptions, host expiry) into a PREALLOCATED ring — a plain Python list
whose slots are overwritten in arrival order. Slot assignment rides an
``itertools.count`` (GIL-atomic) and each record is one tuple + one
small dict, no locks on the hot path, so the recorder is cheap enough to
stay on by default. When a terminal condition fires (``MpiWorldAborted``
→ the broker's group abort, a planner requeue, an unhandled executor
exception, SIGTERM), the ring is serialized to ``FAABRIC_FLIGHT_DIR`` as
one JSON file per process; ``python -m faabric_tpu_torch.runner.flightdump``
merges the files from every host onto one wall-clock timeline.

Knobs:

- ``FAABRIC_FLIGHT``       — ``0`` disables recording entirely (shared
  no-op handle; a ``record()`` is then one no-op method call).
- ``FAABRIC_FLIGHT_RING``  — ring length (default 4096 events).
- ``FAABRIC_FLIGHT_DIR``   — dump directory. Unset → dumps are skipped
  (the ring still records, so a debugger can read it in-process).

Timestamps are wall-clock-anchored (``wall_epoch + monotonic_delta``),
the same convention as the span tracer, so rings dumped by different
hosts merge onto one timeline.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

_DUMP_THROTTLE_SECONDS = 1.0


class _NullFlight:
    """Shared no-op recorder returned while flight recording is off."""

    __slots__ = ()
    size = 0

    def record(self, kind: str, **fields) -> None:
        pass

    def events(self) -> list:
        return []

    def dump(self, reason: str):
        return None


NULL_FLIGHT = _NullFlight()


class FlightRecorder:
    """Fixed-size overwrite-oldest event ring.

    ``record`` is the hot path: one counter draw (GIL-atomic), one tuple
    build, one list-slot store. No lock — a torn read in ``events()``
    (a slot overwritten mid-snapshot) can at worst misorder one event at
    the ring seam, which a post-mortem reader sorts by timestamp anyway.
    """

    def __init__(self, size: int = 4096) -> None:
        self.size = max(8, int(size))
        self._slots: list = [None] * self.size
        self._n = itertools.count()
        self._count = 0  # advisory; exact value comes from the counter
        # Wall anchor shared with the tracer's convention so merged
        # dumps and merged traces line up
        self._wall0 = time.time() - time.monotonic()
        self._last_dump: dict[str, float] = {}
        self._dump_lock = threading.Lock()

    # -- recording ------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        i = next(self._n)
        self._slots[i % self.size] = (
            self._wall0 + time.monotonic(), i, kind, fields)
        self._count = i + 1

    def events(self) -> list[dict]:
        """Snapshot, oldest → newest. Entries are
        ``{"ts", "seq", "kind", ...fields}``."""
        n = self._count
        slots = list(self._slots)  # one pass; racers overwrite harmlessly
        live = [s for s in slots if s is not None]
        live.sort(key=lambda s: s[1])  # seq order handles the ring seam
        if n > self.size:
            live = live[-self.size:]
        return [{"ts": ts, "seq": seq, "kind": kind, **fields}
                for ts, seq, kind, fields in live]

    # -- dumping --------------------------------------------------------
    def dump(self, reason: str):
        """Serialize the ring to ``FAABRIC_FLIGHT_DIR`` (one file per
        process per trigger); returns the path or None when dumping is
        disabled/throttled. Never raises — a failing dump must not mask
        the failure being recorded."""
        directory = os.environ.get("FAABRIC_FLIGHT_DIR", "")
        if not directory:
            return None
        now = time.monotonic()
        with self._dump_lock:
            if now - self._last_dump.get(reason, -1e9) < \
                    _DUMP_THROTTLE_SECONDS:
                return None
            self._last_dump[reason] = now
        try:
            from faabric_tpu_torch.telemetry.tracer import get_tracer

            label = get_tracer().process_label
        except Exception:  # noqa: BLE001 — label is cosmetic
            label = f"pid-{os.getpid()}"
        safe_label = "".join(c if c.isalnum() or c in "-_." else "_"
                             for c in label)
        path = os.path.join(
            directory,
            f"flight-{safe_label}-{os.getpid()}-{time.time_ns()}.json")
        body = {
            "process": label,
            "pid": os.getpid(),
            "reason": reason,
            "dumped_at": time.time(),
            "ring_size": self.size,
            "events_recorded": self._count,
            "events": self.events(),
        }
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f, default=str)
            os.replace(tmp, path)
            self._prune_own_dumps(directory)
            return path
        except OSError:
            return None

    @staticmethod
    def _prune_own_dumps(directory: str) -> None:
        """Keep at most FAABRIC_FLIGHT_MAX_DUMPS (default 20) of THIS
        process's dump files: a recurring trigger (a guest function that
        always raises, a recovery loop) must not fill the disk. Only
        own-pid files are pruned — other processes' black boxes are
        theirs to manage."""
        try:
            keep = int(os.environ.get("FAABRIC_FLIGHT_MAX_DUMPS", 20))
        except ValueError:
            keep = 20
        marker = f"-{os.getpid()}-"
        try:
            mine = sorted(n for n in os.listdir(directory)
                          if n.startswith("flight-") and marker in n
                          and n.endswith(".json"))
        except OSError:
            return
        for name in mine[:-keep] if keep > 0 else mine:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


def _env_enabled() -> bool:
    return os.environ.get("FAABRIC_FLIGHT", "1") not in ("0", "false", "off")


_flight: FlightRecorder | _NullFlight | None = None
_flight_lock = threading.Lock()


def get_flight() -> FlightRecorder | _NullFlight:
    global _flight
    if _flight is None:
        with _flight_lock:
            if _flight is None:
                if _env_enabled():
                    try:
                        size = int(os.environ.get("FAABRIC_FLIGHT_RING",
                                                  4096))
                    except ValueError:
                        # A malformed knob must degrade to the default,
                        # never fail the send/recovery paths that call
                        # flight_record()
                        size = 4096
                    _flight = FlightRecorder(size)
                else:
                    _flight = NULL_FLIGHT
    return _flight


# -- module-level conveniences (instrumentation sites hold these) -------
def flight_record(kind: str, **fields) -> None:
    get_flight().record(kind, **fields)


def live_ring_doc() -> dict:
    """This process's LIVE ring as one JSON-safe document — the body
    both the planner and worker HTTP endpoints serve at ``GET /flight``
    (one schema, one place; ``flightdump --url`` merges on it)."""
    try:
        from faabric_tpu_torch.telemetry.tracer import get_tracer

        label = get_tracer().process_label
    except Exception:  # noqa: BLE001 — label is cosmetic
        label = f"pid-{os.getpid()}"
    ring = get_flight()
    return {
        "process": label,
        "pid": os.getpid(),
        "ring_size": ring.size,
        "events": ring.events(),
    }


def flight_dump(reason: str):
    return get_flight().dump(reason)


def install_signal_dump() -> None:
    """Chain a SIGTERM handler that dumps the ring, then replicates the
    PREVIOUS disposition exactly: a prior handler runs, SIG_IGN stays
    ignored, and SIG_DFL re-raises through the default action so the
    process still dies with the signal (exit status 143, not a fake
    clean 0 — supervisors distinguish the two). Main-thread only;
    silently skipped elsewhere."""
    import signal

    try:
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            try:
                flight_record("sigterm", pid=os.getpid())
                flight_dump("sigterm")
            except Exception:  # noqa: BLE001 — never mask the signal
                pass
            if prev is signal.SIG_IGN:
                return
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
                return
            # Default disposition: restore it and re-raise the signal
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread
