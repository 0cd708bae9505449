"""Opt-in runtime lock-order / hold-time / blocking-syscall detector.

Counterpart of ``faabric_tpu/analysis/lockcheck.py``.
``FAABRIC_LOCKCHECK=1`` makes :func:`install_from_env` (called by an
entry point before it creates locks: ``python -m
faabric_tpu_torch.runner`` and ``chip_smoke.py --worker-child``) replace
the ``threading.Lock``/``threading.RLock`` factories with wrappers
that:

- build a **held-before graph**: acquiring lock B while holding lock A
  records the edge ``site(A) → site(B)`` (sites are the ``Lock()``
  creation points, ``file:line`` — instances pool by site so the graph
  stays small and cycles across *instances* of the same classes are
  caught). ``report()`` runs cycle detection; each cycle carries the
  holder's acquire point and the full acquisition stack of the edge that
  closed it — the two stacks a deadlock post-mortem needs.
- record **hold times** per site into the telemetry registry
  (``faabric_lock_hold_seconds{site=...}``), so ``/metrics`` shows which
  critical sections are long and bench rounds can track them.
- report **locks held across blocking syscalls**: ``time.sleep``,
  ``threading.Event.wait`` and the socket primitives are patched to note
  when the calling thread holds any checked lock (rule the static lint
  enforces too — this catches the paths the lint cannot see, e.g. calls
  through ctypes or dynamically-dispatched handlers).

Scope: only locks *created* from files under ``faabric_tpu_torch/`` or
``tests/`` are wrapped (``FAABRIC_LOCKCHECK_ALL=1`` wraps everything) —
wrapping torch's internal locks would only add noise and overhead.
Locks created before ``install()`` stay plain; the detector is a test
instrument, not a safety net.

Same-site nesting (two *instances* from one creation site nested in one
thread) is reported separately from cycles: it is only a deadlock if
another thread nests them in the opposite order, which a site-keyed
graph cannot order — the report names the site, so that an
instance-ordering discipline can be imposed there.

At exit, a process that installed the detector through
:func:`install_from_env` writes :func:`exit_summary` (cycles, same-site
nestings, blocking sites, the longest hold sites) as one JSON line to
its standard error, after the marker ``lockcheck-report:``. A role that
calls :func:`finish` itself gets a nonzero status back when a cycle was
seen and ``FAABRIC_LOCKCHECK_GATE`` is on (the default).

Everything here must be reentrancy-safe: internal state uses the
*original* lock type, and no code path logs or allocates telemetry
handles while holding the internal lock.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Optional

__all__ = [
    "install", "installed", "enabled_by_env", "report", "format_report",
    "reset", "CheckedLockFactory", "install_from_env", "exit_summary",
    "finish", "gate_enabled", "REPORT_MARKER",
]

_REPO_MARKERS = (f"faabric_tpu_torch{os.sep}", f"tests{os.sep}")
_TELEMETRY_MARKER = f"faabric_tpu_torch{os.sep}telemetry{os.sep}"
REPORT_MARKER = "lockcheck-report: "


def _is_internal_frame(fn: str) -> bool:
    # Exact basename match: endswith() would also skip any caller file
    # that merely ENDS with these names (test_lockcheck.py!)
    return os.path.basename(fn) in ("lockcheck.py", "threading.py")

_orig_lock = threading.Lock
_orig_rlock = threading.RLock

_STACK_DEPTH = int(os.environ.get("FAABRIC_LOCKCHECK_STACK_DEPTH", "10"))
_MAX_BLOCKING_REPORTS = 500


class _State:
    def __init__(self) -> None:
        self.mx = _orig_lock()
        # site id → "file:line"
        self.sites: dict[int, str] = {}
        self.site_ids: dict[str, int] = {}
        # (site_a, site_b) → (holder acquire point, acquiring stack)
        self.edges: dict[tuple[int, int], tuple[str, tuple[str, ...]]] = {}
        # same-site nesting: site → (holder point, acquiring stack)
        self.same_site: dict[int, tuple[str, tuple[str, ...]]] = {}
        # blocking-call-under-lock reports
        self.blocking: list[dict] = []
        # site id → telemetry Histogram (created lazily OUTSIDE self.mx)
        self.hold_hist: dict[int, object] = {}
        # site id → [count, total seconds, longest seconds]: the exit
        # summary's hold ranking (the histograms keep only buckets)
        self.hold_stats: dict[int, list] = {}

    def site_id(self, site: str) -> int:
        with self.mx:
            sid = self.site_ids.get(site)
            if sid is None:
                sid = len(self.site_ids) + 1
                self.site_ids[site] = sid
                self.sites[sid] = site
            return sid


_state = _State()
_installed = False
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _creation_site() -> str | None:
    """Creation point of the lock (first frame outside this module and
    the threading module), or None when the creator is out of scope —
    telemetry's per-series leaf locks are always exempt (the hold-time
    observer itself takes them; wrapping them would both recurse and
    drown the graph in per-counter edges)."""
    wrap_all = os.environ.get("FAABRIC_LOCKCHECK_ALL", "0") == "1"
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not _is_internal_frame(fn):
            if _TELEMETRY_MARKER in fn:
                return None
            if not wrap_all and not any(m in fn for m in _REPO_MARKERS):
                return None
            return f"{os.path.basename(os.path.dirname(fn))}/" \
                   f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>" if wrap_all else None


def _short_stack(limit: int = _STACK_DEPTH) -> tuple[str, ...]:
    out = []
    f = sys._getframe(2)
    while f is not None and len(out) < limit:
        fn = f.f_code.co_filename
        if os.path.basename(fn) != "lockcheck.py":
            out.append(f"{fn}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
    return tuple(out)


class _Entry:
    __slots__ = ("obj_id", "sid", "t0", "count", "frame")

    def __init__(self, obj_id: int, sid: int, t0: float, frame) -> None:
        self.obj_id = obj_id
        self.sid = sid
        self.t0 = t0
        self.count = 1
        # Raw frame of the acquire, formatted lazily — only edges and
        # reports pay the string cost, never the per-acquire hot path
        self.frame = frame

    def point(self) -> str:
        f = self.frame
        while f is not None:
            fn = f.f_code.co_filename
            if not _is_internal_frame(fn):
                return f"{fn}:{f.f_lineno}"
            f = f.f_back
        return "<unknown>"


def _note_acquire(obj_id: int, sid: int) -> None:
    held = _held()
    for e in held:
        if e.obj_id == obj_id:
            e.count += 1  # RLock re-entry: no edge, no new entry
            return
    if held:
        stack = None
        for e in held:
            key = (e.sid, sid)
            if e.sid == sid:
                if sid not in _state.same_site:
                    if stack is None:
                        stack = _short_stack()
                    with _state.mx:
                        _state.same_site.setdefault(
                            sid, (e.point(), stack))
                continue
            if key not in _state.edges:
                if stack is None:
                    stack = _short_stack()
                with _state.mx:
                    _state.edges.setdefault(key, (e.point(), stack))
    held.append(_Entry(obj_id, sid, time.monotonic(), sys._getframe(2)))


def _note_release(obj_id: int, sid: int) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        e = held[i]
        if e.obj_id == obj_id:
            e.count -= 1
            if e.count <= 0:
                del held[i]
                _observe_hold(sid, time.monotonic() - e.t0)
            return


def _observe_hold(sid: int, seconds: float) -> None:
    # Reentrancy guard: the observe itself takes (possibly checked)
    # telemetry locks whose release would land back here
    if getattr(_tls, "in_observe", False):
        return
    _tls.in_observe = True
    try:
        hist = _state.hold_hist.get(sid)
        if hist is None:
            try:
                from faabric_tpu_torch.telemetry import get_metrics

                hist = get_metrics().histogram(
                    "faabric_lock_hold_seconds",
                    "Lock hold time per creation site "
                    "(FAABRIC_LOCKCHECK=1)",
                    site=_state.sites.get(sid, "?"))
            except Exception:  # pragma: no cover - telemetry unavailable
                hist = None
            _state.hold_hist[sid] = hist
        if hist is not None:
            hist.observe(seconds)
        with _state.mx:
            st = _state.hold_stats.setdefault(sid, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += seconds
            if seconds > st[2]:
                st[2] = seconds
    finally:
        _tls.in_observe = False


class _CheckedLock:
    """threading.Lock wrapper; also the base for the RLock wrapper."""

    _reentrant = False

    def __init__(self, inner, sid: int) -> None:
        self._inner = inner
        self._sid = sid

    # -- core protocol -------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        rc = self._inner.acquire(blocking, timeout)
        if rc:
            _note_acquire(id(self._inner), self._sid)
        return rc

    acquire_lock = acquire  # legacy alias some libraries use

    def release(self) -> None:
        self._inner.release()
        _note_release(id(self._inner), self._sid)

    release_lock = release

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        site = _state.sites.get(self._sid, "?")
        return f"<CheckedLock {site} wrapping {self._inner!r}>"


class _CheckedRLock(_CheckedLock):
    _reentrant = True

    # Condition-variable protocol: Condition(lock) probes for these and
    # uses them to fully release a reentrant lock around wait(). The
    # held-tracking must follow, or the detector would see the lock as
    # held across the (legitimate) blocking wait.
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        _note_release(id(self._inner), self._sid)
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        _note_acquire(id(self._inner), self._sid)


class CheckedLockFactory:
    """Callable drop-in for ``threading.Lock``/``threading.RLock``.

    ``force_site`` bypasses the caller-scope check and stamps every
    created lock with the given site label — for benches and tests that
    live outside faabric_tpu_torch/ or tests/ but want a checked lock."""

    def __init__(self, reentrant: bool,
                 force_site: str | None = None) -> None:
        self._reentrant = reentrant
        self._force_site = force_site

    def __call__(self):
        site = self._force_site or _creation_site()
        if site is None:
            return (_orig_rlock if self._reentrant else _orig_lock)()
        sid = _state.site_id(site)
        if self._reentrant:
            return _CheckedRLock(_orig_rlock(), sid)
        return _CheckedLock(_orig_lock(), sid)


# ---------------------------------------------------------------------------
# Blocking-syscall instrumentation
# ---------------------------------------------------------------------------

def _note_blocking(what: str, detail: str = "") -> None:
    held = getattr(_tls, "held", None)
    if not held:
        return
    sites = [_state.sites.get(e.sid, "?") for e in held]
    stack = _short_stack()
    with _state.mx:
        if len(_state.blocking) < _MAX_BLOCKING_REPORTS:
            _state.blocking.append({
                "call": what, "detail": detail, "held": sites,
                "stack": stack,
                "thread": threading.current_thread().name,
            })


def _wrap_blocking(orig, what: str):
    def wrapper(*args, **kwargs):
        held = getattr(_tls, "held", None)
        if held:
            _note_blocking(what)
        return orig(*args, **kwargs)

    wrapper.__name__ = getattr(orig, "__name__", what)
    wrapper.__qualname__ = wrapper.__name__
    return wrapper


def _patch_blocking_calls() -> None:
    import socket as socket_mod

    time.sleep = _wrap_blocking(time.sleep, "time.sleep")

    ev_wait = threading.Event.wait

    def event_wait(self, timeout: Optional[float] = None):
        if getattr(_tls, "held", None):
            _note_blocking("Event.wait",
                           "indefinite" if timeout is None
                           else f"timeout={timeout}")
        return ev_wait(self, timeout)

    threading.Event.wait = event_wait  # type: ignore[method-assign]

    th_join = threading.Thread.join

    def thread_join(self, timeout: Optional[float] = None):
        if getattr(_tls, "held", None):
            _note_blocking("Thread.join",
                           "indefinite" if timeout is None
                           else f"timeout={timeout}")
        return th_join(self, timeout)

    threading.Thread.join = thread_join  # type: ignore[method-assign]

    # socket.socket is a Python subclass of the C _socket.socket, so
    # method overrides stick. Only note-and-delegate — never alter
    # semantics.
    for name in ("accept", "connect", "recv", "recv_into", "recvfrom",
                 "send", "sendall", "sendmsg"):
        base = getattr(socket_mod.socket, name, None)
        if base is None:  # pragma: no cover - platform-dependent
            continue

        def make(nm, fn):
            def sock_wrapper(self, *args, **kwargs):
                if getattr(_tls, "held", None):
                    _note_blocking(f"socket.{nm}")
                return fn(self, *args, **kwargs)

            sock_wrapper.__name__ = nm
            return sock_wrapper

        setattr(socket_mod.socket, name, make(name, base))


# ---------------------------------------------------------------------------
# Install / report
# ---------------------------------------------------------------------------

def enabled_by_env() -> bool:
    return os.environ.get("FAABRIC_LOCKCHECK", "0") not in (
        "0", "", "false", "off")


def installed() -> bool:
    return _installed


def install() -> None:
    """Patch the lock factories and blocking syscalls. Idempotent.
    Locks created before this call stay plain."""
    global _installed
    if _installed:
        return
    _installed = True
    threading.Lock = CheckedLockFactory(reentrant=False)
    threading.RLock = CheckedLockFactory(reentrant=True)
    _patch_blocking_calls()


def reset() -> None:
    """Drop collected graph/report state (tests)."""
    with _state.mx:
        _state.edges.clear()
        _state.same_site.clear()
        _state.blocking.clear()
        _state.hold_stats.clear()


def _find_cycles(edges: dict) -> list[list[int]]:
    graph: dict[int, set[int]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles: list[list[int]] = []
    seen_cycles: set[tuple[int, ...]] = set()

    # Iterative DFS per start node; small graphs (~dozens of sites)
    for start in list(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start:
                    cyc = path[:]
                    key = tuple(sorted(cyc))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(cyc)
                elif nxt not in path and len(path) < 12:
                    stack.append((nxt, path + [nxt]))
    return cycles


def report() -> dict:
    """Snapshot of everything collected so far."""
    with _state.mx:
        edges = dict(_state.edges)
        same_site = dict(_state.same_site)
        blocking = list(_state.blocking)
        sites = dict(_state.sites)

    cycles = []
    for cyc in _find_cycles(edges):
        detail = []
        for i, sid in enumerate(cyc):
            nxt = cyc[(i + 1) % len(cyc)]
            holder_point, acq_stack = edges.get(
                (sid, nxt), ("?", ()))
            detail.append({
                "held": sites.get(sid, "?"),
                "then_acquired": sites.get(nxt, "?"),
                "holder_acquired_at": holder_point,
                "acquisition_stack": list(acq_stack),
            })
        cycles.append(detail)

    return {
        "sites": len(sites),
        "edges": [
            {"held": sites.get(a, "?"), "then": sites.get(b, "?"),
             "holder_acquired_at": point}
            for (a, b), (point, _stack) in sorted(edges.items())
        ],
        "cycles": cycles,
        "same_site_nesting": [
            {"site": sites.get(sid, "?"), "holder_acquired_at": point,
             "acquisition_stack": list(stack)}
            for sid, (point, stack) in sorted(same_site.items())
        ],
        "blocking_under_lock": blocking,
    }


def format_report(rep: Optional[dict] = None) -> str:
    rep = rep if rep is not None else report()
    lines = [
        f"lockcheck: {rep['sites']} checked lock sites, "
        f"{len(rep['edges'])} held-before edges, "
        f"{len(rep['cycles'])} potential-deadlock cycle(s), "
        f"{len(rep['same_site_nesting'])} same-site nesting(s), "
        f"{len(rep['blocking_under_lock'])} blocking-call-under-lock "
        f"report(s)"
    ]
    for cyc in rep["cycles"]:
        lines.append("  POTENTIAL DEADLOCK CYCLE:")
        for hop in cyc:
            lines.append(f"    {hop['held']} (acquired at "
                         f"{hop['holder_acquired_at']}) -> "
                         f"{hop['then_acquired']}")
            for fr in hop["acquisition_stack"][:6]:
                lines.append(f"        {fr}")
    for ss in rep["same_site_nesting"]:
        lines.append(f"  same-site nesting: {ss['site']} "
                     f"(holder acquired at {ss['holder_acquired_at']}) — "
                     f"needs an instance-ordering discipline")
    for b in rep["blocking_under_lock"][:20]:
        lines.append(f"  blocking under lock: {b['call']} "
                     f"({b['detail']}) holding {b['held']} "
                     f"[{b['thread']}]")
        for fr in b["stack"][:4]:
            lines.append(f"        {fr}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Entry points: install from the environment, report at exit
# ---------------------------------------------------------------------------

_exit_written = False


def gate_enabled() -> bool:
    return os.environ.get("FAABRIC_LOCKCHECK_GATE", "1") not in (
        "0", "false")


def exit_summary(rep: Optional[dict] = None, top: int = 5) -> dict:
    """The one-line report a process writes at exit: the cycles (each
    as its ring of sites), the same-site nestings, the distinct blocking
    sites (call, held sites, first frame) and the ``top`` sites by
    longest single hold."""
    rep = rep if rep is not None else report()
    with _state.mx:
        stats = {sid: tuple(v) for sid, v in _state.hold_stats.items()}
        sites = dict(_state.sites)
    blocking: dict[tuple, int] = {}
    for b in rep["blocking_under_lock"]:
        key = (b["call"], tuple(b["held"]), b["stack"][0]
               if b["stack"] else "?")
        blocking[key] = blocking.get(key, 0) + 1
    longest = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {
        "pid": os.getpid(),
        "sites": rep["sites"],
        "edges": len(rep["edges"]),
        "cycles": [[hop["held"] for hop in cyc] for cyc in rep["cycles"]],
        "same_site_nesting": [ss["site"]
                              for ss in rep["same_site_nesting"]],
        "blocking": [
            {"call": call, "held": list(held), "at": at, "n": n}
            for (call, held, at), n in sorted(blocking.items())],
        "longest_holds": [
            {"site": sites.get(sid, "?"), "max_s": mx, "count": n,
             "total_s": tot}
            for sid, (n, tot, mx) in longest],
    }


def finish(stream=None) -> int:
    """Write the exit summary once (marker, then one JSON line) and
    return the status the gate asks for: 1 when a held-before cycle was
    seen and ``FAABRIC_LOCKCHECK_GATE`` is on, else 0. A no-op returning
    0 where the detector is not installed."""
    global _exit_written
    if not _installed:
        return 0
    summary = exit_summary()
    if not _exit_written:
        _exit_written = True
        out = stream if stream is not None else sys.stderr
        try:
            out.write(REPORT_MARKER + json.dumps(summary) + "\n")
            out.flush()
        except (OSError, ValueError):  # closed stream at interpreter exit
            pass
    return 1 if summary["cycles"] and gate_enabled() else 0


def install_from_env() -> bool:
    """Install the detector when ``FAABRIC_LOCKCHECK`` asks for it, and
    write its summary when the process exits. Call it before anything
    creates the locks it should see. Returns whether it installed."""
    if not enabled_by_env():
        return False
    first = not _installed
    install()
    if first:
        atexit.register(finish)
    return True
