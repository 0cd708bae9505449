"""Always-on in-process sampling profiler with per-thread CPU and
GIL-pressure attribution.

Every observability plane so far answers *where the time goes between
processes* — the per-link comm profiles, the invocation phase ledger,
the state access ledger. This module answers *where the CPU goes inside
a process*: a background thread snapshots ``sys._current_frames()``
every ``FAABRIC_PROFILE_INTERVAL_MS`` (default 25 ms) into a bounded,
cardinality-capped stack trie keyed by thread *class* — the
``subsystem/role`` prefix of the thread name, so samples read as
``planner/tick`` or ``bulk/conn``, never ``Thread-7``.

Two attribution signals separate wall-blocked from CPU-burning frames:

* each sample is weighted by the real per-thread CPU delta read from
  ``/proc/self/task/<tid>/stat`` (the procstats parsing idiom), so a
  thread parked in ``select()`` accrues samples but ~zero ``cpu_ms``
  while a busy-spin accrues both;
* a GIL-pressure estimator: the sampler knows exactly when it *asked*
  to wake and when it actually ran, and under a contended GIL that
  drift grows with the interpreter's switch interval; combined with a
  census of runnable threads (those with a CPU delta in the last
  period) it yields a [0, 1] gauge per process. The doctor cross-checks
  it against the lockcheck hold-time histograms so a lock convoy is not
  misread as GIL saturation.

Surfacing follows the established plane pattern end to end: a
``profile`` block on GET_TELEMETRY, planner-merged and per-host
``GET /profile``, ``faabric_profile_*`` / ``faabric_gil_pressure`` on
/metrics and /timeseries, ``python -m faabric_tpu_torch.runner.profile``
(top-down / bottom-up / flamegraph-collapsed / diff / selftest), and
doctor analyzers ``cpu_hotspot`` / ``gil_saturation`` /
``sampler_starved``.

Knobs:

* ``FAABRIC_PROFILE`` — default on; ``0`` pins the whole module to the
  shared no-op singleton (one attribute read + early return).
* ``FAABRIC_PROFILE_INTERVAL_MS`` — sampling period (default 25).
* ``FAABRIC_PROFILE_MAX_NODES`` — process-wide trie node budget
  (default 4096); overflow folds into a reserved ``(trie-cap)`` child
  and counts ``dropped_frames``, so memory is bounded no matter what
  the workload's stacks look like.
* ``FAABRIC_PROFILE_MAX_DEPTH`` — frames kept per stack (default 40,
  innermost kept, outermost folded).

Lifecycle mirrors the timeseries sampler: refcounted
``start_profiler()`` / ``stop_profiler()`` so PlannerServer and
WorkerRuntime (possibly co-resident in one process) share a single
sampler thread and the leak gate sees zero extras after the last
``stop()``.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

from .metrics import get_metrics, metrics_enabled
from .timeseries import get_timeseries

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100

DEFAULT_INTERVAL_MS = 25.0
DEFAULT_MAX_NODES = 4096
DEFAULT_MAX_DEPTH = 40

# Reserved frame labels — never produced by _frame_label, so they can't
# collide with real code locations.
CAP_LABEL = "(trie-cap)"
TRUNC_LABEL = "(deep-stack)"

# A thread whose per-interval CPU delta exceeds this fraction of the
# interval counts as "runnable" in the GIL census (it wanted the GIL
# for most of the period, not just a wakeup blip).
_RUNNABLE_FRACTION = 0.5

# EWMA smoothing for the drift ratio and the per-sample cost estimate.
_EWMA_ALPHA = 0.2

_TRAILING_NUM = re.compile(r"[-_]?\d+$")


def profile_enabled() -> bool:
    """Profiler master switch: requires the metrics plane (the trie is
    surfaced through it) and ``FAABRIC_PROFILE`` != 0 (default on)."""
    return metrics_enabled() and os.environ.get(
        "FAABRIC_PROFILE", "1") != "0"


def profile_interval_s() -> float:
    try:
        ms = float(os.environ.get("FAABRIC_PROFILE_INTERVAL_MS",
                                  DEFAULT_INTERVAL_MS))
    except ValueError:
        ms = DEFAULT_INTERVAL_MS
    return max(ms, 1.0) / 1000.0


def thread_class(name: str) -> str:
    """Collapse a thread name to its stable ``subsystem/role`` class.

    The repo-wide naming convention is
    ``subsystem/role`` with an optional ``@instance`` suffix for
    per-connection / per-app threads (``bulk/conn@9031``,
    ``planner/recover@app7``). Classing strips the instance so the trie
    cardinality tracks the *kinds* of threads, not their count.
    Foreign threads (pytest, concurrent.futures, jax pools) fold under
    ``other/`` with trailing numerals stripped; anonymous ones are
    ``unnamed``.
    """
    if not name:
        return "unnamed"
    if name == "MainThread":
        return "main"
    base = name.split("@", 1)[0]
    if "/" in base:
        return base
    # CPython's "Thread-7 (target_name)" form: class by target.
    if base.startswith("Thread-"):
        if "(" in base and base.endswith(")"):
            target = base.split("(", 1)[1][:-1].strip()
            if target:
                return "other/" + target
        return "unnamed"
    return "other/" + (_TRAILING_NUM.sub("", base) or base)


def _frame_label(frame) -> str:
    """``name (pkg/file.py:lineno)`` with the path clipped to its last
    two components — stable across checkouts, unique enough to read."""
    code = frame.f_code
    path = code.co_filename.replace("\\", "/")
    parts = path.rsplit("/", 2)
    short = "/".join(parts[-2:]) if len(parts) > 1 else path
    return f"{code.co_name} ({short}:{code.co_firstlineno})"


class _Node:
    """One frame in a per-class stack trie (root→leaf = outer→inner)."""

    __slots__ = ("frame", "children", "samples", "cpu_ms")

    def __init__(self, frame: str) -> None:
        self.frame = frame
        self.children: dict[str, _Node] = {}
        self.samples = 0
        self.cpu_ms = 0.0


class _NullProfiler:
    """Shared no-op when the plane is off: every method one early
    return, so the disabled path costs an attribute read."""

    enabled = False

    def sample_now(self) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


NULL_PROFILER = _NullProfiler()


class Profiler:
    """Bounded stack-trie sampler with per-thread CPU weighting.

    All trie / census state is folded under one leaf ``_lock`` per
    sample; the expensive reads (``sys._current_frames()``, the
    ``/proc/self/task`` scans) happen outside it. Nothing under
    ``_lock`` calls out of the module, so it can never participate in
    a lock cycle (concheck baseline stays EMPTY).
    """

    GUARDS = {
        "_roots": "_lock",
        "_class_threads": "_lock",
        "_samples": "_lock",
        "_expected": "_lock",
        "_nodes": "_lock",
        "_dropped": "_lock",
        "_cpu_prev": "_lock",
        "_drift_avg": "_lock",
        "_drift_max": "_lock",
        "_late": "_lock",
        "_runnable_now": "_lock",
        "_runnable_sum": "_lock",
        "_cost_avg_s": "_lock",
    }

    enabled = True

    def __init__(self, interval_s: float | None = None,
                 max_nodes: int | None = None,
                 max_depth: int | None = None) -> None:
        self.interval_s = interval_s or profile_interval_s()
        try:
            self.max_nodes = int(max_nodes or os.environ.get(
                "FAABRIC_PROFILE_MAX_NODES", DEFAULT_MAX_NODES))
        except ValueError:
            self.max_nodes = DEFAULT_MAX_NODES
        try:
            self.max_depth = int(max_depth or os.environ.get(
                "FAABRIC_PROFILE_MAX_DEPTH", DEFAULT_MAX_DEPTH))
        except ValueError:
            self.max_depth = DEFAULT_MAX_DEPTH
        self._lock = threading.Lock()
        self._roots: dict[str, _Node] = {}      # class -> trie root
        self._class_threads: dict[str, int] = {}
        self._samples = 0
        self._expected = 0
        self._nodes = 0
        self._dropped = 0
        self._cpu_prev: dict[int, float] = {}   # native tid -> cpu s
        self._drift_avg = 0.0
        self._drift_max = 0.0
        self._late = 0
        self._runnable_now = 0
        self._runnable_sum = 0.0
        self._cost_avg_s = 0.0
        self._started = time.monotonic()
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        m = get_metrics()
        self._m_samples = m.counter("faabric_profile_samples_total",
                                    "stack samples folded into the trie")
        self._m_nodes = m.gauge("faabric_profile_stack_nodes",
                                "live stack-trie nodes (bounded)")
        self._m_overhead = m.gauge(
            "faabric_profile_overhead_pct",
            "sampler self-cost as % of the sampling interval")
        self._m_gil = m.gauge(
            "faabric_gil_pressure",
            "0..1 sampler-drift + runnable-census GIL estimate")

    # ------------------------------------------------------------------
    # sampling

    @staticmethod
    def _read_thread_cpu() -> dict[int, float]:
        """native tid -> cumulative CPU seconds, from
        ``/proc/self/task/<tid>/stat`` (procstats parsing idiom: the
        comm field may contain spaces/parens, so split after the last
        ``)``; utime/stime are fields 14/15, i.e. offsets 11/12 after
        the split)."""
        out: dict[int, float] = {}
        try:
            tids = os.listdir("/proc/self/task")
        except OSError:
            return out
        for tid in tids:
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    rest = f.read().rsplit(")", 1)[-1].split()
                out[int(tid)] = (int(rest[11]) + int(rest[12])) / _CLK_TCK
            except (OSError, IndexError, ValueError):
                continue  # thread exited mid-scan
        return out

    def sample_now(self, drift_s: float = 0.0) -> None:
        """Take one sample: read frames + per-thread CPU outside the
        lock, fold everything in under it."""
        t0 = time.perf_counter()
        me = threading.get_ident()
        idents: dict[int, tuple[str, int | None]] = {}
        for t in threading.enumerate():
            if t.ident is not None and t.ident != me:
                idents[t.ident] = (t.name, t.native_id)
        try:
            frames = sys._current_frames()
        except Exception:
            return
        cpu_now = self._read_thread_cpu()

        # Pre-compute per-thread stacks and labels outside the lock;
        # only the trie fold itself mutates shared state.
        folds: list[tuple[int, list[str]]] = []
        for ident, frame in frames.items():
            info = idents.get(ident)
            if info is None:
                continue  # our own thread, or one that died mid-walk
            stack: list[str] = []
            f = frame
            while f is not None and len(stack) <= self.max_depth:
                stack.append(_frame_label(f))
                f = f.f_back
            stack.reverse()  # outermost first
            if len(stack) > self.max_depth:
                stack = [TRUNC_LABEL] + stack[-self.max_depth:]
            folds.append((ident, stack))

        interval = self.interval_s
        with self._lock:
            self._samples += 1
            self._expected += 1
            runnable = 0
            cpu_deltas: dict[int, float] = {}
            for tid, total in cpu_now.items():
                prev = self._cpu_prev.get(tid)
                if prev is not None and total > prev:
                    cpu_deltas[tid] = total - prev
                    if total - prev >= _RUNNABLE_FRACTION * interval:
                        runnable += 1
            self._cpu_prev = cpu_now
            self._runnable_now = runnable
            self._runnable_sum += runnable

            drift_ratio = max(drift_s, 0.0) / interval
            self._drift_avg += _EWMA_ALPHA * (drift_ratio
                                              - self._drift_avg)
            self._drift_max = max(self._drift_max, drift_ratio)
            if drift_ratio > 1.0:
                self._late += 1

            self._class_threads = {}
            for ident, stack in folds:
                name, native = idents[ident]
                cls = thread_class(name)
                self._class_threads[cls] = \
                    self._class_threads.get(cls, 0) + 1
                cpu_ms = cpu_deltas.get(native or -1, 0.0) * 1000.0
                self._fold_locked(cls, stack, cpu_ms)

            cost = time.perf_counter() - t0
            self._cost_avg_s += _EWMA_ALPHA * (cost - self._cost_avg_s)
            self._m_samples.inc()
            self._m_nodes.set(float(self._nodes))
            self._m_overhead.set(
                round(100.0 * self._cost_avg_s / interval, 3))
            self._m_gil.set(self.gil_pressure_locked())

    def _fold_locked(self, cls: str, stack: list[str],
                     cpu_ms: float) -> None:
        """Fold one stack into the class trie. Past the node budget new
        paths collapse into a reserved cap child and stop descending —
        counts stay exact, attribution degrades gracefully."""
        node = self._roots.get(cls)
        if node is None:
            node = self._roots[cls] = _Node("(root)")
            self._nodes += 1
        node.samples += 1
        node.cpu_ms += cpu_ms
        for frame in stack:
            child = node.children.get(frame)
            if child is None:
                if self._nodes >= self.max_nodes:
                    child = node.children.get(CAP_LABEL)
                    if child is None:
                        child = node.children[CAP_LABEL] = \
                            _Node(CAP_LABEL)
                    child.samples += 1
                    child.cpu_ms += cpu_ms
                    self._dropped += 1
                    return
                child = node.children[frame] = _Node(frame)
                self._nodes += 1
            child.samples += 1
            child.cpu_ms += cpu_ms
            node = child

    def note_missed(self, n: int) -> None:
        """Record sampler wakeups that never happened (scheduling
        starvation): expected grows, samples doesn't."""
        if n <= 0:
            return
        with self._lock:
            self._expected += n

    def gil_pressure_locked(self) -> float:
        """[0, 1] — EWMA sampler-wakeup drift clamped; drift is in
        units of the interval, so 1.0 means wakeups land a full period
        late on average."""
        return max(0.0, min(1.0, self._drift_avg))

    def snapshot_gil_pressure(self) -> float:
        """Single locked read for the /timeseries gauge closure."""
        with self._lock:
            return self.gil_pressure_locked()

    def snapshot_runnable(self) -> float:
        with self._lock:
            return float(self._runnable_now)

    # ------------------------------------------------------------------
    # sampler thread

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry/profiler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        """Fixed-cadence loop measuring its own wakeup drift.

        ``next_t`` advances by exactly one interval per iteration so
        drift is *measured*, not absorbed — but is clamped to ``now``
        when more than one whole period behind, so a long stall doesn't
        spiral into back-to-back catch-up sampling (the missed wakeups
        are recorded instead)."""
        interval = self.interval_s
        next_t = time.monotonic() + interval
        while not self._stop_evt.wait(
                timeout=max(next_t - time.monotonic(), 0.0)):
            now = time.monotonic()
            drift = now - next_t
            self.sample_now(drift_s=drift)
            next_t += interval
            if next_t < now:
                missed = int((now - next_t) / interval) + 1
                self.note_missed(missed)
                next_t = now + interval

    # ------------------------------------------------------------------
    # export

    def snapshot(self) -> dict:
        """Wire form for the telemetry block / worker ``/profile``."""
        with self._lock:
            wall = max(time.monotonic() - self._started, 1e-9)
            classes = {}
            for cls, root in sorted(self._roots.items()):
                classes[cls] = {
                    "samples": root.samples,
                    "cpu_ms": round(root.cpu_ms, 3),
                    "threads_now": self._class_threads.get(cls, 0),
                }
            samples = self._samples
            doc = {
                "enabled": True,
                "pid": os.getpid(),
                "interval_ms": round(self.interval_s * 1000.0, 3),
                "samples": samples,
                "expected_samples": self._expected,
                "wall_s": round(wall, 3),
                "sample_cost_ms": round(self._cost_avg_s * 1000.0, 4),
                "overhead_pct": round(
                    100.0 * self._cost_avg_s / self.interval_s, 3),
                "nodes": self._nodes,
                "max_nodes": self.max_nodes,
                "dropped_frames": self._dropped,
                "classes": classes,
                "stacks": self._leaf_rows_locked(),
                "gil": {
                    "pressure": round(self.gil_pressure_locked(), 4),
                    "drift_ratio_avg": round(self._drift_avg, 4),
                    "drift_ratio_max": round(self._drift_max, 4),
                    "runnable_now": self._runnable_now,
                    "runnable_avg": round(
                        self._runnable_sum / samples, 3)
                        if samples else 0.0,
                    "late_samples": self._late,
                },
            }
        return doc

    def _leaf_rows_locked(self, per_class_cap: int = 50) -> list[dict]:
        """Collapsed hot-path rows: one row per trie leaf (or per
        interior node where a stack actually *ended*), frames
        outer→inner. Capped per class with an ``(elided)`` fold row so
        the wire size is bounded like every other plane's export."""
        rows: list[dict] = []
        for cls, root in sorted(self._roots.items()):
            class_rows: list[dict] = []

            def walk(node: _Node, path: list[str]) -> None:
                child_samples = sum(c.samples
                                    for c in node.children.values())
                ended = node.samples - child_samples
                if path and (ended > 0 or not node.children):
                    child_cpu = sum(c.cpu_ms
                                    for c in node.children.values())
                    class_rows.append({
                        "class": cls,
                        "frames": list(path),
                        "samples": ended if node.children
                        else node.samples,
                        "cpu_ms": round(node.cpu_ms - child_cpu
                                        if node.children
                                        else node.cpu_ms, 3),
                    })
                for child in node.children.values():
                    walk(child, path + [child.frame])

            walk(root, [])
            class_rows.sort(key=lambda r: (-r["cpu_ms"],
                                           -r["samples"]))
            if len(class_rows) > per_class_cap:
                tail = class_rows[per_class_cap:]
                class_rows = class_rows[:per_class_cap]
                class_rows.append({
                    "class": cls,
                    "frames": ["(elided)"],
                    "samples": sum(r["samples"] for r in tail),
                    "cpu_ms": round(sum(r["cpu_ms"] for r in tail), 3),
                })
            rows.extend(class_rows)
        return rows


# ----------------------------------------------------------------------
# merge / render / CLI helpers (pure functions over wire forms)

def aggregate_profile(telemetry: dict) -> dict:
    """Merge per-host ``profile`` telemetry blocks into one ranked
    cluster document (the ``GET /profile`` payload)."""
    hosts: dict[str, dict] = {}
    for host, tel in sorted((telemetry or {}).items()):
        block = (tel or {}).get("profile")
        if block:
            hosts[host] = block

    classes: list[dict] = []
    stacks: list[dict] = []
    gil: dict[str, dict] = {}
    for host, block in hosts.items():
        for cls, row in (block.get("classes") or {}).items():
            classes.append({"host": host, "class": cls, **row})
        host_cpu = sum((r.get("cpu_ms") or 0.0)
                       for r in (block.get("stacks") or []))
        for row in (block.get("stacks") or []):
            stacks.append({
                "host": host,
                "class": row.get("class", "?"),
                "frames": row.get("frames") or [],
                "samples": row.get("samples", 0),
                "cpu_ms": row.get("cpu_ms", 0.0),
                "cpu_share": round((row.get("cpu_ms") or 0.0)
                                   / host_cpu, 4) if host_cpu else 0.0,
            })
        if block.get("gil"):
            gil[host] = block["gil"]

    classes.sort(key=lambda r: (-r["cpu_ms"], -r["samples"]))
    stacks.sort(key=lambda r: (-r["cpu_ms"], -r["samples"]))
    for i, row in enumerate(stacks):
        row["rank"] = i + 1
    return {
        "generated_at": time.time(),
        "hosts": {h: {k: b.get(k) for k in
                      ("pid", "interval_ms", "samples",
                       "expected_samples", "wall_s", "overhead_pct",
                       "nodes", "dropped_frames")}
                  for h, b in hosts.items()},
        "classes": classes,
        "stacks": stacks,
        "gil": gil,
    }


def render_profile(doc: dict, top: int = 15) -> str:
    """Fixed-width console rendering of an aggregated profile doc."""
    lines = []
    hosts = doc.get("hosts") or {}
    lines.append(f"cluster profile — {len(hosts)} host(s)")
    for host, meta in sorted(hosts.items()):
        g = (doc.get("gil") or {}).get(host) or {}
        lines.append(
            f"  {host}: {meta.get('samples', 0)} samples @ "
            f"{meta.get('interval_ms', '?')} ms, overhead "
            f"{meta.get('overhead_pct', 0)}%, gil_pressure "
            f"{g.get('pressure', 0)}, runnable_avg "
            f"{g.get('runnable_avg', 0)}")
    lines.append("")
    lines.append(f"{'rank':>4}  {'cpu_ms':>10}  {'smpl':>6}  "
                 f"{'share':>6}  host/class · leaf")
    for row in (doc.get("stacks") or [])[:top]:
        leaf = row["frames"][-1] if row.get("frames") else "?"
        lines.append(
            f"{row.get('rank', 0):>4}  {row.get('cpu_ms', 0):>10.1f}  "
            f"{row.get('samples', 0):>6}  "
            f"{row.get('cpu_share', 0):>6.2f}  "
            f"{row.get('host', '?')}/{row.get('class', '?')} · {leaf}")
    return "\n".join(lines)


def collapsed_lines(doc: dict, weight: str = "samples") -> list[str]:
    """Flamegraph-collapsed output: ``host;class;f1;f2;...;fN count``
    — feedable straight into flamegraph.pl / speedscope. ``weight`` is
    ``samples`` or ``cpu`` (cpu_ms rounded to int)."""
    out = []
    for row in doc.get("stacks") or []:
        w = (int(round(row.get("cpu_ms", 0.0))) if weight == "cpu"
             else row.get("samples", 0))
        if w <= 0:
            continue
        parts = [row.get("host", "?"), row.get("class", "?")] + \
            list(row.get("frames") or [])
        out.append(";".join(parts) + f" {w}")
    return out


def bottom_up(doc: dict, top: int = 15) -> list[dict]:
    """Leaf-frame aggregation: for each innermost frame, total self
    weight across all stacks it terminates — the 'which function burns
    the CPU' view, complementary to the top-down trie."""
    acc: dict[str, dict] = {}
    for row in doc.get("stacks") or []:
        frames = row.get("frames") or []
        if not frames:
            continue
        leaf = frames[-1]
        ent = acc.setdefault(leaf, {"frame": leaf, "samples": 0,
                                    "cpu_ms": 0.0, "classes": set()})
        ent["samples"] += row.get("samples", 0)
        ent["cpu_ms"] += row.get("cpu_ms", 0.0)
        ent["classes"].add(f"{row.get('host', '?')}/"
                           f"{row.get('class', '?')}")
    rows = sorted(acc.values(),
                  key=lambda r: (-r["cpu_ms"], -r["samples"]))[:top]
    for r in rows:
        r["cpu_ms"] = round(r["cpu_ms"], 3)
        r["classes"] = sorted(r["classes"])
    return rows


def diff_profiles(before: dict, after: dict, top: int = 15
                  ) -> list[dict]:
    """Round-over-round regression hunting: match stacks by
    (host, class, frames) and rank by cpu_ms growth."""
    def index(doc):
        return {(r.get("host"), r.get("class"),
                 tuple(r.get("frames") or [])): r
                for r in doc.get("stacks") or []}

    b, a = index(before), index(after)
    rows = []
    for key in set(b) | set(a):
        pb, pa = b.get(key), a.get(key)
        cpu_b = pb.get("cpu_ms", 0.0) if pb else 0.0
        cpu_a = pa.get("cpu_ms", 0.0) if pa else 0.0
        rows.append({
            "host": key[0], "class": key[1], "frames": list(key[2]),
            "cpu_ms_before": round(cpu_b, 3),
            "cpu_ms_after": round(cpu_a, 3),
            "cpu_ms_delta": round(cpu_a - cpu_b, 3),
            "samples_before": pb.get("samples", 0) if pb else 0,
            "samples_after": pa.get("samples", 0) if pa else 0,
        })
    rows.sort(key=lambda r: -abs(r["cpu_ms_delta"]))
    return rows[:top]


# ----------------------------------------------------------------------
# process-wide singleton + refcounted lifecycle

_profiler: Profiler | None = None
_profiler_users = 0
_singleton_lock = threading.Lock()


def _register_gauges(p: Profiler) -> None:
    """Best-effort /timeseries wiring (mirrors statestats): cheap
    closures over the profiler's locked state."""
    try:
        ring = get_timeseries()
        ring.register("gil_pressure",
                      lambda: p.snapshot_gil_pressure())
        ring.register("profile_runnable_threads",
                      lambda: p.snapshot_runnable())
    except Exception:
        pass


def _unregister_gauges() -> None:
    try:
        ring = get_timeseries()
        ring.unregister("gil_pressure")
        ring.unregister("profile_runnable_threads")
    except Exception:
        pass


def get_profiler() -> Profiler | _NullProfiler:
    """The process-wide profiler, or the shared no-op when disabled."""
    global _profiler
    if not profile_enabled():
        return NULL_PROFILER
    if _profiler is None:
        with _singleton_lock:
            if _profiler is None:
                p = Profiler()
                _register_gauges(p)
                _profiler = p
    return _profiler


def start_profiler() -> None:
    """Refcounted sampler start: the first caller spawns the thread,
    later callers (a WorkerRuntime sharing the planner's process) just
    bump the count. No-op when the plane is disabled."""
    global _profiler_users
    if not profile_enabled():
        return
    p = get_profiler()
    with _singleton_lock:
        _profiler_users += 1
        if _profiler_users == 1:
            p.start()  # concheck: ok(blocking-under-lock) — spawn only


def stop_profiler() -> None:
    """Refcounted stop: the last caller joins the sampler thread so
    the leak gate sees zero extras."""
    global _profiler_users
    with _singleton_lock:
        if _profiler_users == 0:
            return
        _profiler_users -= 1
        if _profiler_users > 0:
            return
        p = _profiler
    if p is not None:
        p.stop()


def reset_profiler() -> None:
    """Test hook: drop the singleton and its timeseries gauges."""
    global _profiler, _profiler_users
    with _singleton_lock:
        p, _profiler, _profiler_users = _profiler, None, 0
    if p is not None:
        p.stop()
        _unregister_gauges()


def profile_telemetry_block() -> dict:
    """The ``profile`` entry for GET_TELEMETRY's blocks selector —
    ``{}`` when the plane is off, so disabled hosts cost nothing on
    the wire."""
    p = get_profiler()
    if not p.enabled:
        return {}
    return p.snapshot()
