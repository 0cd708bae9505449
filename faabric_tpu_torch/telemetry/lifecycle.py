"""Invocation lifecycle plane: where do an invocation's
milliseconds go?

Counterpart of ``faabric_tpu/telemetry/lifecycle.py``. The data plane
has metrics, spans and the comm matrix; the control plane exposed only
point-in-time counters. faabric itself stamps a per-message ledger
(exec-graph nodes carry queue/exec/wall ms); this module reproduces it
end to end, cluster-merged:

- **Phase ledger**: every Message carries a compact ``lc`` dict of
  monotonic nanosecond stamps (short wire keys, see ``PHASE_LABELS``)
  written at admit, ingress-queue exit, tick schedule, journal append,
  dispatch send, executor-queue exit, run start/end, result push,
  planner record and waiter wake — across processes, because the dict
  rides the Message wire form (``to_wire_dict``) on dispatch and on the
  result push. Recovery requeues stamp a ``requeue`` boundary, so a
  message that died with its host carries a ledger spanning BOTH
  attempts. Stamps are ``time.monotonic_ns()``: on one machine (every
  process shares CLOCK_MONOTONIC) all stamps compare exactly; across
  real machines the two transit phases (``executor_queue``, ``record``)
  absorb the clock offset — the same honesty caveat as
  ``faabric_planner_result_roundtrip_seconds``.
- **Fold**: when the planner records a result, the ledger folds into
  per-phase log-bucket streaming estimators (the perfprofile
  ``DecayedStat``) plus an end-to-end digest — served on ``/healthz``
  (``lifecycle`` block: per-phase quantiles + the dominant-phase
  ranking the doctor reads) and ``/metrics``
  (``faabric_lifecycle_phase_seconds``/``faabric_lifecycle_e2e_seconds``
  histograms).
- **SLO tracker**: declared targets (``FAABRIC_SLO``, e.g.
  ``p99_e2e_ms=50,error_rate=0.001``) evaluated with multi-window burn
  rates over time-bucketed counters; burn onset is flight-recorded and
  the rates ride ``/healthz`` + ``/metrics``.

Cost contract: one stamp is one dict store + one ``monotonic_ns`` call
(~100 ns, benched as ``lifecycle_stamp_ns``); with ``FAABRIC_METRICS=0``
(or ``FAABRIC_LIFECYCLE=0``) every handle is the shared no-op singleton
— ``get_lifecycle() is NULL_LIFECYCLE`` — so the stamping sites cost
one no-op method call and the wire dict carries an empty ``lc``.

Knobs: ``FAABRIC_LIFECYCLE`` (default on while metrics are on),
``FAABRIC_SLO`` (spec; empty → tracker off), ``FAABRIC_SLO_WINDOWS``
(comma seconds, default ``60,600``), ``FAABRIC_SLO_BURN`` (burn-rate
threshold, default 2.0), ``FAABRIC_SLO_BUCKET_S`` (counter bucket
width, default 5), ``FAABRIC_SLO_MIN_COUNT`` (evidence floor per
window, default 20).
"""

from __future__ import annotations

import os
import threading
import time

from faabric_tpu_torch.telemetry.metrics import get_metrics, metrics_enabled
from faabric_tpu_torch.telemetry.perfprofile import DecayedStat
from faabric_tpu_torch.util.config import _env_float, _env_int

# -- phase taxonomy -----------------------------------------------------
# Wire keys are short on purpose: the ledger rides EVERY dispatched and
# result-pushed message's JSON header. Values are monotonic ns stamps.
PHASE_ADMIT = "adm"            # admission granted / classic entry
PHASE_QUEUE_EXIT = "qex"       # left the ingress queue (tick pickup)
PHASE_SCHED = "sch"            # scheduling decision made
PHASE_JOURNAL = "jnl"          # journal append done
PHASE_DISPATCH = "dsp"         # dispatch RPC about to be written
PHASE_REQUEUE = "rqu"          # recovery requeue boundary
PHASE_EXEC_QUEUE_EXIT = "eqx"  # executor pool thread picked the task
PHASE_RUN_START = "rns"        # guest execute_task entered
PHASE_RUN_END = "rne"          # guest execute_task returned
PHASE_RESULT_PUSH = "rsp"      # worker pushing the result
PHASE_RECORDED = "rec"         # planner recorded the result
PHASE_WAITER_WAKE = "wwk"      # waiting client woken with the result

# NOT a stamp: accumulated in-run state pull/push nanoseconds .
# Written by charge_state_time() from the state hot paths while an
# ExecutorContext is set; ledger_durations() carves it out of the run
# window as its own "state" phase so /healthz dominant-phase ranking
# can attribute state-bound invocations (they used to read as opaque
# "run"). A duration key must never enter the time-sorted stamp walk —
# its value is an interval, not a point on the monotonic clock.
PHASE_STATE_ACC = "stx"

# Duration label for the gap ENDING at each stamp (time-sorted — a
# requeued message's second-attempt dispatch stamp lands after its
# requeue stamp, and the sort attributes the gaps truthfully).
PHASE_LABELS = {
    PHASE_QUEUE_EXIT: "ingress_queue",
    PHASE_SCHED: "schedule",
    PHASE_JOURNAL: "journal",
    PHASE_DISPATCH: "dispatch",
    PHASE_REQUEUE: "requeue",
    PHASE_EXEC_QUEUE_EXIT: "executor_queue",
    PHASE_RUN_START: "run_prep",
    PHASE_RUN_END: "run",
    PHASE_RESULT_PUSH: "result_push",
    PHASE_RECORDED: "record",
    PHASE_WAITER_WAKE: "waiter_wake",
}


def lifecycle_enabled() -> bool:
    return (metrics_enabled()
            and os.environ.get("FAABRIC_LIFECYCLE", "1")
            not in ("0", "false", "off"))


class _NullLifecycle:
    """Shared no-op stamper while the plane is off: identity-checkable
    (``get_lifecycle() is NULL_LIFECYCLE``) so the disabled path is one
    no-op method call per site."""

    __slots__ = ()
    enabled = False

    def stamp(self, msg, phase: str) -> None:
        pass

    def stamp_first(self, msg, phase: str) -> None:
        pass

    def stamp_many(self, msgs, phase: str) -> None:
        pass


NULL_LIFECYCLE = _NullLifecycle()


class Lifecycle:
    """The stamper. Stateless — stamps live on the Message itself so
    they travel the wire; no locking (each message is stamped by the
    one thread currently owning its lifecycle step)."""

    __slots__ = ()
    enabled = True

    @staticmethod
    def stamp(msg, phase: str) -> None:
        msg.lc[phase] = time.monotonic_ns()

    @staticmethod
    def stamp_first(msg, phase: str) -> None:
        """First-write stamp: ``admit`` must survive re-entries (thaw,
        direct call_batch after an ingress stamp)."""
        if phase not in msg.lc:
            msg.lc[phase] = time.monotonic_ns()

    @staticmethod
    def stamp_many(msgs, phase: str) -> None:
        now = time.monotonic_ns()
        for m in msgs:
            m.lc[phase] = now


_lifecycle: Lifecycle | _NullLifecycle | None = None
_singleton_lock = threading.Lock()


def get_lifecycle() -> Lifecycle | _NullLifecycle:
    global _lifecycle
    if _lifecycle is None:
        with _singleton_lock:
            if _lifecycle is None:
                _lifecycle = (Lifecycle() if lifecycle_enabled()
                              else NULL_LIFECYCLE)
    return _lifecycle


def charge_state_time(ns: int) -> None:
    """Charge ``ns`` nanoseconds of state pull/push time to the message
    currently executing on THIS thread. No-op unless the
    lifecycle plane is on AND an ExecutorContext is set — state ops
    from non-executor threads (benches, servers, tests) charge nobody.
    Accumulates: one run window may perform many state ops."""
    if not get_lifecycle().enabled or ns <= 0:
        return
    try:
        from faabric_tpu_torch.executor.context import ExecutorContext

        if not ExecutorContext.is_set():
            return
        msg = ExecutorContext.get().msg
        msg.lc[PHASE_STATE_ACC] = (
            msg.lc.get(PHASE_STATE_ACC, 0) + int(ns))
    except Exception:  # noqa: BLE001 — attribution must never kill an op
        pass


# ---------------------------------------------------------------------------
# Pure ledger analysis
# ---------------------------------------------------------------------------

def ledger_durations(lc: dict) -> dict[str, float]:
    """Phase durations (seconds) from a stamp ledger: stamps sort by
    TIME (not taxonomy order — a requeue reorders the tail) and each
    gap is attributed to the label of the stamp that ends it. Negative
    gaps (cross-machine clock offset) clamp to 0. Unknown keys keep
    their raw name so a future phase never silently vanishes.

    ``stx`` is a DURATION, not a stamp: accumulated in-run
    state pull/push ns. It is excluded from the stamp walk and carved
    OUT of the run window (``state`` + ``run`` still sum to the old
    ``run``, so the fold's clock-coherence guard is unaffected)."""
    lc = lc or {}
    stamps = sorted(((int(v), k) for k, v in lc.items()
                     if isinstance(v, (int, float))
                     and k != PHASE_STATE_ACC))
    out: dict[str, float] = {}
    for i in range(1, len(stamps)):
        t, key = stamps[i]
        label = PHASE_LABELS.get(key, key)
        out[label] = out.get(label, 0.0) + max(
            0.0, (t - stamps[i - 1][0]) / 1e9)
    acc = lc.get(PHASE_STATE_ACC)
    if isinstance(acc, (int, float)) and acc > 0 and "run" in out:
        state = min(out["run"], int(acc) / 1e9)
        if state > 0:
            out["state"] = state
            out["run"] -= state
    return out


def ledger_span_s(lc: dict) -> float:
    """Last stamp − first stamp, seconds (0 with <2 stamps)."""
    vals = [int(v) for v in (lc or {}).values()
            if isinstance(v, (int, float))]
    if len(vals) < 2:
        return 0.0
    return max(0.0, (max(vals) - min(vals)) / 1e9)


def ledger_e2e_s(lc: dict) -> float | None:
    """Admit → planner-record wall, the e2e figure the digest and the
    SLO tracker consume (None when either endpoint stamp is absent)."""
    lc = lc or {}
    if PHASE_ADMIT not in lc or PHASE_RECORDED not in lc:
        return None
    return max(0.0, (int(lc[PHASE_RECORDED]) - int(lc[PHASE_ADMIT])) / 1e9)


# ---------------------------------------------------------------------------
# Fold store: per-phase streaming estimators + e2e digest
# ---------------------------------------------------------------------------

class _NullLifecycleStats:
    __slots__ = ()
    enabled = False

    def fold(self, msgs) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_LIFECYCLE_STATS = _NullLifecycleStats()


class LifecycleStats:
    """Per-phase + end-to-end invocation latency digest. Fed by the
    planner as results are recorded (outside the planner lock); read by
    ``/healthz``, ``GET_TELEMETRY`` and the doctor."""

    # Concurrency contract (analysis/concheck.py): estimator maps mutate
    # under one leaf lock; fold/snapshot never hold it across blocking
    # calls. The Prometheus handles are internally locked per series.
    GUARDS = {
        "_phases": "_lock",
        "_e2e": "_lock",
        "_count": "_lock",
        "_failed": "_lock",
    }

    enabled = True

    def __init__(self, half_life: float | None = None) -> None:
        self.half_life = (half_life if half_life is not None else
                          _env_float("FAABRIC_PERF_HALF_LIFE_S", 120.0))
        self._lock = threading.Lock()
        self._phases: dict[str, DecayedStat] = {}
        self._e2e = DecayedStat(self.half_life)
        self._count = 0
        self._failed = 0
        metrics = get_metrics()
        self._h_e2e = metrics.histogram(
            "faabric_lifecycle_e2e_seconds",
            "Admit to planner-recorded invocation latency (phase ledger)")
        self._incoherent = metrics.counter(
            "faabric_lifecycle_incoherent_ledgers_total",
            "Ledgers whose cross-host stamps failed the clock-domain "
            "coherence check (folded as e2e only)")
        self._h_phase: dict[str, object] = {}
        self._metrics = metrics

    def _phase_histogram(self, label: str):
        h = self._h_phase.get(label)
        if h is None:
            h = self._metrics.histogram(
                "faabric_lifecycle_phase_seconds",
                "Per-phase invocation latency from the message ledger",
                phase=label)
            self._h_phase[label] = h
        return h

    def fold(self, msgs) -> None:
        """Fold recorded results' ledgers in. Call OUTSIDE the planner
        lock — a fold is ~10 µs per message across all phases."""
        from faabric_tpu_torch.proto import ReturnValue

        slo = get_slo_tracker()
        for msg in msgs:
            lc = getattr(msg, "lc", None) or {}
            failed = msg.return_value == int(ReturnValue.FAILED)
            e2e = ledger_e2e_s(lc)
            slo.observe(e2e, failed)
            durations = ledger_durations(lc)
            if not durations:
                continue
            # Clock-domain coherence guard: admit and record are BOTH
            # planner-clock stamps, so e2e is always sane — but on a
            # real multi-machine cluster a worker whose monotonic base
            # differs can blow the time-sorted span far past it, and
            # folding that would crown a phantom dominant phase. Such
            # ledgers contribute their (valid) e2e + SLO only.
            if e2e is not None and sum(durations.values()) > \
                    2.0 * e2e + 1.0:
                self._incoherent.inc()
                with self._lock:
                    self._count += 1
                    if failed:
                        self._failed += 1
                    self._e2e.observe(e2e)
                self._h_e2e.observe(e2e)
                continue
            now = time.monotonic()
            with self._lock:
                self._count += 1
                if failed:
                    self._failed += 1
                for label, secs in durations.items():
                    stat = self._phases.get(label)
                    if stat is None:
                        stat = self._phases[label] = DecayedStat(
                            self.half_life)
                    stat.observe(secs, now=now)
                if e2e is not None:
                    self._e2e.observe(e2e, now=now)
            for label, secs in durations.items():
                self._phase_histogram(label).observe(secs)
            if e2e is not None:
                self._h_e2e.observe(e2e)

    @staticmethod
    def _stat_row(stat: DecayedStat) -> dict:
        return {
            "p50_ms": round(stat.quantile(0.50) * 1e3, 4),
            "p90_ms": round(stat.quantile(0.90) * 1e3, 4),
            "p99_ms": round(stat.quantile(0.99) * 1e3, 4),
            "mean_ms": round(stat.mean * 1e3, 4),
            "count": stat.n,
        }

    def snapshot(self) -> dict:
        """JSON-safe digest: per-phase quantiles, the e2e digest, and
        the dominant-phase ranking for the p99 tail — phases ordered by
        their own p99 (in a mostly-serial pipeline the phase with the
        fattest tail is what the e2e p99 is made of)."""
        with self._lock:
            count, failed = self._count, self._failed
            e2e_row = self._stat_row(self._e2e) if self._e2e.n else None
            # Rows read under the lock too: DecayedStat is not
            # thread-safe and fold() mutates these estimators
            rows = {label: self._stat_row(s)
                    for label, s in self._phases.items()}
        e2e_p99 = (e2e_row or {}).get("p99_ms") or 0.0
        dominant = sorted(rows.items(), key=lambda kv: -kv[1]["p99_ms"])
        return {
            "count": count,
            "failed": failed,
            "e2e": e2e_row,
            "phases": rows,
            "dominant_p99": [
                {"phase": label,
                 "p99_ms": row["p99_ms"],
                 "share_of_e2e_p99": (round(row["p99_ms"] / e2e_p99, 4)
                                      if e2e_p99 > 0 else None)}
                for label, row in dominant],
        }

    def reset(self) -> None:
        with self._lock:
            self._phases.clear()
            self._e2e = DecayedStat(self.half_life)
            self._count = 0
            self._failed = 0


# ---------------------------------------------------------------------------
# SLO tracker: declared targets, multi-window burn rates
# ---------------------------------------------------------------------------

def parse_slo_spec(spec: str) -> list[dict]:
    """``FAABRIC_SLO`` grammar: comma-separated ``name=value`` targets.

    - ``pNN_e2e_ms=X``  — the NNth percentile of admit→record e2e must
      stay under X ms; the error budget is the (100−NN)% tail.
    - ``error_rate=F``  — at most fraction F of results may be FAILED.

    Unknown names are skipped with their raw text kept in ``ignored``
    (a typo must not silently disable the whole spec)."""
    targets: list[dict] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, raw = part.partition("=")
        name = name.strip()
        try:
            value = float(raw)
        except ValueError:
            targets.append({"name": name, "ignored": part})
            continue
        if name.startswith("p") and name.endswith("_e2e_ms"):
            head = name[1:name.index("_")]
            if head.isdigit() and 0 < int(head) < 100:
                targets.append({
                    "name": name, "kind": "latency",
                    "threshold_s": value / 1e3,
                    "budget": (100 - int(head)) / 100.0})
                continue
            targets.append({"name": name, "ignored": part})
        elif name == "error_rate":
            targets.append({"name": name, "kind": "error",
                            "budget": max(1e-9, value)})
        else:
            targets.append({"name": name, "ignored": part})
    return targets


class _NullSloTracker:
    __slots__ = ()
    enabled = False

    def observe(self, e2e_s, failed: bool) -> None:
        pass

    def status(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_SLO_TRACKER = _NullSloTracker()


class SloTracker:
    """Time-bucketed good/bad counters per declared target, evaluated
    as burn rates over multiple windows (the SRE multi-window pattern):
    ``burn = bad_fraction / budget`` — 1.0 means exactly consuming the
    error budget; ``FAABRIC_SLO_BURN`` (default 2.0) on EVERY window
    (with ≥ ``FAABRIC_SLO_MIN_COUNT`` events in each) trips "burning".
    The rising edge flight-records and dumps — an SLO violation is a
    post-mortem moment."""

    GUARDS = {
        "_buckets": "_lock",
        "_burning": "_lock",
        "_since_eval": "_lock",
    }

    enabled = True

    def __init__(self, spec: str | None = None,
                 windows: list[float] | None = None,
                 bucket_s: float | None = None,
                 burn_threshold: float | None = None,
                 min_count: int | None = None) -> None:
        self.spec = spec if spec is not None else os.environ.get(
            "FAABRIC_SLO", "")
        parsed = parse_slo_spec(self.spec)
        self.targets = [t for t in parsed if "kind" in t]
        self.ignored = [t["ignored"] for t in parsed if "ignored" in t]
        if windows is None:
            raw = os.environ.get("FAABRIC_SLO_WINDOWS", "60,600")
            windows = []
            for tok in raw.split(","):
                try:
                    windows.append(float(tok))
                except ValueError:
                    continue
        self.windows = sorted(set(windows)) or [60.0, 600.0]
        self.bucket_s = (bucket_s if bucket_s is not None else
                         _env_float("FAABRIC_SLO_BUCKET_S", 5.0))
        self.burn_threshold = (burn_threshold if burn_threshold is not None
                               else _env_float("FAABRIC_SLO_BURN", 2.0))
        self.min_count = (min_count if min_count is not None else
                          _env_int("FAABRIC_SLO_MIN_COUNT", 20))
        # Ring: enough buckets to cover the longest window
        self._n_buckets = max(8, int(max(self.windows) / self.bucket_s) + 2)
        self._lock = threading.Lock()
        # Latency targets each get their OWN bad counter slot: two
        # declared percentiles (p50 + p99) must not share one — a p50
        # miss is not a p99 miss, and a shared counter would false-burn
        # the stricter-budget target off the looser threshold
        self._latency_targets = [t for t in self.targets
                                 if t["kind"] == "latency"]
        # bucket idx → [epoch_bucket, total, err_bad, [lat_bad/target]]
        self._buckets: list = [None] * self._n_buckets
        self._burning: dict[str, bool] = {}
        self._since_eval = 0
        self._gauges: dict[tuple, object] = {}
        self._burns_total = get_metrics().counter(
            "faabric_slo_burns_total",
            "SLO targets newly entering the burning state")

    # ------------------------------------------------------------------
    def observe(self, e2e_s: float | None, failed: bool) -> None:
        if not self.targets:
            return
        epoch = int(time.monotonic() / self.bucket_s)
        run_eval = False
        with self._lock:
            i = epoch % self._n_buckets
            b = self._buckets[i]
            if b is None or b[0] != epoch:
                b = self._buckets[i] = [
                    epoch, 0, 0, [0] * len(self._latency_targets)]
            b[1] += 1
            if failed:
                b[2] += 1
            if e2e_s is not None:
                for j, t in enumerate(self._latency_targets):
                    if e2e_s > t["threshold_s"]:
                        b[3][j] += 1
            self._since_eval += 1
            if self._since_eval >= 64:
                self._since_eval = 0
                run_eval = True
        if run_eval:
            self.status()

    def _window_counts_locked(self, window_s: float, now_epoch: int
                              ) -> tuple[int, int, list[int]]:
        # At least the current bucket: a window narrower than the
        # bucket width must still see events, not silently read empty
        lo = now_epoch - max(1, round(window_s / self.bucket_s))
        total = err_bad = 0
        lat_bad = [0] * len(self._latency_targets)
        for b in self._buckets:
            if b is not None and lo < b[0] <= now_epoch:
                total += b[1]
                err_bad += b[2]
                for j, n in enumerate(b[3]):
                    lat_bad[j] += n
        return total, err_bad, lat_bad

    def status(self) -> dict:
        """Current burn rates per target/window; evaluates the burning
        edge (flight record + counter on a rising edge)."""
        if not self.targets:
            return {"spec": self.spec, "targets": []}
        now_epoch = int(time.monotonic() / self.bucket_s)
        newly_burning: list[tuple[str, dict]] = []
        out_targets = []
        with self._lock:
            per_window = {w: self._window_counts_locked(w, now_epoch)
                          for w in self.windows}
            for t in self.targets:
                lat_idx = (self._latency_targets.index(t)
                           if t["kind"] == "latency" else -1)
                rows = {}
                burning = True
                for w, (total, err_bad, lat_bad) in per_window.items():
                    bad = (lat_bad[lat_idx] if t["kind"] == "latency"
                           else err_bad)
                    frac = bad / total if total else 0.0
                    burn = frac / t["budget"]
                    rows[f"{int(w)}s"] = {
                        "total": total, "bad": bad,
                        "burn": round(burn, 3)}
                    if total < self.min_count or burn < self.burn_threshold:
                        burning = False
                was = self._burning.get(t["name"], False)
                self._burning[t["name"]] = burning
                if burning and not was:
                    newly_burning.append((t["name"], dict(rows)))
                out_targets.append({
                    "name": t["name"], "kind": t["kind"],
                    "budget": t["budget"],
                    "threshold_ms": (round(t["threshold_s"] * 1e3, 3)
                                     if "threshold_s" in t else None),
                    "windows": rows, "burning": burning})
        for row in out_targets:
            for wname, wrow in row["windows"].items():
                key = (row["name"], wname)
                g = self._gauges.get(key)
                if g is None:
                    g = self._gauges[key] = get_metrics().gauge(
                        "faabric_slo_burn_rate",
                        "Current SLO burn rate (bad fraction / budget)",
                        slo=row["name"], window=wname)
                g.set(wrow["burn"])
        if newly_burning:
            from faabric_tpu_torch.telemetry.flight import (
                flight_dump,
                flight_record,
            )

            for name, rows in newly_burning:
                self._burns_total.inc()
                flight_record("slo_burn", slo=name, windows=rows)
            flight_dump("slo_burn")
        return {"spec": self.spec, "burnThreshold": self.burn_threshold,
                "windowsSeconds": [int(w) for w in self.windows],
                "ignored": self.ignored, "targets": out_targets}

    def reset(self) -> None:
        with self._lock:
            self._buckets = [None] * self._n_buckets
            self._burning.clear()


# ---------------------------------------------------------------------------
# Singletons
# ---------------------------------------------------------------------------

_stats: LifecycleStats | None = None
_slo: SloTracker | None = None


def get_lifecycle_stats() -> LifecycleStats | _NullLifecycleStats:
    if not lifecycle_enabled():
        return NULL_LIFECYCLE_STATS
    global _stats
    if _stats is None:
        with _singleton_lock:
            if _stats is None:
                _stats = LifecycleStats()
    return _stats


def get_slo_tracker() -> SloTracker | _NullSloTracker:
    if not lifecycle_enabled():
        return NULL_SLO_TRACKER
    global _slo
    if _slo is None:
        with _singleton_lock:
            if _slo is None:
                _slo = SloTracker()
    return _slo


def reset_lifecycle() -> None:
    """Test hook: drop every singleton so the next use re-reads env."""
    global _lifecycle, _stats, _slo
    with _singleton_lock:
        _lifecycle = None
        _stats = None
        _slo = None
