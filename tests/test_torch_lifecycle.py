"""The port's invocation lifecycle plane against the JAX package's.

Counterpart of ``tests/unit/test_lifecycle.py``: ledger stamps and
durations, the fold digest, the SLO burn tracker, the time-series ring,
the process resource collector, the planner server's sampled gauges,
the doctor's lifecycle analyzers, the flight-dump merge of live rings
and the timeline renderer on the port's CLIs, and an end-to-end ledger
across a port planner and ``WorkerRuntime`` over real sockets, the
ingress's queue-exit stamp among its phases, and the journal's stamp
between schedule and dispatch when the journal is on. Cross-package:
the same stamp ledgers give the reference's durations, folds and SLO
verdicts.
"""

import math
import time

import pytest

from faabric_tpu_torch.proto import (
    ReturnValue,
    batch_exec_factory,
    message_factory,
    messages_from_wire,
    messages_to_wire,
)
from faabric_tpu_torch.telemetry.lifecycle import (
    NULL_LIFECYCLE,
    PHASE_ADMIT,
    PHASE_DISPATCH,
    PHASE_EXEC_QUEUE_EXIT,
    PHASE_JOURNAL,
    PHASE_QUEUE_EXIT,
    PHASE_RECORDED,
    PHASE_REQUEUE,
    PHASE_RESULT_PUSH,
    PHASE_RUN_END,
    PHASE_RUN_START,
    PHASE_SCHED,
    PHASE_STATE_ACC,
    PHASE_WAITER_WAKE,
    Lifecycle,
    LifecycleStats,
    SloTracker,
    get_lifecycle,
    ledger_durations,
    ledger_e2e_s,
    ledger_span_s,
    parse_slo_spec,
)
from faabric_tpu_torch.telemetry.timeseries import TimeSeriesRing


@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    from tests.test_torch_telemetry import clean_port_telemetry, port_singletons

    saved = port_singletons()
    yield
    clean_port_telemetry(saved)

# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------

class TestLedger:
    def test_stamps_ride_the_wire(self):
        lc = Lifecycle()
        m = message_factory("u", "f")
        lc.stamp(m, PHASE_ADMIT)
        lc.stamp(m, PHASE_SCHED)
        dicts, tail = messages_to_wire([m])
        back = messages_from_wire(dicts, tail)[0]
        assert back.lc == m.lc
        assert back.lc[PHASE_SCHED] >= back.lc[PHASE_ADMIT]
        # REST/journal form carries it too
        assert m.to_dict()["lc"] == m.lc

    def test_durations_attribute_consecutive_gaps(self):
        base = 1_000_000_000
        lc = {PHASE_ADMIT: base,
              PHASE_QUEUE_EXIT: base + 2_000_000,     # 2 ms queue
              PHASE_SCHED: base + 3_000_000,          # 1 ms schedule
              PHASE_DISPATCH: base + 3_500_000,
              PHASE_RUN_END: base + 10_000_000}
        d = ledger_durations(lc)
        assert d["ingress_queue"] == pytest.approx(0.002)
        assert d["schedule"] == pytest.approx(0.001)
        assert d["dispatch"] == pytest.approx(0.0005)
        assert d["run"] == pytest.approx(0.0065)
        # durations sum EXACTLY to the span by construction
        assert sum(d.values()) == pytest.approx(ledger_span_s(lc))

    def test_requeue_reorders_by_time_not_taxonomy(self):
        """A requeued message's SECOND dispatch stamp lands after the
        requeue stamp; time-sorting attributes the detection+backoff
        gap to 'requeue' and keeps every duration non-negative."""
        base = 1_000_000_000
        lc = {PHASE_ADMIT: base,
              PHASE_SCHED: base + 1_000_000,
              PHASE_REQUEUE: base + 500_000_000,       # recovery fired
              PHASE_DISPATCH: base + 510_000_000,      # re-dispatch
              PHASE_RUN_END: base + 520_000_000}
        d = ledger_durations(lc)
        assert d["requeue"] == pytest.approx(0.499)
        assert d["dispatch"] == pytest.approx(0.010)
        assert all(v >= 0 for v in d.values())

    def test_e2e_needs_both_endpoint_stamps(self):
        base = 1_000_000_000
        assert ledger_e2e_s({PHASE_ADMIT: base}) is None
        assert ledger_e2e_s({PHASE_RECORDED: base}) is None
        assert ledger_e2e_s({PHASE_ADMIT: base,
                             PHASE_RECORDED: base + 5_000_000}) == \
            pytest.approx(0.005)

    def test_negative_cross_clock_gap_clamps_to_zero(self):
        lc = {PHASE_ADMIT: 2_000_000_000, PHASE_RECORDED: 1_000_000_000}
        assert ledger_e2e_s(lc) == 0.0
        assert all(v >= 0 for v in ledger_durations(lc).values())

    def test_disabled_plane_is_identity_noop(self, monkeypatch):
        from faabric_tpu_torch.telemetry import metrics, reset_lifecycle

        monkeypatch.setattr(metrics, "_enabled", False)
        reset_lifecycle()
        try:
            assert get_lifecycle() is NULL_LIFECYCLE
            m = message_factory("u", "f")
            get_lifecycle().stamp(m, PHASE_ADMIT)
            get_lifecycle().stamp_many([m], PHASE_SCHED)
            assert m.lc == {}
            from faabric_tpu_torch.telemetry import (
                get_lifecycle_stats,
                get_slo_tracker,
            )
            from faabric_tpu_torch.telemetry.lifecycle import (
                NULL_LIFECYCLE_STATS,
                NULL_SLO_TRACKER,
            )

            assert get_lifecycle_stats() is NULL_LIFECYCLE_STATS
            assert get_slo_tracker() is NULL_SLO_TRACKER
        finally:
            monkeypatch.setattr(metrics, "_enabled", True)
            reset_lifecycle()

    def test_lifecycle_knob_disables_independently(self, monkeypatch):
        from faabric_tpu_torch.telemetry import reset_lifecycle

        monkeypatch.setenv("FAABRIC_LIFECYCLE", "0")
        reset_lifecycle()
        try:
            assert get_lifecycle() is NULL_LIFECYCLE
        finally:
            monkeypatch.delenv("FAABRIC_LIFECYCLE")
            reset_lifecycle()


# ---------------------------------------------------------------------------
# Fold digest
# ---------------------------------------------------------------------------

def _folded_message(run_ms: float, i: int = 0, failed: bool = False):
    m = message_factory("u", "f")
    base = 1_000_000_000 + i * 1_000_000_000
    m.lc = {
        PHASE_ADMIT: base,
        PHASE_QUEUE_EXIT: base + 200_000,
        PHASE_SCHED: base + 400_000,
        PHASE_DISPATCH: base + 600_000,
        PHASE_EXEC_QUEUE_EXIT: base + 900_000,
        PHASE_RUN_START: base + 1_000_000,
        PHASE_RUN_END: base + 1_000_000 + int(run_ms * 1e6),
        PHASE_RESULT_PUSH: base + 1_200_000 + int(run_ms * 1e6),
        PHASE_RECORDED: base + 1_500_000 + int(run_ms * 1e6),
    }
    if failed:
        m.return_value = int(ReturnValue.FAILED)
    return m


class TestLifecycleStats:
    def test_fold_and_dominant_ranking(self):
        stats = LifecycleStats()
        stats.fold([_folded_message(30.0, i) for i in range(40)])
        snap = stats.snapshot()
        assert snap["count"] == 40
        assert snap["e2e"]["count"] == 40
        # run (30 ms) dwarfs every sub-ms phase
        assert snap["dominant_p99"][0]["phase"] == "run"
        assert snap["phases"]["run"]["p99_ms"] > 20
        assert 0.5 < snap["dominant_p99"][0]["share_of_e2e_p99"] <= 1.5

    def test_fold_counts_failures(self):
        stats = LifecycleStats()
        stats.fold([_folded_message(1.0, 0, failed=True),
                    _folded_message(1.0, 1)])
        snap = stats.snapshot()
        assert snap["failed"] == 1

    def test_ledgerless_message_does_not_fold(self):
        stats = LifecycleStats()
        stats.fold([message_factory("u", "f")])
        assert stats.snapshot()["count"] == 0

    def test_cross_clock_incoherent_ledger_folds_e2e_only(self):
        """A worker on another machine with a different monotonic base
        would blow the time-sorted span far past the (same-clock,
        always-valid) admit→record e2e — such ledgers must not crown a
        phantom dominant phase; they contribute e2e only."""
        m = message_factory("u", "f")
        base = 10_000_000_000_000  # planner clock
        m.lc = {
            PHASE_ADMIT: base,
            PHASE_SCHED: base + 1_000_000,
            # worker clock booted recently: tiny monotonic values
            PHASE_EXEC_QUEUE_EXIT: 5_000_000,
            PHASE_RUN_START: 6_000_000,
            PHASE_RUN_END: 206_000_000,
            PHASE_RESULT_PUSH: 207_000_000,
            PHASE_RECORDED: base + 300_000_000,  # e2e = 0.3 s, sane
        }
        stats = LifecycleStats()
        stats.fold([m])
        snap = stats.snapshot()
        assert snap["count"] == 1
        assert snap["e2e"]["count"] == 1
        assert snap["phases"] == {}, snap["phases"]  # no phantom fold
        assert snap["dominant_p99"] == []


# ---------------------------------------------------------------------------
# SLO tracker
# ---------------------------------------------------------------------------

class TestSlo:
    def test_spec_parse(self):
        targets = parse_slo_spec("p99_e2e_ms=50,error_rate=0.001")
        latency = [t for t in targets if t["name"] == "p99_e2e_ms"][0]
        assert latency["kind"] == "latency"
        assert latency["threshold_s"] == pytest.approx(0.05)
        assert latency["budget"] == pytest.approx(0.01)
        error = [t for t in targets if t["name"] == "error_rate"][0]
        assert error["kind"] == "error"
        assert error["budget"] == pytest.approx(0.001)
        # p50 grammar and junk
        p90 = parse_slo_spec("p90_e2e_ms=10")[0]
        assert p90["budget"] == pytest.approx(0.10)
        bad = parse_slo_spec("wat=7,p99_e2e_ms=oops")
        assert all("kind" not in t for t in bad)

    def _tracker(self, spec="p99_e2e_ms=10,error_rate=0.01"):
        return SloTracker(spec=spec, windows=[2.0, 4.0], bucket_s=1.0,
                          burn_threshold=2.0, min_count=10)

    def test_latency_burn_trips_on_all_windows(self):
        slo = self._tracker()
        for _ in range(50):
            slo.observe(0.050, False)  # 5× the 10 ms target, all bad
        st = slo.status()
        lat = [t for t in st["targets"] if t["name"] == "p99_e2e_ms"][0]
        assert lat["burning"]
        # bad fraction 1.0 / budget 0.01 = burn 100
        for row in lat["windows"].values():
            assert row["burn"] == pytest.approx(100.0)
        err = [t for t in st["targets"] if t["name"] == "error_rate"][0]
        assert not err["burning"]

    def test_error_burn(self):
        slo = self._tracker()
        for i in range(100):
            slo.observe(0.001, failed=(i % 10 == 0))  # 10% FAILED
        st = slo.status()
        err = [t for t in st["targets"] if t["name"] == "error_rate"][0]
        assert err["burning"]  # 0.1 / 0.01 = burn 10 ≥ 2

    def test_min_count_gates_burning(self):
        slo = self._tracker()
        for _ in range(5):  # below min_count=10
            slo.observe(0.050, False)
        st = slo.status()
        assert not any(t["burning"] for t in st["targets"])

    def test_healthy_traffic_never_burns(self):
        slo = self._tracker()
        for _ in range(200):
            slo.observe(0.001, False)
        assert not any(t["burning"] for t in slo.status()["targets"])

    def test_burn_edge_flight_recorded(self):
        from faabric_tpu_torch.telemetry import get_flight

        before = len([e for e in get_flight().events()
                      if e["kind"] == "slo_burn"])
        slo = self._tracker()
        for _ in range(50):
            slo.observe(0.050, False)
        slo.status()
        slo.status()  # steady state: no second edge record
        events = [e for e in get_flight().events()
                  if e["kind"] == "slo_burn"]
        assert len(events) == before + 1
        assert events[-1]["slo"] == "p99_e2e_ms"

    def test_empty_spec_is_inert(self):
        slo = SloTracker(spec="")
        slo.observe(10.0, True)
        assert slo.status()["targets"] == []

    def test_multiple_latency_targets_count_independently(self):
        """A p50 miss is not a p99 miss: each latency target owns its
        bad counter, so 20 ms traffic burns a 10 ms p50 target without
        false-burning a 1000 ms p99 target off the shared stream."""
        slo = SloTracker(spec="p50_e2e_ms=10,p99_e2e_ms=1000",
                         windows=[2.0, 4.0], bucket_s=1.0,
                         burn_threshold=2.0, min_count=10)
        for _ in range(100):
            slo.observe(0.020, False)
        st = slo.status()
        p50 = [t for t in st["targets"] if t["name"] == "p50_e2e_ms"][0]
        p99 = [t for t in st["targets"] if t["name"] == "p99_e2e_ms"][0]
        assert p50["burning"], p50
        assert not p99["burning"], p99
        for row in p99["windows"].values():
            assert row["bad"] == 0, p99


# ---------------------------------------------------------------------------
# Time-series ring + procstats
# ---------------------------------------------------------------------------

class TestTimeSeries:
    def test_sample_and_snapshot(self):
        ring = TimeSeriesRing(capacity=16)
        ring.register("depth", lambda: 7.0)
        for _ in range(3):
            ring.sample()
        snap = ring.snapshot()
        assert len(snap["series"]["depth"]) == 3
        assert all(v == 7.0 for _t, v in snap["series"]["depth"])
        assert snap["samples_taken"] == 3

    def test_ring_wraparound_keeps_newest(self):
        ring = TimeSeriesRing(capacity=8)
        vals = iter(range(100))
        ring.register("x", lambda: float(next(vals)))
        for _ in range(20):
            ring.sample()
        pts = ring.snapshot()["series"]["x"]
        assert len(pts) == 8
        assert [v for _t, v in pts] == [float(v) for v in range(12, 20)]

    def test_raising_gauge_records_nan_and_survives(self):
        ring = TimeSeriesRing(capacity=8)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("gauge died")
            return 1.0

        ring.register("flaky", flaky)
        for _ in range(3):
            ring.sample()
        pts = ring.snapshot()["series"]["flaky"]
        assert len(pts) == 2  # the NaN sample is dropped per point

    def test_register_replaces(self):
        ring = TimeSeriesRing(capacity=8)
        ring.register("x", lambda: 1.0)
        ring.register("x", lambda: 2.0)
        ring.sample()
        assert ring.snapshot()["series"]["x"][-1][1] == 2.0

    def test_fn_matched_unregister_spares_the_replacement(self):
        """A stopping owner unregisters with ITS callable: when a
        co-resident runtime re-registered the name, the live series
        survives; only a matching (or fn-less) unregister removes."""
        ring = TimeSeriesRing(capacity=8)
        mine, theirs = (lambda: 1.0), (lambda: 2.0)
        ring.register("x", mine)
        ring.register("x", theirs)  # replacement wins the name
        ring.unregister("x", mine)  # stale owner: must not kill it
        ring.sample()
        assert ring.snapshot()["series"]["x"][-1][1] == 2.0
        ring.unregister("x", theirs)
        assert "x" not in ring.snapshot()["series"]

    def test_late_registration_has_no_ghost_points(self):
        ring = TimeSeriesRing(capacity=8)
        ring.register("a", lambda: 1.0)
        ring.sample()
        ring.register("b", lambda: 2.0)
        ring.sample()
        snap = ring.snapshot()
        assert len(snap["series"]["a"]) == 2
        assert len(snap["series"]["b"]) == 1

    def test_planner_server_unregisters_its_gauges_on_stop(self):
        """stop() must drop the gauge closures start() registered: a
        leftover lambda would pin the stopped planner alive and keep a
        surviving in-process sampler polling its locks."""
        from faabric_tpu_torch.planner import PlannerServer, get_planner
        from faabric_tpu_torch.telemetry import get_timeseries
        from faabric_tpu_torch.transport.common import register_host_alias
        from tests.conftest import next_port_base

        from faabric_tpu_torch.telemetry import timeseries as ts_mod

        base = next_port_base()
        register_host_alias("tsplanner", "127.0.0.1", base)
        get_planner().reset()
        ring = get_timeseries()
        # A co-resident runtime's sampler share, held across the
        # server's lifecycle: an unmatched server stop must not steal it
        ts_mod.start_sampler()
        server = PlannerServer(port_offset=base)
        try:
            server.start()
            try:
                ring.sample()
                # (the port has no ingress: no ingress_depth series)
                assert "free_slots" in ring.snapshot()["series"]
            finally:
                server.stop()
            assert "free_slots" not in ring.snapshot()["series"]
            assert "results_total" not in ring.snapshot()["series"]
            # Double stop: releases no second share — the co-resident
            # share keeps the shared sampler thread alive
            server.stop()
            assert ts_mod._sampler is not None
            assert ts_mod._sampler._thread is not None
            assert ts_mod._sampler._thread.is_alive()
        finally:
            ts_mod.stop_sampler()
            get_planner().reset()


class TestProcStats:
    def test_refresh_reports_and_publishes(self):
        from faabric_tpu_torch.telemetry import get_metrics
        from faabric_tpu_torch.telemetry.procstats import ProcStats

        stats = ProcStats()
        values = stats.refresh()
        assert values["rss_bytes"] > 1 << 20
        assert values["threads"] >= 1
        assert values["open_fds"] >= 3
        assert "gc_collections" in values
        # second refresh (after the throttle) yields a CPU figure
        stats._last_refresh = 0.0
        time.sleep(0.01)
        values = stats.refresh()
        assert "cpu_percent" in values
        # the gauges landed in the registry snapshot
        snap = get_metrics().snapshot()
        assert "faabric_process_rss_bytes" in snap
        assert snap["faabric_process_rss_bytes"]["series"][0][
            "value"] > 1 << 20

    def test_throttle_returns_cached(self):
        from faabric_tpu_torch.telemetry.procstats import ProcStats

        stats = ProcStats()
        first = stats.refresh()
        assert stats.refresh() is first


# ---------------------------------------------------------------------------
# Doctor analyzers
# ---------------------------------------------------------------------------

class TestDoctorAnalyzers:
    def test_dominant_phase_finding(self):
        from faabric_tpu_torch.runner.doctor import check_lifecycle

        stats = LifecycleStats()
        stats.fold([_folded_message(25.0, i) for i in range(30)])
        findings = check_lifecycle({"lifecycle": stats.snapshot()})
        assert findings and findings[0]["kind"] == "dominant_phase"
        assert "'run'" in findings[0]["subject"]

    def test_dominant_phase_needs_evidence(self):
        from faabric_tpu_torch.runner.doctor import check_lifecycle

        stats = LifecycleStats()
        stats.fold([_folded_message(25.0)])
        assert check_lifecycle({"lifecycle": stats.snapshot()}) == []
        assert check_lifecycle(None) == []

    def test_slo_finding_only_when_burning(self):
        from faabric_tpu_torch.runner.doctor import check_slo

        slo = SloTracker(spec="p99_e2e_ms=10", windows=[2.0],
                         bucket_s=1.0, burn_threshold=2.0, min_count=5)
        for _ in range(20):
            slo.observe(0.001, False)
        assert check_slo({"slo": slo.status()}) == []
        for _ in range(20):
            slo.observe(0.500, False)
        findings = check_slo({"slo": slo.status()})
        assert findings and findings[0]["kind"] == "slo_burn"
        assert "p99_e2e_ms" in findings[0]["subject"]

    def test_queue_growth_and_exhaustion(self):
        from faabric_tpu_torch.runner.doctor import check_queue_trend

        grow = {"hosts": {"planner": {"series": {
            "ingress_depth": [[100.0 + i, 2.0 * i] for i in range(20)],
            "free_slots": [[100.0 + i, 0.0] for i in range(20)],
        }}}}
        kinds = {f["kind"] for f in check_queue_trend(grow)}
        assert kinds == {"queue_growth", "capacity_exhausted"}

        flat = {"hosts": {"planner": {"series": {
            "ingress_depth": [[100.0 + i, 3.0] for i in range(20)],
            "free_slots": [[100.0 + i, 6.0] for i in range(20)],
        }}}}
        assert check_queue_trend(flat) == []
        assert check_queue_trend(None) == []


# ---------------------------------------------------------------------------
# flightdump live rings + timeline renderer
# ---------------------------------------------------------------------------

class TestTools:
    def test_flightdump_merges_live_ring_pseudo_dumps(self):
        from faabric_tpu_torch.runner.flightdump import merge_dumps

        live = {"process": "worker-w0", "pid": 42, "reason": "live",
                "dumped_at": 2000.0,
                "events": [{"ts": 10.0, "seq": 1, "kind": "x"}]}
        disk = {"process": "planner", "pid": 7, "reason": "sigterm",
                "dumped_at": 1000.0,
                "events": [{"ts": 9.0, "seq": 3, "kind": "y"}]}
        events = merge_dumps([live, disk])
        assert [e["kind"] for e in events] == ["y", "x"]
        assert events[1]["process"] == "worker-w0"
        assert events[1]["dump_reason"] == "live"

    def _status(self):
        msgs = []
        for i in range(2):
            d = _folded_message(5.0, i).to_dict()
            d["executed_host"] = "hA"
            msgs.append(d)
        return {"appId": 123, "finished": True, "messageResults": msgs}

    def test_timeline_rows_and_text(self):
        from faabric_tpu_torch.runner.timeline import (
            _BAR_MARKS,
            _msg_rows,
            render_text,
        )

        rows = _msg_rows(self._status())
        assert len(rows) == 2
        assert rows[0]["durations"]["run"] == pytest.approx(0.005)
        text = render_text(123, rows)
        assert "app 123: 2 message(s)" in text
        assert "run=" in text
        # Distinct bar marks: the five r-labels must not collapse
        assert "u=result_push" in text and "c=record" in text
        assert len(set(_BAR_MARKS.values())) == len(_BAR_MARKS)

    def test_timeline_chrome_trace(self):
        from faabric_tpu_torch.runner.timeline import (
            _msg_rows,
            chrome_trace_events,
        )

        events = chrome_trace_events(123, _msg_rows(self._status()))
        phases = [e["name"] for e in events if e["ph"] == "X"]
        assert "run" in phases and "ingress_queue" in phases
        assert all(e["dur"] > 0 for e in events if e["ph"] == "X")

    def test_timeline_empty(self):
        from faabric_tpu_torch.runner.timeline import _msg_rows, render_text

        assert "no messages" in render_text(9, _msg_rows(
            {"messageResults": [{"id": 1, "lc": {}}]}))


# ---------------------------------------------------------------------------
# End-to-end: real planner + worker in one process, every RPC over
# real sockets — the result's ledger spans admit → waiter wake
# ---------------------------------------------------------------------------

@pytest.fixture
def lifecycle_cluster():
    from faabric_tpu_torch.executor import set_executor_factory
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.runner import WorkerRuntime
    from faabric_tpu_torch.transport.common import register_host_alias
    from tests.conftest import next_port_base
    from tests.test_torch_execution import EchoFactory

    base = next_port_base()
    register_host_alias("planner", "127.0.0.1", base)
    register_host_alias("lcA", "127.0.0.1", base + 1000)

    get_planner().reset()
    planner_server = PlannerServer(port_offset=base)
    planner_server.start()
    set_executor_factory(EchoFactory())
    w = WorkerRuntime(host="lcA", slots=4, planner_host="planner")
    w.start()

    yield w

    w.shutdown()
    planner_server.stop()
    get_planner().reset()
    set_executor_factory(None)


def test_e2e_ledger_spans_the_invocation(lifecycle_cluster):
    w = lifecycle_cluster
    req = batch_exec_factory("demo", "echo", 2)
    for m in req.messages:
        m.input_data = b"abc"
    t0 = time.monotonic()
    decision = w.planner_client.call_functions(req)
    assert decision.n_messages == 2
    results = [w.planner_client.get_message_result(req.app_id, m.id,
                                                   timeout=15.0)
               for m in req.messages]
    wall = time.monotonic() - t0
    for r in results:
        assert r.return_value == int(ReturnValue.SUCCESS)
        lc = r.lc
        # Every planner + executor stamp made the round trip (the
        # worker-side result_push stamp rides the wire to the planner;
        # waiter_wake is stamped as the push lands back here)
        for phase in (PHASE_ADMIT, PHASE_QUEUE_EXIT, PHASE_SCHED,
                      PHASE_DISPATCH, PHASE_EXEC_QUEUE_EXIT,
                      PHASE_RUN_START, PHASE_RUN_END, PHASE_RESULT_PUSH,
                      PHASE_RECORDED):
            assert phase in lc, (phase, sorted(lc))
        assert PHASE_WAITER_WAKE in lc or lc[PHASE_RECORDED] > 0
        # The ledger is ordered and spans most of the measured wall
        assert lc[PHASE_ADMIT] <= lc[PHASE_SCHED] <= lc[PHASE_DISPATCH]
        assert lc[PHASE_DISPATCH] <= lc[PHASE_EXEC_QUEUE_EXIT]
        assert lc[PHASE_RUN_START] <= lc[PHASE_RUN_END]
        assert lc[PHASE_RUN_END] <= lc[PHASE_RESULT_PUSH]
        span = ledger_span_s(lc)
        assert 0 < span <= wall * 1.05
        durations = ledger_durations(lc)
        assert math.isclose(sum(durations.values()), span,
                            rel_tol=1e-6)
    # The planner folded the ledgers into the lifecycle digest
    from faabric_tpu_torch.telemetry import get_lifecycle_stats

    lifecycle = get_lifecycle_stats().snapshot()
    assert lifecycle["count"] >= 2
    assert lifecycle["e2e"]["count"] >= 2
    assert lifecycle["dominant_p99"], lifecycle
    # ...which healthz carries, beside the ingress that admitted them
    from faabric_tpu_torch.planner import get_planner

    health = get_planner().health_summary()
    assert health["lifecycle"]["count"] >= 2
    assert health["ingress"]["admittedTotal"] >= 2


def test_e2e_journal_stamp_lands_when_journal_enabled(
        lifecycle_cluster, tmp_path):
    """With the write-ahead journal on, the ledger carries the journal
    phase between schedule and dispatch."""
    from faabric_tpu_torch.planner import get_planner
    from faabric_tpu_torch.planner.journal import open_planner_journal

    planner = get_planner()
    old_journal = planner._journal
    planner._journal = open_planner_journal(str(tmp_path))
    try:
        w = lifecycle_cluster
        req = batch_exec_factory("demo", "echo", 1)
        req.messages[0].input_data = b"x"
        w.planner_client.call_functions(req)
        r = w.planner_client.get_message_result(
            req.app_id, req.messages[0].id, timeout=15.0)
        assert PHASE_JOURNAL in r.lc
        assert r.lc[PHASE_SCHED] <= r.lc[PHASE_JOURNAL] <= \
            r.lc[PHASE_DISPATCH]
    finally:
        planner._journal.close()
        planner._journal = old_journal


# ---------------------------------------------------------------------------
# Cross-package: the same ledgers, the same durations, digests and burns
# ---------------------------------------------------------------------------

def _ledgers(seed: int, n: int = 40) -> list[dict]:
    """Seeded stamp ledgers over the phases both packages stamp, with a
    charged state duration on some."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = [PHASE_ADMIT, PHASE_SCHED, PHASE_DISPATCH,
             PHASE_EXEC_QUEUE_EXIT, PHASE_RUN_START, PHASE_RUN_END,
             PHASE_RESULT_PUSH, PHASE_RECORDED, PHASE_WAITER_WAKE]
    out = []
    for _ in range(n):
        t = int(1e12) + int(rng.integers(0, 10**9))
        lc = {}
        for phase in order:
            t += int(rng.exponential(2e6))
            lc[phase] = t
        if rng.random() < 0.5:
            run = lc[PHASE_RUN_END] - lc[PHASE_RUN_START]
            lc[PHASE_STATE_ACC] = int(run * rng.random())
        out.append(lc)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_analysis_and_fold_equal_reference(seed):
    from faabric_tpu import proto as ref_proto
    from faabric_tpu.telemetry import lifecycle as ref_lc

    from faabric_tpu_torch import proto as port_proto
    from faabric_tpu_torch.telemetry import lifecycle as port_lc

    ledgers = _ledgers(seed)
    for lc in ledgers:
        assert port_lc.ledger_durations(lc) == ref_lc.ledger_durations(lc)
        assert port_lc.ledger_span_s(lc) == ref_lc.ledger_span_s(lc)
        assert port_lc.ledger_e2e_s(lc) == ref_lc.ledger_e2e_s(lc)

    def fold(proto, lc_mod):
        stats = lc_mod.LifecycleStats(half_life=1e9)
        msgs = []
        for i, lc in enumerate(ledgers):
            m = proto.Message(id=i + 1, app_id=7)
            m.lc = dict(lc)
            m.return_value = int(proto.ReturnValue.FAILED
                                 if i % 9 == 0 else proto.ReturnValue.SUCCESS)
            msgs.append(m)
        stats.fold(msgs)
        return stats.snapshot()

    got, want = fold(port_proto, port_lc), fold(ref_proto, ref_lc)
    assert got["count"] == want["count"] and got["failed"] == want["failed"]
    assert got["dominant_p99"] == want["dominant_p99"]
    assert sorted(got["phases"]) == sorted(want["phases"])


def test_slo_spec_and_burns_equal_reference():
    from faabric_tpu.telemetry import lifecycle as ref_lc

    from faabric_tpu_torch.telemetry import lifecycle as port_lc

    for spec in ("p99_e2e_ms=50,error_rate=0.001", "p90_e2e_ms=10",
                 "wat=7,p99_e2e_ms=oops", ""):
        assert port_lc.parse_slo_spec(spec) == ref_lc.parse_slo_spec(spec)
    kw = dict(spec="p99_e2e_ms=10,error_rate=0.01", windows=[2.0, 4.0],
              bucket_s=1.0, burn_threshold=2.0, min_count=10)
    port, ref = port_lc.SloTracker(**kw), ref_lc.SloTracker(**kw)
    for i in range(120):
        e2e, failed = (0.05 if i % 3 == 0 else 0.001), i % 11 == 0
        port.observe(e2e, failed)
        ref.observe(e2e, failed)

    def burns(st):
        return {t["name"]: (t["burning"],
                            {w: r["burn"] for w, r in t["windows"].items()})
                for t in st["targets"]}

    assert burns(port.status()) == burns(ref.status())
