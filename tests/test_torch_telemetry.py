"""The port's telemetry layer against the JAX package's.

Counterpart of ``tests/unit/test_telemetry.py``: every case of it runs on
``faabric_tpu_torch.telemetry`` (metrics registry semantics, span tracer
nesting, disabled-mode fast paths, Prometheus text and Chrome
``trace_event`` JSON, trace contexts and flow ids, the flight ring and
the comm matrix). A flight dump written by the port is read back with
the port's ``runner/flightdump.py`` (``tests/test_torch_doctor.py`` holds
it against the reference's on the same dumps).
Then the cross-package checks on the same inputs: the Prometheus text
of the same registry operations is byte-equal, and a 3 + 3 world with
tracing on gives both packages the same multiset of spans and the same
comm-matrix cells. The knobs read at import (``FAABRIC_METRICS``,
``FAABRIC_TRACING``, ``FAABRIC_SELF_TRACING``, ``FAABRIC_TRACE_BUFFER``)
and ``install_signal_dump`` run in subprocesses.
"""

import json
import math
import threading

import pytest

from faabric_tpu_torch.telemetry import (
    DEFAULT_BUCKETS,
    NULL_METRIC,
    NULL_SPAN,
    MetricsRegistry,
    get_metrics,
    get_tracer,
    metrics_enabled,
    render_snapshots,
    reset_tracing,
    set_metrics_enabled,
    set_tracing,
    snapshot_delta,
    span,
    trace_events,
    tracing_enabled,
)
from faabric_tpu_torch.telemetry.metrics import _label_str


# The port's singletons that modules capture at import (``_PERF``,
# ``_PROFILER``, ``_COMM``, ``_FLIGHT``, ``_LC``, ``_metrics``): a test
# that drops one (the reference's ``reset_*`` hooks do) must not leave
# the call sites writing to an object the getters no longer return
_SINGLETONS = (("perfprofile", "_store"), ("perfprofile", "_profiler"),
               ("commmatrix", "_matrix"), ("flight", "_flight"),
               ("lifecycle", "_lifecycle"), ("lifecycle", "_stats"),
               ("lifecycle", "_slo"), ("statestats", "_store"),
               ("metrics", "_registry"))


def port_singletons() -> dict:
    """The singletons as they stand, made first if none exists yet."""
    import importlib

    from faabric_tpu_torch import telemetry

    # The call-site modules capture their handles from these
    for name in ("transport.bulk", "transport.client", "mpi.world",
                 "device_plane.plane", "executor.executor",
                 "planner.planner"):
        importlib.import_module(f"faabric_tpu_torch.{name}")
    for get in (telemetry.get_perf_store, telemetry.get_collective_profiler,
                telemetry.get_comm_matrix, telemetry.get_flight,
                telemetry.get_lifecycle, telemetry.get_lifecycle_stats,
                telemetry.get_slo_tracker, telemetry.get_state_stats,
                telemetry.get_metrics):
        get()
    mods = {m: importlib.import_module(f"faabric_tpu_torch.telemetry.{m}")
            for m, _ in _SINGLETONS}
    return {(m, n): getattr(mods[m], n) for m, n in _SINGLETONS}


def clean_port_telemetry(saved: dict) -> None:
    """Disarm the port's faults, stop tracing, reset the port's globals
    (mock mode, aliases, planner, functions, config), put back the
    singletons ``saved`` holds and empty the stores in place, so that no
    later test of an xdist worker inherits them (a measured link flips
    the governor and the schedule families)."""
    import importlib

    from faabric_tpu_torch.faults import clear_faults
    from faabric_tpu_torch.transport.codec import reset_wire_governor

    from faabric_tpu_torch.batch_scheduler import reset_batch_scheduler
    from faabric_tpu_torch.executor import (
        clear_registered_functions,
        set_executor_factory,
    )
    from faabric_tpu_torch.planner import clear_mock_planner_calls, get_planner
    from faabric_tpu_torch.scheduler import clear_mock_requests
    from faabric_tpu_torch.transport import clear_host_aliases
    from faabric_tpu_torch.transport.ptp_remote import clear_sent_ptp
    from faabric_tpu_torch.util.config import get_system_config
    from faabric_tpu_torch.util.testing import set_mock_mode

    clear_faults()
    set_tracing(False)
    reset_tracing()
    # The port's other process-wide state (the conftest resets only the
    # JAX package's): mock mode left on silently swallows every send
    set_mock_mode(False)
    clear_host_aliases()
    get_planner().reset()
    clear_registered_functions()
    set_executor_factory(None)
    clear_mock_requests()
    clear_mock_planner_calls()
    clear_sent_ptp()
    reset_batch_scheduler()
    get_system_config().reset()
    for (m, n), obj in saved.items():
        setattr(importlib.import_module(f"faabric_tpu_torch.telemetry.{m}"),
                n, obj)
    for (m, n), obj in saved.items():
        if n != "_registry" and hasattr(obj, "reset"):
            obj.reset()
    reset_wire_governor()


@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    saved = port_singletons()
    yield
    clean_port_telemetry(saved)


# ---------------------------------------------------------------------------
# Registry semantics
# ---------------------------------------------------------------------------

def test_counter_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("t_requests_total", "requests", route="a")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)  # counters are monotonic

    g = reg.gauge("t_depth", "queue depth")
    g.set(7)
    g.inc(2)
    g.dec()
    assert g.value == 8


def test_same_labels_same_handle_different_labels_new_series():
    reg = MetricsRegistry()
    a = reg.counter("t_frames_total", path="tcp")
    b = reg.counter("t_frames_total", path="tcp")
    c = reg.counter("t_frames_total", path="shm")
    assert a is b
    assert a is not c
    a.inc(3)
    c.inc(1)
    snap = reg.snapshot()
    rows = {tuple(sorted(r["labels"].items())): r["value"]
            for r in snap["t_frames_total"]["series"]}
    assert rows[(("path", "tcp"),)] == 3
    assert rows[(("path", "shm"),)] == 1


def test_type_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("t_thing")
    with pytest.raises(ValueError):
        reg.gauge("t_thing")


def test_histogram_bucket_boundaries():
    reg = MetricsRegistry()
    h = reg.histogram("t_lat_seconds", buckets=(0.01, 0.1, 1.0))
    h.observe(0.005)   # bucket 0
    h.observe(0.01)    # le is INCLUSIVE: still bucket 0
    h.observe(0.02)    # bucket 1
    h.observe(0.5)     # bucket 2
    h.observe(5.0)     # overflow: +Inf only
    assert h.counts == [2, 1, 1]
    assert h.count == 5
    assert h.sum == pytest.approx(0.005 + 0.01 + 0.02 + 0.5 + 5.0)

    # Prometheus render is CUMULATIVE with a trailing +Inf bucket
    text = reg.render_prometheus()
    assert 't_lat_seconds_bucket{le="0.01"} 2' in text
    assert 't_lat_seconds_bucket{le="0.1"} 3' in text
    assert 't_lat_seconds_bucket{le="1"} 4' in text
    assert 't_lat_seconds_bucket{le="+Inf"} 5' in text
    assert "t_lat_seconds_count 5" in text


def test_default_buckets_ascending():
    assert list(DEFAULT_BUCKETS) == sorted(DEFAULT_BUCKETS)
    assert all(b > 0 and math.isfinite(b) for b in DEFAULT_BUCKETS)


def test_concurrent_increments_do_not_lose_updates():
    reg = MetricsRegistry()
    c = reg.counter("t_par_total")
    h = reg.histogram("t_par_seconds", buckets=(1.0,))
    n, iters = 8, 2000

    def worker():
        for _ in range(iters):
            c.inc()
            h.observe(0.5)

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n * iters
    assert h.count == n * iters
    assert h.counts[0] == n * iters


def test_disabled_mode_returns_shared_noop_handle():
    assert metrics_enabled()  # default-on in this process
    set_metrics_enabled(False)
    try:
        reg = MetricsRegistry()
        c = reg.counter("t_off_total")
        g = reg.gauge("t_off_depth")
        h = reg.histogram("t_off_seconds")
        # One shared singleton — the zero-allocation fast path
        assert c is NULL_METRIC and g is NULL_METRIC and h is NULL_METRIC
        c.inc()
        g.set(3)
        h.observe(1.0)  # all no-ops
        assert reg.snapshot() == {}
    finally:
        set_metrics_enabled(True)


def test_get_metrics_is_a_singleton():
    assert get_metrics() is get_metrics()


# ---------------------------------------------------------------------------
# Export: multi-host merge + deltas
# ---------------------------------------------------------------------------

def test_render_snapshots_merges_hosts_under_host_label():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    r1.counter("t_tx_bytes_total", "bytes", plane="sync").inc(10)
    r2.counter("t_tx_bytes_total", "bytes", plane="sync").inc(32)
    text = render_snapshots({"w1": r1.snapshot(), "w2": r2.snapshot()})
    assert text.count("# TYPE t_tx_bytes_total counter") == 1
    assert 't_tx_bytes_total{host="w1",plane="sync"} 10' in text
    assert 't_tx_bytes_total{host="w2",plane="sync"} 32' in text


def test_label_escaping():
    assert _label_str({"f": 'a"b\\c'}) == '{f="a\\"b\\\\c"}'


def test_snapshot_delta_counters_and_histograms():
    reg = MetricsRegistry()
    c = reg.counter("t_d_total", op="x")
    h = reg.histogram("t_d_seconds", buckets=(1.0,))
    c.inc(5)
    h.observe(0.25)
    before = reg.snapshot()
    c.inc(7)
    h.observe(0.5)
    h.observe(0.25)
    delta = snapshot_delta(before, reg.snapshot())
    assert delta['t_d_total{op="x"}'] == 7
    assert delta["t_d_seconds_count"] == 2
    assert delta["t_d_seconds_sum"] == pytest.approx(0.75)
    # Unchanged series do not appear
    assert snapshot_delta(reg.snapshot(), reg.snapshot()) == {}


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

@pytest.fixture
def tracing():
    was = tracing_enabled()
    set_tracing(True)
    reset_tracing()
    yield get_tracer()
    reset_tracing()
    set_tracing(was)


def test_disabled_span_is_shared_noop():
    assert not tracing_enabled()  # default-off in the test process
    reset_tracing()  # other tests may have left recorded spans behind
    s = span("mpi", "allreduce", bytes=1024)
    assert s is NULL_SPAN
    with s:
        pass  # no-op, no recording
    assert [e for e in trace_events() if e.get("ph") == "X"] == []


def test_span_nesting_records_parent(tracing):
    with span("mpi", "allreduce", rank=0):
        with span("mpi.phase", "reduce", rank=0):
            pass
        with span("mpi.phase", "broadcast", rank=0):
            pass
    events = [e for e in trace_events() if e.get("ph") == "X"]
    by_name = {e["name"]: e for e in events}
    assert set(by_name) == {"allreduce", "reduce", "broadcast"}
    for phase in ("reduce", "broadcast"):
        assert by_name[phase]["args"]["parent"] == "mpi/allreduce"
        # Child interval sits inside the parent's
        p, c = by_name["allreduce"], by_name[phase]
        assert c["ts"] >= p["ts"] - 1e-3
        assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-3


def test_span_nesting_is_thread_isolated(tracing):
    """Two threads nest independently: neither sees the other's span as
    its parent (contextvars give each thread an empty stack)."""
    barrier = threading.Barrier(2)

    def worker(label):
        with span("t", f"outer-{label}"):
            barrier.wait(timeout=5)
            with span("t", f"inner-{label}"):
                pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    events = {e["name"]: e for e in trace_events() if e.get("ph") == "X"}
    assert events["inner-0"]["args"]["parent"] == "t/outer-0"
    assert events["inner-1"]["args"]["parent"] == "t/outer-1"
    assert events["inner-0"]["tid"] != events["inner-1"]["tid"]


def test_chrome_trace_json_schema(tracing):
    with span("transport", "sync_handle", code=7):
        pass
    doc = json.loads(tracing.chrome_trace_json())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    events = doc["traceEvents"]
    # Metadata records name the process and threads
    metas = [e for e in events if e["ph"] == "M"]
    assert any(e["name"] == "process_name" for e in metas)
    assert any(e["name"] == "thread_name" for e in metas)
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == 1
    e = xs[0]
    assert e["name"] == "sync_handle" and e["cat"] == "transport"
    assert e["args"]["code"] == 7
    assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
    assert e["dur"] >= 0
    assert isinstance(e["pid"], int) and isinstance(e["tid"], int)


def test_text_summary_and_totals(tracing):
    for _ in range(3):
        with span("prof", "step"):
            pass
    data = tracing.summary_data()
    assert data["prof/step"]["count"] == 3
    assert data["prof/step"]["total_s"] >= 0
    text = tracing.text_summary()
    assert "prof/step" in text and "n=3" in text


def test_clock_prof_delegates_into_tracer(tracing):
    from faabric_tpu_torch.util.clock import is_tracing_enabled, prof, prof_summary

    assert is_tracing_enabled()
    with prof("legacy.label"):
        pass
    assert tracing.summary_data()["prof/legacy.label"]["count"] == 1
    assert "prof/legacy.label" in prof_summary()


# ---------------------------------------------------------------------------
# Trace context propagation
# ---------------------------------------------------------------------------

def test_trace_context_encode_decode_roundtrip():
    from faabric_tpu_torch.telemetry import (
        decode_trace_context,
        encode_trace_context,
    )

    for trace_id, span_id in ((1, 2), (0xDEADBEEF, 0xCAFE),
                              ((1 << 52) + 7, (1 << 53) - 1)):
        wire = encode_trace_context(trace_id, span_id)
        assert decode_trace_context(wire) == (trace_id, span_id)

    # Malformed input degrades to None, never raises (server handler path)
    for bad in (None, "", "nodot", "x.y", "1.", ".2", "0.5", "-1.2",
                123, {"a": 1}, "1.2.3extra."):
        assert decode_trace_context(bad) is None


def test_current_trace_context_and_remote_parent(tracing):
    from faabric_tpu_torch.telemetry import (
        current_trace_context,
        current_trace_context as ctc,
        span_from_remote,
        trace_events,
    )

    assert current_trace_context() is None  # no open span

    captured = {}
    with span("planner", "call_batch"):
        captured["tc"] = ctc()
        assert captured["tc"] is not None

    # "Another host" continues the trace from the wire context
    with span_from_remote("transport", "sync_handle", captured["tc"],
                          code=10):
        with span("planner", "inner"):
            pass

    events = {e["name"]: e for e in trace_events() if e.get("ph") == "X"}
    root = events["call_batch"]["args"]
    handler = events["sync_handle"]["args"]
    inner = events["inner"]["args"]
    # Root mints the trace id; the remote handler joins the SAME trace
    # with the root's span id as its parent
    assert root["trace_id"] == root["span_id"]
    assert handler["trace_id"] == root["trace_id"]
    assert handler["parent_span_id"] == root["span_id"]
    assert handler["remote_parent"] is True
    # Locally-nested spans chain below the handler
    assert inner["trace_id"] == root["trace_id"]
    assert inner["parent_span_id"] == handler["span_id"]


def test_remote_context_garbage_degrades_to_root_span(tracing):
    from faabric_tpu_torch.telemetry import span_from_remote, trace_events

    with span_from_remote("transport", "handle", "not-a-context"):
        pass
    args = [e for e in trace_events() if e.get("ph") == "X"][0]["args"]
    assert args["trace_id"] == args["span_id"]  # fresh root
    assert "remote_parent" not in args


def test_flow_events_and_deterministic_ids(tracing):
    from faabric_tpu_torch.telemetry import flow_id_for, trace_events

    fid = flow_id_for(group_id=7, send_idx=0, recv_idx=2, channel=0,
                      seq=13)
    # Deterministic (cross-process derivable) and JSON-safe
    assert fid == flow_id_for(7, 0, 2, 0, 13)
    assert fid != flow_id_for(7, 0, 2, 0, 14)
    assert 0 <= fid < (1 << 53)

    tracing.flow_start(fid)
    tracing.flow_end(fid)
    tracing.instant("faults", "transport.send", action="drop")
    events = trace_events()
    assert any(e["ph"] == "s" and e["id"] == fid for e in events)
    assert any(e["ph"] == "f" and e.get("bp") == "e" and e["id"] == fid
               for e in events)
    marks = [e for e in events if e["ph"] == "i"]
    assert marks and marks[0]["name"] == "transport.send"
    assert marks[0]["args"]["action"] == "drop"


def test_fault_firing_is_visible_in_metrics_and_trace(tracing):
    from faabric_tpu_torch.faults import clear_faults, install_faults
    from faabric_tpu_torch.faults.registry import FaultInjected, get_fault_registry
    from faabric_tpu_torch.telemetry import get_metrics, trace_events

    install_faults("ut.telemetry.point=raise:boom")
    try:
        with pytest.raises(FaultInjected):
            get_fault_registry().point("ut.telemetry.point").fire(host="w9")
        rows = get_metrics().snapshot().get("faabric_faults_fired_total",
                                            {}).get("series", [])
        mine = [r for r in rows
                if r["labels"].get("point") == "ut.telemetry.point"]
        assert mine and mine[0]["value"] >= 1
        marks = [e for e in trace_events() if e.get("ph") == "i"
                 and e["name"] == "ut.telemetry.point"]
        assert marks and marks[0]["args"]["action"] == "raise"
    finally:
        clear_faults()


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_overwrites_oldest():
    from faabric_tpu_torch.telemetry import FlightRecorder

    fr = FlightRecorder(size=8)
    for i in range(20):
        fr.record("tick", i=i)
    events = fr.events()
    assert len(events) == 8
    assert [e["i"] for e in events] == list(range(12, 20))
    assert all(e["kind"] == "tick" for e in events)
    # Timestamps are monotone non-decreasing across the ring seam
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)


def test_flight_ring_capacity_is_preallocated_and_bounded():
    from faabric_tpu_torch.telemetry import FlightRecorder

    fr = FlightRecorder(size=16)
    assert len(fr._slots) == 16
    for i in range(1000):
        fr.record("e", n=i)
    assert len(fr._slots) == 16
    assert len(fr.events()) == 16


def test_flight_dump_and_flightdump_merge(tmp_path, monkeypatch):
    from faabric_tpu_torch.runner import flightdump

    from faabric_tpu_torch.telemetry import FlightRecorder

    monkeypatch.setenv("FAABRIC_FLIGHT_DIR", str(tmp_path))
    a, b = FlightRecorder(size=32), FlightRecorder(size=32)
    # merge() dedupes on (process, pid, ring seq) — in production one
    # process owns ONE ring, so two recorders in this test process must
    # not alias each other's sequence numbers
    import itertools

    b._n = itertools.count(100)
    a.record("send", src=0, dst=2, plane="shm", bytes=4096)
    a.record("group_abort", group=9, reason="peer dead")
    b.record("fault_fired", point="transport.send", action="drop")
    assert a.dump("mpi_world_aborted")
    assert b.dump("planner_requeue")

    merged = flightdump.merge(str(tmp_path))
    assert len(merged) == 3
    kinds = [e["kind"] for e in merged]
    assert set(kinds) == {"send", "group_abort", "fault_fired"}
    # Provenance rides each merged event
    assert all("dump_reason" in e and "pid" in e for e in merged)
    text = flightdump.render(merged)
    assert "group_abort" in text and "fault_fired" in text

    # Throttle: an immediate second dump for the same reason is skipped
    assert a.dump("mpi_world_aborted") is None

    # A second trigger re-dumps the (overlapping) ring; merge dedupes on
    # ring seq so each real event still appears exactly once
    a.record("sigterm")
    assert a.dump("sigterm")
    merged = flightdump.merge(str(tmp_path))
    assert len(merged) == 4
    assert [e["kind"] for e in merged].count("group_abort") == 1


def test_flight_dump_without_dir_is_noop(monkeypatch):
    from faabric_tpu_torch.telemetry import FlightRecorder

    monkeypatch.delenv("FAABRIC_FLIGHT_DIR", raising=False)
    fr = FlightRecorder(size=8)
    fr.record("x")
    assert fr.dump("whatever") is None


# ---------------------------------------------------------------------------
# Communication matrix
# ---------------------------------------------------------------------------

def test_comm_matrix_records_per_link():
    from faabric_tpu_torch.telemetry import CommMatrix

    cm = CommMatrix(max_ranks=16)
    cm.record(0, 2, "shm", 1024, 0.001)
    cm.record(0, 2, "shm", 2048, 0.002)
    cm.record(1, 3, "bulk-tcp", 4096, 0.01)
    cm.record(0, 1, "ptp", 64)  # latency optional

    snap = cm.snapshot()
    cells = {(c["src"], c["dst"], c["plane"]): c for c in snap["cells"]}
    shm = cells[("0", "2", "shm")]
    assert shm["messages"] == 2 and shm["bytes"] == 3072
    assert shm["lat_count"] == 2
    assert shm["lat_sum"] == pytest.approx(0.003)
    assert cells[("0", "1", "ptp")]["lat_count"] == 0

    fams = cm.families()
    assert set(fams) == {"faabric_comm_messages_total",
                         "faabric_comm_bytes_total",
                         "faabric_comm_raw_bytes_total",
                         "faabric_comm_send_seconds"}
    from faabric_tpu_torch.telemetry import render_snapshots

    text = render_snapshots({"w1": fams})
    assert ('faabric_comm_bytes_total{codec="raw",dst="2",host="w1",'
            'plane="shm",src="0"} 3072') in text


def test_comm_matrix_codec_rows_account_raw_and_wire():
    """Truthfulness: coded frames land in their own codec=
    row, accounting BOTH wire bytes and pre-codec raw bytes — so
    compression shows as a ratio, never as vanished traffic."""
    from faabric_tpu_torch.telemetry import CommMatrix

    cm = CommMatrix(max_ranks=16)
    cm.record(0, 1, "bulk-tcp", 4096, 0.001)  # raw frame
    cm.record(0, 1, "bulk-tcp", 500, 0.001, raw_bytes=1 << 20,
              codec="delta")
    cm.record(0, 1, "bulk-tcp", 700, 0.001, raw_bytes=1 << 20,
              codec="delta")
    cells = {(c["src"], c["dst"], c["plane"], c["codec"]): c
             for c in cm.snapshot()["cells"]}
    raw = cells[("0", "1", "bulk-tcp", "raw")]
    assert raw["bytes"] == 4096 and raw["bytes_raw"] == 4096
    d = cells[("0", "1", "bulk-tcp", "delta")]
    assert d["bytes"] == 1200           # what crossed the wire
    assert d["bytes_raw"] == 2 << 20    # what the payloads really were
    assert d["messages"] == 2
    # /metrics carries the raw-bytes family with the codec label
    fams = cm.families()
    series = fams["faabric_comm_raw_bytes_total"]["series"]
    dd = [s for s in series if s["labels"]["codec"] == "delta"]
    assert dd and dd[0]["value"] == 2 << 20


def test_comm_matrix_cardinality_guard():
    """A 256-rank world must not bloat /metrics: ranks beyond the cap
    collapse into one 'other' bucket per direction."""
    from faabric_tpu_torch.telemetry import CommMatrix

    cm = CommMatrix(max_ranks=4)
    for src in range(256):
        for dst in (0, 255):
            cm.record(src, dst, "ptp", 10)
    cells = cm.snapshot()["cells"]
    # src ∈ {0..3, other} × dst ∈ {0, other} = at most 10 series
    assert len(cells) <= (4 + 1) * 2
    labels = {(c["src"], c["dst"]) for c in cells}
    assert ("other", "other") in labels
    assert ("0", "0") in labels
    assert all(c["src"] in {"0", "1", "2", "3", "other"} for c in cells)
    # Nothing lost: total messages survive the collapse
    assert sum(c["messages"] for c in cells) == 256 * 2
    # Garbage ranks collapse too instead of raising
    cm.record("not-a-rank", -3, "ptp", 1)
    assert any(c["src"] == "other" and c["dst"] == "other"
               for c in cm.snapshot()["cells"])


def test_comm_matrix_merge_cell_rows():
    from faabric_tpu_torch.telemetry import merge_cell_rows

    merged = merge_cell_rows({
        "w1": [{"src": "0", "dst": "2", "plane": "shm", "messages": 2,
                "bytes": 100, "lat_sum": 0.1, "lat_count": 2}],
        "w2": [{"src": "0", "dst": "2", "plane": "shm", "messages": 1,
                "bytes": 50, "lat_sum": 0.05, "lat_count": 1},
               {"src": "3", "dst": "1", "plane": "ptp", "messages": 1,
                "bytes": 999, "lat_sum": 0.0, "lat_count": 0}],
    })
    by_key = {(r["src"], r["dst"], r["plane"]): r for r in merged}
    assert by_key[("0", "2", "shm")]["bytes"] == 150
    assert by_key[("0", "2", "shm")]["messages"] == 3
    assert by_key[("3", "1", "ptp")]["bytes"] == 999
    # Sorted by bytes, fattest link first
    assert merged[0]["bytes"] == 999


def test_malformed_ring_and_cardinality_knobs_degrade(monkeypatch):
    """Telemetry knobs are parsed on hot-path-adjacent lazy inits: a
    malformed value must degrade to the default, never raise out of a
    send or recovery path."""
    import faabric_tpu_torch.telemetry.flight as flight_mod
    from faabric_tpu_torch.telemetry import CommMatrix

    monkeypatch.setattr(flight_mod, "_flight", None)
    monkeypatch.setenv("FAABRIC_FLIGHT_RING", "8k")
    fr = flight_mod.get_flight()
    assert fr.size == 4096
    fr.record("x")  # and it records
    monkeypatch.setattr(flight_mod, "_flight", None)

    monkeypatch.setenv("FAABRIC_COMMMATRIX_MAX_RANKS", "lots")
    cm = CommMatrix()
    assert cm.max_ranks == 64
    cm.record(0, 1, "ptp", 10)


def test_flight_dump_pruning_bounds_directory(tmp_path, monkeypatch):
    """A recurring dump trigger must not fill the disk: only the newest
    FAABRIC_FLIGHT_MAX_DUMPS files of this process survive."""
    from faabric_tpu_torch.telemetry import FlightRecorder

    monkeypatch.setenv("FAABRIC_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("FAABRIC_FLIGHT_MAX_DUMPS", "3")
    fr = FlightRecorder(size=8)
    fr.record("tick")
    for i in range(6):
        fr._last_dump.clear()  # bypass the 1s per-reason throttle
        assert fr.dump(f"reason{i}")
    files = [n for n in tmp_path.iterdir() if n.name.endswith(".json")]
    assert len(files) == 3



# ---------------------------------------------------------------------------
# Cross-package: the same operations give the same exposition
# ---------------------------------------------------------------------------

def _drive_registry(reg, rng):
    """The same registry operations on either package's registry, from
    one seeded numpy stream."""
    c = reg.counter("x_frames_total", "frames", plane="shm")
    for v in rng.integers(0, 9, 20):
        c.inc(int(v))
    reg.counter("x_frames_total", "frames", plane="tcp").inc(3)
    reg.counter("x_escaped_total", 'say "hi"\\now', path='a"b\\c').inc()
    g = reg.gauge("x_depth", "queue depth")
    for v in rng.standard_normal(5):
        g.set(float(v))
    g.inc(2.5)
    g.dec(0.25)
    h = reg.histogram("x_seconds", "latency")
    for v in rng.exponential(0.05, 64):
        h.observe(float(v))
    h2 = reg.histogram("x_bytes", "sizes", buckets=(1.0, 10.0, 100.0),
                       path="tcp")
    for v in rng.integers(0, 500, 40):
        h2.observe(float(v))
    h2.observe(math.inf)


def test_prometheus_text_byte_equal_to_reference():
    import numpy as np

    from faabric_tpu.telemetry import metrics as ref_metrics

    from faabric_tpu_torch.telemetry import metrics as port_metrics

    port, ref = port_metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    _drive_registry(port, np.random.default_rng(7))
    _drive_registry(ref, np.random.default_rng(7))
    assert port.snapshot() == ref.snapshot()
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.render_prometheus({"host": "w1"}) == \
        ref.render_prometheus({"host": "w1"})
    # Several hosts merged under a host label, and the delta of two
    # snapshots
    snaps_p = {"hA": port.snapshot(), "hB": port.snapshot()}
    snaps_r = {"hA": ref.snapshot(), "hB": ref.snapshot()}
    assert port_metrics.render_snapshots(snaps_p, {"cluster": "c"}) == \
        ref_metrics.render_snapshots(snaps_r, {"cluster": "c"})
    before_p, before_r = port.snapshot(), ref.snapshot()
    _drive_registry(port, np.random.default_rng(8))
    _drive_registry(ref, np.random.default_rng(8))
    # (the +Inf observation makes a NaN sum delta: compare as text)
    assert json.dumps(port_metrics.snapshot_delta(before_p, port.snapshot()),
                      sort_keys=True) == \
        json.dumps(ref_metrics.snapshot_delta(before_r, ref.snapshot()),
                   sort_keys=True)


def test_trace_context_and_flow_ids_agree_with_reference():
    from faabric_tpu.telemetry import tracer as ref_tracer

    from faabric_tpu_torch.telemetry import tracer as port_tracer

    for tid, sid in ((1, 2), (0xABCDEF, 0x1234), ((1 << 52) - 1, 77)):
        wire = port_tracer.encode_trace_context(tid, sid)
        assert wire == ref_tracer.encode_trace_context(tid, sid)
        assert ref_tracer.decode_trace_context(wire) == (tid, sid)
    for bad in ("", "x", "1.", ".2", "0.1", "g.1", None, 5):
        assert port_tracer.decode_trace_context(bad) == \
            ref_tracer.decode_trace_context(bad)
    for key in ((7, 0, 1, 0, 0), (1 << 70, 5, 3, 1, 99), (4242, 2, 4, 0, -1)):
        assert port_tracer.flow_id_for(*key) == ref_tracer.flow_id_for(*key)


# ---------------------------------------------------------------------------
# Cross-package: a 3 + 3 world traced on both packages
# ---------------------------------------------------------------------------

def _world_program(w, rank, pk):
    import numpy as np

    data = np.arange(6 * 1024, dtype=np.float64) * (rank + 1)
    w.barrier(rank)
    w.allreduce(rank, data[:1024].copy(), pk.MpiOp.SUM)
    w.broadcast(0, rank, data[:512].copy())
    w.reduce(rank, 3, data[:256].copy(), pk.MpiOp.SUM)
    w.allgather(rank, data[:128].copy())
    w.alltoall(rank, data[:6 * 16].copy())
    w.reduce_scatter(rank, data[:6 * 64].copy(), pk.MpiOp.SUM)
    w.gather(rank, 4, data[:32].copy())
    return w.scan(rank, data[:8].copy(), pk.MpiOp.SUM)


def _span_multiset(events) -> dict:
    out: dict = {}
    for e in events:
        if e.get("ph") == "X":
            key = (e["cat"], e["name"])
            out[key] = out.get(key, 0) + 1
    return out


def _cells(matrix) -> list:
    rows = (matrix.snapshot() or {}).get("cells", [])
    return sorted((c["src"], c["dst"], c["plane"], c.get("codec", "raw"),
                   c["bytes"], c.get("bytes_raw", c["bytes"]),
                   c.get("msgs", c.get("count")))
                  for c in rows)


def test_traced_two_host_world_matches_reference_spans_and_cells():
    """The same program on a 3 + 3 world of each package, tracing on:
    both record the same multiset of (subsystem, label) spans and the
    same comm-matrix cells (bytes and message counts per link)."""
    from faabric_tpu import telemetry as ref_tel

    from faabric_tpu_torch import telemetry as port_tel
    from tests.test_torch_mpi_world import TWO_HOSTS, Pair

    pair = Pair(TWO_HOSTS, group=4242 + 31)
    try:
        for tel in (ref_tel, port_tel):
            tel.get_comm_matrix().reset()
            tel.set_tracing(True)
            tel.reset_tracing()
        pair.both(_world_program)
        ref_spans = _span_multiset(ref_tel.trace_events())
        port_spans = _span_multiset(port_tel.trace_events())
        ref_cells = _cells(ref_tel.get_comm_matrix())
        port_cells = _cells(port_tel.get_comm_matrix())
    finally:
        for tel in (ref_tel, port_tel):
            tel.set_tracing(False)
            tel.reset_tracing()
        pair.close()
    assert port_spans == ref_spans
    assert port_cells == ref_cells
    # Every collective of the program is there, once a rank
    for coll in ("barrier", "allreduce", "broadcast", "reduce",
                 "allgather", "alltoall", "reduce_scatter", "gather",
                 "scan"):
        assert port_spans[("mpi", coll)] == 6, coll
    assert any(k[0] == "mpi.phase" for k in port_spans)
    assert any(c[2] != "ptp" or c[4] > 0 for c in port_cells)


# ---------------------------------------------------------------------------
# Knobs read at import, and the SIGTERM dump: subprocesses
# ---------------------------------------------------------------------------

_KNOB_PROGRAM = r"""
import json
import faabric_tpu_torch.telemetry as t
from faabric_tpu_torch.telemetry import metrics, tracer
from faabric_tpu_torch.util import clock
h = t.get_metrics().counter("k_total", "k")
with t.span("mpi", "allreduce"):
    pass
print(json.dumps({
    "metrics": metrics.metrics_enabled(),
    "null_handle": h is t.NULL_METRIC,
    "tracing": t.tracing_enabled(),
    "clock_tracing": clock.is_tracing_enabled(),
    "buffer": t.get_tracer()._events.maxlen,
    "spans": sum(1 for e in t.trace_events() if e.get("ph") == "X"),
}))
"""


def _run_program(program: str, env: dict, timeout: float = 120.0):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith("FAABRIC_")}
    out = subprocess.run([sys.executable, "-c", program], cwd=root,
                         env={**clean, **env}, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("env,want", [
    ({}, {"metrics": True, "null_handle": False, "tracing": False,
          "spans": 0}),
    ({"FAABRIC_METRICS": "0"}, {"metrics": False, "null_handle": True}),
    ({"FAABRIC_TRACING": "1"}, {"tracing": True, "clock_tracing": True,
                                "spans": 1}),
    ({"FAABRIC_SELF_TRACING": "1"}, {"tracing": True, "spans": 1}),
    ({"FAABRIC_TRACING": "1", "FAABRIC_TRACE_BUFFER": "7"},
     {"tracing": True, "buffer": 7}),
])
def test_import_time_knobs_in_a_subprocess(env, want):
    got = _run_program(_KNOB_PROGRAM, env)
    for k, v in want.items():
        assert got[k] == v, (env, k, got)


_SIGTERM_PROGRAM = r"""
import os, signal, time
from faabric_tpu_torch.telemetry import flight_record
from faabric_tpu_torch.telemetry.flight import install_signal_dump
flight_record("before_sigterm", n=1)
install_signal_dump()
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(10)
"""


def test_install_signal_dump_dumps_and_still_dies(tmp_path):
    """SIGTERM after ``install_signal_dump`` writes the ring (read back
    by the port's ``flightdump``) and the process still dies of the
    signal (exit -15)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from faabric_tpu_torch.runner import flightdump

    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FAABRIC_")}
    env["FAABRIC_FLIGHT_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _SIGTERM_PROGRAM], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == -15, (out.returncode, out.stderr[-2000:])
    kinds = [e["kind"] for e in flightdump.merge(str(tmp_path))]
    assert "before_sigterm" in kinds and "sigterm" in kinds


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 23 at a small width on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_telemetry_phase_small(monkeypatch):
    """Phase 23 with every check: 23a's spans, device cells, profiler
    records and device rate; 23b's plane bytes, link rate, Chrome trace
    and planted straggler (2 s here, so that no scheduling noise of a
    loaded machine reads as one); 23c's three fault rules. The fault
    call sites are armed as ``FAABRIC_FAULTS`` at import arms them (this
    process imported the port without it)."""
    import torch

    import chip_smoke
    import faabric_tpu_torch.executor.executor as executor_mod
    import faabric_tpu_torch.mpi.world as world_mod
    import faabric_tpu_torch.transport.bulk as bulk_mod
    from faabric_tpu_torch.faults import registry
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.mpi import MpiWorld
    from faabric_tpu_torch.ops import _build
    from tests.conftest import next_port_base

    registry.set_faults_enabled(True)
    reg = registry.get_fault_registry()
    for mod, attr, name in ((world_mod, "_FP_COLLECTIVE", "mpi.collective"),
                            (executor_mod, "_FP_RUN", "executor.run"),
                            (bulk_mod, "_FP_BULK", "transport.bulk")):
        monkeypatch.setattr(mod, "_FAULTS", True)
        monkeypatch.setattr(mod, attr, reg.point(name))
    monkeypatch.setattr(MpiWorld, "CHUNK_BYTES", 1 << 20)
    cfg = ModelConfig(vocab_size=2048, d_model=256, n_layers=2, n_heads=4,
                      d_ff=512, max_seq=64, attention_impl="reference",
                      norm_impl="reference", compute_dtype=torch.float32)
    launches = chip_smoke.telemetry_phase(
        torch.device("cpu"), _build, cfg=cfg, seq=32, base=next_port_base(),
        straggle_s=2.0, child=False)
    assert launches == {}  # the plain versions run on the CPU
