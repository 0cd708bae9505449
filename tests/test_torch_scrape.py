"""The reference's scrape cases on the port: a planner serving its REST
endpoint and two workers as OS processes, read by the port's doctor,
timeline and flightdump.

Counterparts of ``tests/dist/test_doctor.py:163`` (a planted slow link
and a planted straggler, both ranked by the doctor),
``tests/dist/test_statemap.py:133`` (a planted hot key: ``/statemap``'s
ranking and origins, the ``plane=state`` comm-matrix rows against the
ledger, and the doctor's master-hotspot and pull-amplification
findings), ``tests/dist/test_lifecycle_plane.py:156`` and ``:294``
(every ledger holds its phases and spans its invocation, the SLO burns,
the doctor names the dominant phase, the timeline renders the ledgers,
and the live flight rings of the planner and a worker merge through
``flightdump --url``)
and ``tests/dist/test_profile.py:124`` (the planted hotspot attributed
to its host and thread class). Each case stands up its own
``ProcCluster`` (``tests/test_torch_multiprocess.py``) on a port slot of
``tests/conftest.py``, its endpoints on the slot's own ports.

The lifecycle case submits through ``call_functions``, whose CALL_BATCH
goes through the planner's ingress: every ledger holds the ingress's
queue-exit stamp and the timeline renders the ``ingress_queue`` phase.
(The reference submits in bulks through ``submit_functions_many``; 120
apps dispatched at once can queue for the workers' executors long
enough, on a loaded machine, that ``executor_queue`` outweighs the
planted run in the p99.) Four cases need an idle machine or a sampler's
luck and are chaos and slow, as the chaos cases are: the ledgers' 90%
coverage of their walls, the reference's bulk load with its p99 and
doctor assertions, the burst of phase B whose backlog the 50 ms sampler
must catch in the planner's ``ingress_depth`` series, and the profile
case (50 samples on each worker while one of them spins).
"""

import threading
import time

import pytest

from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
from faabric_tpu_torch.telemetry.lifecycle import (
    PHASE_ADMIT,
    PHASE_DISPATCH,
    PHASE_EXEC_QUEUE_EXIT,
    PHASE_QUEUE_EXIT,
    PHASE_RECORDED,
    PHASE_RESULT_PUSH,
    PHASE_RUN_END,
    PHASE_RUN_START,
    PHASE_SCHED,
    PHASE_WAITER_WAKE,
    ledger_durations,
    ledger_span_s,
)
from tests.test_torch_multiprocess import (
    ProcCluster,
    http_json,
    http_text,
    wait_batch_finished,
)


@pytest.fixture
def cluster_of():
    """Start a ``ProcCluster`` with the given arguments; stops it after
    the test."""
    started = []

    def start(*args, **kwargs):
        started.append(ProcCluster(*args, **kwargs))
        return started[-1].start()

    yield start
    for c in started:
        c.stop()


# ---------------------------------------------------------------------------
# tests/dist/test_doctor.py:163
# ---------------------------------------------------------------------------

SLOW_RANK = 5
ROUNDS = 6


def _bulk_link_gibs(perf_doc: dict) -> dict[tuple, dict]:
    """(src, dst) → bytes-weighted gibs_avg over the bulk-tcp rows."""
    links: dict[tuple, dict] = {}
    for row in perf_doc["links"]:
        if row.get("plane") != "bulk-tcp" or row.get("gibs_avg") is None:
            continue
        cur = links.setdefault((row["src"], row["dst"]),
                               {"bytes": 0, "weighted": 0.0, "messages": 0})
        cur["bytes"] += row.get("bytes") or 0
        cur["weighted"] += row["gibs_avg"] * (row.get("bytes") or 0)
        cur["messages"] += row.get("messages") or 0
    return {k: {"gibs": v["weighted"] / v["bytes"], "bytes": v["bytes"],
                "messages": v["messages"]}
            for k, v in links.items() if v["bytes"] > 0}


def test_dist_doctor_names_slow_link_and_straggler(cluster_of):
    """dw1's bulk frames toward dw2 pay a planted 8 ms (shm rings off, the
    wire codec raw) and rank 5 enters each collective 250 ms late:
    ``/perf`` profiles both directions and flags the straggler, its
    bandwidth agrees with the comm matrix's within 25%, ``/healthz``
    reports the aggregation, and the doctor ranks both faults in its top
    five findings."""
    from faabric_tpu_torch.runner.doctor import diagnose, fetch_live
    from faabric_tpu_torch.telemetry import (
        get_collective_profiler,
        get_comm_matrix,
        get_perf_store,
    )

    # This process is a host of the scrape too: its links and series
    # start from a clean slate, whatever earlier tests of the process
    # measured (a stale slow link would join the doctor's ranking)
    for store in (get_perf_store(), get_collective_profiler(),
                  get_comm_matrix()):
        store.reset()
    cluster = cluster_of(
        "dw", {"dw1": 4, "dw2": 4}, http=True,
        extra_env={"SHM_RING_BYTES": "0", "FAABRIC_WIRE_CODEC": "raw",
                   "MPI_PERF_SLOW_RANK": str(SLOW_RANK),
                   "MPI_PERF_SLOW_S": "0.25",
                   "MPI_PERF_ROUNDS": str(ROUNDS)},
        host_env={"dw1": {
            "FAABRIC_FAULTS": "transport.bulk=delay:8ms@dest=dw2"}})
    me = cluster.me
    req = batch_exec_factory("dist", "mpi_perf", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=180.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    assert r.output_data == b"r0:ok"
    status = wait_batch_finished(me, req.app_id, timeout=60)
    for m in status.message_results:
        assert m.return_value == int(ReturnValue.SUCCESS), m.output_data

    base = cluster.http_url
    perf = http_json(base, "/perf")
    links = _bulk_link_gibs(perf)
    assert ("dw1", "dw2") in links, sorted(links)
    assert ("dw2", "dw1") in links, sorted(links)
    slow = links[("dw1", "dw2")]["gibs"]
    fast = links[("dw2", "dw1")]["gibs"]
    assert slow < fast * 0.5, (
        f"planted delay invisible: dw1→dw2 {slow:.3f} GiB/s vs "
        f"dw2→dw1 {fast:.3f}")

    matrix = http_json(base, "/commmatrix")
    for host in ("dw1", "dw2"):
        cells = [c for c in matrix["hosts"].get(host, [])
                 if c["plane"] == "bulk-tcp"]
        m_bytes = sum(c["bytes"] for c in cells)
        m_lat = sum(c.get("lat_sum", 0.0) for c in cells)
        assert m_bytes > 0 and m_lat > 0, f"no matrix rows for {host}"
        matrix_gibs = (m_bytes / m_lat) / (1 << 30)
        rows = {k: v for k, v in links.items() if k[0] == host}
        tot = sum(v["bytes"] for v in rows.values())
        profile_gibs = sum(v["gibs"] * v["bytes"]
                           for v in rows.values()) / tot
        assert profile_gibs == pytest.approx(matrix_gibs, rel=0.25), (
            f"{host}: profile {profile_gibs:.3f} vs matrix "
            f"{matrix_gibs:.3f} GiB/s")

    stragglers = perf["stragglers"]
    flagged = {(s["world"], s["rank"]) for s in stragglers}
    assert (7600, SLOW_RANK) in flagged, stragglers
    others = [s for s in stragglers
              if s["world"] == 7600 and s["rank"] != SLOW_RANK]
    assert not others, f"false positives: {others}"

    perf_block = http_json(base, "/healthz").get("perf")
    assert perf_block is not None
    assert perf_block["lastAggregationAgeSeconds"] is not None
    assert perf_block["clusterLinks"] and perf_block["clusterLinks"] > 0
    assert perf_block["clusterStragglers"] >= 1

    top5 = diagnose(fetch_live(base))[:5]
    slow_links = [f for f in top5 if f["kind"] == "slow_link"]
    assert slow_links, f"no slow_link in top findings: {top5}"
    assert any("dw1→dw2" in f["subject"] for f in slow_links), slow_links
    straggler_f = [f for f in top5 if f["kind"] == "straggler"]
    assert straggler_f, f"no straggler in top findings: {top5}"
    assert any(f"rank {SLOW_RANK}" in f["subject"]
               for f in straggler_f), straggler_f


# ---------------------------------------------------------------------------
# tests/dist/test_statemap.py:133
# ---------------------------------------------------------------------------

HOT_SIZE = 2 << 20
COLD_SIZE = 64 << 10
CHUNK = 4096
HAMMERS = 2  # sequential worker invocations of fn_state_hot


def test_dist_statemap_attribution_and_doctor(cluster_of):
    """This process masters a planted 2 MiB hot key and three cold keys;
    the workers hammer the hot key. ``/statemap`` ranks it first with
    its master and a per-origin split naming the workers, the
    ``plane=state`` comm-matrix bytes agree with the workers' own wire
    counts and the ledger's remote bytes within 5%, and the doctor finds
    the master hotspot and the pull amplification."""
    from faabric_tpu_torch.runner.doctor import diagnose, fetch_live
    from faabric_tpu_torch.telemetry import get_comm_matrix
    from faabric_tpu_torch.telemetry.statestats import (
        get_state_stats,
        reset_state_stats,
    )

    cluster = cluster_of("s", {"sw1": 4, "sw2": 4}, http=True,
                         extra_env={"FAABRIC_METRICS": "1"})
    me = cluster.me
    client = cluster.client_host
    # This process reports its own ledger and matrix as the client host:
    # from a clean slate, whatever earlier tests of the process did
    reset_state_stats()
    get_state_stats().reset()
    get_comm_matrix().reset()

    hot = me.state.get_kv("dist", "hot", HOT_SIZE)
    assert hot.is_master
    hot.set(b"\x07" * HOT_SIZE)
    for i in range(3):
        kv = me.state.get_kv("dist", f"cold{i}", COLD_SIZE)
        kv.set(bytes([i]) * COLD_SIZE)

    exec_hosts, wire_total = set(), 0
    for _ in range(HAMMERS):
        req = batch_exec_factory("dist", "state_hot", 1)
        me.planner_client.call_functions(req)
        r = me.planner_client.get_message_result(
            req.app_id, req.messages[0].id, timeout=30.0)
        assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
        assert r.output_data.startswith(b"wire=")
        wire_total += int(r.output_data.split(b"=")[1])
        exec_hosts.add(r.executed_host)
    assert exec_hosts <= {"sw1", "sw2"}
    assert wire_total == HAMMERS * (3 * HOT_SIZE + 2 * CHUNK)

    base = cluster.http_url
    smap = http_json(base, "/statemap")
    top = smap["keys"][0]
    assert top["key"] == "dist/hot", [r["key"] for r in smap["keys"]]
    assert top["rank"] == 1
    assert top["master"] == client
    assert top["size"] == HOT_SIZE
    by_origin = top["by_origin"]
    assert client in by_origin
    for host in exec_hosts:
        assert by_origin[host]["bytes"] > 0, by_origin
    remote_bytes = sum(o["bytes"] for h, o in by_origin.items()
                       if h != client)
    assert remote_bytes > by_origin[client]["bytes"]
    assert top["pull_amplification"] >= 3.0
    cold_keys = {r["key"]: r for r in smap["keys"]
                 if r["key"].startswith("dist/cold")}
    assert len(cold_keys) == 3
    assert all(r["master"] == client for r in cold_keys.values())
    assert smap["hosts"][client]["mastered_keys"] >= 4
    assert smap["hosts"][client]["mastered_bytes"] >= \
        HOT_SIZE + 3 * COLD_SIZE

    matrix = http_json(base, "/commmatrix")
    comm_state = sum(c["bytes"] for cells in matrix["hosts"].values()
                     for c in cells if c.get("plane") == "state")
    assert comm_state == pytest.approx(wire_total, rel=0.05), (
        f"comm {comm_state} vs reported wire {wire_total}")
    assert comm_state == pytest.approx(remote_bytes, rel=0.05), (
        f"comm {comm_state} vs statemap remote {remote_bytes}")

    findings = diagnose(fetch_live(base))
    hotspot = [f for f in findings if f["kind"] == "master_hotspot"]
    assert hotspot, f"no master_hotspot finding: {findings[:5]}"
    assert any(client in f["subject"] for f in hotspot), hotspot
    amp = [f for f in findings if f["kind"] == "pull_amplification"]
    assert any("dist/hot" in f["subject"] for f in amp), (
        f"no pull_amplification on dist/hot: {findings[:8]}")


# ---------------------------------------------------------------------------
# tests/dist/test_lifecycle_plane.py:156 and :294
# ---------------------------------------------------------------------------

RUN_DELAY_S = 0.2
N_THREADS = 3
PER_THREAD = 40
BULK = 10
BULKS = 4
BURST = 400
LIFECYCLE_ENV = {
    "FAABRIC_FAULTS": f"executor.run=delay:{int(RUN_DELAY_S * 1e3)}ms",
    "FAABRIC_TIMESERIES_INTERVAL_S": "0.05",
    "FAABRIC_SLO": "p99_e2e_ms=5,error_rate=0.01",
    "FAABRIC_SLO_WINDOWS": "10,30"}


@pytest.fixture(scope="module")
def lifecycle_cluster():
    """A planner and two 64-slot workers whose every guest run pays a
    planted 200 ms; worker lfw1 serves its own endpoint. The SLO's 5 ms
    p99 must burn."""
    cluster = ProcCluster(
        "lf", {"lfw1": 64, "lfw2": 64}, http=True, worker_http=("lfw1",),
        extra_env=LIFECYCLE_ENV).start()
    try:
        yield cluster
    finally:
        cluster.stop()


def lifecycle_load(cluster, bulk: bool = False
                   ) -> list[tuple[object, float]]:
    """Three threads submit 40 single-message noop apps each, then wait
    for their results: (result, submit time) of every message, each
    SUCCESS with the phases from admission through the ingress queue to
    the waiter's wake and the planted run delay inside its run phase.
    Each app goes in its own CALL_BATCH, or with ``bulk`` as the
    reference sends them: ``BULKS`` SUBMIT_BATCH calls of ``BULK`` apps
    a thread, on the shared client."""
    from faabric_tpu_torch.planner.client import PlannerClient

    client = cluster.me.planner_client
    per_thread: list[list] = [[] for _ in range(N_THREADS)]
    errors: list[str] = []

    def submit_each(sub) -> list:
        submitted = []
        for _ in range(PER_THREAD):
            req = batch_exec_factory("dist", "noop", 1)
            t0 = time.monotonic()
            sub.call_functions(req)
            submitted.append((t0, req))
        return submitted

    def submit_bulks() -> list:
        submitted = []
        for _ in range(BULKS):
            reqs = [batch_exec_factory("dist", "noop", 1)
                    for _ in range(BULK)]
            t0 = time.monotonic()
            accepted, retry = client.submit_functions_many(reqs)
            assert accepted, f"bulk shed (retry {retry})"
            submitted.extend((t0, req) for req in reqs)
        return submitted

    def submitter(ti: int) -> None:
        # Each thread calls on a client of its own: one shared client's
        # sync lock would queue a thread's call behind the others' whole
        # CALL_BATCH, before the planner stamps its admission
        sub = PlannerClient(cluster.client_host, cluster.planner_host)
        try:
            submitted = submit_bulks() if bulk else submit_each(sub)
            for t0, req in submitted:
                msg = client.get_message_result(
                    req.app_id, req.messages[0].id, timeout=90.0)
                per_thread[ti].append((msg, t0))
        except Exception as e:  # noqa: BLE001 — reported to the test
            errors.append(f"{ti}: {e!r}")
        finally:
            sub.close()

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    required = (PHASE_ADMIT, PHASE_QUEUE_EXIT, PHASE_SCHED, PHASE_DISPATCH,
                PHASE_EXEC_QUEUE_EXIT, PHASE_RUN_START, PHASE_RUN_END,
                PHASE_RESULT_PUSH, PHASE_RECORDED, PHASE_WAITER_WAKE)
    done = [row for rows in per_thread for row in rows]
    assert len(done) == N_THREADS * PER_THREAD
    for msg, _t0 in done:
        assert msg.return_value == int(ReturnValue.SUCCESS), msg.output_data
        missing = [p for p in required if p not in msg.lc]
        assert not missing, (missing, sorted(msg.lc))
        durations = ledger_durations(msg.lc)
        assert durations["run"] >= RUN_DELAY_S * 0.9, durations
    return done


@pytest.mark.chaos
@pytest.mark.slow
def test_dist_lifecycle_ledgers_span_their_invocations(lifecycle_cluster):
    """Every invocation's ledger spans at least 90% of its wall from the
    test's submit to the waiter's wake (the reference's bar). The ledger
    starts when the planner's ingress admits the call, so on a loaded
    machine the wait for a planner thread before it falls outside the
    ledger: this case needs an idle machine."""
    low_coverage = []
    for msg, t0 in lifecycle_load(lifecycle_cluster):
        wall = msg.lc[PHASE_WAITER_WAKE] / 1e9 - t0
        span = ledger_span_s(msg.lc)
        assert wall > 0
        if span < 0.9 * wall:
            low_coverage.append((msg.id, span, wall))
    assert not low_coverage, (
        f"{len(low_coverage)} invocation(s) under 90% ledger coverage: "
        f"{low_coverage[:5]}")


def test_dist_lifecycle_ledger_timeseries_slo_and_doctor(lifecycle_cluster):
    """Under the load of :func:`lifecycle_load`, ``run`` dominates the
    p99 on ``/healthz`` and the SLO burns, ``/metrics`` carries the
    lifecycle histograms and process gauges, the doctor names the
    dominant phase and the burn, the timeline renders one app's ledger,
    and ``/timeseries`` merges the workers' rings. (The ledgers' 90%
    coverage of their walls is the chaos case above.)"""
    from faabric_tpu_torch.runner.doctor import diagnose, fetch_live
    from faabric_tpu_torch.runner.timeline import (
        _msg_rows,
        fetch_status,
        render_text,
    )

    cluster = lifecycle_cluster
    base = cluster.http_url
    done = lifecycle_load(cluster)

    health = http_json(base, "/healthz")
    lifecycle = health["lifecycle"]
    assert lifecycle["count"] >= N_THREADS * PER_THREAD
    assert lifecycle["dominant_p99"][0]["phase"] == "run", \
        lifecycle["dominant_p99"][:3]
    slo = health["slo"]
    latency = [t for t in slo["targets"] if t["name"] == "p99_e2e_ms"][0]
    assert latency["burning"], latency
    error_t = [t for t in slo["targets"] if t["name"] == "error_rate"][0]
    assert not error_t["burning"], error_t

    metrics_text = http_text(base, "/metrics")
    assert "faabric_lifecycle_phase_seconds" in metrics_text
    assert 'phase="run"' in metrics_text
    assert "faabric_process_rss_bytes" in metrics_text
    assert "faabric_slo_burn_rate" in metrics_text

    findings = diagnose(fetch_live(base))
    dominant = [f for f in findings if f["kind"] == "dominant_phase"]
    assert dominant, [f["kind"] for f in findings]
    assert "'run'" in dominant[0]["subject"], dominant[0]
    assert any(f["kind"] == "slo_burn" for f in findings), \
        [f["kind"] for f in findings]

    app_id = done[-1][0].app_id
    rows = _msg_rows(fetch_status(base, app_id))
    assert rows, f"timeline found no ledgers for app {app_id}"
    text = render_text(app_id, rows)
    assert "run=" in text and "ingress_queue=" in text

    ts = http_json(base, "/timeseries")
    for host in ("lfw1", "lfw2"):
        series = (ts["hosts"].get(host) or {}).get("series") or {}
        assert series.get("proc_rss_bytes"), (host, sorted(series))


@pytest.mark.chaos
@pytest.mark.slow
def test_dist_lifecycle_bulk_load_run_dominates_p99(cluster_of):
    """The reference's own load, 120 apps in bulks of 10 through
    SUBMIT_BATCH, on a cluster of its own: ``run`` dominates the p99 on
    ``/healthz``, the SLO burns and the doctor names ``run``. With the
    bulks dispatched at once, a loaded machine can keep the apps in the
    workers' executor queues longer than the planted run, so this case
    needs an idle machine."""
    from faabric_tpu_torch.runner.doctor import diagnose, fetch_live

    cluster = cluster_of("lb", {"lbw1": 64, "lbw2": 64}, http=True,
                         extra_env=LIFECYCLE_ENV)
    base = cluster.http_url
    lifecycle_load(cluster, bulk=True)

    health = http_json(base, "/healthz")
    lifecycle = health["lifecycle"]
    assert lifecycle["count"] >= N_THREADS * PER_THREAD
    assert lifecycle["dominant_p99"][0]["phase"] == "run", \
        lifecycle["dominant_p99"][:3]
    latency = [t for t in health["slo"]["targets"]
               if t["name"] == "p99_e2e_ms"][0]
    assert latency["burning"], latency

    findings = diagnose(fetch_live(base))
    dominant = [f for f in findings if f["kind"] == "dominant_phase"]
    assert dominant, [f["kind"] for f in findings]
    assert "'run'" in dominant[0]["subject"], dominant[0]


@pytest.mark.chaos
@pytest.mark.slow
def test_dist_lifecycle_burst_fills_ingress_depth_series(lifecycle_cluster):
    """Phase B of the reference's case: 400 messages in one submit
    against 128 slots of 200 ms runs hold admission credits for over a
    second, so the planner's 50 ms sampler catches a nonzero
    ``ingress_depth`` series. Whether it does is the sampler's luck."""
    cluster = lifecycle_cluster
    base = cluster.http_url
    client = cluster.me.planner_client
    base_results = http_json(base, "/healthz")["resultsTotal"]
    reqs = [batch_exec_factory("dist", "noop", 1) for _ in range(BURST)]
    accepted, retry = client.submit_functions_many(reqs)
    assert accepted, f"burst shed (retry {retry})"
    deadline = time.time() + 120
    done = 0
    while time.time() < deadline:
        done = http_json(base, "/healthz")["resultsTotal"] - base_results
        if done >= BURST:
            break
        time.sleep(0.2)
    assert done >= BURST, f"burst incomplete: {done}/{BURST}"
    ts = http_json(base, "/timeseries")
    planner_series = (ts["hosts"].get("planner") or {}).get("series") or {}
    depth = planner_series.get("ingress_depth") or []
    assert depth, f"no ingress_depth series: {sorted(planner_series)}"
    assert max(v for _t, v in depth) > 0, depth[-10:]


def test_dist_flight_endpoints_and_flightdump_url(lifecycle_cluster):
    """The planner's and a worker's live flight rings, served on their
    endpoints, merge through ``flightdump --url``; the worker answers
    ``/metrics`` and ``/timeseries`` itself."""
    from faabric_tpu_torch.runner.flightdump import (
        fetch_live_rings,
        merge_dumps,
    )

    cluster = lifecycle_cluster
    base = cluster.http_url
    worker_base = cluster.worker_url("lfw1")

    planner_ring = http_json(base, "/flight")
    assert planner_ring["ring_size"] > 0
    # The SLO burn of the load case left a flight record
    kinds = {e["kind"] for e in planner_ring["events"]}
    assert "slo_burn" in kinds, sorted(kinds)

    worker_ring = http_json(worker_base, "/flight")
    assert worker_ring["process"].startswith("worker-")
    assert isinstance(worker_ring["events"], list)

    assert "faabric_process_rss_bytes" in http_text(worker_base, "/metrics")
    assert http_json(worker_base, "/timeseries")["series"].get(
        "proc_rss_bytes")

    dumps = fetch_live_rings([base, worker_base])
    assert len(dumps) == 2
    events = merge_dumps(dumps)
    assert any(e["kind"] == "slo_burn" for e in events)
    assert all(e.get("dump_reason") == "live" for e in events)


# ---------------------------------------------------------------------------
# tests/dist/test_profile.py:124
# ---------------------------------------------------------------------------

SPIN_S = 8.0


@pytest.mark.chaos
@pytest.mark.slow
def test_dist_profile_hotspot_attribution_and_doctor(cluster_of):
    """A worker spins in a planted frame with a lock convoy beside it,
    sampled every 10 ms: the merged ``/profile`` ranks the frame first
    on that host and the ``executor/pool`` class, the host's GIL gauge
    reads hot and the other's calm, and the doctor raises
    ``cpu_hotspot`` and ``gil_saturation`` on that host alone."""
    from faabric_tpu_torch.runner.doctor import diagnose, fetch_live

    cluster = cluster_of("pf", {"pf1": 4, "pf2": 4}, http=True,
                         extra_env={"FAABRIC_METRICS": "1",
                                    "FAABRIC_PROFILE_INTERVAL_MS": "10"})
    me = cluster.me
    base = cluster.http_url
    req = batch_exec_factory("dist", "profile_spin", 1)
    req.messages[0].input_data = str(SPIN_S).encode()
    me.planner_client.call_functions(req)
    time.sleep(SPIN_S * 0.75)

    doc = http_json(base, "/profile")
    findings = diagnose(fetch_live(base))

    r = me.planner_client.get_message_result(
        req.app_id, req.messages[0].id, timeout=30.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    host = r.executed_host
    assert host in ("pf1", "pf2"), host
    idle = "pf2" if host == "pf1" else "pf1"

    assert doc["stacks"], doc
    top = doc["stacks"][0]
    assert top["rank"] == 1
    assert top["host"] == host, (top, host)
    assert top["class"] == "executor/pool", top
    assert any("_planted_profile_burn" in f for f in top["frames"]), top
    assert top["cpu_ms"] > 500.0, top
    for h in (host, idle):
        assert doc["hosts"][h]["samples"] >= 50, doc["hosts"]
    assert doc["gil"][host]["pressure"] >= 0.25, doc["gil"]
    assert doc["gil"][host]["runnable_avg"] >= 0.5, doc["gil"]
    assert doc["gil"][idle]["runnable_avg"] < 0.5, doc["gil"]

    hot = [f for f in findings if f["kind"] == "cpu_hotspot"]
    assert any(host in f["subject"] and "executor/pool" in f["subject"]
               for f in hot), (hot, findings[:6])
    gil = [f for f in findings if f["kind"] == "gil_saturation"]
    assert any(host in f["subject"] for f in gil), (gil, findings[:6])
    for f in findings:
        if f["kind"] in ("cpu_hotspot", "gil_saturation",
                         "sampler_starved"):
            assert idle not in f["subject"], f
