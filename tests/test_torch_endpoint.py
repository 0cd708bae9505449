"""The port's planner REST endpoint and worker endpoint against the JAX
package's.

Counterparts of the REST cases of
``tests/unit/test_endpoint_and_migration.py`` (``:250`` hosts, config
and policy; ``:267`` a batch through EXECUTE_BATCH, its status and its
exec graph; ``:296`` in-flight apps and eviction; ``:310`` ``/metrics``
and ``/trace``; ``:355`` ``/topology``; ``:381`` bad requests) and its
elastic scale hint (``:203``) on a port planner and two
``WorkerRuntime``s in one process, with the reference's assertions;
then a decision preloaded through PRELOAD_SCHEDULING_DECISION placing
an EXECUTE_BATCH where it says, and a shed EXECUTE_BATCH answered 429
with ``Retry-After`` over HTTP. The worker endpoint's cases of
``tests/unit/test_aux.py`` (``:292``, ``:362``) follow, then the
cross-package check: one collected-telemetry document, built from both
packages' registries fed the same seeded events, handed to each
package's ``PlannerHttpEndpoint`` through a stub planner, gives equal
``/metrics``, ``/trace``, ``/commmatrix``, ``/perf``, ``/statemap`` and
``/profile``. Every cluster takes a conftest slot through
``port_slot()``, off the slots whose bases the reference's
``tests/dist/test_multiprocess.py`` binds by fixed aliases, and every
endpoint binds a port of its slot.
"""

import copy
import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from faabric_tpu_torch.endpoint import HttpMessageType, PlannerHttpEndpoint
from tests.test_torch_migration import (
    PORT_PK,
    Cluster,
    factory_of,
    gate_executor,
    wait_for_recovery_threads,
)
from tests.test_torch_multiprocess import HTTP_PORT, port_slot


@pytest.fixture(autouse=True)
def _isolate():
    yield
    pk = PORT_PK
    pk.testing.set_mock_mode(False)
    pk.common.clear_host_aliases()
    pk.planner.get_planner().reset()
    pk.executor.set_executor_factory(None)
    pk.batch_scheduler.reset_batch_scheduler()
    pk.config.get_system_config().reset()
    wait_for_recovery_threads()


@pytest.fixture
def cluster():
    """The reference test's cluster on the port: a planner and hostA and
    hostB (4 slots, 4 devices each) with its gate guests, and the
    endpoint on the slot's own port; yields (workers, port)."""
    gate = gate_executor(PORT_PK)
    base = port_slot()
    PORT_PK.batch_scheduler.reset_batch_scheduler("bin-pack")
    with Cluster(PORT_PK, base, factory_of(PORT_PK, gate)) as c:
        ep = PlannerHttpEndpoint(port=base + HTTP_PORT)
        ep.start()
        try:
            yield c.workers, ep.port, gate
        finally:
            gate.gate.set()
            gate.blocker_gate.set()
            ep.stop()


def post(port, http_type, payload=""):
    body = json.dumps({"http_type": int(http_type),
                       "payload": payload}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=body,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        assert resp.status == 200
        return resp.headers["Content-Type"], resp.read().decode()


def finish(worker, req, timeout=15.0):
    for m in req.messages:
        r = worker.planner_client.get_message_result(req.app_id, m.id,
                                                     timeout=timeout)
        assert r.return_value == 0, r.output_data


def test_rest_hosts_config_policy(cluster):
    _, port, _ = cluster
    status, out = post(port, HttpMessageType.GET_AVAILABLE_HOSTS)
    assert status == 200
    assert {h["ip"] for h in out["hosts"]} == {"hostA", "hostB"}

    status, out = post(port, HttpMessageType.GET_CONFIG)
    assert status == 200 and "hostTimeout" in out

    status, out = post(port, HttpMessageType.GET_POLICY)
    assert out["policy"] == "bin-pack"
    status, out = post(port, HttpMessageType.SET_POLICY, "compact")
    assert status == 200 and out["policy"] == "compact"
    status, _ = post(port, HttpMessageType.SET_POLICY, "nonsense")
    assert status == 400
    post(port, HttpMessageType.SET_POLICY, "bin-pack")


def test_rest_batch_status_exec_graph_and_flushes(cluster):
    """The second half of ``:267`` (a batch's status and its exec graph)
    for a batch submitted through ``call_functions``; then the FLUSHes
    and RESET."""
    workers, port, _ = cluster
    w = workers["hostA"]
    req = PORT_PK.proto.batch_exec_factory("demo", "echo", 4)
    for m in req.messages:
        m.input_data = b"abc"
    w.planner_client.call_functions(req)
    finish(w, req)
    status, out = post(port, HttpMessageType.EXECUTE_BATCH_STATUS,
                       json.dumps({"app_id": req.app_id}))
    assert status == 200 and out["finished"]
    assert len(out["messageResults"]) == 4
    assert all(m["return_value"] == 0 for m in out["messageResults"])
    assert all(m["output_data"] for m in out["messageResults"])

    status, graph = post(
        port, HttpMessageType.GET_EXEC_GRAPH,
        json.dumps({"app_id": req.app_id, "id": req.messages[0].id}))
    assert status == 200
    assert graph["root"]["msg"]["id"] == req.messages[0].id

    status, out = post(port, HttpMessageType.FLUSH_EXECUTORS)
    assert status == 200 and sorted(out["hosts"]) == ["hostA", "hostB"]
    status, out = post(port, HttpMessageType.FLUSH_AVAILABLE_HOSTS)
    assert status == 200
    assert post(port, HttpMessageType.GET_AVAILABLE_HOSTS)[1]["hosts"] == []
    assert post(port, HttpMessageType.RESET) == (200, {"status": "reset"})


def test_rest_preloaded_decision_places_execute_batch(cluster):
    """A decision preloaded through PRELOAD_SCHEDULING_DECISION places
    the app's EXECUTE_BATCH where it says (one message a host, against
    bin-pack's both on one), and the planner drops it once the app
    completes."""
    workers, port, _ = cluster
    req = PORT_PK.proto.batch_exec_factory("demo", "echo", 2)
    decision = PORT_PK.batch_scheduler.SchedulingDecision(req.app_id, 0)
    for m, host in zip(req.messages, ("hostB", "hostA")):
        decision.add_message(host, m.id, m.app_idx, m.app_idx)
    status, out = post(port, HttpMessageType.PRELOAD_SCHEDULING_DECISION,
                       json.dumps(decision.to_dict()))
    assert (status, out) == (200, {"status": "preloaded",
                                   "appId": req.app_id})
    status, out = post(port, HttpMessageType.EXECUTE_BATCH,
                       json.dumps(req.to_dict()))
    assert status == 200, out
    assert out["hosts"] == ["hostB", "hostA"]
    assert out["messageIds"] == [m.id for m in req.messages]
    finish(workers["hostA"], req)
    planner = PORT_PK.planner.get_planner()
    with planner._lock:
        assert req.app_id not in planner._preloaded


def test_rest_execute_batch_and_status(cluster):
    """``:267``: a batch through EXECUTE_BATCH (the ingress's immediate
    path), polled to its end with EXECUTE_BATCH_STATUS, then its exec
    graph."""
    _, port, _ = cluster
    req = PORT_PK.proto.batch_exec_factory("demo", "echo", 4)
    for m in req.messages:
        m.input_data = b"abc"
    status, out = post(port, HttpMessageType.EXECUTE_BATCH,
                       json.dumps(req.to_dict()))
    assert status == 200
    assert out["appId"] == req.app_id
    assert len(out["hosts"]) == 4

    deadline = time.time() + 30
    while time.time() < deadline:
        status, out = post(port, HttpMessageType.EXECUTE_BATCH_STATUS,
                           json.dumps({"app_id": req.app_id}))
        if out.get("finished"):
            break
        time.sleep(0.05)
    assert out["finished"]
    assert len(out["messageResults"]) == 4
    assert all(m["return_value"] == 0 for m in out["messageResults"])

    status, graph = post(
        port, HttpMessageType.GET_EXEC_GRAPH,
        json.dumps({"app_id": req.app_id, "id": req.messages[0].id}))
    assert status == 200
    assert graph["root"]["msg"]["id"] == req.messages[0].id
    ingress = PORT_PK.planner.get_planner().health_summary()["ingress"]
    assert ingress["admittedTotal"] >= 4 and ingress["immediateTotal"] >= 1


def test_rest_execute_batch_shed_answers_429_with_retry_after(
        cluster, monkeypatch):
    """Over HTTP: a batch larger than the admission queue's bound is
    shed with 429 and a ``Retry-After`` header, and runs nothing."""
    from faabric_tpu_torch.ingress import AdmissionController

    _, port, _ = cluster
    planner = PORT_PK.planner.get_planner()
    monkeypatch.setattr(planner.ingress, "admission",
                        AdmissionController(queue_max=1,
                                            source_credits=100))
    req = PORT_PK.proto.batch_exec_factory("tenant", "echo", 2)
    body = json.dumps({"http_type": int(HttpMessageType.EXECUTE_BATCH),
                       "payload": json.dumps(req.to_dict())}).encode()
    http_req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                      data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(http_req, timeout=10)
    assert err.value.code == 429
    assert int(err.value.headers["Retry-After"]) >= 1
    out = json.loads(err.value.read())
    assert out["retryAfterSeconds"] > 0 and "queue" in out["reason"]
    assert planner.health_summary()["ingress"]["shedTotal"] == 2
    assert planner.get_in_flight_apps() == {}


def test_elastic_scale_hint_fills_main_host(cluster):
    """``:203``: an OpenMP-style fork asks for one message with the
    elastic hint and grows to every free slot of its main host."""
    workers, _, gate = cluster
    w = workers["hostA"]
    # The parent stays in flight (gated) while it forks
    req = PORT_PK.proto.batch_exec_factory("demo", "gated", 1)
    req.messages[0].main_host = "hostB"
    d1 = w.planner_client.call_functions(req)
    main_host = d1.hosts[0]
    req.messages[0].main_host = main_host

    scale = PORT_PK.proto.batch_exec_factory("demo", "echo", 1)
    scale.app_id = req.app_id
    scale.elastic_scale_hint = True
    scale.messages[0].main_host = main_host
    d = w.planner_client.call_functions(scale)
    # Grew past the one message asked for, to the main host's 3 free
    # slots, all on the main host
    assert d.n_messages == 3 and set(d.hosts) == {main_host}
    gate.gate.set()
    for m in req.messages:
        w.planner_client.get_message_result(req.app_id, m.id, timeout=15.0)
    status = PORT_PK.planner.get_planner().get_batch_results(req.app_id)
    assert status.expected_num_messages == 4


def test_rest_in_flight_and_evict(cluster):
    _, port, _ = cluster
    status, out = post(port, HttpMessageType.GET_IN_FLIGHT_APPS)
    assert status == 200
    assert out["numMigrations"] == 0

    status, out = post(port, HttpMessageType.SET_NEXT_EVICTED_VM, "hostB")
    assert status == 200 and out["nextEvictedVmIps"] == ["hostB"]
    status, out = post(port, HttpMessageType.GET_IN_FLIGHT_APPS)
    assert out["nextEvictedVmIps"] == ["hostB"]

    status, out = post(port, HttpMessageType.FLUSH_SCHEDULING_STATE)
    assert status == 200


def test_rest_metrics_and_trace(cluster):
    """GET /metrics serves Prometheus-parseable text over every
    registered host's registry; GET /trace serves a Chrome trace."""
    from faabric_tpu_torch.telemetry import set_tracing, span

    workers, port, _ = cluster
    w = workers["hostA"]
    req = PORT_PK.proto.batch_exec_factory("demo", "echo", 2)
    assert len(w.planner_client.call_functions(req).hosts) == 2
    finish(w, req)
    set_tracing(True)
    try:
        with span("test", "rest_trace_probe", n=1):
            pass
        _, body = get(port, "/trace")
        trace = json.loads(body)
    finally:
        set_tracing(False)
    assert any(e.get("name") == "rest_trace_probe"
               for e in trace["traceEvents"])

    ctype, text = get(port, "/metrics")
    assert ctype.startswith("text/plain")
    sample_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9.eE+-]+$')
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    assert lines
    for line in lines:
        assert sample_re.match(line), f"unparseable: {line!r}"
    # One process, one registry: every registered host (and the planner)
    # appears as a host label over it
    for host in ("hostA", "hostB", "planner"):
        assert f'host="{host}"' in text
    assert "faabric_transport_tx_bytes_total" in text
    assert "faabric_planner_schedule_seconds_bucket" in text


def test_rest_topology_scrape(cluster):
    """GET /topology: per-host capacity and the topology of every
    in-flight MPI world."""
    workers, port, gate = cluster
    req = PORT_PK.proto.batch_exec_factory("demo", "blocker", 4)
    for m in req.messages:
        m.is_mpi = True
    workers["hostA"].planner_client.call_functions(req)
    try:
        _, body = get(port, "/topology")
        topo = json.loads(body)
        assert set(topo["hosts"]) == {"hostA", "hostB"}
        assert all(h["slots"] == 4 for h in topo["hosts"].values())
        world = topo["worlds"][str(req.app_id)]
        # Gang-scheduled: the 4 ranks on one host
        assert world["size"] == 4 and world["n_hosts"] == 1
        assert len(world["leaders"]) == 1
        assert not world["hierarchical"]
    finally:
        gate.blocker_gate.set()
    finish(workers["hostA"], req)


def test_rest_bad_requests(cluster):
    _, port, _ = cluster
    status, out = post(port, HttpMessageType.EXECUTE_BATCH, "{}")
    assert status == 400
    status, out = post(port, 99)
    assert status == 500 or status == 400


def test_rest_get_surfaces_answer_and_parse(cluster):
    """Every GET surface answers 200 with its document; an unknown path
    says the endpoint runs."""
    workers, port, _ = cluster
    health = json.loads(get(port, "/healthz")[1])
    assert {h["host"] for h in health["hosts"]} == {"hostA", "hostB"}
    assert all(h["breaker"] is None or "state" in h["breaker"]
               for h in health["hosts"])
    assert health["journal"] == {"enabled": False}
    for path, key in (("/perf", "links"), ("/statemap", "keys"),
                      ("/profile", "stacks"), ("/timeseries", "hosts"),
                      ("/flight", "events"), ("/commmatrix", "total")):
        doc = json.loads(get(port, path)[1])
        assert key in doc, (path, sorted(doc))
    assert json.loads(get(port, "/nothing")[1]) == {"status": "running"}


def test_endpoint_binds_loopback_unless_an_interface_is_named(monkeypatch):
    assert PlannerHttpEndpoint(port=1).host == "127.0.0.1"
    monkeypatch.setenv("ENDPOINT_INTERFACE", "0.0.0.0")
    PORT_PK.config.get_system_config().reset()
    assert PlannerHttpEndpoint(port=1).host == "0.0.0.0"
    assert PlannerHttpEndpoint(port=1, host="127.0.0.2").host == "127.0.0.2"


def test_endpoint_settings_match_the_reference(monkeypatch):
    from faabric_tpu.util.config import SystemConfig as RefConfig

    from faabric_tpu_torch.util.config import SystemConfig

    fields = ("endpoint_interface",)
    for env in ({}, {"ENDPOINT_INTERFACE": "0.0.0.0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ref, port = RefConfig(), SystemConfig()
        ref.reset()
        port.reset()
        assert ({f: getattr(port, f) for f in fields}
                == {f: getattr(ref, f) for f in fields})


# ---------------------------------------------------------------------------
# The worker endpoint (tests/unit/test_aux.py:292, :362)
# ---------------------------------------------------------------------------

def test_worker_endpoint_rejects_everything():
    """The worker's HTTP surface turns direct requests away, as the
    reference's does: the planner owns the REST API."""
    from faabric_tpu_torch.endpoint import WorkerHttpEndpoint

    port = port_slot() + HTTP_PORT
    ep = WorkerHttpEndpoint(port)
    ep.start()
    try:
        for method, data in (("GET", None), ("POST", b"{}")):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                         data=data, method=method)
            try:
                urllib.request.urlopen(req, timeout=5)
                raise AssertionError("expected 403")
            except urllib.error.HTTPError as e:
                assert e.code == 403
                assert "planner" in json.loads(e.read())["error"]
    finally:
        ep.stop()


def test_worker_endpoint_healthz_and_bind_collision():
    """GET /healthz answers locally; a second endpoint on the same port
    (two workers of one machine sharing WORKER_HTTP_PORT) logs a warning
    and stays off, and never fails the worker's start."""
    from faabric_tpu_torch.endpoint import WorkerHttpEndpoint

    port = port_slot() + HTTP_PORT
    ep = WorkerHttpEndpoint(port)
    ep.start()
    try:
        body = json.loads(get(port, "/healthz")[1])
        assert body["status"] == "ok"
        assert body["uptimeSeconds"] >= 0
        # The worker's own scrape surfaces
        assert "faabric_process" in get(port, "/metrics")[1]
        for path in ("/timeseries", "/flight", "/profile"):
            json.loads(get(port, path)[1])

        rival = WorkerHttpEndpoint(port)
        rival.start()  # EADDRINUSE: off, not raised
        assert rival._server is None
        rival.stop()  # a no-op
    finally:
        ep.stop()


def test_worker_runtime_serves_its_endpoint_at_worker_http_port(monkeypatch):
    """``WORKER_HTTP_PORT`` makes a ``WorkerRuntime`` serve its endpoint
    while it runs, with its identity in ``/healthz``."""
    base = port_slot()
    monkeypatch.setenv("WORKER_HTTP_PORT", str(base + 1000 + HTTP_PORT))
    gate = gate_executor(PORT_PK)
    with Cluster(PORT_PK, base, factory_of(PORT_PK, gate)) as c:
        body = json.loads(get(base + 1000 + HTTP_PORT, "/healthz")[1])
        assert body["host"] == "hostA" and body["slots"] == 4
        # hostB's endpoint lost the port to hostA's and stayed off
        assert c.workers["hostB"].http_endpoint._server is None
    with pytest.raises(OSError):
        get(base + 1000 + HTTP_PORT, "/healthz")


# ---------------------------------------------------------------------------
# Cross-package: the same collected telemetry through both endpoints
# ---------------------------------------------------------------------------

def _registry_blocks(pkg: str, seed: int) -> dict:
    """A host's metrics and comm-matrix blocks from ``pkg``'s own
    registry and matrix, fed events drawn from ``seed``."""
    import importlib

    metrics = importlib.import_module(f"{pkg}.telemetry.metrics")
    commmatrix = importlib.import_module(f"{pkg}.telemetry.commmatrix")
    rng = np.random.default_rng(seed)
    reg = metrics.MetricsRegistry()
    for i in range(6):
        reg.counter("faabric_transport_tx_bytes_total", "bytes sent",
                    plane=str(rng.choice(["ptp", "rpc", "state"])),
                    peer=f"p{i % 3}").inc(int(rng.integers(1, 1 << 30)))
    reg.gauge("faabric_planner_in_flight_apps", "apps").set(
        int(rng.integers(0, 9)))
    hist = reg.histogram("faabric_planner_schedule_seconds", "latency")
    for v in rng.exponential(0.01, 40):
        hist.observe(float(v))
    cm = commmatrix.CommMatrix(max_ranks=16)
    for _ in range(30):
        src, dst = (int(x) for x in rng.integers(0, 8, 2))
        plane = str(rng.choice(["ptp", "bulk-tcp", "shm"]))
        nbytes = int(rng.integers(1, 1 << 24))
        codec = str(rng.choice(["raw", "delta"]))
        cm.record(src, dst, plane, nbytes, float(rng.exponential(0.001)),
                  raw_bytes=nbytes * (4 if codec == "delta" else 1),
                  codec=codec)
    return {"metrics": reg.snapshot(), "commmatrix": cm.snapshot()}


def _trace(seed: int, pid: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"name": str(rng.choice(["allreduce", "send", "call_batch"])),
             "cat": str(rng.choice(["mpi", "ptp", "planner"])), "ph": "X",
             "ts": float(1e6 + 10 * i), "dur": float(rng.integers(1, 9)),
             "pid": pid, "tid": int(rng.integers(1, 4)),
             "args": {"bytes": int(rng.integers(0, 1 << 20))}}
            for i in range(12)]


def _collected(monkeypatch) -> dict:
    """host → blocks: the planner's and w1's from the port's registries
    and stores, w2's from the reference's, on the same seeded events;
    every host shares pid 1, as processes in containers do."""
    from tests.test_torch_perfprofile import _rounds, _SteppedClock
    from tests.test_torch_profiler import _row, _snap
    from tests.test_torch_statestats import _planted_tel

    rng = np.random.default_rng(5)
    obs = [(str(h), str(plane), int(nb), float(sec))
           for h, plane, nb, sec in zip(
               rng.choice(["w1", "w2"], 60),
               rng.choice(["bulk-tcp", "shm", "ptp"], 60),
               rng.integers(1 << 10, 64 << 20, 60),
               rng.exponential(0.01, 60))]
    rounds = _rounds(np.random.default_rng(6), n_rounds=20, n_ranks=4)
    states = _planted_tel()
    profiles = {
        "planner": _snap([_row("planner/tick", ["a (p/q.py:1)",
                                                "b (p/q.py:2)"], 90, 900.0)]),
        "w1": _snap([_row("executor/pool", ["d (p/q.py:4)"], 40, 400.0),
                     _row("main", ["c (p/q.py:3)"], 10, 50.0)],
                    pressure=0.5),
        "w2": {},
    }

    def perf_block(pkg, host):
        import importlib

        pp = importlib.import_module(f"{pkg}.telemetry.perfprofile")
        monkeypatch.setattr(pp, "time", _SteppedClock())
        store = pp.PerfProfileStore(half_life=1e9)
        prof = pp.CollectiveProfiler(window=64)
        for dst, plane, nb, sec in obs:
            if dst != host:
                store.observe(dst, plane, nb, sec)
        for i, rd in sorted(rounds.items()):
            for r, phases in rd.items():
                if (r < 2) == (host == "w1"):
                    for ph in ("enter_ts", "intra", "leader",
                               "redistribute"):
                        prof.record_phase(9, "allreduce", r, ph, phases[ph])
                    prof.record_phase(9, "allreduce", r, "total",
                                      phases["total"], 1 << 20)
        return {"links": store.snapshot(), "collectives": prof.snapshot()}

    tel = {}
    for seed, (host, pkg) in enumerate((("planner", "faabric_tpu_torch"),
                                        ("w1", "faabric_tpu_torch"),
                                        ("w2", "faabric_tpu"))):
        blocks = _registry_blocks(pkg, seed)
        # The same events give both packages the same blocks
        other = "faabric_tpu" if pkg != "faabric_tpu" else "faabric_tpu_torch"
        assert _registry_blocks(other, seed) == blocks
        blocks["perf"] = perf_block(pkg, host)
        blocks["statestats"] = (states.get({"w1": "hA", "w2": "hB"}.get(host))
                                or {}).get("statestats", {})
        blocks["profile"] = profiles[host]
        blocks["trace"] = _trace(100 + seed, pid=1)
        tel[host] = blocks
    return tel


class StubPlanner:
    """Answers what the endpoint asks the planner from a fixed
    collected-telemetry document."""

    def __init__(self, tel: dict, placement: dict):
        self.tel = tel
        self.placement = placement
        self.noted = []

    def collect_telemetry(self, include_trace=False, timeout=5.0,
                          blocks=None):
        out = {}
        for host, t in copy.deepcopy(self.tel).items():
            row = {k: v for k, v in t.items() if k != "trace"
                   and (blocks is None or k in blocks)}
            if include_trace:
                row["trace"] = t["trace"]
            out[host] = row
        return out

    def note_perf_aggregation(self, doc):
        self.noted.append(doc)

    def state_placement(self):
        return copy.deepcopy(self.placement)


def test_endpoint_outputs_equal_reference_on_one_document(monkeypatch):
    from faabric_tpu.endpoint import PlannerHttpEndpoint as RefEndpoint

    monkeypatch.delenv("FAABRIC_PERF_PROFILE_DIR", raising=False)
    tel = _collected(monkeypatch)
    placement = {"demo/hot": {"master": "hA", "backup": "hB", "epoch": 2}}
    port_ep = PlannerHttpEndpoint(port=1, planner=StubPlanner(tel, placement))
    ref_ep = RefEndpoint(port=1, planner=StubPlanner(tel, placement))

    def doc(text):
        d = json.loads(text)
        d.pop("generated_at", None)
        return d

    assert port_ep.metrics_text() == ref_ep.metrics_text()
    assert 'host="w2"' in port_ep.metrics_text()
    assert port_ep.trace_json() == ref_ep.trace_json()
    # Equal pids were renumbered per host
    assert len({e["pid"] for e in doc(port_ep.trace_json())[
        "traceEvents"]}) == 3
    assert port_ep.commmatrix_json() == ref_ep.commmatrix_json()
    perf = doc(port_ep.perf_json())
    assert perf == doc(ref_ep.perf_json())
    assert perf["links"] and port_ep.planner.noted
    assert doc(port_ep.statemap_json()) == doc(ref_ep.statemap_json())
    assert doc(port_ep.profile_json()) == doc(ref_ep.profile_json())
