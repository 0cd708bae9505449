"""Recovery requeues and cross-host group aborts: the port against the
JAX package.

Counterparts of ``tests/unit/test_faults.py``'s recovery cases
(:302-475: requeue onto a survivor, budget exhaustion, MPI never
requeued, an MPI app found from any message, late results win), each on
a fresh planner of each package in mock mode with the reference's
``PLANNER_REQUEUE_BACKOFF=0.01``, both packages required to reach the
same outcome; a failed THREADS snapshot push requeued onto a host that
can take the snapshot; the abort relay (:565-700: the relay when a peer
is unreachable, the relay RPC reaching a far-side broker, twice: the
port's client and the reference's client to the port's planner, which
proves the wire frame; a synthetic failure never overwriting a genuine
result); a watched recv whose sender's host refuses connections; and
``chip_smoke.py``'s phase 24 (c) and (d) at a small width on the CPU.
Every wait polls to a deadline.
"""

import copy
import importlib
import threading
import time
import types

import pytest
import torch

pytest.importorskip("jax")

REF, PORT = "faabric_tpu", "faabric_tpu_torch"


def pkg(name: str) -> types.SimpleNamespace:
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in {
        "planner": "planner", "planner_mod": "planner.planner",
        "planner_client": "planner.client", "proto": "proto",
        "common": "transport.common", "ptp": "transport.point_to_point",
        "ptp_remote": "transport.ptp_remote", "decision":
        "batch_scheduler.decision", "testing": "util.testing",
        "config": "util.config"}.items()}
    return types.SimpleNamespace(name=name, **mods)


REF_PK, PORT_PK = pkg(REF), pkg(PORT)
BOTH = pytest.mark.parametrize("pk", [REF_PK, PORT_PK],
                               ids=["reference", "port"])


def wait_for_recovery_threads(timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(t.name.startswith("planner/recover@")
                   for t in threading.enumerate()):
            return
        time.sleep(0.02)


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.setenv("PLANNER_REQUEUE_BACKOFF", "0.01")
    for pk in (REF_PK, PORT_PK):
        pk.config.get_system_config().reset()
    yield
    wait_for_recovery_threads()
    for pk in (REF_PK, PORT_PK):
        pk.testing.set_mock_mode(False)
        pk.common.clear_host_aliases()
        pk.planner.get_planner().reset()
    monkeypatch.delenv("PLANNER_REQUEUE_BACKOFF")
    for pk in (REF_PK, PORT_PK):
        pk.config.get_system_config().reset()


def fresh_planner(pk, **env):
    """A planner of its own, in mock mode, with ``env`` read into the
    package's config."""
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        pk.config.get_system_config().reset()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    pk.testing.set_mock_mode(True)
    return pk.planner_mod.Planner()


def poll(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def expire(planner, ip):
    with planner._lock:
        planner._hosts[ip].register_ts -= 10_000
    planner.expire_hosts()


def two_hosts(planner, a=4, b=4):
    planner.register_host("hA", a)
    planner.register_host("hB", b)


# ---------------------------------------------------------------------------
# tests/unit/test_faults.py:302-475 on both packages
# ---------------------------------------------------------------------------

def survivor_flow(pk) -> dict:
    planner = fresh_planner(pk)
    two_hosts(planner)
    req = pk.proto.batch_exec_factory("ft", "echo", 8)
    decision = planner.call_batch(req)
    dead = [decision.message_ids[i] for i, h in enumerate(decision.hosts)
            if h == "hB"]
    planner.register_host("hA", 8)  # the keep-alive grows hA
    expire(planner, "hB")
    assert poll(lambda: (lambda d: d is not None and set(d.hosts) == {"hA"}
                         and d.n_messages == 8)(
        planner.get_scheduling_decision(req.app_id)))
    moved = planner.get_scheduling_decision(req.app_id)
    with planner._lock:
        return {"first": sorted(decision.hosts), "n_dead": len(dead),
                "moved": sorted(moved.hosts),
                "same_ids": sorted(moved.message_ids)
                == sorted(decision.message_ids),
                "results": len(planner._results.get(req.app_id, {})),
                "attempts": planner._requeue_attempts.get(req.app_id),
                "used_hA": planner._hosts["hA"].state.used_slots}


def budget_flow(pk) -> dict:
    planner = fresh_planner(pk, PLANNER_MAX_REQUEUES="0")
    two_hosts(planner)
    req = pk.proto.batch_exec_factory("ft", "echo", 8)
    decision = planner.call_batch(req)
    dead = {decision.message_ids[i] for i, h in enumerate(decision.hosts)
            if h == "hB"}
    expire(planner, "hB")
    assert poll(lambda: dead <= set(planner._results.get(req.app_id, {})))
    results = planner._results[req.app_id]
    return {"n_dead": len(dead),
            "failed": sorted((results[m].return_value,
                              results[m].output_data) for m in dead)}


def mpi_flow(pk, root_is_mpi: bool) -> dict:
    planner = fresh_planner(pk)
    two_hosts(planner, 8 if not root_is_mpi else 4,
              8 if not root_is_mpi else 4)
    req = pk.proto.batch_exec_factory("ft", "mpi", 8)
    for m in (req.messages if root_is_mpi else req.messages[1:]):
        m.is_mpi = True
    decision = planner.call_batch(req)
    dead = {decision.message_ids[i] for i, h in enumerate(decision.hosts)
            if h == "hB"}
    if not dead:
        return {"hosts": sorted(decision.hosts)}
    expire(planner, "hB")
    assert poll(lambda: dead <= set(planner._results.get(req.app_id, {})))
    results = planner._results[req.app_id]
    with planner._lock:
        attempts = planner._requeue_attempts.get(req.app_id)
    return {"hosts": sorted(decision.hosts), "n_dead": len(dead),
            "failed": sorted((results[m].return_value,
                              results[m].output_data) for m in dead),
            "attempts": attempts}


def late_result_flow(pk) -> dict:
    planner = fresh_planner(pk, PLANNER_REQUEUE_BACKOFF="0.3")
    two_hosts(planner)
    req = pk.proto.batch_exec_factory("ft", "echo", 8)
    decision = planner.call_batch(req)
    dead_ids = [decision.message_ids[i] for i, h in
                enumerate(decision.hosts) if h == "hB"]
    planner.register_host("hA", 8)
    expire(planner, "hB")
    late = next(m for m in req.messages if m.id == dead_ids[0])
    late.return_value = int(pk.proto.ReturnValue.SUCCESS)
    late.output_data = b"late but real"
    planner.set_message_result(late)
    assert poll(lambda: (lambda d: d is not None and set(d.hosts) == {"hA"}
                         and d.n_messages == 7)(
        planner.get_scheduling_decision(req.app_id)))
    live = planner.get_scheduling_decision(req.app_id)
    return {"late": planner._results[req.app_id][late.id].output_data,
            "n_live": live.n_messages, "live_hosts": sorted(set(live.hosts)),
            "n_results": len(planner._results[req.app_id])}


def snapshot_push_flow(pk) -> dict:
    """A THREADS sub-batch whose host cannot be given the main thread's
    snapshot is requeued, and lands on a host that can."""
    planner = fresh_planner(pk)
    planner.register_host("hA", 4)
    planner.register_host("hB", 2)
    failed_once = []

    def push(req, host):
        if host == "hB" and not failed_once:
            failed_once.append(host)
            return False
        return True

    planner._push_snapshot_for_threads = push
    req = pk.proto.batch_exec_factory("ft", "threads", 6)
    req.type = int(pk.proto.BatchExecuteType.THREADS)
    req.snapshot_key = "ft/threads"
    for i, m in enumerate(req.messages):
        m.group_idx = i
        m.main_host = "main"
    decision = planner.call_batch(req)
    on_b = sorted(m for m, h in zip(decision.message_ids, decision.hosts)
                  if h == "hB")
    # The requeued slice took a budget unit and was placed again
    assert poll(lambda: planner._requeue_attempts.get(req.app_id) == 1)
    live = planner.get_scheduling_decision(req.app_id)
    with planner._lock:
        return {"first": sorted(decision.hosts), "n_on_b": len(on_b),
                "live_n": live.n_messages,
                "same_ids": sorted(live.message_ids)
                == sorted(decision.message_ids),
                "results": len(planner._results.get(req.app_id, {})),
                "used": sorted((ip, h.state.used_slots)
                               for ip, h in planner._hosts.items())}


def synthetic_failure_flow(pk) -> dict:
    planner = fresh_planner(pk)
    planner.register_host("hA", 8)
    req = pk.proto.batch_exec_factory("ft", "echo", 2)
    decision = planner.call_batch(req)
    victim = next(m for m in req.messages if m.id == decision.message_ids[0])
    synthetic = copy.deepcopy(victim)
    victim.return_value = int(pk.proto.ReturnValue.SUCCESS)
    victim.output_data = b"slow but alive"
    planner.set_message_result(victim)
    synthetic.return_value = int(pk.proto.ReturnValue.FAILED)
    synthetic.output_data = b"Host expired"
    planner.set_message_result(synthetic)  # first write wins: ignored
    planner._fail_messages([synthetic], b"Host expired")  # also ignored
    stored = planner.get_message_result(req.app_id, victim.id)
    return {"stored": (stored.return_value, stored.output_data)}


FLOWS = {
    "requeue_onto_survivor": survivor_flow,
    "budget_exhaustion_fails_terminally": budget_flow,
    "mpi_not_requeued": lambda pk: mpi_flow(pk, True),
    "mpi_app_found_from_any_message": lambda pk: mpi_flow(pk, False),
    "late_results_win": late_result_flow,
    "failed_snapshot_push_requeues": snapshot_push_flow,
    "synthetic_failure_never_overwrites_genuine": synthetic_failure_flow,
}


@pytest.mark.parametrize("name", list(FLOWS))
def test_recovery_matches_reference(name):
    ref = FLOWS[name](REF_PK)
    wait_for_recovery_threads()
    REF_PK.testing.set_mock_mode(False)
    port = FLOWS[name](PORT_PK)
    assert port == ref


def test_recovery_outcomes_are_the_reference_tests():
    """The reference tests' own assertions, on the port's outcomes."""
    fail = int(PORT_PK.proto.ReturnValue.FAILED)
    out = survivor_flow(PORT_PK)
    assert out["moved"] == ["hA"] * 8 and out["same_ids"]
    assert out["results"] == 0 and out["attempts"] == 1
    assert out["used_hA"] == 8
    wait_for_recovery_threads()
    out = budget_flow(PORT_PK)
    assert out["n_dead"] and all(rv == fail and b"expired" in o
                                 for rv, o in out["failed"])
    for root_is_mpi in (True, False):
        out = mpi_flow(PORT_PK, root_is_mpi)
        assert out["n_dead"] and out["attempts"] is None
        assert all(rv == fail for rv, _ in out["failed"])
    out = late_result_flow(PORT_PK)
    assert out["late"] == b"late but real"
    assert out["n_live"] == 7 and out["live_hosts"] == ["hA"]
    wait_for_recovery_threads()
    out = snapshot_push_flow(PORT_PK)
    assert out["n_on_b"] and out["live_n"] == 6 and out["results"] == 0
    out = synthetic_failure_flow(PORT_PK)
    assert out["stored"] == (int(PORT_PK.proto.ReturnValue.SUCCESS),
                             b"slow but alive")


# ---------------------------------------------------------------------------
# The abort relay (tests/unit/test_faults.py:565-700)
# ---------------------------------------------------------------------------

@BOTH
def test_abort_group_relays_via_planner_when_peer_unreachable(pk):
    from importlib import import_module

    decision_mod = import_module(f"{pk.name}.batch_scheduler.decision")
    broker = pk.ptp.PointToPointBroker("w0")
    decision = decision_mod.SchedulingDecision(1, 99)
    decision.add_message("w0", 11, 0, 0)
    decision.add_message("w1", 12, 1, 1)
    broker.set_up_local_mappings_from_decision(decision)
    broker.watch_group(99)

    class DeadPeerClient:
        def abort_group(self, group_id, reason):
            raise ConnectionRefusedError("partitioned")

    relayed = []

    class FakePlanner:
        def relay_group_abort(self, group_id, reason, hosts):
            relayed.append((group_id, reason, list(hosts)))

    broker._clients["w1"] = DeadPeerClient()
    broker.planner_client = FakePlanner()
    broker.abort_group(99, "pair link down")
    assert relayed == [(99, "pair link down", ["w1"])]
    with pytest.raises(pk.ptp.GroupAbortedError):
        broker.recv_message(99, 1, 0)
    broker.abort_group(99, "again")
    assert len(relayed) == 1


@pytest.mark.parametrize("client_pk", [PORT_PK, REF_PK],
                         ids=["port_client", "reference_client"])
def test_abort_relay_rpc_reaches_far_side_broker(client_pk):
    """The port's planner serves RELAY_GROUP_ABORT: the relay reaches a
    far-side port broker and wakes its blocked recv. The reference's
    client sends the same frame (call 17 and its header) to the port's
    planner."""
    from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision
    from tests.conftest import next_port_base

    base = next_port_base()
    for pk in (PORT_PK, client_pk):
        pk.common.register_host_alias("relpl", "127.0.0.1", base)
        pk.common.register_host_alias("relw0", "127.0.0.1", base + 1000)
    planner = PORT_PK.planner.get_planner()
    planner.reset()
    planner_server = PORT_PK.planner.PlannerServer(port_offset=base)
    planner_server.start()
    far_broker = PORT_PK.ptp.PointToPointBroker("relw0")
    far_server = PORT_PK.ptp_remote.PointToPointServer(far_broker)
    far_server.start()
    client = client_pk.planner_client.PlannerClient("relw1", "relpl")
    try:
        assert int(client_pk.planner_client.PlannerCalls.RELAY_GROUP_ABORT) \
            == int(PORT_PK.planner.PlannerCalls.RELAY_GROUP_ABORT) == 17
        decision = SchedulingDecision(1, 777)
        decision.add_message("relw0", 21, 0, 0)
        decision.add_message("relw1", 22, 1, 1)
        far_broker.set_up_local_mappings_from_decision(decision)
        far_broker.watch_group(777)
        got = {}

        def blocked_recv():
            try:
                far_broker.recv_message(777, 1, 0, timeout=10.0)
            except PORT_PK.ptp.GroupAbortedError as e:
                got["reason"] = e.reason

        t = threading.Thread(target=blocked_recv)
        t.start()
        assert poll(lambda: (777, 1, 0, 0) in far_broker._queues)
        client.relay_group_abort(777, "pair link down", ["relw0"])
        t.join(timeout=5)
        assert not t.is_alive(), "far-side recv never aborted"
        assert "pair link down" in got["reason"]
        assert "planner relay" in got["reason"]
    finally:
        client.close()
        far_server.stop()
        planner_server.stop()
        planner.reset()


def test_abort_group_frame_matches_reference():
    """ABORT_GROUP = 8 and RELAY_GROUP_ABORT = 17 with the reference's
    headers: the port's clients send what the reference's servers read."""
    PORT_PK.testing.set_mock_mode(False)
    sent = {}
    for pk in (REF_PK, PORT_PK):
        for cls, call, args in (
                (pk.ptp_remote.PointToPointClient, "abort_group",
                 (5, "why")),
                (pk.planner_client.PlannerClient, "relay_group_abort",
                 (5, "why", ["h1", "h2"]))):
            obj = cls.__new__(cls)
            frames = []
            obj.async_send = lambda code, header=None, payload=b"", \
                _f=frames: _f.append((int(code), header, payload))
            getattr(obj, call)(*args)
            sent[(pk.name, call)] = frames
    for call in ("abort_group", "relay_group_abort"):
        assert sent[(PORT, call)] == sent[(REF, call)]
    assert sent[(PORT, "abort_group")][0][0] == 8
    assert sent[(PORT, "relay_group_abort")][0][0] == 17


@BOTH
def test_watched_recv_aborts_when_sender_host_refuses(pk):
    """A watched recv whose sender's host refuses connections (a port
    slot with nothing listening) raises GroupAbortedError within a few
    check intervals, long before its own 20 s timeout."""
    from importlib import import_module

    from tests.conftest import next_port_base

    decision_mod = import_module(f"{pk.name}.batch_scheduler.decision")
    base = next_port_base()
    pk.common.register_host_alias("live-w0", "127.0.0.1", base)
    pk.common.register_host_alias("dead-w1", "127.0.0.1", base + 1000)
    pk.config.get_system_config().mpi_abort_check_seconds = 0.2
    broker = pk.ptp.PointToPointBroker("live-w0")
    decision = decision_mod.SchedulingDecision(1, 4242)
    decision.add_message("live-w0", 31, 0, 0)
    decision.add_message("dead-w1", 32, 1, 1)
    broker.set_up_local_mappings_from_decision(decision)
    broker.watch_group(4242)
    t0 = time.monotonic()
    with pytest.raises(pk.ptp.GroupAbortedError) as err:
        broker.recv_message(4242, 1, 0, timeout=20.0)
    assert time.monotonic() - t0 < 15.0
    assert "connection refused" in err.value.reason
    assert broker.group_aborted(4242) is not None


def test_unwatched_recv_times_out_without_probing():
    """An unwatched group's recv waits out its own timeout."""
    broker = PORT_PK.ptp.PointToPointBroker("w0")
    from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision

    decision = SchedulingDecision(1, 7)
    decision.add_message("w0", 1, 0, 0)
    decision.add_message("nowhere-w1", 2, 1, 1)
    broker.set_up_local_mappings_from_decision(decision)
    with pytest.raises(TimeoutError):
        broker.recv_message(7, 1, 0, timeout=0.3)
    assert broker.group_aborted(7) is None


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 24 (c) and (d) at a small width on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_recovery_and_abort_phase_small(monkeypatch):
    """Phase 24 (c): a serving batch's share on host B is stranded by a
    dropped dispatch and suppressed keep-alives, and host B's expiry
    requeues it onto host A: every result SUCCESS with direct
    ``generate``'s tokens, the requeued counter up by host B's share,
    an ``rqu`` stamp in each requeued ledger. (d): an abort crosses
    hosts directly and, with the direct frame dropped, through the
    planner's relay. The fault call sites are armed as
    ``FAABRIC_FAULTS`` at import arms them (this process imported the
    port without it)."""
    import chip_smoke
    import faabric_tpu_torch.planner.client as client_mod
    import faabric_tpu_torch.planner.planner as planner_mod
    import faabric_tpu_torch.transport.client as tclient_mod
    from faabric_tpu_torch.faults import clear_faults, registry
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.ops import _build
    from tests.conftest import next_port_base

    was_enabled = registry.faults_enabled()
    registry.set_faults_enabled(True)
    reg = registry.get_fault_registry()
    for mod, attr, name in ((planner_mod, "_FP_DISPATCH", "planner.dispatch"),
                            (client_mod, "_FP_KEEPALIVE", "keepalive"),
                            (tclient_mod, "_FP_SEND", "transport.send")):
        monkeypatch.setattr(mod, "_FAULTS", True)
        monkeypatch.setattr(mod, attr, reg.point(name))
    monkeypatch.delenv("PLANNER_REQUEUE_BACKOFF")
    PORT_PK.config.get_system_config().reset()
    cfg = ModelConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=1,
                      d_ff=256, max_seq=64, attention_impl="reference",
                      norm_impl="reference", compute_dtype=torch.float32)
    try:
        launches = chip_smoke.migration_phase(
            torch.device("cpu"), _build, cfg=cfg, seq=32, prompt_len=64,
            serve_len=16, n_new=4, base=next_port_base(), parts="cd")
    finally:
        clear_faults()
        registry.set_faults_enabled(was_enabled)
    monkeypatch.setenv("PLANNER_REQUEUE_BACKOFF", "0.01")
    assert launches == {}  # the plain versions run on the CPU
