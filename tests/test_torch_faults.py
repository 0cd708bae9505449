"""The port's fault injection against the JAX package's.

Counterpart of ``tests/unit/test_faults.py``: the spec parser,
deterministic firing, the ``RetryPolicy`` backoff schedule, the circuit
breaker's transitions, the RPC client's fault point and breaker, and
host-pair (partition) rules, on ``faabric_tpu_torch.faults``. Recovery
requeues and abort relays are the reference's part C
(``ROADMAP.md`` Queue 1 #7 part C) and have no case here; a planner
that fails its messages when their host expires keeps its cases.
Cross-package: the same specs parse to equal rules and, under one seed,
fire the identical sequence; ``FAABRIC_FAULTS`` is read at import, in a
subprocess.
"""

import time

import pytest

from faabric_tpu_torch.faults import (
    DROP,
    NULL_FAULT,
    SUPPRESS,
    FaultConnectionError,
    FaultInjected,
    FaultPoint,
    clear_faults,
    fault_point,
    faults_enabled,
    install_faults,
    parse_fault_spec,
    set_faults_enabled,
)
from faabric_tpu_torch.util.retry import CircuitBreaker, RetryPolicy

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    from tests.test_torch_telemetry import clean_port_telemetry, port_singletons

    saved = port_singletons()
    yield
    clean_port_telemetry(saved)


# ---------------------------------------------------------------------------
# Spec parser
# ---------------------------------------------------------------------------

def test_parse_fault_spec_full_grammar():
    rules = parse_fault_spec(
        "transport.send=delay:50ms@p=0.25;"
        "planner.dispatch=kill_conn@times=2@host=w2;"
        "executor.run=raise:boom@after=3;"
        "keepalive=suppress;"
        "transport.bulk=drop")
    assert [r.point for r in rules] == [
        "transport.send", "planner.dispatch", "executor.run", "keepalive",
        "transport.bulk"]
    assert rules[0].action == "delay"
    assert rules[0].delay_seconds == pytest.approx(0.05)
    assert rules[0].p == 0.25
    assert rules[1].times == 2
    assert rules[1].matchers == {"host": "w2"}
    assert rules[2].after == 3
    assert rules[2].arg == "boom"


@pytest.mark.parametrize("bad", [
    "transport.send",            # no action
    "x=explode",                 # unknown action
    "x=delay:1s@oops",           # modifier without value
])
def test_parse_fault_spec_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_fault_spec(bad)


def test_duration_forms():
    assert parse_fault_spec("a=delay:250ms")[0].delay_seconds == \
        pytest.approx(0.25)
    assert parse_fault_spec("a=delay:1.5s")[0].delay_seconds == \
        pytest.approx(1.5)
    assert parse_fault_spec("a=delay:0.02")[0].delay_seconds == \
        pytest.approx(0.02)


# ---------------------------------------------------------------------------
# Firing semantics
# ---------------------------------------------------------------------------

def _point_with(spec, seed=0):
    rules = parse_fault_spec(spec, seed=seed)
    pt = FaultPoint(rules[0].point)
    pt.set_rules(rules)
    return pt


def test_fire_actions_and_verdicts():
    assert _point_with("p=drop").fire() is DROP
    assert _point_with("p=suppress").fire() is SUPPRESS
    with pytest.raises(FaultInjected, match="boom"):
        _point_with("p=raise:boom").fire()
    with pytest.raises(FaultConnectionError):
        _point_with("p=kill_conn").fire()
    # kill_conn must look like a real peer failure to transport code
    assert issubclass(FaultConnectionError, ConnectionError)
    assert issubclass(FaultConnectionError, OSError)


def test_after_and_times_modifiers():
    pt = _point_with("p=drop@after=2@times=2")
    # first two arrivals pass, next two fire, then disarmed
    assert [pt.fire() for _ in range(6)] == [
        None, None, DROP, DROP, None, None]


def test_ctx_matchers_filter():
    pt = _point_with("p=suppress@host=w2")
    assert pt.fire(host="w1") is None
    assert pt.fire(host="w2-worker") is SUPPRESS  # substring match
    assert pt.fire() is None  # missing key never matches


def test_probability_is_seed_deterministic():
    def draws(seed):
        pt = _point_with("p=drop@p=0.5", seed=seed)
        return [pt.fire() is DROP for _ in range(64)]

    a, b = draws(7), draws(7)
    assert a == b  # identical across runs for one seed
    assert draws(8) != a  # and the seed actually matters
    assert 10 < sum(a) < 54  # p=0.5 actually gates


def test_delay_action_sleeps():
    pt = _point_with("p=delay:30ms")
    t0 = time.monotonic()
    assert pt.fire() is None  # delay lets the operation proceed
    assert time.monotonic() - t0 >= 0.025


# ---------------------------------------------------------------------------
# Enable/disable: the no-op handle trick
# ---------------------------------------------------------------------------

def test_disabled_fault_point_is_shared_noop():
    set_faults_enabled(False)
    h1, h2 = fault_point("transport.send"), fault_point("anything.else")
    assert h1 is NULL_FAULT and h2 is NULL_FAULT
    assert h1.fire(host="x") is None
    assert not faults_enabled()


def test_install_faults_arms_live_handles():
    install_faults("executor.run=raise@times=1")
    pt = fault_point("executor.run")
    assert pt is not NULL_FAULT and pt.active
    with pytest.raises(FaultInjected):
        pt.fire()
    assert pt.fire() is None  # times=1 disarmed
    # clear_faults disarms but the handle object survives for re-install
    clear_faults()
    assert not pt.active and pt.fire() is None
    install_faults("executor.run=suppress")
    assert fault_point("executor.run") is pt  # per-name singleton
    assert pt.fire() is SUPPRESS


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

def test_retry_policy_backoff_schedule():
    p = RetryPolicy(max_attempts=5, backoff=0.1, multiplier=2.0,
                    max_backoff=0.5, jitter=0.0)
    assert p.schedule() == pytest.approx([0.1, 0.2, 0.4, 0.5])


def test_retry_policy_jitter_bounds():
    import random

    p = RetryPolicy(max_attempts=2, backoff=1.0, jitter=0.25,
                    rng=random.Random(3))
    for _ in range(100):
        d = p.delay(0)
        assert 0.75 <= d <= 1.25


def test_retry_policy_validates():
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)


# ---------------------------------------------------------------------------
# CircuitBreaker state machine
# ---------------------------------------------------------------------------

def test_breaker_closed_to_open_to_half_open_to_closed():
    t = [0.0]
    b = CircuitBreaker(threshold=3, reset_after=10.0, clock=lambda: t[0])
    assert b.state == CircuitBreaker.CLOSED
    for _ in range(2):
        b.record_failure()
    assert b.state == CircuitBreaker.CLOSED and b.allow()
    b.record_failure()  # third consecutive failure trips it
    assert b.state == CircuitBreaker.OPEN
    assert not b.allow()
    t[0] = 9.9
    assert not b.allow()
    t[0] = 10.1  # reset window elapsed: half-open, ONE trial allowed
    assert b.allow()
    assert b.state == CircuitBreaker.HALF_OPEN
    assert not b.allow()  # second concurrent trial refused
    b.record_success()
    assert b.state == CircuitBreaker.CLOSED and b.allow()


def test_breaker_failed_trial_reopens_with_fresh_timer():
    t = [0.0]
    b = CircuitBreaker(threshold=1, reset_after=5.0, clock=lambda: t[0])
    b.record_failure()
    assert b.state == CircuitBreaker.OPEN
    t[0] = 5.5
    assert b.allow()  # half-open trial
    b.record_failure()
    assert b.state == CircuitBreaker.OPEN
    t[0] = 10.0  # 4.5s after reopen: still open
    assert not b.allow()
    t[0] = 10.6
    assert b.allow()


def test_breaker_success_resets_failure_streak():
    b = CircuitBreaker(threshold=2, reset_after=5.0)
    b.record_failure()
    b.record_success()
    b.record_failure()
    assert b.state == CircuitBreaker.CLOSED  # streak broken, never trips


def test_drop_verdict_does_not_strand_half_open_breaker(monkeypatch):
    """A DROP drawn on the half-open trial attempt must record an
    outcome — otherwise the trial flag stays set and the breaker rejects
    forever (an injected transient becomes a permanent node loss)."""
    from faabric_tpu_torch.faults.registry import FaultPoint
    from faabric_tpu_torch.transport import client as tclient

    pt = FaultPoint("transport.send")
    pt.set_rules(parse_fault_spec("transport.send=drop"))
    monkeypatch.setattr(tclient, "_FAULTS", True)
    monkeypatch.setattr(tclient, "_FP_SEND", pt)
    c = tclient.MessageEndpointClient("nowhere.invalid", 1, 2)
    t = [0.0]
    c.breaker = CircuitBreaker(threshold=1, reset_after=5.0,
                               clock=lambda: t[0])
    c.breaker.record_failure()  # OPEN
    t[0] = 5.5  # reset elapsed: next allow() is the half-open trial
    c.async_send(1)  # trial draws DROP (silent loss, caller sees success)
    assert c.breaker.allow(), "breaker stranded after injected drop"
    # Sync plane: the drop surfaces as RpcError AND counts as a failure
    c2 = tclient.MessageEndpointClient("nowhere.invalid", 1, 2)
    c2.breaker = CircuitBreaker(threshold=1, reset_after=5.0,
                                clock=lambda: t[0])
    with pytest.raises(tclient.RpcError, match="injected drop"):
        c2.sync_send(1)
    assert c2.breaker.state == CircuitBreaker.OPEN


def test_client_fails_fast_when_circuit_open():
    """An open breaker short-circuits sync_send with RpcError before any
    dial — bounded-time failure propagation for callers."""
    from faabric_tpu_torch.transport.client import MessageEndpointClient, RpcError

    c = MessageEndpointClient("nowhere.invalid", 1, 2,
                              retry_policy=RetryPolicy(max_attempts=1))
    c.breaker = CircuitBreaker(threshold=1, reset_after=60.0)
    c.breaker.record_failure()
    t0 = time.monotonic()
    with pytest.raises(RpcError, match="circuit open"):
        c.sync_send(1)
    with pytest.raises(RpcError, match="circuit open"):
        c.async_send(1)
    assert time.monotonic() - t0 < 0.5  # no connect attempt happened


# ---------------------------------------------------------------------------
# Planner recovery: requeue-with-backoff (mock mode — no sockets)
# ---------------------------------------------------------------------------

def _make_batch(n, function="echo"):
    from faabric_tpu_torch.proto import batch_exec_factory

    return batch_exec_factory("ft", function, n)


def _fresh_planner(monkeypatch):
    from faabric_tpu_torch.planner.planner import Planner

    monkeypatch.setenv("PLANNER_REQUEUE_BACKOFF", "0.01")
    from faabric_tpu_torch.util.config import get_system_config

    get_system_config().reset()
    return Planner()


def test_requeue_budget_exhaustion_fails_terminally(monkeypatch):
    from faabric_tpu_torch.proto import ReturnValue
    from faabric_tpu_torch.util.testing import set_mock_mode

    set_mock_mode(True)
    monkeypatch.setenv("PLANNER_MAX_REQUEUES", "0")
    planner = _fresh_planner(monkeypatch)
    planner.register_host("hA", 4)
    planner.register_host("hB", 4)
    req = _make_batch(8)
    decision = planner.call_batch(req)
    dead = {decision.message_ids[i] for i, h in enumerate(decision.hosts)
            if h == "hB"}
    with planner._lock:
        planner._hosts["hB"].register_ts -= 10_000
    planner.expire_hosts()

    deadline = time.time() + 5
    while time.time() < deadline:
        results = planner._results.get(req.app_id, {})
        if dead <= set(results):
            break
        time.sleep(0.02)
    results = planner._results.get(req.app_id, {})
    assert dead <= set(results), "budget-0 messages must fail terminally"
    for mid in dead:
        assert results[mid].return_value == int(ReturnValue.FAILED)
        assert b"expired" in results[mid].output_data


# ---------------------------------------------------------------------------
# Host-pair partition specs: directed src/dst ctx matching +
# heal-on-clear + the planner abort relay for the far side
# ---------------------------------------------------------------------------

def test_host_pair_rules_match_direction():
    """One cluster-wide spec partitions a DIRECTED pair: each process's
    fire() is stamped with its own identity as ``src``, so the w0→w1
    rule fires only where src resolves to w0 — w1→w0 and planner links
    are untouched."""
    from faabric_tpu_torch.faults import set_fault_identity

    rules = parse_fault_spec("transport.send=drop@src=w0@host=w1")
    pt = FaultPoint("transport.send")
    pt.set_rules(rules)
    try:
        set_fault_identity("w0", force=True)
        assert pt.fire(host="w1") is DROP          # the partitioned leg
        assert pt.fire(host="w2") is None          # other peer: flows
        assert pt.fire(host="planner") is None     # control plane: flows
        set_fault_identity("w1", force=True)
        assert pt.fire(host="w0") is None          # reverse direction: flows
        set_fault_identity("planner", force=True)
        assert pt.fire(host="w1") is None          # planner→w1: flows
    finally:
        set_fault_identity("", force=True)


def test_host_pair_rules_both_directions_and_delay():
    """Two rules make the partition bidirectional; delay rules express a
    degraded (not severed) pair the same way."""
    from faabric_tpu_torch.faults import set_fault_identity

    pt = FaultPoint("transport.bulk")
    pt.set_rules(parse_fault_spec(
        "transport.bulk=drop@src=w0@dest=w1;"
        "transport.bulk=drop@src=w1@dest=w0"))
    try:
        set_fault_identity("w0", force=True)
        assert pt.fire(dest="w1") is DROP
        set_fault_identity("w1", force=True)
        assert pt.fire(dest="w0") is DROP
        assert pt.fire(dest="w2") is None

        slow = FaultPoint("transport.send")
        slow.set_rules(parse_fault_spec(
            "transport.send=delay:30ms@src=w1@host=w0"))
        t0 = time.monotonic()
        assert slow.fire(host="w0") is None        # delayed, not dropped
        assert time.monotonic() - t0 >= 0.025
        t0 = time.monotonic()
        assert slow.fire(host="w2") is None        # unmatched: instant
        assert time.monotonic() - t0 < 0.02
    finally:
        set_fault_identity("", force=True)


def test_host_pair_partition_heals_on_clear():
    """clear_faults() removes the partition rules: the same fire()
    arrivals flow again (call sites re-dial on their next attempt — the
    registry holds no sticky state beyond the rules)."""
    from faabric_tpu_torch.faults import get_fault_registry, set_fault_identity

    install_faults("transport.send=kill_conn@src=w0@host=w1")
    pt = fault_point("transport.send")
    try:
        set_fault_identity("w0", force=True)
        with pytest.raises(FaultConnectionError):
            pt.fire(host="w1")
        clear_faults()
        assert pt.fire(host="w1") is None          # healed
        # A times= budget heals the same way without an explicit clear
        install_faults("transport.send=kill_conn@src=w0@host=w1@times=2")
        pt2 = fault_point("transport.send")
        for _ in range(2):
            with pytest.raises(FaultConnectionError):
                pt2.fire(host="w1")
        assert pt2.fire(host="w1") is None         # budget spent: healed
        assert get_fault_registry().snapshot()[
            "transport.send"][0]["fired"] == 2
    finally:
        set_fault_identity("", force=True)


# ---------------------------------------------------------------------------
# First-write-wins under the expiry race: a genuine late result arriving between _fail_messages'
# check and its synthetic write must never be overwritten
# ---------------------------------------------------------------------------

def test_synthetic_failure_never_overwrites_genuine_late_result(
        monkeypatch):
    from faabric_tpu_torch.proto import ReturnValue
    from faabric_tpu_torch.util.testing import set_mock_mode

    set_mock_mode(True)
    planner = _fresh_planner(monkeypatch)
    planner.register_host("hA", 8)
    req = _make_batch(2)
    decision = planner.call_batch(req)
    victim_id = decision.message_ids[0]

    # The genuine result lands AFTER _fail_messages' under-lock check
    # but BEFORE its synthetic write — exactly the window the advisory
    # flagged. Emulate it by landing the genuine result first and then
    # letting the terminal path run its (stale) check-then-write.
    genuine = next(m for m in req.messages if m.id == victim_id)
    import copy

    synthetic = copy.deepcopy(genuine)
    genuine.return_value = int(ReturnValue.SUCCESS)
    genuine.output_data = b"slow but alive"
    planner.set_message_result(genuine)

    synthetic.return_value = int(ReturnValue.FAILED)
    synthetic.output_data = b"Host expired"
    planner.set_message_result(synthetic)  # first-write-wins: ignored
    planner._fail_messages([synthetic], b"Host expired")  # also ignored

    stored = planner.get_message_result(req.app_id, victim_id)
    assert stored.return_value == int(ReturnValue.SUCCESS)
    assert stored.output_data == b"slow but alive"


def test_conflicting_identities_disable_src_stamping():
    """Two runtimes in one process (in-process multi-host tests) must
    not mis-stamp src: the second DIFFERENT identity clears the stamp,
    so directed rules match nothing instead of the wrong direction."""
    from faabric_tpu_torch.faults import get_fault_identity, set_fault_identity

    try:
        set_fault_identity("", force=True)
        set_fault_identity("w0")
        set_fault_identity("w0")            # idempotent re-set is fine
        assert get_fault_identity() == "w0"
        set_fault_identity("w1")            # conflict: a second runtime
        assert get_fault_identity() == ""
        set_fault_identity("w2")            # latched: still ambiguous
        assert get_fault_identity() == ""
        pt = FaultPoint("transport.send")
        pt.set_rules(parse_fault_spec("transport.send=drop@src=w0@host=w1"))
        assert pt.fire(host="w1") is None   # no stamp → no wrong match
        set_fault_identity("w0", force=True)
        assert pt.fire(host="w1") is DROP   # explicit force restores
    finally:
        set_fault_identity("", force=True)


# ---------------------------------------------------------------------------
# Cross-package: the same specs, the same rules and firing sequences
# ---------------------------------------------------------------------------

SPECS = [
    "transport.send=delay:50ms@p=0.25;planner.dispatch=kill_conn@times=2"
    "@host=w2;executor.run=raise:boom@after=3;keepalive=suppress;"
    "transport.bulk=drop",
    "transport.send=drop@src=w0@host=w1;transport.send=drop@src=w1@host=w0",
    "mpi.collective=raise@after=2",
    "p=drop@p=0.5",
    "p=drop@p=0.3@after=4@times=9@host=w",
    "state.pull=kill_conn@key=a/k;state.replicate=drop@times=1",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_equals_reference(spec):
    from faabric_tpu.faults import parse_fault_spec as ref_parse

    for seed in (0, 7):
        assert [r.to_dict() for r in parse_fault_spec(spec, seed=seed)] == \
            [r.to_dict() for r in ref_parse(spec, seed=seed)]


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("spec", ["p=drop@p=0.5", "p=drop@p=0.2@after=3",
                                  "p=suppress@p=0.7@times=20@host=w",
                                  "p=drop@p=0.5;p=suppress@p=0.5"])
def test_seeded_firing_sequence_equals_reference(spec, seed):
    """One point armed with the same rules and seed in each package; a
    seeded numpy stream of contexts; the verdicts match one for one."""
    import numpy as np

    from faabric_tpu.faults.registry import FaultPoint as RefPoint
    from faabric_tpu.faults.registry import parse_fault_spec as ref_parse

    from faabric_tpu_torch.faults.registry import FaultPoint

    port, ref = FaultPoint("p"), RefPoint("p")
    port.set_rules(parse_fault_spec(spec, seed=seed))
    ref.set_rules(ref_parse(spec, seed=seed))
    hosts = np.random.default_rng(seed).choice(["w0", "w1", "x"], 200)
    got = [port.fire(host=str(h)) for h in hosts]
    want = [ref.fire(host=str(h)) for h in hosts]
    assert [str(v) for v in got] == [str(v) for v in want]
    assert any(v is not None for v in got)


_FAULTS_KNOB_PROGRAM = r"""
import json
import faabric_tpu_torch.faults as f
import faabric_tpu_torch.transport.client as client
import faabric_tpu_torch.mpi.world as world
pt = world._FP_COLLECTIVE
verdicts = []
for _ in range(4):
    try:
        pt.fire(op="allreduce", bytes=8)
        verdicts.append("ok")
    except f.FaultInjected as e:
        verdicts.append("raised")
print(json.dumps({"enabled": f.faults_enabled(),
                  "client": client._FAULTS, "world": world._FAULTS,
                  "verdicts": verdicts}))
"""


@pytest.mark.parametrize("env,want", [
    ({}, {"enabled": False, "client": False, "world": False,
          "verdicts": ["ok"] * 4}),
    ({"FAABRIC_FAULTS": "mpi.collective=raise@after=2"},
     {"enabled": True, "client": True, "world": True,
      "verdicts": ["ok", "ok", "raised", "raised"]}),
])
def test_faults_knob_read_at_import_in_a_subprocess(env, want):
    from tests.test_torch_telemetry import _run_program

    assert _run_program(_FAULTS_KNOB_PROGRAM, env) == want
