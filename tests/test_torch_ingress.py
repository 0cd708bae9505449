"""The port's invocation ingress against the JAX package's.

The 23 cases of ``tests/unit/test_ingress.py`` on the port, in process
and in mock mode (dispatches and mappings are recorded, not sent): the
immediate path against tick batching, the decision cache as the tick's
fast path, the journal's group commit and its replay, admission and its
sheds (429 with ``Retry-After`` on the REST surface), the queue
deadline, the stop latch, and the pipelined wire forms
(EXECUTE_BATCHES, SUBMIT_BATCH, batched mappings). Where the reference
case waits on a clock, the port's waits on events and moves the
ingress's queue clock (``ingress/tick.py::_clock``) instead; polls wait
for a state, never for a wall-clock window.

Then both packages: one host map and one request sequence through each
planner's ``call_batch_group`` give the same hosts per message and the
same deferred and backlogged requests, and a tick's ``group`` record
written by either package's journal reads back through the other's
``load_journal_dir`` as the record that package writes for that tick.
"""

import importlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest

from faabric_tpu_torch.batch_scheduler import get_decision_cache
from faabric_tpu_torch.batch_scheduler.decision import NOT_ENOUGH_SLOTS
from faabric_tpu_torch.ingress import AdmissionController
from faabric_tpu_torch.ingress import tick as tick_mod
from faabric_tpu_torch.planner.planner import Planner
from faabric_tpu_torch.proto import (
    BatchExecuteType,
    ReturnValue,
    batch_exec_factory,
)
from faabric_tpu_torch.util.config import get_system_config

REF, PORT = "faabric_tpu", "faabric_tpu_torch"


def pkg(name: str) -> types.SimpleNamespace:
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in {
        "planner_mod": "planner.planner", "journal": "planner.journal",
        "proto": "proto", "testing": "util.testing",
        "config": "util.config", "scheduler": "batch_scheduler",
        "function_call": "scheduler.function_call",
        "ptp_remote": "transport.ptp_remote",
        "client": "planner.client"}.items()}
    return types.SimpleNamespace(name=name, **mods)


REF_PK, PORT_PK = pkg(REF), pkg(PORT)

# Every planner a test makes: its ingress is stopped when the test ends,
# so that no tick thread outlives it
_made: list = []


def _track(p):
    _made.append(p)
    return p


@pytest.fixture(autouse=True)
def _mock_and_clean():
    for pk in (REF_PK, PORT_PK):
        pk.testing.set_mock_mode(True)
        pk.function_call.clear_mock_requests()
        pk.client.clear_mock_planner_calls()
        pk.ptp_remote.clear_sent_ptp()
    yield
    while _made:
        p = _made.pop()
        p.ingress.stop()
        p.close_journal()
    for pk in (REF_PK, PORT_PK):
        pk.scheduler.get_decision_cache().clear()
        pk.scheduler.reset_batch_scheduler()
        pk.testing.set_mock_mode(False)
        pk.function_call.clear_mock_requests()
        pk.client.clear_mock_planner_calls()
        pk.ptp_remote.clear_sent_ptp()
        pk.config.get_system_config().reset()


def _planner(slots=64, n_hosts=2) -> Planner:
    p = _track(Planner())
    for i in range(n_hosts):
        p.register_host(f"ing-h{i}", slots, 0)
    return p


def _wait_for(pred, what: str, timeout: float = 60.0):
    """Poll ``pred`` until it holds (a state, not a time window)."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


class _Clock:
    """The ingress's queue clock, moved by the test."""

    def __init__(self, monkeypatch, start: float = 1000.0):
        self.now = start
        monkeypatch.setattr(tick_mod, "_clock", lambda: self.now)


# ---------------------------------------------------------------------------
# Tick batching against the immediate path
# ---------------------------------------------------------------------------
def test_idle_submission_takes_immediate_path():
    p = _planner()
    d = p.ingress.submit(batch_exec_factory("u", "fn", 1), source="s")
    assert d.n_messages == 1 and d.hosts[0].startswith("ing-h")
    st = p.ingress.stats()
    assert st["immediateTotal"] == 1
    assert st["batchedTotal"] == 0 and st["ticks"] == 0
    assert st["queueDepth"] == 0  # credits released


def test_concurrent_submissions_batch_into_ticks():
    """One submission holds the immediate path while 29 others arrive:
    they find the ingress busy and queue, and the tick thread, held until
    all 29 are queued, takes them in one tick."""
    p = _planner(slots=64)
    inline = threading.Event()
    release = threading.Event()
    real_call_batch = p.call_batch

    def held_call_batch(req):
        inline.set()
        assert release.wait(60)
        return real_call_batch(req)

    p.call_batch = held_call_batch
    real_ensure = p.ingress._ensure_thread_locked
    p.ingress._ensure_thread_locked = lambda: None
    decisions, errs = {}, []

    def submit(i):
        try:
            decisions[i] = p.ingress.submit(
                batch_exec_factory("u", "fn", 1), source=f"s{i % 3}")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=submit, args=(0,))]
    threads[0].start()
    assert inline.wait(60)
    threads += [threading.Thread(target=submit, args=(i,))
                for i in range(1, 30)]
    for t in threads[1:]:
        t.start()
    _wait_for(lambda: p.ingress.stats()["queuedRequests"] == 29,
              "29 submissions queued behind the immediate path")
    p.ingress._ensure_thread_locked = real_ensure
    with p.ingress._lock:
        p.ingress._ensure_thread_locked()
    release.set()
    for t in threads:
        t.join(60)
    assert not errs
    assert len(decisions) == 30
    assert all(d.n_messages == 1 for d in decisions.values())
    st = p.ingress.stats()
    assert st["immediateTotal"] == 1
    assert st["batchedTotal"] == 29 and st["ticks"] == 1
    assert st["batchedTotal"] / st["ticks"] > 1.0  # real batching
    assert st["queueDepth"] == 0 and st["queuedRequests"] == 0


def test_non_batchable_requests_bypass_the_queue():
    p = _planner()
    req = batch_exec_factory("u", "mpifn", 1)
    req.messages[0].is_mpi = True
    assert not p.is_batchable_shape(req)
    d = p.ingress.submit(req, source="s")
    assert d.n_messages == 1
    st = p.ingress.stats()
    # Went straight through: neither admitted nor ticked
    assert st["admittedTotal"] == 0 and st["immediateTotal"] == 0


# ---------------------------------------------------------------------------
# The decision cache as the tick's fast path
# ---------------------------------------------------------------------------
def test_group_pass_uses_decision_cache_fast_path():
    p = _planner(slots=64)
    cache = get_decision_cache()
    r1 = batch_exec_factory("u", "hot", 1)
    results, deferred = p.call_batch_group([r1])
    assert not deferred and results[0] is not None
    before = cache.stats()
    assert before["misses"] >= 1  # the first sighting ran the policy

    r2 = batch_exec_factory("u", "hot", 1)
    results, _ = p.call_batch_group([r2])
    after = cache.stats()
    assert after["hits"] == before["hits"] + 1
    # The cached placement was reused as it was
    assert results[0].hosts == [cache.get_cached_decision(r2).hosts[0]]


def test_cache_signature_mismatch_never_hits():
    p = _planner(slots=64)
    cache = get_decision_cache()
    p.call_batch_group([batch_exec_factory("u", "sig", 2)])
    assert cache.get_cached_decision(
        batch_exec_factory("u", "sig", 2)) is not None
    # Another width, function, user, and batch type of the same shape:
    # all distinct keys
    assert cache.get_cached_decision(
        batch_exec_factory("u", "sig", 3)) is None
    assert cache.get_cached_decision(
        batch_exec_factory("u", "other", 2)) is None
    assert cache.get_cached_decision(
        batch_exec_factory("v", "sig", 2)) is None
    threads = batch_exec_factory("u", "sig", 2)
    threads.type = int(BatchExecuteType.THREADS)
    assert cache.get_cached_decision(threads) is None


def test_compact_tenant_never_shares_cached_placement():
    """Compact keys a tenant id into ``req.subtype`` and filters hosts
    running other tenants' apps; the fast path honours both the tenant's
    cache key and the live filter."""
    PORT_PK.scheduler.reset_batch_scheduler("compact")
    p = _planner(slots=4, n_hosts=2)
    a = batch_exec_factory("u", "fn", 1)
    a.subtype = 1
    results, _ = p.call_batch_group([a])
    host_a = results[0].hosts[0]
    # Same user, function and width, another tenant: tenant 1's row is
    # not reused, and the policy places it on the other host
    b = batch_exec_factory("u", "fn", 1)
    b.subtype = 2
    results, _ = p.call_batch_group([b])
    assert results[0] is not None
    assert results[0].hosts[0] != host_a


def test_compact_filter_invalidates_stale_cache_entry():
    """A cached placement whose host has since taken another tenant's
    app falls out of the fast path: the policy's filter is part of
    correctness, not only the free slots."""
    PORT_PK.scheduler.reset_batch_scheduler("compact")
    p = _planner(slots=4, n_hosts=1)
    cache = get_decision_cache()
    a = batch_exec_factory("u", "fn", 1)
    a.subtype = 1
    results, _ = p.call_batch_group([a])
    assert results[0] is not None  # tenant 1's row cached for h0
    m = a.messages[0]
    m.return_value = int(ReturnValue.SUCCESS)
    p.set_message_results([m])  # tenant 1 leaves the host

    c = batch_exec_factory("u", "other", 1)
    c.subtype = 2
    results, _ = p.call_batch_group([c])
    assert results[0] is not None  # tenant 2 now runs on h0

    # Tenant 1 returns: its cache entry names h0, which has free slots,
    # but tenant 2 runs there: the cached row and the policy both refuse
    misses = cache.stats()["misses"]
    a2 = batch_exec_factory("u", "fn", 1)
    a2.subtype = 1
    results, deferred = p.call_batch_group([a2])
    assert not deferred
    assert results[0] is None
    assert cache.stats()["misses"] == misses + 1


def test_stale_cache_capacity_falls_back_to_policy():
    p = _planner(slots=2, n_hosts=1)
    cache = get_decision_cache()
    # A cached placement on ing-h0...
    cache.add_cached_decision(batch_exec_factory("u", "big", 2),
                              ["ing-h0", "ing-h0"], 0)
    p.register_host("ing-roomy", 8, 0)
    # ...then ing-h0 shrinks (a keep-alive's slot update), so that the
    # cached placement no longer fits
    p.register_host("ing-h0", 1, 0)
    req = batch_exec_factory("u", "big", 2)
    results, _ = p.call_batch_group([req])
    assert results[0] is not None
    assert "ing-roomy" in set(results[0].hosts)  # the policy placed it
    assert cache.stats()["misses"] >= 1  # a capacity fail is a miss


# ---------------------------------------------------------------------------
# The journal's group commit
# ---------------------------------------------------------------------------
def _journaled_planner(monkeypatch, tmp_path, pk=PORT_PK):
    monkeypatch.setenv("FAABRIC_PLANNER_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setenv("FAABRIC_PLANNER_RECONCILE_GRACE", "30")
    pk.config.get_system_config().reset()
    return _track(pk.planner_mod.Planner())


def _fingerprint(planner) -> str:
    with planner._lock:
        return json.dumps(planner._journal_snapshot_locked(),
                          sort_keys=True, default=str)


def test_group_commit_one_record_replay_idempotent(monkeypatch, tmp_path):
    from faabric_tpu_torch.planner.journal import load_journal_dir

    p = _journaled_planner(monkeypatch, tmp_path)
    p.register_host("h1", 64, 0)
    reqs = [batch_exec_factory("u", "fn", 1) for _ in range(8)]
    results, deferred = p.call_batch_group(reqs)
    assert not deferred and all(r is not None for r in results)
    p.flush_journal()

    _, records, meta = load_journal_dir(str(tmp_path))
    assert not meta["torn"]
    groups = [r for r in records if r["k"] == "group"]
    # One group record holds the tick's app updates
    assert len(groups) == 1 and groups[0]["n"] == 8
    assert all(s["k"] == "app_update" for s in groups[0]["recs"])
    p.close_journal()

    # A restart replays every app; replaying the log twice lands in the
    # same state
    p2 = _journaled_planner(monkeypatch, tmp_path)
    assert len(p2.get_in_flight_apps()) == 8
    fp2 = _fingerprint(p2)
    p2.close_journal()

    p3 = _journaled_planner(monkeypatch, tmp_path)
    _, records, _ = p3._journal.replay()
    with p3._lock:
        for rec in records:
            p3._apply_journal_record_locked(rec)
    assert _fingerprint(p3) == fp2


def test_torn_group_tail_drops_the_whole_tick(monkeypatch, tmp_path):
    from faabric_tpu_torch.planner.journal import (
        JOURNAL_FILE,
        load_journal_dir,
    )

    p = _journaled_planner(monkeypatch, tmp_path)
    p.register_host("h1", 64, 0)
    first = [batch_exec_factory("u", "fn", 1) for _ in range(3)]
    p.call_batch_group(first)
    p.flush_journal()
    path = os.path.join(str(tmp_path), JOURNAL_FILE)
    intact_size = os.path.getsize(path)
    second = [batch_exec_factory("u", "fn", 1) for _ in range(3)]
    p.call_batch_group(second)
    p.flush_journal()
    p.close_journal()

    # A crash mid-append: the second group record cut in half. Its CRC
    # rejects it, so the whole second tick goes, none of it applied
    full = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(intact_size + (full - intact_size) // 2)

    _, records, meta = load_journal_dir(str(tmp_path))
    assert meta["torn"]
    groups = [r for r in records if r["k"] == "group"]
    assert len(groups) == 1 and groups[0]["n"] == 3

    p2 = _journaled_planner(monkeypatch, tmp_path)
    replayed = set(p2.get_in_flight_apps())
    assert replayed == {r.app_id for r in first}
    assert not replayed & {r.app_id for r in second}


def test_journaldump_renders_and_filters_group_records(monkeypatch,
                                                       tmp_path):
    from faabric_tpu_torch.runner import journaldump

    p = _journaled_planner(monkeypatch, tmp_path)
    p.register_host("h1", 64, 0)
    p.call_batch_group([batch_exec_factory("u", "fn", 1)
                        for _ in range(4)])
    p.flush_journal()
    p.close_journal()

    _, records, _ = journaldump.load_journal_dir(str(tmp_path))
    text = journaldump.render(records)
    assert "group" in text and "app_update" in text and "└" in text
    # --kind matches the group's own kind and the kinds inside it
    assert journaldump.filter_kind(records, "group")
    narrowed = journaldump.filter_kind(records, "app_update")
    assert narrowed and all(s["k"] == "app_update"
                            for g in narrowed for s in g["recs"])
    assert journaldump.filter_kind(records, "result") == []


# ---------------------------------------------------------------------------
# Admission and shedding
# ---------------------------------------------------------------------------
def test_admission_queue_bound_sheds():
    a = AdmissionController(queue_max=5, source_credits=100)
    assert a.try_admit("s1", 3).admitted
    v = a.try_admit("s1", 3)  # 6 > 5
    assert not v.admitted and v.retry_after > 0
    a.release("s1", 3)
    assert a.try_admit("s1", 5).admitted
    st = a.stats()
    assert st["shedTotal"] == 3 and st["queueDepth"] == 5


def test_admission_per_source_credit_cap():
    a = AdmissionController(queue_max=100, source_credits=4)
    assert a.try_admit("greedy", 4).admitted
    assert not a.try_admit("greedy", 1).admitted  # over its cap...
    assert a.try_admit("modest", 4).admitted      # ...the others are not
    a.release("greedy", 4)
    assert a.try_admit("greedy", 2).admitted


def test_http_endpoint_sheds_with_429_and_retry_after():
    from faabric_tpu_torch.endpoint.http_server import (
        HttpMessageType,
        PlannerHttpEndpoint,
    )

    p = _planner()
    # A queue bound of one message: a batch of two sheds
    p.ingress.admission = AdmissionController(queue_max=1,
                                              source_credits=100)
    ep = PlannerHttpEndpoint(port=0, planner=p)
    req = batch_exec_factory("tenant", "fn", 2)
    body = json.dumps({
        "http_type": int(HttpMessageType.EXECUTE_BATCH),
        "payload": json.dumps(req.to_dict()),
    }).encode()
    status, payload, headers = ep.handle(body)
    assert status == 429
    out = json.loads(payload)
    assert out["retryAfterSeconds"] > 0
    assert int(headers["Retry-After"]) >= 1
    # The shed shows on the health surface
    assert p.health_summary()["ingress"]["shedTotal"] >= 2


def test_queue_deadline_fails_unscheduled_submissions(monkeypatch):
    """A fire-and-forget submission that no host can take fails once its
    queue deadline passes on the ingress's clock."""
    monkeypatch.setenv("FAABRIC_INGRESS_QUEUE_TIMEOUT", "0.3")
    monkeypatch.setenv("FAABRIC_PLANNER_TICK_MS", "5")
    get_system_config().reset()
    clock = _Clock(monkeypatch)
    p = _track(Planner())  # no hosts: nothing can be placed
    req = batch_exec_factory("u", "fn", 1)
    p.ingress.submit_many([req], source="s")
    # The entry goes back to the queue tick after tick...
    _wait_for(lambda: p.ingress.stats()["ticks"] >= 2, "two ticks ran")
    assert not p.get_batch_results(req.app_id).finished
    # ...until the clock passes its deadline
    clock.now += 0.31
    _wait_for(lambda: p.get_batch_results(req.app_id).finished,
              "the shed submission's results recorded")
    status = p.get_batch_results(req.app_id)
    assert all(m.return_value == int(ReturnValue.FAILED)
               for m in status.message_results)
    assert b"Shed" in status.message_results[0].output_data
    assert p.ingress.stats()["queueDepth"] == 0  # credits released


def test_sync_waiter_gets_not_enough_slots_at_deadline(monkeypatch):
    monkeypatch.setenv("FAABRIC_PLANNER_TICK_MS", "5")
    get_system_config().reset()
    clock = _Clock(monkeypatch)
    p = _track(Planner())  # no hosts
    # Hold the immediate path, so that the waiter has to queue
    inline, release = threading.Event(), threading.Event()
    real_call_batch = p.call_batch

    def held_call_batch(req):
        inline.set()
        assert release.wait(60)
        return real_call_batch(req)

    p.call_batch = held_call_batch
    blocker = threading.Thread(target=lambda: p.ingress.submit(
        batch_exec_factory("u", "fn", 1), timeout=1.0))
    blocker.start()
    assert inline.wait(60)
    out = {}
    waiter = threading.Thread(target=lambda: out.setdefault(
        "d", p.ingress.submit(batch_exec_factory("u", "fn", 1),
                              timeout=30.0)))
    waiter.start()
    _wait_for(lambda: p.ingress.stats()["ticks"] >= 1,
              "a tick found no room for the waiter")
    assert "d" not in out
    # Past the deadline and its grace on the queue clock: the next tick
    # sheds the entry
    clock.now += 31.0
    waiter.join(60)
    release.set()
    blocker.join(60)
    assert out["d"].app_id == NOT_ENOUGH_SLOTS


def test_tick_firing_within_waiter_grace_still_schedules(monkeypatch):
    """A tick that runs after an entry's bare deadline but before its
    waiter withdraws (deadline + grace) schedules it: shedding there
    would answer NOT_ENOUGH_SLOTS from a busy, not a full, cluster."""
    monkeypatch.setenv("FAABRIC_PLANNER_TICK_MS", "5")
    get_system_config().reset()
    clock = _Clock(monkeypatch)
    p = _planner()
    stall, release = threading.Event(), threading.Event()
    orig = p.call_batch_group

    def stalled(reqs):
        stall.set()
        assert release.wait(60)
        return orig(reqs)

    p.call_batch_group = stalled
    try:
        p.ingress.submit_many([batch_exec_factory("u", "fn", 1)],
                              source="s")
        assert stall.wait(60)  # the tick is held mid-"network"
        out = {}

        def waiter():
            out["d"] = p.ingress.submit(batch_exec_factory("u", "fn", 1),
                                        source="s", timeout=10.0)

        t = threading.Thread(target=waiter)
        t.start()
        _wait_for(lambda: p.ingress.stats()["queuedRequests"] == 1,
                  "the waiter queued")
        # Past the 10 s deadline, inside the 0.5 s grace
        clock.now += 10.25
        p.call_batch_group = orig
        release.set()
        t.join(60)
        d = out["d"]
        assert d is not None and d.app_id != NOT_ENOUGH_SLOTS
        assert d.n_messages == 1
    finally:
        release.set()
        p.call_batch_group = orig


def test_stop_with_stalled_tick_never_resurrects_zombie_thread(
        monkeypatch):
    """stop()'s join can expire while a tick is stalled in the network;
    a later start() and submission make a new tick thread, and the old
    one exits when its stalled call returns rather than come back."""
    monkeypatch.setattr(tick_mod.IngressCoordinator, "STOP_JOIN_SECONDS",
                        0.01)
    p = _planner()
    stall, release = threading.Event(), threading.Event()
    orig = p.call_batch_group

    def stalled(reqs):
        stall.set()
        assert release.wait(60)
        return orig(reqs)

    p.call_batch_group = stalled
    try:
        req = batch_exec_factory("u", "fn", 1)
        p.ingress.submit_many([req], source="s")
        assert stall.wait(60)
        t_old = p.ingress._thread
        p.ingress.stop()  # the join expires: the tick is mid-"network"
        assert t_old.is_alive()

        p.ingress.start()
        p.call_batch_group = orig
        req2 = batch_exec_factory("u", "fn", 1)
        p.ingress.submit_many([req2], source="s")
        t_new = p.ingress._thread
        assert t_new is not t_old

        release.set()
        t_old.join(60)
        assert not t_old.is_alive()  # the zombie saw it lost the loop
        _wait_for(lambda: all(p.get_scheduling_decision(r.app_id)
                              is not None for r in (req, req2)),
                  "both submissions scheduled")
        assert p.ingress.stats()["tickThreadAlive"]
        # Scoped to this coordinator's tick thread name
        ticks = [t for t in threading.enumerate()
                 if t.name == p.ingress._tick_name and t.is_alive()]
        assert ticks == [t_new]
    finally:
        release.set()
        p.call_batch_group = orig


def test_executor_idle_racing_flush_does_not_repark():
    """An executor whose last batch drains while flush() runs must not
    go back on the idle list: a later claim would get a dead executor
    whose pool thread has exited."""
    from faabric_tpu_torch.proto import func_to_string
    from faabric_tpu_torch.scheduler.scheduler import Scheduler

    s = Scheduler("idle-h", None)
    req = batch_exec_factory("u", "fn", 1)
    msg = req.messages[0]

    class StubExec:
        bound_msg = msg

        def shutdown(self):
            pass

    e = StubExec()
    func = func_to_string(msg)
    with s._lock:  # registered as claim_executor's create path does
        s._executors.setdefault(func, []).append(e)
        s._parkable.add(id(e))
    s.notify_executor_idle(e)
    assert s._idle[func] == [e]  # registered executors park

    s.flush()  # clears the registry and shuts the executor down
    s.notify_executor_idle(e)  # the racing epilogue arrives late
    assert func not in s._idle


# ---------------------------------------------------------------------------
# The pipelined wire forms
# ---------------------------------------------------------------------------
def test_execute_batches_wire_slices_per_request():
    from faabric_tpu_torch.proto import ber_to_wire
    from faabric_tpu_torch.scheduler.function_call import (
        FunctionCalls,
        FunctionCallServer,
    )
    from faabric_tpu_torch.transport.message import TransportMessage

    reqs = [batch_exec_factory("u", "fn", 1) for _ in range(3)]
    for i, r in enumerate(reqs):
        r.messages[0].input_data = bytes([i]) * (i + 1)
    pairs = [ber_to_wire(r) for r in reqs]
    seen = []
    stub = types.SimpleNamespace(
        scheduler=types.SimpleNamespace(execute_batch=seen.append))
    msg = TransportMessage(
        code=int(FunctionCalls.EXECUTE_BATCHES),
        header={"bers": [h for h, _ in pairs],
                "tails": [len(t) for _, t in pairs]},
        payload=b"".join(t for _, t in pairs))
    FunctionCallServer.do_async_recv(stub, msg)
    assert [r.app_id for r in seen] == [r.app_id for r in reqs]
    assert [r.messages[0].input_data for r in seen] == \
        [r.messages[0].input_data for r in reqs]


def test_bers_from_wire_rejects_tail_length_mismatch():
    """A frame whose tail lengths do not take exactly its payload is
    corrupt and fails as a frame."""
    from faabric_tpu_torch.proto import ber_to_wire, bers_from_wire

    reqs = [batch_exec_factory("u", "fn", 1) for _ in range(2)]
    for r in reqs:
        r.messages[0].input_data = b"xy"
    pairs = [ber_to_wire(r) for r in reqs]
    headers = [h for h, _ in pairs]
    tails = [t for _, t in pairs]
    payload = b"".join(tails)
    hdr = {"bers": headers, "tails": [len(t) for t in tails]}
    assert len(bers_from_wire(hdr, payload)) == 2
    with pytest.raises(ValueError, match="payload carries"):
        bers_from_wire(hdr, payload + b"extra")
    with pytest.raises(ValueError, match="payload carries"):
        bers_from_wire({"bers": headers,
                        "tails": [len(tails[0]), len(tails[1]) + 1]},
                       payload)


def test_bulk_submit_rpc_enqueues_every_app():
    from faabric_tpu_torch.planner.server import PlannerCalls, PlannerServer
    from faabric_tpu_torch.proto import bers_to_wire
    from faabric_tpu_torch.scheduler.function_call import get_batch_requests
    from faabric_tpu_torch.transport.message import TransportMessage

    p = _planner(slots=64)
    reqs = [batch_exec_factory("u", "fn", 1) for _ in range(5)]
    header, tail = bers_to_wire(reqs)
    msg = TransportMessage(code=int(PlannerCalls.SUBMIT_BATCH),
                           header={**header, "host": "client"},
                           payload=tail)
    resp = PlannerServer.do_sync_recv(types.SimpleNamespace(planner=p), msg)
    assert resp.header["accepted"]
    want = {r.app_id for r in reqs}
    _wait_for(lambda: want <= {r.app_id for _, r in get_batch_requests()},
              "every submitted app dispatched")


def test_tick_mappings_and_clear_groups_are_batched():
    from faabric_tpu_torch.transport.ptp_remote import get_sent_mappings

    p = _planner(slots=64, n_hosts=1)
    reqs = [batch_exec_factory("u", "fn", 1) for _ in range(4)]
    results, _ = p.call_batch_group(reqs)
    assert all(r is not None for r in results)
    sent = get_sent_mappings()
    # One mapping set per decision reached the host (mock mode records
    # each set; the wire carries them in one call)
    assert len(sent) == 4
    assert {m.group_id for _, m in sent} == {r.group_id for r in results}
    msgs = [r.messages[0] for r in reqs]
    for m in msgs:
        m.return_value = int(ReturnValue.SUCCESS)
    p.set_message_results(msgs)
    for r in reqs:
        assert p.get_batch_results(r.app_id).finished


# ---------------------------------------------------------------------------
# Both packages
# ---------------------------------------------------------------------------
def _twin(req, pk):
    """``req`` (a reference request) as a request of ``pk``."""
    return pk.proto.BatchExecuteRequest.from_dict(req.to_dict())


def _group_sequence(seed: int) -> list:
    """Reference requests of seeded widths and kinds for the group pass:
    plain FUNCTIONS and PROCESSES batches, one with a fixed group id, and
    (filled in by the test) a scale change of an app in flight."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(14):
        r = REF_PK.proto.batch_exec_factory(
            "u", f"fn{rng.randint(3)}", int(rng.randint(1, 5)))
        if i % 4 == 3:
            r.type = int(REF_PK.proto.BatchExecuteType.PROCESSES)
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_call_batch_group_places_as_the_reference_does(seed):
    """One host map and one request sequence through both planners'
    ``call_batch_group`` (two ticks: the second holds a scale change of
    a first-tick app, a frozen app, a preloaded app and more than the
    free slots) give the same hosts per message, the same deferred
    indices and the same backlog."""
    planners = {}
    for pk in (REF_PK, PORT_PK):
        pk.scheduler.get_decision_cache().clear()
        p = _track(pk.planner_mod.Planner())
        for ip, slots in (("pa", 8), ("pb", 6), ("pc", 5)):
            p.register_host(ip, slots, 0)
        planners[pk.name] = p
    # At most 12 of the 19 slots taken in the first tick: the second
    # places its first plain request and runs out of room later
    first = _group_sequence(seed)[:3]
    scale = REF_PK.proto.batch_exec_factory("u", "fn0", 1)
    scale.app_id = first[0].app_id
    frozen = REF_PK.proto.batch_exec_factory("u", "cold", 1)
    preloaded = REF_PK.proto.batch_exec_factory("u", "pre", 1)
    second = [scale, frozen, preloaded] + _group_sequence(seed + 10)
    outcomes = {}
    for pk in (REF_PK, PORT_PK):
        p = planners[pk.name]
        ticks = []
        for batch in (first, second):
            if batch is second:
                p._evicted[frozen.app_id] = _twin(frozen, pk)
                d = pk.scheduler.SchedulingDecision(preloaded.app_id, 0)
                d.add_message("pa", preloaded.messages[0].id, 0, 0)
                p.preload_scheduling_decision(d)
            results, deferred = p.call_batch_group(
                [_twin(r, pk) for r in batch])
            ticks.append(([None if r is None else list(r.hosts)
                           for r in results], sorted(deferred)))
        outcomes[pk.name] = ticks
    ref, port = outcomes[REF], outcomes[PORT]
    assert port == ref
    # The sequence reaches every branch: placed, deferred, backlogged
    results2, deferred2 = ref[1]
    assert deferred2 == [0, 1, 2]
    assert any(h is None for h in results2[3:])
    assert any(h is not None for h in results2[3:])


def _strip(rec):
    """A journal record without its write times."""
    if isinstance(rec, dict):
        return {k: _strip(v) for k, v in rec.items() if k != "ts"}
    if isinstance(rec, list):
        return [_strip(v) for v in rec]
    return rec


@pytest.mark.parametrize("writer", [REF, PORT])
def test_group_records_read_across_the_two_journals(writer, monkeypatch,
                                                    tmp_path):
    """The same tick through each package's planner over a journal: the
    group record the writer's journal holds reads back through the other
    package's ``load_journal_dir`` as the record that package writes."""
    reqs = []
    for i in range(6):
        r = REF_PK.proto.batch_exec_factory("u", f"fn{i % 2}", 1 + i % 3)
        r.group_id = 7000 + i  # no random group ids in the records
        reqs.append(r)
    groups = {}
    for pk in (REF_PK, PORT_PK):
        d = tmp_path / pk.name
        p = _journaled_planner(monkeypatch, d, pk)
        p.register_host("jh", 64, 0)
        # The lifecycle stamps ride the messages in the records: a tick
        # without metrics writes none
        twins = [_twin(r, pk) for r in reqs]
        for t in twins:
            for m in t.messages:
                m.lc = {}
        monkeypatch.setattr(pk.planner_mod, "_LC",
                            types.SimpleNamespace(
                                stamp_many=lambda *a, **k: None,
                                stamp_first=lambda *a, **k: None))
        results, deferred = p.call_batch_group(twins)
        assert not deferred and all(r is not None for r in results)
        p.flush_journal()
        p.close_journal()
        groups[pk.name] = str(d)
    reader = PORT if writer == REF else REF
    read_pk = PORT_PK if reader == PORT else REF_PK
    _, across, meta = read_pk.journal.load_journal_dir(groups[writer])
    _, own, _ = read_pk.journal.load_journal_dir(groups[reader])
    assert not meta["torn"]
    g_across = [r for r in across if r["k"] == "group"]
    g_own = [r for r in own if r["k"] == "group"]
    assert len(g_across) == len(g_own) == 1 and g_own[0]["n"] == 6
    assert _strip(g_across) == _strip(g_own)
