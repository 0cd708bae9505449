"""The planner's write-ahead journal, restart replay and reconcile, and
the planner client's result buffering and resync: the port against the
JAX package.

The reference's 19 cases of ``tests/unit/test_journal.py`` run on the
port with the same inputs: the record codec, torn tails, the null
journal, replay and its idempotence, slot re-claims, compaction, the
reconcile, the journal's stats and replay stats through
``health_summary``, the state-master corpse fixes, the client's outage buffer, keep-alive,
waiter bookkeeping and resync, and ``journaldump``. Then the cross-package
cases: record bytes; a journal written by one package's planner through
a scripted sequence (hosts, a NEW batch, results, a spot freeze, state
claims with a failover, a compaction) replays in both to equal
``_journal_snapshot_locked()`` fingerprints, both ways; torn tails and
CRC breaks stop both replays at the same record; both ``journaldump``
CLIs print the same text and exit alike; a port client against a
reference planner server and the reverse (a buffered result arrives
through ``FLUSH_RESULTS``, a changed ``boot`` makes one resync round).
Nothing waits on a clock except the reconcile case, which polls to a
deadline as the reference's does.
"""

import importlib
import json
import os
import shutil
import threading
import time
import types

import pytest

pytest.importorskip("jax")

from faabric_tpu_torch.planner.journal import (  # noqa: E402
    HEADER_LEN,
    JOURNAL_FILE,
    NULL_JOURNAL,
    SNAPSHOT_FILE,
    PlannerJournal,
    decode_records,
    encode_record,
    load_journal_dir,
)
from faabric_tpu_torch.proto import (  # noqa: E402
    ReturnValue,
    batch_exec_factory,
)
from faabric_tpu_torch.util.config import get_system_config  # noqa: E402
from faabric_tpu_torch.util.testing import set_mock_mode  # noqa: E402

REF, PORT = "faabric_tpu", "faabric_tpu_torch"


def pkg(name: str) -> types.SimpleNamespace:
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in {
        "planner": "planner", "planner_mod": "planner.planner",
        "client": "planner.client", "journal": "planner.journal",
        "dump": "runner.journaldump", "proto": "proto",
        "common": "transport.common", "testing": "util.testing",
        "config": "util.config",
        "scheduler": "batch_scheduler",
        "decision": "batch_scheduler.decision"}.items()}
    return types.SimpleNamespace(name=name, **mods)


REF_PK, PORT_PK = pkg(REF), pkg(PORT)

# Planners opened over a journal directory in a test: their journals are
# closed (drain thread, fd, reconcile timer) when it ends
_opened: list = []


@pytest.fixture(autouse=True)
def _isolate():
    yield
    while _opened:
        _opened.pop().close_journal()
    for pk in (REF_PK, PORT_PK):
        pk.testing.set_mock_mode(False)
        pk.common.clear_host_aliases()
        pk.scheduler.reset_batch_scheduler()
    PORT_PK.planner.get_planner().reset()
    # After monkeypatch has restored the environment (this fixture is set
    # up before the tests' own, so it is torn down after them)
    for pk in (REF_PK, PORT_PK):
        pk.config.get_system_config().reset()


# ---------------------------------------------------------------------------
# Record codec
# ---------------------------------------------------------------------------
def test_record_encode_decode_roundtrip():
    recs = [("host_register", {"ip": "w0", "slots": 8, "n_devices": 4}),
            ("result", {"msg": {"id": 7, "output_data": "ff00"}}),
            ("state_claim", {"key": "u/k", "host": "w1"})]
    blob = b"".join(encode_record(k, f) for k, f in recs)
    decoded, end, torn = decode_records(blob)
    assert not torn and end == len(blob)
    assert [(r["k"],) for r in decoded] == [(k,) for k, _ in recs]
    for (_, fields), rec in zip(recs, decoded):
        for key, val in fields.items():
            assert rec[key] == val
        assert rec["ts"] > 0


def test_crc_rejection_stops_replay_at_corruption():
    good = encode_record("a", {"n": 1}) + encode_record("b", {"n": 2})
    tail = encode_record("c", {"n": 3})
    corrupt = bytearray(good + tail)
    corrupt[-3] ^= 0xFF
    decoded, end, torn = decode_records(bytes(corrupt))
    assert torn and end == len(good)
    assert [r["k"] for r in decoded] == ["a", "b"]


def test_torn_tail_is_truncated_on_reopen(tmp_path):
    d = str(tmp_path)
    j = PlannerJournal(d, fsync_interval=0.0)
    j.append("one", {"n": 1})
    j.append("two", {"n": 2})
    j.close()
    path = os.path.join(d, JOURNAL_FILE)
    with open(path, "ab") as f:
        f.write(encode_record("torn", {"n": 3})[:-4])
    _, records, meta = load_journal_dir(d)
    assert [r["k"] for r in records] == ["one", "two"]
    assert meta["torn"] and meta["torn_bytes"] > 0
    j2 = PlannerJournal(d)
    assert j2.records == 2
    j2.append("three", {"n": 3})
    j2.close()
    _, records, meta = load_journal_dir(d)
    assert [r["k"] for r in records] == ["one", "two", "three"]
    assert not meta["torn"]


def test_null_journal_is_inert():
    assert not NULL_JOURNAL.enabled
    NULL_JOURNAL.append("x", {"y": 1})
    NULL_JOURNAL.flush()
    assert NULL_JOURNAL.replay() == (None, [], {"enabled": False})
    assert NULL_JOURNAL.stats() == {"enabled": False}


# ---------------------------------------------------------------------------
# Planner replay
# ---------------------------------------------------------------------------
def _journaled_planner(monkeypatch, tmp_path, pk=PORT_PK, **env):
    monkeypatch.setenv("FAABRIC_PLANNER_JOURNAL_DIR", str(tmp_path))
    # The reconcile must not fire mid-test unless the test waits for it
    monkeypatch.setenv("FAABRIC_PLANNER_RECONCILE_GRACE",
                       env.pop("grace", "30"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pk.config.get_system_config().reset()
    p = pk.planner_mod.Planner()
    _opened.append(p)
    return p


def _state_fingerprint(planner):
    with planner._lock:
        return json.dumps(planner._journal_snapshot_locked(),
                          sort_keys=True, default=str)


def test_replay_restores_state_and_is_idempotent(monkeypatch, tmp_path):
    set_mock_mode(True)
    p = _journaled_planner(monkeypatch, tmp_path)
    p.register_host("h1", 8, 4)
    p.register_host("h2", 4, 2)
    req = batch_exec_factory("u", "fn", 6)
    p.call_batch(req)
    p.claim_state_master("u", "k1", "h1")
    p.claim_state_master("u", "k2", "h2")
    p.drop_state_master("u", "k2")
    for m in list(req.messages)[:4]:
        m.return_value = int(ReturnValue.SUCCESS)
        m.output_data = b"done"
        p.set_message_result(m)
    p.flush_journal()

    p2 = _journaled_planner(monkeypatch, tmp_path)
    assert p2._expected[req.app_id] == 6
    assert len(p2._results[req.app_id]) == 4
    assert p2.get_scheduling_decision(req.app_id).n_messages == 2
    assert p2._state_masters == {"u/k1": "h1"}
    assert p2._journal_replay_stats["inFlightApps"] == 1
    fp2 = _state_fingerprint(p2)

    p3 = _journaled_planner(monkeypatch, tmp_path)
    snapshot, records, _ = p3._journal.replay()
    with p3._lock:
        for rec in records:  # a second application of the same log
            p3._apply_journal_record_locked(rec)
    assert _state_fingerprint(p3) == fp2

    for m in list(p2.get_scheduling_decision(req.app_id).message_ids):
        orig = next(x for x in req.messages if x.id == m)
        orig.return_value = int(ReturnValue.SUCCESS)
        p2.set_message_result(orig)
    status = p2.get_batch_results(req.app_id)
    assert status.finished and len(status.message_results) == 6


def test_replayed_host_rows_reclaim_slots_on_reregister(monkeypatch,
                                                        tmp_path):
    set_mock_mode(True)
    p = _journaled_planner(monkeypatch, tmp_path)
    p.register_host("h1", 8, 0)
    req = batch_exec_factory("u", "fn", 5)
    p.call_batch(req)
    p.flush_journal()

    p2 = _journaled_planner(monkeypatch, tmp_path)
    p2.register_host("h1", 8, 0, overwrite=True)
    h = next(x for x in p2.get_available_hosts() if x.ip == "h1")
    assert h.used_slots == 5


def test_snapshot_compaction_folds_and_replays(monkeypatch, tmp_path):
    set_mock_mode(True)
    p = _journaled_planner(
        monkeypatch, tmp_path,
        FAABRIC_PLANNER_JOURNAL_COMPACT_RECORDS="10")
    p.register_host("h1", 16, 0)
    done = []
    for _ in range(4):
        req = batch_exec_factory("u", "fn", 3)
        p.call_batch(req)
        for m in list(req.messages):
            m.return_value = int(ReturnValue.SUCCESS)
            p.set_message_result(m)
        done.append(req.app_id)
    assert p._journal.compactions >= 1
    assert os.path.exists(os.path.join(str(tmp_path), SNAPSHOT_FILE))
    assert p._journal.since_compact < 10 + 3
    p.flush_journal()

    p2 = _journaled_planner(monkeypatch, tmp_path)
    for app_id in done:
        status = p2.get_batch_results(app_id)
        assert status.finished and len(status.message_results) == 3
    assert _state_fingerprint(p2) == _state_fingerprint(p)


def test_reconcile_requeues_only_unregistered_hosts(monkeypatch, tmp_path):
    set_mock_mode(True)
    p = _journaled_planner(monkeypatch, tmp_path)
    p.register_host("h1", 4, 0)
    p.register_host("h2", 4, 0)
    req = batch_exec_factory("u", "fn", 8)
    dec = p.call_batch(req)
    assert set(dec.hosts) == {"h1", "h2"}
    p.claim_state_master("u", "k", "h2")
    p.flush_journal()

    p2 = _journaled_planner(monkeypatch, tmp_path, grace="0.4")
    # h1 rejoins, grown to 8 slots so that the requeue fits; h2 never
    # comes back
    p2.register_host("h1", 8, 0, overwrite=True)
    deadline = time.time() + 10
    while p2._reconcile_stats is None and time.time() < deadline:
        time.sleep(0.05)
    assert p2._reconcile_stats is not None, "reconcile never ran"
    assert p2._reconcile_stats["missingHosts"] == ["h2"]
    assert p2._reconcile_stats["requeuedMessages"] == 4
    assert p2._reconcile_stats["droppedStateMasters"] == 1
    deadline = time.time() + 10
    live = None
    while time.time() < deadline:
        live = p2.get_scheduling_decision(req.app_id)
        if live is not None and set(live.hosts) == {"h1"}:
            break
        time.sleep(0.05)
    assert live is not None and set(live.hosts) == {"h1"}, live
    assert live.n_messages == 8


def test_healthz_reports_journal_and_replay(monkeypatch, tmp_path):
    set_mock_mode(True)
    p = _journaled_planner(monkeypatch, tmp_path)
    p.register_host("h1", 2, 0)
    health = p.health_summary()
    j = health["journal"]
    assert j["enabled"] and j["records"] >= 1
    assert j["sizeBytes"] > HEADER_LEN
    assert "lastFsyncAgeSeconds" in j
    p.flush_journal()

    p2 = _journaled_planner(monkeypatch, tmp_path)
    j2 = p2.health_summary()["journal"]
    assert j2["lastReplay"]["records"] >= 1
    assert j2["lastReplay"]["lastKnownHosts"] == ["h1"]


def test_journal_disabled_healthz_and_noop():
    from faabric_tpu_torch.planner.planner import Planner

    set_mock_mode(True)
    p = Planner()
    assert not p._journal.enabled
    p.register_host("h1", 2, 0)
    assert p.health_summary()["journal"] == {"enabled": False}


# ---------------------------------------------------------------------------
# State-master corpse fixes
# ---------------------------------------------------------------------------
def test_expire_hosts_drops_dead_state_masters(monkeypatch):
    from faabric_tpu_torch.planner.planner import Planner

    set_mock_mode(True)
    monkeypatch.setenv("PLANNER_HOST_TIMEOUT", "0.2")
    get_system_config().reset()
    p = Planner()
    p.register_host("alive", 2, 0)
    p.register_host("doomed", 2, 0)
    assert p.claim_state_master("u", "k", "doomed")[0] == "doomed"
    assert p.claim_state_master("u", "k2", "alive")[0] == "alive"
    # Past the timeout without a keep-alive (the reference sleeps 0.3 s)
    with p._lock:
        p._hosts["doomed"].register_ts -= 0.3
    p.register_host("alive", 2, 0)
    p.expire_hosts()
    assert p.num_registered_hosts() == 1
    assert p.claim_state_master("u", "k", "alive")[0] == "alive"
    assert p.claim_state_master("u", "k2", "alive")[0] == "alive"


def test_remove_host_drops_masters_and_claim_reelects():
    from faabric_tpu_torch.planner.planner import Planner

    set_mock_mode(True)
    p = Planner()
    p.register_host("h1", 2, 0)
    p.register_host("h2", 2, 0)
    assert p.claim_state_master("u", "k", "h1")[0] == "h1"
    p.remove_host("h1")
    assert p.claim_state_master("u", "k", "h2")[0] == "h2"
    p2 = Planner()
    assert p2.claim_state_master("u", "k", "x")[0] == "x"
    assert p2.claim_state_master("u", "k", "y")[0] == "x"


# ---------------------------------------------------------------------------
# Client degraded mode
# ---------------------------------------------------------------------------
def test_client_buffers_results_while_planner_down():
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.planner.client import PlannerClient
    from faabric_tpu_torch.proto import message_factory
    from faabric_tpu_torch.transport.common import register_host_alias
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("deadplanner", "127.0.0.1", base)
    client = PlannerClient("w0", planner_host="deadplanner")
    client.retry.max_attempts = 1  # nothing listens there
    try:
        msg = message_factory("u", "fn")
        msg.return_value = int(ReturnValue.SUCCESS)
        client.set_message_result(msg)
        assert client.planner_down
        assert len(client._pending_results) == 1
        client.flush_pending_results()
        assert len(client._pending_results) == 1

        get_planner().reset()
        server = PlannerServer(port_offset=base)
        server.start()
        try:
            client.flush_pending_results()
            assert client._pending_results == []
            assert get_planner().get_message_result(
                msg.app_id, msg.id) is not None
        finally:
            server.stop()
            get_planner().reset()
    finally:
        client.close()


def test_keepalive_survives_dead_planner():
    from faabric_tpu_torch.planner.client import (
        KeepAliveThread,
        PlannerClient,
    )
    from faabric_tpu_torch.transport.common import register_host_alias
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("noplanner", "127.0.0.1", base)
    client = PlannerClient("w1", planner_host="noplanner")
    client.retry.max_attempts = 1
    try:
        ka = KeepAliveThread(client, slots=2, n_devices=0)
        ka.do_work()
        ka.do_work()
        assert client.planner_down
    finally:
        client.close()


def test_get_message_result_cleans_up_waiter_on_rpc_error():
    from faabric_tpu_torch.planner.client import PlannerClient
    from faabric_tpu_torch.transport.client import RpcError
    from faabric_tpu_torch.transport.common import register_host_alias
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("goneplanner", "127.0.0.1", base)
    client = PlannerClient("w2", planner_host="goneplanner")
    client.retry.max_attempts = 1
    try:
        with pytest.raises(RpcError):
            client.get_message_result(1, 42, timeout=1.0)
        assert client._result_events == {}
        assert client._result_interest == {}
    finally:
        client.close()


def test_concurrent_waiter_survives_peer_rpc_error():
    """Two threads blocked on one msg_id share its event; one waiter's
    RpcError must not unregister the other."""
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.planner.client import PlannerClient
    from faabric_tpu_torch.proto import message_factory
    from faabric_tpu_torch.transport.client import RpcError
    from faabric_tpu_torch.transport.common import register_host_alias
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("pairplanner", "127.0.0.1", base)
    get_planner().reset()
    server = PlannerServer(port_offset=base)
    server.start()
    client = PlannerClient("w4", planner_host="pairplanner")
    try:
        got: dict = {}
        asked = threading.Event()
        real_send = client.sync_send

        def first_send(*a, **k):
            try:
                return real_send(*a, **k)
            finally:
                asked.set()

        client.sync_send = first_send
        t = threading.Thread(
            target=lambda: got.update(
                msg=client.get_message_result(9, 77, timeout=20)),
            daemon=True)
        t.start()
        assert asked.wait(5)
        assert 77 in client._result_events

        client.sync_send = lambda *a, **k: (_ for _ in ()).throw(
            RpcError("injected"))
        try:
            with pytest.raises(RpcError):
                client.get_message_result(9, 77, timeout=5)
        finally:
            client.sync_send = real_send
        assert 77 in client._result_events
        assert 77 in client._result_interest

        msg = message_factory("u", "fn")
        msg.app_id, msg.id = 9, 77
        msg.return_value = int(ReturnValue.SUCCESS)
        client.set_message_result_locally(msg)
        t.join(5)
        assert not t.is_alive()
        assert got["msg"].id == 77
        assert client._result_events == {}
        assert client._result_waiters == {}
    finally:
        client.close()
        server.stop()
        get_planner().reset()


def test_waiter_nudges_resync_when_healthy_planner_push_is_lost():
    """A push lost on a dead connection fires no restart signal: the
    blocked waiter nudges its id each interval and the keep-alive's next
    round re-polls it and delivers the stored result."""
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.planner.client import (
        KeepAliveThread,
        PlannerClient,
    )
    from faabric_tpu_torch.proto import message_factory
    from faabric_tpu_torch.transport.common import register_host_alias
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("pushplanner", "127.0.0.1", base)
    get_planner().reset()
    server = PlannerServer(port_offset=base)
    server.start()
    client = PlannerClient("w5", planner_host="pushplanner")
    conf = get_system_config()
    old_timeout = conf.planner_host_timeout
    conf.planner_host_timeout = 0.8  # the waiter nudges after 0.4 s
    try:
        client.register_host(2, 0)
        got: dict = {}
        t = threading.Thread(
            target=lambda: got.update(
                msg=client.get_message_result(11, 55, timeout=10)),
            daemon=True)
        t.start()
        deadline = time.time() + 5
        while 55 not in client._result_events and time.time() < deadline:
            time.sleep(0.02)
        assert 55 in client._result_events

        # Stored at the planner directly: its push to "w5" (no function
        # server, no alias) is the lost push
        msg = message_factory("u", "fn")
        msg.app_id, msg.id = 11, 55
        msg.return_value = int(ReturnValue.SUCCESS)
        get_planner().set_message_result(msg)

        ka = KeepAliveThread(client, slots=2, n_devices=0)
        deadline = time.time() + 5
        while "msg" not in got and time.time() < deadline:
            ka.do_work()
            time.sleep(0.1)
        assert got.get("msg") is not None and got["msg"].id == 55
        assert client._result_events == {}
        assert client._result_waiters == {}
    finally:
        conf.planner_host_timeout = old_timeout
        client.close()
        server.stop()
        get_planner().reset()


def test_resync_gated_on_planner_incarnation_change():
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.planner.client import (
        KeepAliveThread,
        PlannerClient,
    )
    from faabric_tpu_torch.transport.common import register_host_alias
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("bootplanner", "127.0.0.1", base)
    get_planner().reset()
    server = PlannerServer(port_offset=base)
    server.start()
    client = PlannerClient("w3", planner_host="bootplanner")
    try:
        resyncs: list[int] = []
        real_resync = client.resync_result_interest
        client.resync_result_interest = (
            lambda: resyncs.append(1) is None and real_resync())

        client.register_host(2, 0)
        assert client._planner_boot == get_planner().boot_id
        ka = KeepAliveThread(client, slots=2, n_devices=0)
        ka.do_work()
        assert not resyncs and not client._resync_all

        client._planner_boot = "previous-incarnation"
        ka.do_work()
        assert resyncs and not client._resync_all
        assert client._planner_boot == get_planner().boot_id
    finally:
        client.close()
        server.stop()
        get_planner().reset()


# ---------------------------------------------------------------------------
# journaldump CLI
# ---------------------------------------------------------------------------
def test_journaldump_renders_and_verifies(tmp_path, capsys):
    from faabric_tpu_torch.runner import journaldump

    d = str(tmp_path)
    j = PlannerJournal(d, fsync_interval=0.0)
    j.append("host_register", {"ip": "w0", "slots": 4})
    j.append("result", {"msg": {"id": 9, "app_id": 3}})
    j.close()

    assert journaldump.main([d]) == 0
    out = capsys.readouterr().out
    assert "host_register" in out and "result" in out
    assert journaldump.main([d, "--verify"]) == 0
    capsys.readouterr()
    assert journaldump.main([d, "--kind", "result", "--json"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert [r["k"] for r in body["records"]] == ["result"]

    with open(os.path.join(d, JOURNAL_FILE), "ab") as f:
        f.write(b"\x99\x00\x00\x00garbage")
    assert journaldump.main([d, "--verify"]) == 2
    assert journaldump.main([d]) == 0


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------
RECORDS = [
    ("host_register", {"ip": "w0", "slots": 8, "n_devices": 4}),
    ("app_update", {"app_id": 12, "expected": 3, "next_idx": 3,
                    "group": [[5], ["w0", "w1"]]}),
    ("result", {"msg": {"id": 7, "app_id": 12, "output_data": "ff00"}}),
    ("state_failover", {"key": "u/k", "host": "w1", "backup": "w2",
                        "epoch": 2}),
    ("group", {"n": 1, "recs": [{"k": "app_update", "ts": 5.25,
                                 "app_id": 1}]}),
    ("reset", {}),
]


@pytest.mark.parametrize("kind,fields", RECORDS,
                         ids=[k for k, _ in RECORDS])
def test_encode_record_bytes_match_reference(kind, fields):
    ts = 1760745600.125
    assert encode_record(kind, fields, ts=ts) == \
        REF_PK.journal.encode_record(kind, fields, ts=ts)
    blob = b"".join(REF_PK.journal.encode_record(k, f, ts=ts)
                    for k, f in RECORDS)
    assert decode_records(blob) == REF_PK.journal.decode_records(blob)


def script_planner(pk, directory: str, monkeypatch) -> None:
    """The scripted sequence: two hosts and a NEW batch of 6, folded by
    a compaction into the snapshot; then in the journal's tail a spot
    freeze of a second app, 4 results of the first, a third host, state
    claims, a drop and a failover. The journal is closed as a clean stop
    would."""
    pk.testing.set_mock_mode(True)
    p = _journaled_planner(monkeypatch, directory, pk=pk)
    pk.scheduler.reset_batch_scheduler("spot")
    p.register_host("hA", 4, 2)
    p.register_host("hB", 4, 2)
    req = pk.proto.batch_exec_factory("u", "fn", 6)
    p.call_batch(req)
    # What the planner does when the log crosses its threshold
    with p._lock:
        p._journal.compact(p._journal_snapshot_locked())
    # The spot app takes the last 2 slots; evicted there with the other
    # host full, it must freeze
    spot = pk.proto.batch_exec_factory("u", "spot", 2)
    spot_hosts = set(p.call_batch(spot).hosts)
    assert len(spot_hosts) == 1
    p.set_next_evicted_host_ips(sorted(spot_hosts))
    frozen = p.check_migration(spot.app_id)
    assert frozen is not None
    assert frozen.app_id == pk.decision.MUST_FREEZE
    p.set_next_evicted_host_ips([])
    for m in list(req.messages)[:4]:
        m.return_value = int(pk.proto.ReturnValue.SUCCESS)
        m.output_data = b"done"
        p.set_message_result(m)
    p.register_host("hC", 4, 0)
    for key, host in (("k1", "hA"), ("k2", "hB"), ("k3", "hC")):
        p.claim_state_master("u", key, host)
    p.drop_state_master("u", "k3")
    p.remove_host("hA")  # k1 fails over to its backup
    p.close_journal()


def replay_fingerprint(pk, directory: str, monkeypatch) -> tuple:
    p = _journaled_planner(monkeypatch, directory, pk=pk)
    stats = p._journal_replay_stats
    return (_state_fingerprint(p),
            {k: stats[k] for k in ("inFlightApps", "inFlightMessages",
                                   "results", "stateMasters",
                                   "lastKnownHosts", "records")})


@pytest.mark.parametrize("writer", [REF, PORT])
def test_journal_of_either_package_replays_in_both(writer, tmp_path,
                                                   monkeypatch):
    """A journal dir written by ``writer``'s planner replays in each
    package (each on its own copy: a replay compacts the dir) to equal
    fingerprints and replay stats."""
    w = REF_PK if writer == REF else PORT_PK
    src = str(tmp_path / "written")
    script_planner(w, src, monkeypatch)
    _, records, meta = load_journal_dir(src)
    assert meta["snapshot"] and {"app_update", "app_freeze", "result",
                                 "host_register", "state_claim",
                                 "state_drop", "host_remove",
                                 "state_failover"} <= {r["k"]
                                                       for r in records}
    got = {}
    for pk in (REF_PK, PORT_PK):
        copy = str(tmp_path / pk.name)
        shutil.copytree(src, copy)
        got[pk.name] = replay_fingerprint(pk, copy, monkeypatch)
    assert got[PORT] == got[REF]
    fp, stats = got[PORT]
    assert stats["inFlightApps"] == 1 and stats["inFlightMessages"] == 2
    assert stats["results"] == 4 and stats["stateMasters"] == 2
    assert stats["lastKnownHosts"] == ["hB", "hC"]
    state = json.loads(fp)
    assert len(state["evicted"]) == 1
    assert state["state_masters"]["u/k1"] in ("hB", "hC")
    assert state["state_epochs"]["u/k1"] == 2


def _journal_of_records(directory: str) -> list[int]:
    """A journal of a registered host and an app with two results; the
    records' end offsets."""
    from faabric_tpu_torch.batch_scheduler.decision import (
        SchedulingDecision,
    )
    from faabric_tpu_torch.proto import message_factory

    j = PlannerJournal(directory, fsync_interval=0.0)
    ends = []
    req = batch_exec_factory("u", "fn", 2)
    j.append_durable("host_register", {"ip": "h1", "slots": 4,
                                       "n_devices": 0})
    ends.append(j.size_bytes)
    decision = SchedulingDecision(req.app_id, 3)
    for i, m in enumerate(req.messages):
        decision.add_message("h1", m.id, i, i)
    j.append_durable("app_update", {"app_id": req.app_id, "expected": 2,
                                    "next_idx": 2, "group": [[3], ["h1"]],
                                    "req": req.to_dict(),
                                    "decision": decision.to_dict()})
    ends.append(j.size_bytes)
    for m in req.messages:
        done = message_factory("u", "fn")
        done.app_id, done.id = req.app_id, m.id
        done.return_value = int(ReturnValue.SUCCESS)
        j.append_durable("result", {"msg": done.to_dict()})
        ends.append(j.size_bytes)
    j.close()
    return ends


@pytest.mark.parametrize("damage", ["torn", "crc"])
def test_torn_tail_and_crc_break_stop_both_replays_alike(damage, tmp_path,
                                                         monkeypatch):
    src = str(tmp_path / "written")
    ends = _journal_of_records(src)
    path = os.path.join(src, JOURNAL_FILE)
    with open(path, "r+b") as f:
        if damage == "torn":
            f.seek(0, os.SEEK_END)
            f.write(encode_record("result", {"msg": {"id": 1}})[:-5])
            kept = 4
        else:
            # One payload byte of the third record: the replay keeps the
            # two before it
            f.seek(ends[1] + 12)
            byte = f.read(1)
            f.seek(ends[1] + 12)
            f.write(bytes([byte[0] ^ 0x20]))
            kept = 2
    loads = [pk.journal.load_journal_dir(src) for pk in (REF_PK, PORT_PK)]
    assert loads[0][1] == loads[1][1] and loads[0][2] == loads[1][2]
    assert len(loads[1][1]) == kept and loads[1][2]["torn"]
    got = {}
    for pk in (REF_PK, PORT_PK):
        copy = str(tmp_path / pk.name)
        shutil.copytree(src, copy)
        got[pk.name] = replay_fingerprint(pk, copy, monkeypatch)
    assert got[PORT] == got[REF]
    # Opening the journal truncated the damage: the replay applies the
    # valid prefix
    assert got[PORT][1]["records"] == kept
    assert got[PORT][1]["results"] == kept - 2


@pytest.mark.parametrize("pk", [REF_PK, PORT_PK], ids=["reference",
                                                        "port"])
def test_async_send_returns_its_failed_attempts(pk, monkeypatch):
    """0 for a frame that went out first time, and the failed attempts
    before it otherwise: a non-zero count tells the planner client that
    an earlier push may have died in the old connection."""
    tclient = importlib.import_module(f"{pk.name}.transport.client")
    client = tclient.MessageEndpointClient("nowhere", 1, 2)
    client.retry.backoff = 0.0
    fails = iter([True, False, False])
    sent = []

    def send_frame(sock, msg):
        if next(fails):
            raise OSError("broken pipe")
        sent.append(msg.code)

    monkeypatch.setattr(tclient, "send_frame", send_frame)
    monkeypatch.setattr(client, "_get_sock", lambda plane: None)
    assert client.async_send(5) == 1
    assert client.async_send(6) == 0
    assert sent == [5, 6]


DUMP_ARGS = [[], ["--verify"], ["--kind", "result"], ["--json"],
             ["--last", "2"], ["--kind", "app_update", "--json"]]


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn"])
def test_journaldump_prints_what_the_reference_prints(torn, tmp_path,
                                                      capsys, monkeypatch):
    d = str(tmp_path / "j")
    script_dir = str(tmp_path / "scripted")
    script_planner(PORT_PK, script_dir, monkeypatch)
    # The compacted dir plus a tail with a group commit of the reference
    shutil.copytree(script_dir, d)
    with open(os.path.join(d, JOURNAL_FILE), "ab") as f:
        f.write(encode_record("group", {"n": 2, "recs": [
            {"k": "app_update", "ts": 1.0, "app_id": 5, "expected": 1},
            {"k": "result", "ts": 1.0, "msg": {"id": 3, "app_id": 5}}]},
            ts=2.0))
        if torn:
            f.write(b"\x99\x00\x00\x00garbage")
    for args in DUMP_ARGS:
        outs = []
        for pk in (REF_PK, PORT_PK):
            rc = pk.dump.main([d, *args])
            cap = capsys.readouterr()
            outs.append((rc, cap.out, cap.err))
        assert outs[1] == outs[0], args
        want_rc = 2 if torn and "--verify" in args else 0
        assert outs[1][0] == want_rc


@pytest.mark.parametrize("client_name,server_name",
                         [(PORT, REF), (REF, PORT)],
                         ids=["port_client", "port_server"])
def test_result_plane_across_packages(client_name, server_name):
    """A result pushed while the planner is down buffers on the client
    and arrives through ``FLUSH_RESULTS`` once the other package's
    planner server is up; a healthy keep-alive tick makes no resync
    round, and one that sees a changed ``boot`` makes exactly one."""
    from tests.conftest import next_port_base

    cpk = PORT_PK if client_name == PORT else REF_PK
    spk = PORT_PK if server_name == PORT else REF_PK
    base = next_port_base()
    cpk.common.register_host_alias("xplanner", "127.0.0.1", base)
    client = cpk.client.PlannerClient("xw0", planner_host="xplanner")
    client.retry.max_attempts = 1
    planner = spk.planner.get_planner()
    planner.reset()
    server = spk.planner.PlannerServer(port_offset=base)
    codes: list[int] = []
    real_sync = server.do_sync_recv
    server.do_sync_recv = lambda msg: (codes.append(msg.code), real_sync(
        msg))[1]
    try:
        msg = cpk.proto.message_factory("u", "fn")
        msg.return_value = int(cpk.proto.ReturnValue.SUCCESS)
        msg.output_data = b"buffered"
        client.set_message_result(msg)
        assert client.planner_down and len(client._pending_results) == 1

        server.start()
        ka = cpk.client.KeepAliveThread(client, slots=2, n_devices=0)
        resyncs: list[int] = []
        real_resync = client.resync_result_interest
        client.resync_result_interest = (
            lambda: resyncs.append(1) is None and real_resync())
        ka.do_work()  # the end of the outage: rejoin, flush, one resync
        assert client._pending_results == [] and not client.planner_down
        flush = int(spk.planner.PlannerCalls.FLUSH_RESULTS)
        assert flush == 16 and codes.count(flush) == 1
        got = planner.get_message_result(msg.app_id, msg.id)
        assert got is not None and got.output_data == b"buffered"
        assert client._planner_boot == planner.boot_id
        assert len(resyncs) == 1

        ka.do_work()  # healthy: no resync
        assert len(resyncs) == 1 and not client._resync_all
        client._planner_boot = "previous-incarnation"
        ka.do_work()
        assert len(resyncs) == 2 and not client._resync_all
        assert client._planner_boot == planner.boot_id
    finally:
        client.close()
        server.stop()
        planner.reset()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 25 at a small width on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_restart_phase_small():
    """Phase 25 with its planner child process: a batch of 8 outlives a
    SIGKILLed planner (4 requests held in their guests across the kill,
    the restart replaying the journal, the held results flushed, no
    request run twice, the journal verified), then the batch with the
    journal on and off."""
    import torch

    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.ops import _build
    from faabric_tpu_torch.transport.common import STATE_ASYNC_PORT
    from tests.test_torch_mpi import _hold_ports
    from tests.test_torch_multiprocess import port_slot

    cfg = ModelConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=1,
                      d_ff=256, max_seq=64, attention_impl="reference",
                      norm_impl="reference", compute_dtype=torch.float32)
    # The planner child takes seconds to bind the slot, and the workers
    # bind theirs only after it: a listening socket on a port of the slot
    # that nothing of the phase binds (the planner's offset's state port)
    # keeps other test workers' next_port_base() off the slot meanwhile
    for _ in range(20):
        base = port_slot()
        sentinel = _hold_ports([base + STATE_ASYNC_PORT], listen=True)
        if sentinel:
            break
    assert sentinel, "no free port slot"
    # A longer host timeout and grace than the card's: a loaded test
    # worker must not expire a live host or reconcile before its rejoin
    try:
        launches = chip_smoke.restart_phase(
            torch.device("cpu"), _build, cfg=cfg, serve_len=16, n_new=4,
            base=base, host_timeout=6.0, grace=15.0)
    finally:
        sentinel[0].close()
    assert launches == {}  # the plain versions run on the CPU
