"""The port's state and snapshot ledger against the JAX package's.

Counterpart of ``tests/unit/test_statestats.py``: the per-key access
ledger of the port's ``StateKeyValue`` against hand-computed bytes, the
cardinality cap's ``other`` bucket, the metrics-off no-op identity,
state time charged to the running invocation, the statemap merge and
render, the snapshot events and registry residency, and the port
doctor's state analyzers on planted skew. Cross-package: the same ops
on a port and a reference key give the same ledger rows, and the same
telemetry gives the same statemap.
"""

import numpy as np
import pytest

from faabric_tpu_torch.state import STATE_CHUNK_SIZE, State, StateKeyValue
from faabric_tpu_torch.state.backend import StateAuthority
from faabric_tpu_torch.telemetry.statestats import (
    NULL_STATE_STATS,
    OTHER,
    StateStatsStore,
    aggregate_statemap,
    get_state_stats,
    merge_placement,
    render_statemap,
    reset_state_stats,
)


@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    from tests.test_torch_telemetry import clean_port_telemetry, port_singletons

    saved = port_singletons()
    yield
    clean_port_telemetry(saved)


def _live_store():
    reset_state_stats()
    store = get_state_stats()
    assert store.enabled, "metrics are on by default in the test env"
    store.reset()
    return store


def _key_row(store, full_key):
    for row in store.snapshot()["keys"]:
        if row["key"] == full_key:
            return row
    raise AssertionError(f"no ledger row for {full_key}")


class MemoryAuthority(StateAuthority):
    """In-proc remote-shaped authority: lets a non-master KV pull/push
    without sockets, so the ledger numbers are exactly hand-computable."""

    def __init__(self, size):
        self.buf = bytearray(size)

    def pull_chunk(self, offset, length):
        return bytes(self.buf[offset:offset + length])

    def push_chunk(self, offset, data):
        self.buf[offset:offset + len(data)] = data


# ---------------------------------------------------------------------------
# Ledger accounting
# ---------------------------------------------------------------------------

class TestLedgerAccounting:
    def test_master_ops_hand_computed_bytes(self):
        store = _live_store()
        size = 2 * STATE_CHUNK_SIZE + 1808  # 3 chunks
        state = State("hostT")
        kv = state.get_kv("t", "acct", size)
        kv.set(b"\x11" * size)
        assert kv.get() == b"\x11" * size
        kv.get_chunk(0, 100)
        kv.set_chunk(STATE_CHUNK_SIZE, b"\x22" * 10)

        row = _key_row(store, "t/acct")
        assert row["master"] == "hostT" and row["is_master"]
        assert row["size"] == size
        assert row["ops"] == {"set": 1, "get": 1, "get_chunk": 1,
                              "set_chunk": 1}
        assert row["bytes"] == {"set": size, "get": size,
                                "get_chunk": 100, "set_chunk": 10}
        assert row["bytes_total"] == 2 * size + 110
        assert row["chunks"] == {"set": 3, "set_chunk": 1}
        # Master image: every read served locally
        assert row["local_reads"] == 2 and row["remote_reads"] == 0
        assert row["pull_chunks_total"] == 0

    def test_replica_pull_and_partial_push_accounting(self):
        store = _live_store()
        size = 4 * STATE_CHUNK_SIZE
        auth = MemoryAuthority(size)
        auth.buf[:] = b"\x5a" * size
        kv = StateKeyValue("t", "rep", size, False, "hostM",
                           authority=auth, local_host="hostR")
        assert not kv.is_master

        kv.pull()                    # 4 chunks, all first-time
        kv.pull()                    # 4 chunks again, none fresh
        row = _key_row(store, "t/rep")
        assert row["ops"]["pull"] == 2
        assert row["bytes"]["pull"] == 2 * size
        assert row["pull_chunks_total"] == 8
        assert row["pull_chunks_fresh"] == 4  # amplification 2×
        assert row["remote_reads"] == 2 and row["local_reads"] == 0

        # Two dirty chunks out of four: only their bytes travel
        kv.set_chunk(0, b"\x01" * STATE_CHUNK_SIZE)
        kv.set_chunk(2 * STATE_CHUNK_SIZE, b"\x02" * STATE_CHUNK_SIZE)
        kv.push_partial()
        row = _key_row(store, "t/rep")
        assert row["ops"]["push_partial"] == 1
        assert row["bytes"]["push_partial"] == 2 * STATE_CHUNK_SIZE
        assert bytes(auth.buf[:STATE_CHUNK_SIZE]) == \
            b"\x01" * STATE_CHUNK_SIZE
        assert row["dirty_ratio"] == pytest.approx(0.5)
        assert row["dirty_outstanding"] == 0

    def test_lock_wait_and_stall_counts(self):
        store = StateStatsStore(max_keys=8)
        store.lock_wait("t/l", 0.001)
        store.lock_wait("t/l", 0.5, stalled=True)
        row = _key_row(store, "t/l")
        assert row["lock_waits"] == 2 and row["lock_stalls"] == 1
        assert row["lock_wait_p90_ms"] is not None


# ---------------------------------------------------------------------------
# Cardinality cap
# ---------------------------------------------------------------------------

class TestCardinalityCap:
    def test_overflow_collapses_into_other(self):
        store = StateStatsStore(max_keys=4)
        for i in range(4):
            store.record(f"t/k{i}", "get", nbytes=10)
        for i in range(20):
            store.record(f"t/spill{i}", "set", nbytes=100)
        # 4 named entries plus the shared overflow bucket
        assert store.cardinality() == 5
        row = _key_row(store, OTHER)
        assert row["ops"]["set"] == 20
        assert row["bytes"]["set"] == 2000

    def test_capped_store_still_feeds_existing_keys(self):
        store = StateStatsStore(max_keys=2)
        store.record("t/a", "get", nbytes=1)
        store.record("t/b", "get", nbytes=1)
        store.record("t/c", "get", nbytes=1)   # overflow → other
        store.record("t/a", "get", nbytes=1)   # existing key: own entry
        assert _key_row(store, "t/a")["ops"]["get"] == 2
        assert _key_row(store, OTHER)["ops"]["get"] == 1


# ---------------------------------------------------------------------------
# No-op identity (FAABRIC_METRICS=0 / FAABRIC_STATE_STATS=0)
# ---------------------------------------------------------------------------

class TestNoOpPlane:
    def test_metrics_off_yields_shared_null_store(self, monkeypatch):
        from faabric_tpu_torch.telemetry import metrics

        monkeypatch.setattr(metrics, "_enabled", False)
        reset_state_stats()
        try:
            store = get_state_stats()
            assert store is NULL_STATE_STATS
            assert not store.enabled
            # Full surface is a no-op, never a TypeError
            store.note_key("t/x", master="h", size=8, is_master=True)
            store.record("t/x", "get", nbytes=8)
            store.lock_wait("t/x", 0.1, stalled=True)
            store.set_dirty_outstanding("t/x", 3)
            store.snapshot_event("diff", nbytes=1, pages=1, regions=1)
            store.set_registry_bytes(42)
            assert store.snapshot() == {}
            assert store.cardinality() == 0
        finally:
            monkeypatch.setattr(metrics, "_enabled", True)
            reset_state_stats()

    def test_state_stats_knob_disables_independently(self, monkeypatch):
        monkeypatch.setenv("FAABRIC_STATE_STATS", "0")
        reset_state_stats()
        try:
            assert get_state_stats() is NULL_STATE_STATS
        finally:
            monkeypatch.delenv("FAABRIC_STATE_STATS")
            reset_state_stats()

    def test_kv_hot_path_works_with_plane_off(self, monkeypatch):
        from faabric_tpu_torch.telemetry import metrics

        monkeypatch.setattr(metrics, "_enabled", False)
        reset_state_stats()
        try:
            state = State("hostOff")
            kv = state.get_kv("t", "dark", 64)
            kv.set(b"\x07" * 64)
            assert kv.get() == b"\x07" * 64
            assert kv._stats is NULL_STATE_STATS
        finally:
            monkeypatch.setattr(metrics, "_enabled", True)
            reset_state_stats()


# ---------------------------------------------------------------------------
# Run-window attribution (the lifecycle stx phase)
# ---------------------------------------------------------------------------

class TestRunWindowAttribution:
    def test_state_ops_charge_stx_inside_executor_context(self):
        from faabric_tpu_torch.executor.context import ExecutorContext
        from faabric_tpu_torch.proto import batch_exec_factory
        from faabric_tpu_torch.telemetry.lifecycle import (
            PHASE_STATE_ACC,
            charge_state_time,
            ledger_durations,
        )

        _live_store()  # plane on
        req = batch_exec_factory("t", "fn", 1)
        msg = req.messages[0]
        # Outside a run window: charges nobody
        charge_state_time(1_000_000)
        assert PHASE_STATE_ACC not in msg.lc
        ExecutorContext.set(None, req, 0)
        try:
            charge_state_time(1_000_000)
            charge_state_time(2_000_000)
        finally:
            ExecutorContext.unset()
        assert msg.lc[PHASE_STATE_ACC] == 3_000_000
        # The carve-out: stx comes OUT of the run phase
        from faabric_tpu_torch.telemetry.lifecycle import (
            PHASE_RUN_END,
            PHASE_RUN_START,
        )

        msg.lc[PHASE_RUN_START] = 1_000_000_000
        msg.lc[PHASE_RUN_END] = 1_010_000_000
        d = ledger_durations(msg.lc)
        assert d["state"] == pytest.approx(0.003)
        assert d["run"] == pytest.approx(0.007)


# ---------------------------------------------------------------------------
# Statemap merge + render
# ---------------------------------------------------------------------------

def _ledger_row(key, **kw):
    row = {"key": key, "master": "", "size": 0, "is_master": False,
           "ops_total": 0, "bytes_total": 0, "local_reads": 0,
           "remote_reads": 0, "pull_chunks_total": 0,
           "pull_chunks_fresh": 0, "lock_waits": 0, "lock_stalls": 0}
    row.update(kw)
    return row


def _planted_tel():
    """Two-host telemetry: hA masters demo/hot (remote-hammered by hB)
    and demo/cold; hB's ledger carries its own remote accesses."""
    return {
        "hA": {"statestats": {
            "keys": [
                _ledger_row("demo/hot", master="hA", is_master=True,
                            size=64 << 20, ops_total=10,
                            bytes_total=32 << 20, local_reads=10),
                _ledger_row("demo/cold", master="hA", is_master=True,
                            size=1 << 20, ops_total=4,
                            bytes_total=1 << 20, local_reads=4),
            ],
            "snapshots": {"diff": {"events": 3, "bytes": 300,
                                   "pages": 7}},
            "registry_bytes": 1234,
        }},
        "hB": {"statestats": {
            "keys": [
                _ledger_row("demo/hot", master="hA", size=64 << 20,
                            ops_total=400, bytes_total=512 << 20,
                            remote_reads=400, pull_chunks_total=900,
                            pull_chunks_fresh=300, lock_waits=5,
                            lock_stalls=2),
            ],
        }},
    }


class TestStatemap:
    def test_merge_attributes_master_origin_and_locality(self):
        doc = aggregate_statemap(_planted_tel())
        hot = doc["keys"][0]
        assert hot["key"] == "demo/hot" and hot["rank"] == 1
        assert hot["master"] == "hA"
        assert hot["bytes_total"] == (32 << 20) + (512 << 20)
        # Origin split: each host's row is its own traffic
        assert hot["by_origin"]["hA"]["bytes"] == 32 << 20
        assert hot["by_origin"]["hB"]["bytes"] == 512 << 20
        assert hot["pull_amplification"] == pytest.approx(3.0)
        assert hot["locality"] == pytest.approx(10 / 410, abs=1e-4)
        hosts = doc["hosts"]
        assert hosts["hA"]["mastered_keys"] == 2
        assert hosts["hA"]["mastered_bytes"] == (64 << 20) + (1 << 20)
        assert hosts["hB"]["origin_bytes"] == 512 << 20
        assert doc["registry_bytes"] == {"hA": 1234}
        assert doc["snapshots"]["diff"]["pages"] == 7
        assert doc["locality_ratio"] == pytest.approx(14 / 414, abs=1e-4)

    def test_statemap_block_roundtrips_from_live_store(self):
        store = _live_store()
        state = State("hostT")
        kv = state.get_kv("t", "map", 128)
        kv.set(b"\x01" * 128)
        doc = aggregate_statemap(
            {"hostT": {"statestats": store.snapshot()}})
        assert doc["keys"][0]["key"] == "t/map"
        assert doc["keys"][0]["master"] == "hostT"
        assert doc["hosts"]["hostT"]["mastered_bytes"] == 128

    def test_render_shows_keys_hosts_and_ratio(self):
        out = render_statemap(aggregate_statemap(_planted_tel()))
        assert "demo/hot" in out and "demo/cold" in out
        assert "hA" in out and "hB" in out
        assert "3.0x" in out          # pull amplification column
        assert "locality ratio" in out
        # top= truncation note
        out2 = render_statemap(aggregate_statemap(_planted_tel()), top=1)
        assert "1 more key(s)" in out2

    def test_render_handles_empty_doc(self):
        out = render_statemap(aggregate_statemap({}))
        assert "no reads recorded" in out


# ---------------------------------------------------------------------------
# Doctor analyzers on planted skew
# ---------------------------------------------------------------------------

class TestDoctorStateAnalyzers:
    def _map(self, tel):
        return aggregate_statemap(tel)

    def test_hot_key_skew_found_on_planted_skew(self):
        from faabric_tpu_torch.runner.doctor import check_hot_key_skew

        tel = {"hA": {"statestats": {"keys": [
            _ledger_row("demo/hot", master="hA", bytes_total=512 << 20,
                        ops_total=100, is_master=True, size=64 << 20),
            _ledger_row("demo/c0", bytes_total=2 << 20, ops_total=5),
            _ledger_row("demo/c1", bytes_total=2 << 20, ops_total=5),
            _ledger_row("demo/c2", bytes_total=3 << 20, ops_total=5),
        ]}}}
        findings = check_hot_key_skew(self._map(tel))
        assert len(findings) == 1
        f = findings[0]
        assert f["kind"] == "hot_key_skew"
        assert "demo/hot" in f["subject"]
        assert f["severity"] > 45

    def test_hot_key_skew_quiet_on_uniform_traffic(self):
        from faabric_tpu_torch.runner.doctor import check_hot_key_skew

        tel = {"hA": {"statestats": {"keys": [
            _ledger_row(f"demo/k{i}", bytes_total=8 << 20, ops_total=10)
            for i in range(4)
        ]}}}
        assert check_hot_key_skew(self._map(tel)) == []

    def test_master_hotspot_found_on_planted_imbalance(self):
        from faabric_tpu_torch.runner.doctor import check_master_hotspot

        findings = check_master_hotspot(self._map(_planted_tel()))
        assert any(f["kind"] == "master_hotspot" and "hA" in f["subject"]
                   for f in findings)

    def test_pull_amplification_and_lock_convoy(self):
        from faabric_tpu_torch.runner.doctor import (
            check_lock_convoy,
            check_pull_amplification,
        )

        tel = {"hB": {"statestats": {"keys": [
            _ledger_row("demo/amp", bytes_total=200 << 20, ops_total=50,
                        remote_reads=50, pull_chunks_total=5000,
                        pull_chunks_fresh=100),
            _ledger_row("demo/locky", bytes_total=1 << 20, ops_total=40,
                        lock_waits=120, lock_stalls=24),
        ]}}}
        smap = self._map(tel)
        amp = check_pull_amplification(smap)
        assert any(f["kind"] == "pull_amplification"
                   and "demo/amp" in f["subject"] for f in amp)
        convoy = check_lock_convoy(smap)
        assert any(f["kind"] == "lock_convoy"
                   and "demo/locky" in f["subject"] for f in convoy)

    def test_analyzers_quiet_without_statemap(self):
        from faabric_tpu_torch.runner.doctor import (
            check_hot_key_skew,
            check_lock_convoy,
            check_master_hotspot,
            check_pull_amplification,
        )

        for check in (check_hot_key_skew, check_master_hotspot,
                      check_pull_amplification, check_lock_convoy):
            assert check(None) == []
            assert check({}) == []

    def test_doctor_selftest_plants_and_finds_all_four(self):
        from faabric_tpu_torch.runner.doctor import run_selftest

        assert run_selftest() == 0


# ---------------------------------------------------------------------------
# Snapshot lifecycle estimators
# ---------------------------------------------------------------------------

class TestSnapshotEstimators:
    def test_snapshot_events_fold_into_store(self):
        store = StateStatsStore(max_keys=8)
        store.snapshot_event("diff", nbytes=100, pages=4, regions=2,
                             seconds=0.001)
        store.snapshot_event("diff", nbytes=50, pages=1, regions=1,
                             seconds=0.002)
        store.set_registry_bytes(4096)
        snap = store.snapshot()
        d = snap["snapshots"]["diff"]
        assert d["events"] == 2 and d["bytes"] == 150 and d["pages"] == 5
        assert d["p50_ms"] > 0
        assert snap["registry_bytes"] == 4096

    def test_registry_reports_residency(self):
        from faabric_tpu_torch.snapshot import SnapshotData, SnapshotRegistry

        store = _live_store()
        reg = SnapshotRegistry()
        reg.register_snapshot("a", SnapshotData(np.zeros(512, np.uint8)))
        reg.register_snapshot("b", SnapshotData(np.zeros(256, np.uint8)))
        assert reg.resident_bytes() == 768
        assert store.snapshot()["registry_bytes"] == 768
        reg.delete_snapshot("a")
        assert store.snapshot()["registry_bytes"] == 256
        reg.clear()
        assert store.snapshot()["registry_bytes"] == 0


# ---------------------------------------------------------------------------
# Cross-package: the same ops, the same ledger and statemap
# ---------------------------------------------------------------------------

_STABLE = ("key", "master", "size", "is_master", "ops", "bytes", "chunks",
           "bytes_total", "ops_total", "local_reads", "remote_reads",
           "pull_chunks_total", "pull_chunks_fresh", "dirty_outstanding",
           "lock_waits", "lock_stalls")


def _drive_kv(pkg_state, pkg_kv, auth_cls, rng):
    size = 5 * STATE_CHUNK_SIZE + 123
    master = pkg_state.State("hostX").get_kv("x", "k", size)
    master.set(rng.integers(0, 255, size, dtype=np.uint8).tobytes())
    master.get()
    master.get_chunk(100, 5000)
    master.set_chunk(2 * STATE_CHUNK_SIZE + 7, b"\x09" * 300)
    master.push_partial()
    auth = auth_cls(size)
    replica = pkg_kv.StateKeyValue("x", "r", size, False, "hostM",
                                   authority=auth, local_host="hostR")
    replica.get_chunk(0, 10)
    replica.pull()
    replica.set_chunk(STATE_CHUNK_SIZE, b"\x01" * STATE_CHUNK_SIZE)
    replica.push_partial()
    replica.push_full()


def test_ledger_rows_equal_reference():
    from faabric_tpu import state as ref_state
    from faabric_tpu.state import kv as ref_kv
    from faabric_tpu.state.backend import StateAuthority as RefAuthority
    from faabric_tpu.telemetry import statestats as ref_ss

    from faabric_tpu_torch import state as port_state
    from faabric_tpu_torch.state import kv as port_kv

    class RefMemoryAuthority(RefAuthority):
        def __init__(self, size):
            self.buf = bytearray(size)

        def pull_chunk(self, offset, length):
            return bytes(self.buf[offset:offset + length])

        def push_chunk(self, offset, data):
            self.buf[offset:offset + len(data)] = data

    port = _live_store()
    ref_ss.reset_state_stats()
    ref = ref_ss.get_state_stats()
    ref.reset()
    try:
        _drive_kv(port_state, port_kv, MemoryAuthority,
                  np.random.default_rng(3))
        _drive_kv(ref_state, ref_kv, RefMemoryAuthority,
                  np.random.default_rng(3))
        for key in ("x/k", "x/r"):
            got, want = _key_row(port, key), _key_row(ref, key)
            assert {k: got.get(k) for k in _STABLE} == \
                {k: want.get(k) for k in _STABLE}, key
    finally:
        ref_ss.reset_state_stats()


def test_statemap_equals_reference():
    from faabric_tpu.telemetry import statestats as ref_ss

    tel = _planted_tel()
    placement = {"demo/hot": {"master": "hA", "backup": "hB", "epoch": 2},
                 "demo/cold": {"master": "hA", "backup": "", "epoch": 1}}
    got = merge_placement(aggregate_statemap(tel), placement)
    want = ref_ss.merge_placement(ref_ss.aggregate_statemap(tel), placement)
    got.pop("generated_at", None)
    want.pop("generated_at", None)
    assert got == want
    assert render_statemap(got) == ref_ss.render_statemap(want)
