"""The port's performance introspection plane against the JAX package's.

Counterpart of ``tests/unit/test_perfprofile.py``: decayed estimators,
the rolling profile store (cardinality cap, persistence round trip),
the collective profiler's rounds, critical paths and entry-skew
stragglers, the wire-codec governor reading the store, the rolling
delta bases, and the doctor's cases (its selftest, Prometheus parsing,
health checks, ``--dir`` mode and the profile-against-matrix check) on
the port's ``runner/doctor.py``. Cross-package: ``DecayedStat``,
``find_stragglers``, ``critical_path`` and ``aggregate_perf`` give the
reference's answers, to 1e-12 relative, on the same numpy inputs and
the same injected clock.
"""

import json
import os
import time

import numpy as np
import pytest

@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    from tests.test_torch_telemetry import clean_port_telemetry, port_singletons

    saved = port_singletons()
    yield
    clean_port_telemetry(saved)


from faabric_tpu_torch.telemetry.perfprofile import (
    CollectiveProfiler,
    DecayedStat,
    PerfProfileStore,
    aggregate_perf,
    critical_path,
    find_stragglers,
    merge_collective_series,
    size_class,
)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------

def test_decayed_stat_ewma_and_quantiles():
    s = DecayedStat(half_life=60.0)
    for _ in range(100):
        s.observe(2.0)
    assert s.mean == pytest.approx(2.0)
    assert s.ewma == pytest.approx(2.0, rel=0.05)
    # Geometric buckets: p50 lands within one half-octave of the value
    assert 1.4 < s.quantile(0.5) < 2.9
    # A spread distribution orders its quantiles
    s2 = DecayedStat(half_life=60.0)
    for v in (0.1,) * 10 + (1.0,) * 10 + (10.0,) * 10:
        s2.observe(v)
    assert s2.quantile(0.1) < s2.quantile(0.5) < s2.quantile(0.9)


def test_decayed_stat_decay_forgets_the_past():
    s = DecayedStat(half_life=0.05)
    s.observe(100.0, now=time.monotonic())
    w0 = s.weight
    # Far beyond several half-lives: old evidence decays to nothing and
    # fresh observations dominate both weight and mean
    later = time.monotonic() + 10.0
    for _ in range(20):
        s.observe(1.0, now=later)
    assert s.weight < w0 + 21  # the old sample's weight is ~gone
    assert s.mean == pytest.approx(1.0, rel=0.01)


def test_size_class_labels():
    assert size_class(100) == "64B"
    assert size_class(64 * 1024) == "64KiB"
    assert size_class(3 << 20) == "1MiB"
    assert size_class(5 << 30) == "4GiB"


# ---------------------------------------------------------------------------
# Profile store
# ---------------------------------------------------------------------------

def test_store_observe_snapshot_and_link_gibs():
    store = PerfProfileStore(label="t1")
    # 1 MiB in 1 ms ≈ 0.98 GiB/s
    for _ in range(10):
        store.observe("hostB", "bulk-tcp", 1 << 20, 0.001)
    snap = store.snapshot()
    rows = snap["links"]
    assert len(rows) == 1
    row = rows[0]
    assert row["dst"] == "hostB" and row["plane"] == "bulk-tcp"
    assert row["messages"] == 10
    assert row["gibs_ewma"] == pytest.approx(0.9766, rel=0.05)
    # gibs_avg (bytes/lat) matches the per-frame rate for uniform frames
    assert row["gibs_avg"] == pytest.approx(row["gibs_ewma"], rel=0.05)
    assert store.link_gibs("hostB") == pytest.approx(0.9766, rel=0.05)
    assert store.link_gibs("hostB", plane="ptp") is None
    assert store.link_gibs("nowhere") is None


def test_store_small_frames_feed_latency_not_bandwidth():
    store = PerfProfileStore(label="t2")
    store.observe("h", "ptp", 100, 0.5)  # tiny frame, awful "rate"
    assert store.link_gibs("h") is None  # no bandwidth evidence
    row = store.snapshot()["links"][0]
    assert row["lat_p50_ms"] > 100


def test_store_cardinality_cap_collapses_to_other():
    store = PerfProfileStore(label="t3", max_links=4)
    for i in range(10):
        store.observe(f"host{i}", "bulk-tcp", 1 << 20, 0.001)
    assert store.cardinality() <= 5  # 4 + the shared "other" bucket
    dsts = {r["dst"] for r in store.snapshot()["links"]}
    assert "other" in dsts
    # An entry that ALREADY exists keeps receiving live updates at the
    # cap (a boot-seeded store at max_links must not starve its own
    # links into the other bucket)
    before = next(r for r in store.snapshot()["links"]
                  if r["dst"] == "host0")["messages"]
    store._fast.clear()  # simulate the seeded shape: entries, no fast
    store.observe("host0", "bulk-tcp", 1 << 20, 0.001)
    after = next(r for r in store.snapshot()["links"]
                 if r["dst"] == "host0")["messages"]
    assert after == before + 1


def test_store_persistence_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("FAABRIC_PERF_PROFILE_DIR", str(tmp_path))
    store = PerfProfileStore(label="persist-me")
    for _ in range(20):
        store.observe("hostZ", "bulk-tcp", 4 << 20, 0.0005)  # ~7.8 GiB/s
    path = store.persist()
    assert path and os.path.exists(path)
    body = json.load(open(path))
    assert body["links"][0]["dst"] == "hostZ"
    # A fresh incarnation under the same label seeds from the file:
    # the governor sees a measured link at boot, not assume-slow
    reborn = PerfProfileStore(label="persist-me")
    assert reborn.link_gibs("hostZ", plane="bulk-tcp") == pytest.approx(
        7.8, rel=0.1)
    assert reborn.snapshot()["links"][0]["seeded"] is True


# ---------------------------------------------------------------------------
# Collective profiler: critical path + stragglers
# ---------------------------------------------------------------------------

def _synthetic_rounds(n_rounds=8, n_ranks=4, slow_rank=None,
                      skew_s=0.05, work_s=0.08, period_s=0.2):
    """End-aligned synchronous rounds (the shape real instrumentation
    produces): every rank's round k ENDS together at
    ``t0 + k·period + work``; the slow rank enters ``skew_s`` late —
    idling outside the collective — so its total is short while the
    waiters' totals absorb the delay."""
    rounds = {}
    t0 = 1000.0
    for i in range(n_rounds):
        rd = {}
        for r in range(n_ranks):
            late = skew_s if r == slow_rank else 0.0
            enter = t0 + i * period_s + late
            total = work_s - late
            rd[r] = {"enter_ts": enter, "total": total,
                     "intra": total * 0.5, "leader": total * 0.3,
                     "redistribute": total * 0.2}
        rounds[i] = rd
    return rounds


def test_find_stragglers_flags_idle_gap_not_totals():
    # Rank 2 idles 50 ms before every round: flagged
    found = find_stragglers(_synthetic_rounds(slow_rank=2))
    assert list(found) == [2]
    assert found[2]["median_skew_s"] == pytest.approx(0.05, rel=0.1)
    assert found[2]["rounds_flagged"] >= 3
    # Uniformly slow rounds (everyone's total inflated, gaps tight)
    # flag NOBODY — totals cannot identify a straggler
    assert find_stragglers(_synthetic_rounds(
        work_s=0.18, period_s=0.2)) == {}
    # Sub-threshold jitter flags nobody
    assert find_stragglers(
        _synthetic_rounds(slow_rank=1, skew_s=0.001)) == {}


def test_find_stragglers_ignores_echo_victims():
    """A rank stuck INSIDE round k−1 waiting on the true straggler also
    *enters* round k late — but its idle gap is ~zero, so only the rank
    that dawdled outside the collective is flagged (raw entry-skew
    analysis would co-flag the victim)."""
    rounds = {}
    t0 = 2000.0
    for i in range(8):
        # Rank 0: the true straggler — idles 60 ms, then everyone runs.
        # Rank 1: ring successor of 0 — RELEASED 50 ms late from round
        # i−1 (echo), so it enters late too, but with zero idle.
        # Ranks 2,3: normal.
        start = t0 + i * 0.3
        rounds[i] = {
            0: {"enter_ts": start + 0.060, "total": 0.040},
            1: {"enter_ts": start + 0.050, "total": 0.100},
            2: {"enter_ts": start, "total": 0.100},
            3: {"enter_ts": start, "total": 0.100},
        }
    found = find_stragglers(rounds)
    assert list(found) == [0], found


def test_critical_path_decomposition():
    rounds = _synthetic_rounds(n_rounds=6)
    # Make rank 3 the bound in every round, dominated by `leader`
    for rd in rounds.values():
        rd[3] = {"enter_ts": rd[3]["enter_ts"], "total": 0.2,
                 "intra": 0.02, "leader": 0.15, "redistribute": 0.03}
    cp = critical_path(rounds)
    assert cp["rounds_analyzed"] == 6
    assert cp["dominant_rank"] == 3
    assert cp["dominant_phase"] == "leader"
    assert cp["bound_counts"]["3"] == 6
    assert cp["phase_shares"]["leader"] > 0.5


def test_profiler_records_rounds_and_emits_straggler_metrics():
    from faabric_tpu_torch.telemetry import get_metrics

    prof = CollectiveProfiler(window=16, min_rounds=3)
    t0 = 2000.0
    for i in range(10):
        for r in range(4):
            late = 0.08 if r == 1 else 0.0  # rank 1 idles pre-round
            prof.record_phase(77, "allreduce", r, "enter_ts",
                              t0 + i * 0.3 + late)
            prof.record_phase(77, "allreduce", r, "intra", 0.004)
            prof.record_phase(77, "allreduce", r, "total", 0.1 - late)
    flags = prof.detect()
    assert {"world": 77, "collective": "allreduce", "rank": 1} in flags
    snap = prof.snapshot()
    series = [s for s in snap if s["world"] == 77]
    assert series and series[0]["stragglers"] == [1]
    assert series[0]["critical_path"]["rounds_analyzed"] >= 8
    # The detection emitted the faabric_straggler_* metric family
    reg = get_metrics().snapshot()
    fam = reg.get("faabric_straggler_detected_total")
    assert fam is not None
    assert any(row["labels"].get("rank") == "1"
               for row in fam["series"])


def test_profiler_round_window_prunes():
    prof = CollectiveProfiler(window=4)
    for i in range(20):
        prof.record_phase(5, "allgather", 0, "total", 0.001)
    snap = [s for s in prof.snapshot() if s["world"] == 5][0]
    assert len(snap["rounds"]) <= 5


def test_merge_collective_series_cross_host_straggler():
    """Each host only saw its own ranks; only the MERGED series can
    compare arrivals across hosts — the dist-world case."""
    t0 = 3000.0

    def host_series(ranks, slow=None):
        rounds = {}
        for i in range(8):
            rd = {}
            for r in ranks:
                late = 0.06 if r == slow else 0.0
                rd[str(r)] = {"enter_ts": t0 + i * 0.3 + late,
                              "total": 0.08 - late}
            rounds[str(i)] = rd
        return [{"world": 9, "collective": "allreduce", "completed": 8,
                 "rounds": rounds, "stragglers": []}]

    merged = merge_collective_series({
        "w1": host_series([0, 1]),
        "w2": host_series([2, 3], slow=3),
    })
    assert len(merged) == 1
    assert list(merged[0]["stragglers"]) == ["3"]
    # Provenance IS placement: the merge knows which host's telemetry
    # carried each rank — exact straggler attribution, no topology
    assert merged[0]["rank_hosts"] == {"0": "w1", "1": "w1",
                                       "2": "w2", "3": "w2"}


def test_find_stragglers_immune_to_host_clock_offset():
    """Entry stamps are raw wall clocks; a host whose clock runs 30 ms
    ahead must NOT read as a fleet of stragglers. The idle-gap signal
    subtracts two stamps taken on the SAME rank's clock (totals are
    durations), so constant offsets cancel exactly while genuine
    pre-round idling survives untouched."""
    t0 = 5000.0
    period, work = 0.2, 0.08
    rounds = {}
    for i in range(8):
        rd = {}
        for r in range(4):
            clock = 0.030 if r in (2, 3) else 0.0  # "hostB" runs ahead
            idle = 0.040 if r == 3 else 0.0        # rank 3 dawdles
            rd[r] = {"enter_ts": t0 + i * period + idle + clock,
                     "total": work - idle}
        rounds[i] = rd
    found = find_stragglers(rounds)
    assert list(found) == [3], found
    assert found[3]["median_skew_s"] == pytest.approx(0.04, rel=0.2)


def test_aggregate_perf_shapes_links_and_stragglers():
    tel = {
        "w1": {"perf": {
            "links": {"links": [{"dst": "w2", "plane": "bulk-tcp",
                                 "codec": "raw", "size_class": "1MiB",
                                 "messages": 9, "bytes": 9 << 20,
                                 "gibs_ewma": 2.0, "gibs_avg": 2.0}]},
            "collectives": []}},
        "planner": {"perf": {"links": {"links": []}, "collectives": []}},
    }
    doc = aggregate_perf(tel)
    assert doc["links"][0]["src"] == "w1"
    assert doc["links"][0]["dst"] == "w2"
    assert doc["hosts"] == ["planner", "w1"]
    assert doc["stragglers"] == []


# ---------------------------------------------------------------------------
# Governor: auto mode reads the profile store
# ---------------------------------------------------------------------------

def test_governor_auto_mode_reads_profile_store():
    from faabric_tpu_torch.telemetry import get_perf_store, reset_perf_profile
    from faabric_tpu_torch.transport.codec import WireCodecGovernor

    reset_perf_profile()
    try:
        store = get_perf_store()
        assert store.enabled, "metrics must be on for this pin"
        # A measured FAST link (≈9.8 GiB/s, over the 4 GiB/s threshold)
        for _ in range(10):
            store.observe("fast-host", "bulk-tcp", 10 << 20, 0.001)
        # A measured SLOW link (≈0.2 GiB/s)
        for _ in range(10):
            store.observe("slow-host", "bulk-tcp", 1 << 20, 0.005)
        gov = WireCodecGovernor(mode="auto")
        # Rank labels (61, 62) no other test's bulk traffic uses: the
        # unmeasured-destination case falls back to the GLOBAL comm
        # matrix per (src, dst), and (0, 1) cells left behind by
        # test_wire_codec's real bulk transfers flipped this pin when
        # module order put that file first (observed pre-existing flake)
        assert gov.bulk_codec("fast-host", False, 61, 62,
                              1 << 20) == "raw"
        assert gov.bulk_codec("slow-host", False, 61, 62, 1 << 20) == \
            "delta"
        # Unmeasured destination keeps the assume-slow default
        assert gov.bulk_codec("unseen-host", False, 61, 62, 1 << 20) == \
            "delta"
    finally:
        reset_perf_profile()


def test_governor_verdict_flip_emits_flight_record():
    from faabric_tpu_torch.telemetry import (
        get_flight,
        get_perf_store,
        reset_perf_profile,
    )
    from faabric_tpu_torch.transport.codec import WireCodecGovernor

    reset_perf_profile()
    try:
        store = get_perf_store()
        for _ in range(10):
            store.observe("flip-host", "bulk-tcp", 1 << 20, 0.0001)
        gov = WireCodecGovernor(mode="auto")
        gov.WINDOW_SECONDS = 0.0  # re-evaluate every call
        assert gov.bulk_codec("flip-host", False, 7, 8, 1 << 20) == "raw"
        # The link collapses (same size class, so the same estimator):
        # a burst of slow evidence drags the EWMA under the threshold
        for _ in range(400):
            store.observe("flip-host", "bulk-tcp", 1 << 20, 0.02)
        assert gov.bulk_codec("flip-host", False, 7, 8, 1 << 20) == \
            "delta"
        events = [e for e in get_flight().events()
                  if e["kind"] == "codec_verdict"
                  and e.get("host") == "flip-host"]
        assert events, "verdict decisions must leave flight breadcrumbs"
        flips = [e for e in events if e.get("prev") == "raw"
                 and e.get("verdict") == "delta"]
        assert flips, "the raw→delta flip must be flight-recorded"
    finally:
        reset_perf_profile()


# ---------------------------------------------------------------------------
# Doctor analyzers
# ---------------------------------------------------------------------------

def test_doctor_selftest_finds_planted_faults(capsys):
    from faabric_tpu_torch.runner.doctor import run_selftest

    assert run_selftest() == 0
    out = capsys.readouterr().out
    assert "slow_link" in out and "straggler" in out


def test_doctor_parse_prometheus():
    from faabric_tpu_torch.runner.doctor import parse_prometheus

    text = ('# HELP x y\n# TYPE x counter\n'
            'x{a="1",b="two"} 3\nx 4.5\nbad line\n')
    parsed = parse_prometheus(text)
    assert parsed["x"][0] == ({"a": "1", "b": "two"}, 3.0)
    assert parsed["x"][1] == ({}, 4.5)


def test_doctor_healthz_checks():
    from faabric_tpu_torch.runner.doctor import check_healthz

    findings = check_healthz({
        "hosts": [
            {"host": "w1", "keepAliveAgeSeconds": 29.0,
             "timeoutSeconds": 30,
             "breaker": {"state": "open", "consecutiveFailures": 7}},
        ],
        "ingress": {"shedTotal": 500, "admittedTotal": 1000,
                    "queueDepth": 900, "queueMax": 1024},
        "journal": {"enabled": True, "bufferedRecords": 4000,
                    "dirty": True, "lastFsyncAgeSeconds": 9.0,
                    "fsyncIntervalSeconds": 0.05},
    })
    kinds = {f["kind"] for f in findings}
    assert {"breaker_open", "keepalive_at_risk", "admission_shed",
            "journal_fsync_pressure"} <= kinds


def test_doctor_dir_mode_roundtrip(tmp_path):
    from faabric_tpu_torch.runner.doctor import (
        diagnose,
        load_dir,
        selftest_sources,
    )

    sources = selftest_sources()
    (tmp_path / "perf.json").write_text(json.dumps(sources["perf"]))
    (tmp_path / "healthz.json").write_text(
        json.dumps(sources["healthz"]))
    (tmp_path / "topology.json").write_text(
        json.dumps(sources["topology"]))
    metrics_text = (
        'faabric_codec_frames_total{codec="delta"} 900\n'
        'faabric_codec_escapes_total{reason="nack"} 120\n')
    (tmp_path / "metrics.txt").write_text(metrics_text)
    loaded = load_dir(str(tmp_path))
    findings = diagnose(loaded)
    kinds = [f["kind"] for f in findings[:5]]
    assert "slow_link" in kinds and "straggler" in kinds
    assert "codec_escape_storm" in [f["kind"] for f in findings]


def test_doctor_agreement_check_compares_wire_bytes():
    """A compressed link moves few wire bytes for many raw ones: the
    profile-against-matrix check must compare wire rates on both sides,
    or every healthy delta link reads as a broken feed."""
    from faabric_tpu_torch.runner.doctor import (
        check_profile_matrix_agreement,
    )

    lat = (1 << 20) / (2.0 * (1 << 30))  # 1 MiB of wire at 2.0 GiB/s
    perf = {"links": [{"src": "h1", "dst": "h2", "plane": "bulk-tcp",
                       "codec": "delta", "size_class": "1MiB",
                       "messages": 50, "bytes": 1 << 20,
                       "gibs_avg": 2.0, "gibs_ewma": 2.0}]}
    matrix = {"hosts": {"h1": [{
        "src": "0", "dst": "4", "plane": "bulk-tcp", "codec": "delta",
        "bytes": 1 << 20,          # wire
        "bytes_raw": 16 << 20,     # 16x compression
        "lat_sum": lat}]}}
    assert check_profile_matrix_agreement(perf, matrix) == []


# ---------------------------------------------------------------------------
# Rolling double-buffer bases (byte-accounting pin)
# ---------------------------------------------------------------------------

def _mutate(data: np.ndarray, rng) -> np.ndarray:
    """Fixed-offset block mutation: steers clear of the fingerprint
    sample windows so the sender's O(1) base lookup stays on the latest
    base every round (the steady-state single-stream shape)."""
    out = data.copy()
    out[200_000:204_096] = rng.integers(0, 255, 4096, dtype=np.uint8)
    return out


def test_rolling_bases_sender_and_receiver_reuse_buffers():
    from faabric_tpu_torch.transport.codec import (
        CODEC_DELTA,
        ReceiverDeltaCache,
        SenderDeltaCache,
    )

    tx = SenderDeltaCache(budget_bytes=1 << 30)
    rx = ReceiverDeltaCache(budget_bytes=1 << 30)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    key = ("roll",)
    steady_tx = steady_rx = None
    out_ids = []
    for i in range(12):
        data = _mutate(data, rng)
        frame = tx.encode(key, [data], i)
        # Model the socket: the receiver gets its own copy of the wire
        out = rx.decode(key, frame.codec, frame.flags, frame.base_epoch,
                        frame.self_epoch, frame.crc, frame.wire.copy(),
                        frame.raw_nbytes)
        assert out is not None
        assert bytes(out) == data.tobytes(), f"round {i} not bitwise"
        if i >= 2:
            assert frame.codec == CODEC_DELTA
        if i >= 4:
            out_ids.append(id(out))
        del out, frame  # drop consumer refs: reuse needs idle buffers
        if i == 3:
            steady_tx, steady_rx = tx.cached_bytes, rx._bytes
    # Byte accounting pin: the steady state holds exactly two rolling
    # 1 MiB bases per side — no per-round growth, no reallocation
    assert tx.cached_bytes == steady_tx == 2 << 20
    assert rx._bytes == steady_rx == 2 << 20
    # The flatten/apply copy disappeared: rounds reused buffers...
    assert tx.reused >= 8
    assert tx.reused_bytes == tx.reused * (1 << 20)
    # ...and deliveries alternate between the SAME two allocations
    assert len(set(out_ids)) <= 2


def test_rolling_bases_consumer_reference_vetoes_reuse():
    """A consumer still holding a delivered array blocks in-place reuse
    — the refcount guard must prefer a copy over corrupting a reader."""
    from faabric_tpu_torch.transport.codec import (
        ReceiverDeltaCache,
        SenderDeltaCache,
    )

    tx = SenderDeltaCache(budget_bytes=1 << 30)
    rx = ReceiverDeltaCache(budget_bytes=1 << 30)
    rng = np.random.default_rng(12)
    data = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    key = ("held",)
    held = []  # the consumer never lets go
    snapshots = []
    for i in range(8):
        data = _mutate(data, rng)
        frame = tx.encode(key, [data], i)
        out = rx.decode(key, frame.codec, frame.flags, frame.base_epoch,
                        frame.self_epoch, frame.crc, frame.wire.copy(),
                        frame.raw_nbytes)
        assert out is not None and bytes(out) == data.tobytes()
        held.append(out)
        snapshots.append(out.tobytes())
    # Every delivered payload is still intact — nothing was patched
    # under the consumer, and they are all distinct round images
    for got, want in zip(held, snapshots):
        assert bytes(got) == want
    assert len({bytes(h) for h in held}) == len(held)


def test_rolling_bases_nack_heal_survives_buffer_recycling():
    """The resend guarantee must survive the copy elimination: a NACK
    naming a seq whose epoch's BUFFER was recycled is healed by
    reverse-applying the retained XOR delta chain (pure-XOR deltas are
    self-inverting), reproducing the historical payload bitwise."""
    from faabric_tpu_torch.transport.codec import SenderDeltaCache

    tx = SenderDeltaCache(budget_bytes=1 << 30)
    rng = np.random.default_rng(14)
    data = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    key = ("heal",)
    payloads = {}
    for i in range(10):
        data = _mutate(data, rng)
        payloads[i] = data.tobytes()
        frame = tx.encode(key, [data], i)
        del frame
    assert tx.reused >= 6  # the steady state really recycled buffers
    # A late NACK for an early round: its epoch's buffer is long gone,
    # yet the heal must ship the EXACT round-3 payload
    got = tx.take_for_resend(key, 3)
    assert got is not None, "recycled epoch must reconstruct, not lose"
    base, _epoch = got
    assert bytes(base) == payloads[3]
    assert tx.reconstructed == 1
    # The most recent seq still serves straight from the live base
    got = tx.take_for_resend(key, 9)
    assert got is not None and bytes(got[0]) == payloads[9]
    # Beyond the sent window stays the documented unhealable corner
    assert tx.take_for_resend(key, 999) is None


def test_rolling_bases_full_frame_escape_restarts_lineage():
    from faabric_tpu_torch.transport.codec import (
        CODEC_FULL,
        ReceiverDeltaCache,
        SenderDeltaCache,
    )

    tx = SenderDeltaCache(budget_bytes=1 << 30)
    rx = ReceiverDeltaCache(budget_bytes=1 << 30)
    rng = np.random.default_rng(13)
    data = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    key = ("esc",)
    for i in range(5):
        data = _mutate(data, rng)
        frame = tx.encode(key, [data], i)
        out = rx.decode(key, frame.codec, frame.flags, frame.base_epoch,
                        frame.self_epoch, frame.crc, frame.wire.copy(),
                        frame.raw_nbytes)
        del out, frame
    # Receiver loses its bases (migration remap / restart): the next
    # delta NACKs, the sender escapes to FULL, and the stream heals —
    # with the rolling lineage restarted, not corrupted
    rx.drop_bases()
    data = _mutate(data, rng)
    frame = tx.encode(key, [data], 99)
    out = rx.decode(key, frame.codec, frame.flags, frame.base_epoch,
                    frame.self_epoch, frame.crc, frame.wire.copy(),
                    frame.raw_nbytes)
    assert out is None  # base_missing → the caller NACKs
    got = tx.take_for_resend(key, 99)
    assert got is not None
    base, epoch = got
    assert bytes(base) == data.tobytes()
    del got, base
    # The escape full frame re-establishes a base; rounds resume rolling
    data2 = _mutate(data, rng)
    frame2 = tx.encode(key, [data2], 100)
    assert frame2.flags & 0x2  # FLAG_ESCAPE: forced full after the NACK
    assert frame2.codec in (CODEC_FULL, 3)  # full or zlib full
    out2 = rx.decode(key, frame2.codec, frame2.flags, frame2.base_epoch,
                     frame2.self_epoch, frame2.crc, frame2.wire.copy(),
                     frame2.raw_nbytes)
    assert out2 is not None and bytes(out2) == data2.tobytes()


# ---------------------------------------------------------------------------
# Cross-package: the same inputs and clock, the same answers
# ---------------------------------------------------------------------------

def _close(got, want, where="") -> None:
    """Equal structure; floats within 1e-12 relative."""
    if isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=1e-12, abs=0), where
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decayed_stat_equals_reference(seed):
    from faabric_tpu.telemetry.perfprofile import DecayedStat as RefStat

    rng = np.random.default_rng(seed)
    values = rng.lognormal(-3, 1.5, 300)
    gaps = rng.exponential(0.5, 300)
    port, ref = DecayedStat(half_life=2.0), RefStat(half_life=2.0)
    now = 1000.0
    for v, g in zip(values, gaps):
        now += float(g)
        port.observe(float(v), now=now)
        ref.observe(float(v), now=now)
    for attr in ("mean", "ewma", "weight"):
        assert getattr(port, attr) == pytest.approx(getattr(ref, attr),
                                                    rel=1e-12)
    for q in (0.1, 0.5, 0.9, 0.99):
        assert port.quantile(q) == pytest.approx(ref.quantile(q), rel=1e-12)


def _rounds(rng, n_rounds=24, n_ranks=6, late=(4,)):
    rounds = {}
    t = 5000.0
    for i in range(n_rounds):
        t += 0.2
        rd = {}
        for r in range(n_ranks):
            skew = float(rng.exponential(0.002))
            if r in late:
                skew += 0.05 + float(rng.exponential(0.01))
            rd[r] = {"enter_ts": t + skew,
                     "total": 0.1 - skew + float(rng.exponential(0.001)),
                     "intra": float(rng.exponential(0.01)),
                     "leader": float(rng.exponential(0.03)),
                     "redistribute": float(rng.exponential(0.005))}
        rounds[i] = rd
    return rounds


@pytest.mark.parametrize("seed,late", [(0, (4,)), (1, ()), (2, (0, 5))])
def test_stragglers_and_critical_path_equal_reference(seed, late):
    from faabric_tpu.telemetry import perfprofile as ref_pp

    rounds = _rounds(np.random.default_rng(seed), late=late)
    _close(find_stragglers(rounds), ref_pp.find_stragglers(rounds))
    _close(critical_path(rounds), ref_pp.critical_path(rounds))
    assert sorted(find_stragglers(rounds)) == sorted(late)


class _SteppedClock:
    """A ``time`` stand-in whose monotonic clock advances 1 ms a read:
    each package's store sees the same stamps."""

    def __init__(self):
        self._t = 100.0

    def monotonic(self):
        self._t += 0.001
        return self._t

    def time(self):
        return 1.7e9 + self._t

    def perf_counter(self):
        return self.monotonic()


def test_aggregate_perf_equals_reference(monkeypatch):
    """Two hosts' profiles and collective series, built by each
    package's own store and profiler from the same observations under
    the same stepped clock."""
    from faabric_tpu.telemetry import perfprofile as ref_pp

    from faabric_tpu_torch.telemetry import perfprofile as port_pp

    rng = np.random.default_rng(5)
    obs = [(str(h), plane, int(nb), float(sec))
           for h, plane, nb, sec in zip(
               rng.choice(["w1", "w2"], 60),
               rng.choice(["bulk-tcp", "shm", "ptp"], 60),
               rng.integers(1 << 10, 64 << 20, 60),
               rng.exponential(0.01, 60))]
    rounds = _rounds(np.random.default_rng(6), n_rounds=20, n_ranks=4)

    def telemetry(pp):
        monkeypatch.setattr(pp, "time", _SteppedClock())
        tel = {}
        for host in ("w1", "w2"):
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
                            prof.record_phase(9, "allreduce", r, ph,
                                              phases[ph])
                        prof.record_phase(9, "allreduce", r, "total",
                                          phases["total"], 1 << 20)
            tel[host] = {"perf": {"links": store.snapshot(),
                                  "collectives": prof.snapshot()}}
        return tel

    got = port_pp.aggregate_perf(telemetry(port_pp))
    want = ref_pp.aggregate_perf(telemetry(ref_pp))
    # The documents' own wall stamps differ; everything else agrees
    got.pop("generated_at", None)
    want.pop("generated_at", None)
    _close(got, want)
    assert got["stragglers"] or got["collectives"]
