"""The port's wire codecs against the JAX package's.

Counterpart of ``tests/unit/test_wire_codec.py``. Both packages'
``SenderDeltaCache``s take the same payload sequences and must emit the
same ``CodedFrame`` bytes, and each package's receiver cache decodes the
other's frames; the governors' verdicts must be equal over a table of
modes and locality (the reference's perf store and comm matrix reset
first, since the port has neither yet). Then the escape protocol over a
real port ``BulkServer``/``BulkClient`` pair on loopback with rings off:
delta streams deliver bitwise, a dropped base NACKs and heals, a
receiver restart recovers, a corrupted frame heals, and a coded stream
stays on one stripe. The reference corrupts a frame through its
``transport.bulk`` fault point; here the stripe's send is monkeypatched
(the port's fault points come with ``ROADMAP.md`` Queue 1 #7 part B).
The governor's tuned threshold reads the perf-profile store (part B)
and has no case here.
"""

import time

import numpy as np
import pytest

pytest.importorskip("jax")

from faabric_tpu.transport import codec as ref_codec  # noqa: E402

from tests.conftest import next_port_base  # noqa: E402

from faabric_tpu_torch.transport import codec as port_codec  # noqa: E402
from faabric_tpu_torch.transport.bulk import (  # noqa: E402
    BulkClient,
    BulkServer,
    _Stripe,
)
from faabric_tpu_torch.transport.codec import (  # noqa: E402
    CODEC_DELTA,
    CODEC_FULL,
    CODEC_ZLIB,
    ReceiverDeltaCache,
    SenderDeltaCache,
    WireCodecGovernor,
    payload_entropy,
    set_wire_codec,
)
from faabric_tpu_torch.transport.common import (  # noqa: E402
    clear_host_aliases,
    register_host_alias,
)

GROUP = 7700


@pytest.fixture(autouse=True)
def _reset_governors():
    port_codec.reset_wire_governor()
    ref_codec.reset_wire_governor()
    yield
    port_codec.reset_wire_governor()
    ref_codec.reset_wire_governor()
    clear_host_aliases()


def _frame_tuple(f):
    return (f.codec, f.flags, f.base_epoch, f.self_epoch, f.crc,
            f.wire.tobytes(), f.raw_nbytes)


def _stream(seed=0, rounds=6, size=1 << 20):
    """A parameter-broadcast-like stream: rounds of a buffer with a few
    pages mutated each, as two segments (a small header and the body,
    as a bulk frame arrives)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 255, size, dtype=np.uint8)
    out = []
    for rnd in range(rounds):
        if rnd:
            p = p.copy()
            p[rnd * 7000:rnd * 7000 + 3000] ^= (rnd & 0xFF) or 1
        out.append([p[:64].copy(), p[64:].copy()])
    return out


# ---------------------------------------------------------------------------
# Frames: bytes equal to the reference's, decodable by either package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["delta", "zlib"])
def test_coded_frames_equal_reference_bytes(mode):
    """Both senders take the same sequences (mutating rounds through the
    rolling lineage, an identical resend, a zero buffer that zlibs, a
    new size) and emit byte-identical frames."""
    seqs = [*_stream(1), _stream(1)[-1],
            [np.zeros(1 << 19, np.uint8)], [np.zeros(1 << 19, np.uint8)],
            [np.arange(300_000, dtype=np.uint8)]]
    tx_p = SenderDeltaCache(budget_bytes=1 << 30)
    tx_r = ref_codec.SenderDeltaCache(budget_bytes=1 << 30)
    for seq, parts in enumerate(seqs):
        fp = tx_p.encode(("s",), [p.copy() for p in parts], seq, mode)
        fr = tx_r.encode(("s",), [p.copy() for p in parts], seq, mode)
        assert _frame_tuple(fp) == _frame_tuple(fr), f"frame {seq}"
    assert tx_p.reused == tx_r.reused and tx_p.cached_bytes == \
        tx_r.cached_bytes
    for seq in range(len(seqs)):
        gp, gr = (tx.take_for_resend(("s",), seq) for tx in (tx_p, tx_r))
        assert (gp is None) == (gr is None)
        if gp is not None:
            assert gp[1] == gr[1] and gp[0].tobytes() == gr[0].tobytes()


@pytest.mark.parametrize("sender", ["port", "ref"])
def test_frames_decode_across_packages(sender):
    tx = (SenderDeltaCache if sender == "port"
          else ref_codec.SenderDeltaCache)(budget_bytes=1 << 30)
    rx = (ref_codec.ReceiverDeltaCache if sender == "port"
          else ReceiverDeltaCache)(budget_bytes=1 << 30)
    for seq, parts in enumerate(_stream(2)):
        f = tx.encode(("k",), parts, seq)
        out = rx.decode(("k",), f.codec, f.flags, f.base_epoch,
                        f.self_epoch, f.crc, f.wire, f.raw_nbytes)
        assert out is not None and out.tobytes() == b"".join(
            p.tobytes() for p in parts), seq
        assert seq == 0 or f.codec == CODEC_DELTA


def test_sender_cache_identity_reuses_epoch_and_mutation_inserts():
    c = SenderDeltaCache(budget_bytes=1 << 30)
    rng = np.random.default_rng(2)
    p = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    f0 = c.encode(("s",), [p], 0)
    assert f0.codec == CODEC_FULL and f0.self_epoch == 1
    f1 = c.encode(("s",), [p.copy()], 1)
    assert f1.codec == CODEC_DELTA
    assert f1.base_epoch == 1 and f1.self_epoch == 1
    assert f1.wire.nbytes < 64
    before = c.cached_bytes
    q = p.copy()
    q[1000:2000] ^= 1
    f2 = c.encode(("s",), [q], 2)
    assert f2.codec == CODEC_DELTA and f2.self_epoch == 2
    assert f2.wire.nbytes < q.nbytes // 10
    assert c.cached_bytes == before + q.nbytes
    got = c.take_for_resend(("s",), 2)
    assert got is not None and bytes(got[0]) == q.tobytes()
    assert c.take_for_resend(("s",), 99) is None


def test_sender_cache_budget_eviction():
    c = SenderDeltaCache(budget_bytes=3 << 20)
    rng = np.random.default_rng(3)
    for i in range(6):
        c.encode((f"s{i}",), [rng.integers(0, 255, 1 << 20,
                                           dtype=np.uint8)], 0)
    assert c.cached_bytes <= 3 << 20


def test_zlib_full_frame_roundtrip():
    tx = SenderDeltaCache(budget_bytes=1 << 30)
    rx = ReceiverDeltaCache(budget_bytes=1 << 30)
    p = np.zeros(1 << 20, dtype=np.uint8)
    f = tx.encode(("z",), [p], 0)
    assert f.codec == CODEC_ZLIB and f.wire.nbytes < p.nbytes // 4
    out = rx.decode(("z",), f.codec, f.flags, f.base_epoch, f.self_epoch,
                    f.crc, f.wire, f.raw_nbytes)
    assert out is not None and bytes(out) == p.tobytes()
    q = p.copy()
    q[10:20] = 7
    f2 = tx.encode(("z",), [q], 1)
    assert f2.codec == CODEC_DELTA and f2.base_epoch == f.self_epoch
    out2 = rx.decode(("z",), f2.codec, f2.flags, f2.base_epoch,
                     f2.self_epoch, f2.crc, f2.wire, f2.raw_nbytes)
    assert bytes(out2) == q.tobytes()
    # Deliveries share the cache's bases: read-only
    assert not out2.flags.writeable


def test_receiver_rejects_crc_and_missing_base():
    tx = SenderDeltaCache(budget_bytes=1 << 30)
    rx = ReceiverDeltaCache(budget_bytes=1 << 30)
    rng = np.random.default_rng(4)
    p = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    f0 = tx.encode(("k",), [p], 0)
    assert rx.decode(("k",), f0.codec, f0.flags, 0, f0.self_epoch,
                     f0.crc, f0.wire, f0.raw_nbytes) is not None
    q = p.copy()
    q[5000:5100] ^= 9
    f1 = tx.encode(("k",), [q], 1)
    assert f1.codec == CODEC_DELTA
    bad = f1.wire.copy()
    bad[:4] ^= 0x5A
    assert rx.decode(("k",), f1.codec, f1.flags, f1.base_epoch,
                     f1.self_epoch, f1.crc, bad, f1.raw_nbytes) is None
    rx.drop_bases()
    assert rx.decode(("k",), f1.codec, f1.flags, f1.base_epoch,
                     f1.self_epoch, f1.crc, f1.wire,
                     f1.raw_nbytes) is None


def test_payload_entropy_matches_reference():
    rng = np.random.default_rng(5)
    cases = [np.zeros(4096, np.uint8),
             rng.integers(0, 255, 1 << 16, dtype=np.uint8),
             np.repeat(np.arange(8, dtype=np.uint8), 3000),
             np.zeros(0, np.uint8)]
    for arr in cases:
        assert payload_entropy(arr) == ref_codec.payload_entropy(arr)
    assert payload_entropy(cases[0]) == 0.0
    assert payload_entropy(cases[1]) > 7.0
    data = b"the same bytes"
    assert port_codec.crc_of(data) == ref_codec.crc_of(data)
    for name in ("CODEC_RAW", "CODEC_FULL", "CODEC_DELTA", "CODEC_ZLIB",
                 "FLAG_CACHE", "FLAG_ESCAPE", "CODEC_MIN_BYTES",
                 "CODEC_LABELS"):
        assert getattr(port_codec, name) == getattr(ref_codec, name), name
    assert vars(port_codec.DELTA_SETTINGS) == vars(ref_codec.DELTA_SETTINGS)


# ---------------------------------------------------------------------------
# The governor
# ---------------------------------------------------------------------------

MODES = ["auto", "raw", "off", "delta", "zlib", "quant", "auto,quant",
         "delta,quant", "zlib,quant", "bogus,", ""]


@pytest.mark.parametrize("min_gibs", [None, "9.5"])
@pytest.mark.parametrize("mode", MODES)
def test_governor_verdicts_equal_reference(monkeypatch, mode, min_gibs):
    from tests.test_torch_mpi_world import reset_reference_links

    reset_reference_links()
    if min_gibs is None:
        monkeypatch.delenv("FAABRIC_WIRE_CODEC_MIN_GIBS", raising=False)
    else:
        monkeypatch.setenv("FAABRIC_WIRE_CODEC_MIN_GIBS", min_gibs)
    port, ref = WireCodecGovernor(mode=mode), ref_codec.WireCodecGovernor(
        mode=mode)
    assert port.mode == ref.mode
    for local in (True, False):
        for nbytes in (1 << 16, 1 << 20, 1 << 26):
            assert port.bulk_codec(f"h{local}", local, 0, 1, nbytes) == \
                ref.bulk_codec(f"h{local}", local, 0, 1, nbytes), \
                (mode, local, nbytes)
        for knob in ("", "int8"):
            assert port.quant_mode(knob) == ref.quant_mode(knob)
            assert port.quant_for_link(knob, "h", local) == \
                ref.quant_for_link(knob, "h", local)


def test_governor_env_and_set_mode(monkeypatch):
    monkeypatch.setenv("FAABRIC_WIRE_CODEC", "zlib")
    port_codec.reset_wire_governor()
    assert port_codec.get_wire_governor().bulk_codec(
        "x", True, 0, 1, 1 << 20) == "zlib"
    set_wire_codec("raw")
    assert port_codec.get_wire_governor().bulk_codec(
        "x", False, 0, 1, 1 << 20) == "raw"


def test_quant_codec_per_link_raw_passthrough():
    from faabric_tpu_torch.mpi.quant import Int8ChunkCodec

    codec = Int8ChunkCodec()
    chunk = np.linspace(-5.0, 5.0, 1000, dtype=np.float32)
    assert np.array_equal(codec.decode(codec.encode(chunk, quantize=False)),
                          chunk)
    q = codec.decode(codec.encode(chunk, quantize=True))
    assert np.max(np.abs(q - chunk)) <= 5.0 / 127 + 1e-6
    assert not np.array_equal(q, chunk)


# ---------------------------------------------------------------------------
# The escape protocol over a real loopback bulk pair
# ---------------------------------------------------------------------------

class _SinkBroker:
    def __init__(self):
        self.host = "codec-sink"
        self.got = []

    def deliver(self, gid, s, r, data, seq, chan):
        self.got.append((seq, data))

    def deliver_many(self, gid, s, r, items, chan):
        for seq, d in items:
            self.deliver(gid, s, r, d, seq, chan)


@pytest.fixture
def bulk_codec_pair(monkeypatch):
    """A real BulkServer and BulkClient over loopback, rings off, the
    governor forced to delta."""
    monkeypatch.setenv("SHM_RING_BYTES", "0")
    offset = next_port_base()
    register_host_alias("codec-peer", "127.0.0.1", offset)
    broker = _SinkBroker()
    server = BulkServer(broker, port_offset=offset)
    server.start()
    set_wire_codec("delta")
    client = BulkClient("codec-peer")
    holder = {"server": server}
    try:
        yield broker, holder, client, offset
    finally:
        client.close()
        holder["server"].stop()


def _await(broker, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(broker.got) < n and time.monotonic() < deadline:
        time.sleep(0.02)
    return len(broker.got) >= n


def test_delta_stream_delivers_bitwise_and_saves_wire(bulk_codec_pair):
    broker, _holder, client, _ = bulk_codec_pair
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    sent = []
    for rnd in range(5):
        p = payload.copy()
        p[rnd * 500:rnd * 500 + 2048] ^= 0x1
        client.send(GROUP, 0, 1, [p], rnd, 0)
        payload = p
        sent.append(p)
    assert _await(broker, 5)
    for (seq, got), want in zip(sorted(broker.got, key=lambda x: x[0]),
                                sent):
        assert np.array_equal(np.asarray(got), want)
    assert client.coded_frames == 5
    assert client.escape_frames == 0
    stripe = [s for s in client.stripes() if s.coded_frames][0]
    assert stripe.wire_bytes < stripe.raw_bytes // 4


def test_dropped_base_nacks_and_heals_without_another_send(
        bulk_codec_pair):
    broker, holder, client, _ = bulk_codec_pair
    rng = np.random.default_rng(8)
    p = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    client.send(GROUP, 0, 1, [p], 0, 0)
    assert _await(broker, 1)
    holder["server"].drop_codec_bases()
    q = p.copy()
    q[100:200] ^= 0x3
    client.send(GROUP, 0, 1, [q], 1, 0)
    assert _await(broker, 2), "NACK escape did not heal the stream"
    assert np.array_equal(np.asarray(broker.got[-1][1]), q)
    assert client.escape_frames >= 1
    r = q.copy()
    r[5000:5050] ^= 0x9
    client.send(GROUP, 0, 1, [r], 2, 0)
    assert _await(broker, 3)
    assert np.array_equal(np.asarray(broker.got[-1][1]), r)


def test_receiver_restart_mid_stream_recovers(bulk_codec_pair):
    broker, holder, client, offset = bulk_codec_pair
    rng = np.random.default_rng(9)
    p = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    client.send(GROUP, 0, 1, [p], 0, 0)
    assert _await(broker, 1)
    holder["server"].stop()
    holder["server"] = BulkServer(broker, port_offset=offset)
    holder["server"].start()
    time.sleep(0.4)  # the NACK reader sees the close and resets
    q = p.copy()
    q[300:400] ^= 0x5
    client.send(GROUP, 0, 1, [q], 1, 0)
    assert _await(broker, 2), "restart did not recover"
    assert np.array_equal(np.asarray(broker.got[-1][1]), q)
    r = q.copy()
    r[9000:9050] ^= 0x2
    client.send(GROUP, 0, 1, [r], 2, 0)
    assert _await(broker, 3)
    assert np.array_equal(np.asarray(broker.got[-1][1]), r)


def test_corrupt_delta_frame_heals(bulk_codec_pair, monkeypatch):
    """The first delta frame's wire bytes are scrambled on their way out
    (crc left stale); the receiver NACKs and the same seq heals
    bitwise."""
    broker, _holder, client, _ = bulk_codec_pair
    rng = np.random.default_rng(10)
    p = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    client.send(GROUP, 0, 1, [p], 0, 0)
    assert _await(broker, 1)
    send = _Stripe._send_coded_frame_locked
    corrupted = []

    def scramble(self, gh, gl, s, r, c, seq, frame):
        if frame.codec == CODEC_DELTA and not corrupted:
            wire = frame.wire.copy()
            wire[:min(8, wire.size)] ^= 0x5A
            frame.wire = wire
            corrupted.append(seq)
        return send(self, gh, gl, s, r, c, seq, frame)

    monkeypatch.setattr(_Stripe, "_send_coded_frame_locked", scramble)
    q = p.copy()
    q[100:150] ^= 0x2
    client.send(GROUP, 0, 1, [q], 1, 0)
    assert _await(broker, 2), "corrupt frame did not heal"
    assert corrupted == [1]
    assert broker.got[-1][0] == 1
    assert np.array_equal(np.asarray(broker.got[-1][1]), q)
    assert client.escape_frames >= 1


def test_coded_streams_pin_to_one_stripe(bulk_codec_pair):
    broker, _holder, client, _ = bulk_codec_pair
    rng = np.random.default_rng(11)
    p = rng.integers(0, 255, 1 << 19, dtype=np.uint8)
    for rnd in range(4):
        client.send(GROUP, 0, 1, [p], rnd, 0)
    assert _await(broker, 4)
    coded_stripes = [s for s in client.stripes() if s.coded_frames > 0]
    assert len(coded_stripes) == 1
    assert coded_stripes[0].coded_frames == 4
