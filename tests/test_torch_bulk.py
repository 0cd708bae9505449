"""The port's bulk data plane, and bulk frames across the two packages.

Counterpart of ``tests/unit/test_bulk.py``: the same 18 cases on a port
``bulk_pair`` (two brokers on loopback aliases with live
``PointToPointServer``s, each with its ``BulkServer``), then interop:
a reference broker on one alias and a port broker on the other, both
ways, with raw frames over TCP, frames over a shm ring and delta-coded
frames, which must arrive bitwise. Where the reference reads its comm
matrix (not ported), the port's bulk counters say which plane carried
the bytes. Every blocking wait has a timeout; every fixture closes its
clients, so no ring stays in /dev/shm.
"""

import socket
import threading
import time

import numpy as np
import pytest

from tests.conftest import next_port_base, run_threads

from faabric_tpu_torch.batch_scheduler import SchedulingDecision
from faabric_tpu_torch.mpi import MpiOp, MpiWorld
from faabric_tpu_torch.transport import bulk as bulk_mod
from faabric_tpu_torch.transport.bulk import (
    BULK_PORT,
    BULK_THRESHOLD,
    SHM_ANNOUNCE,
    BulkServer,
    _pack_raw,
)
from faabric_tpu_torch.transport.codec import (
    reset_wire_governor,
    set_wire_codec,
)
from faabric_tpu_torch.transport.common import (
    clear_host_aliases,
    register_host_alias,
    resolve_host,
)
from faabric_tpu_torch.transport.point_to_point import (
    COORD_CHANNEL,
    PointToPointBroker,
)
from faabric_tpu_torch.transport.ptp_remote import PointToPointServer
from faabric_tpu_torch.transport.server import MessageEndpointServer
from faabric_tpu_torch.transport.shm import shm_available

GROUP = 6060
WAIT = 10.0

needs_shm = pytest.mark.skipif(not shm_available(),
                               reason="no /dev/shm or native build")


@pytest.fixture(autouse=True)
def _reset_port_globals():
    reset_wire_governor()
    yield
    reset_wire_governor()
    clear_host_aliases()


def _decision(group, hosts):
    d = SchedulingDecision(app_id=group, group_id=group)
    for idx, host in enumerate(hosts):
        d.add_message(host, idx + 1, idx, idx)
    return d


@pytest.fixture
def bulk_pair():
    base = next_port_base()
    register_host_alias("bulkA", "127.0.0.1", base)
    register_host_alias("bulkB", "127.0.0.1", base + 1000)
    brokers = {h: PointToPointBroker(h) for h in ("bulkA", "bulkB")}
    servers = [PointToPointServer(b) for b in brokers.values()]
    for b, s in zip(brokers.values(), servers):
        b.test_ptp_server = s
    started = []
    try:
        for s in servers:
            s.start()
            started.append(s)
        d = _decision(GROUP, ["bulkA", "bulkB"])
        for b in brokers.values():
            b.set_up_local_mappings_from_decision(d)
        yield brokers
    finally:
        for s in started:
            s.stop()
        for b in brokers.values():
            b.clear()
        clear_host_aliases()


def test_large_payload_rides_bulk_plane(bulk_pair):
    """Over the threshold, intact and in order, with a 128-bit group
    id."""
    big_group = (1 << 70) + GROUP
    d = _decision(big_group, ["bulkA", "bulkB"])
    for b in bulk_pair.values():
        b.set_up_local_mappings_from_decision(d)
    payload = bytes(np.arange(BULK_THRESHOLD * 2, dtype=np.uint8) % 251)
    bulk_pair["bulkA"].send_message(big_group, 0, 1, payload)
    got = bulk_pair["bulkB"].recv_message(big_group, 0, 1, timeout=WAIT)
    assert bytes(got) == payload
    assert bulk_pair["bulkA"]._get_bulk_client("bulkB").stripes()


def test_bulk_and_rpc_planes_interleave_in_order(bulk_pair, monkeypatch):
    """Small frames on the RPC plane and large ones on the bulk plane,
    alternating on one queue, arrive in send order."""
    monkeypatch.setenv("SHM_BULK", "0")  # small frames stay on RPC
    msgs = [bytes([i]) * (BULK_THRESHOLD + 10) if i % 2
            else bytes([i]) * 16 for i in range(8)]
    for m in msgs:
        bulk_pair["bulkA"].send_message(GROUP, 0, 1, m)
    for i, m in enumerate(msgs):
        got = bulk_pair["bulkB"].recv_message(GROUP, 0, 1, timeout=WAIT)
        assert bytes(got) == m, f"message {i} out of order or corrupt"


def _worlds(brokers, size=2):
    return {h: MpiWorld(b, GROUP, size, GROUP) for h, b in brokers.items()}


def test_mpi_large_allreduce_cross_host(bulk_pair):
    """16 MiB allreduce across the hosts, chunk-pipelined over the bulk
    plane, matches numpy."""
    worlds = _worlds(bulk_pair)
    n = (16 << 20) // 4
    datas = {0: np.full(n, 3, np.int32), 1: np.full(n, 4, np.int32)}
    out = {}

    def rank_fn(host, rank):
        w = worlds[host]
        w.refresh_rank_hosts()
        out[rank] = w.allreduce(rank, datas[rank], MpiOp.SUM)

    run_threads([lambda: rank_fn("bulkA", 0), lambda: rank_fn("bulkB", 1)],
                timeout=30)
    for rank in (0, 1):
        np.testing.assert_array_equal(out[rank], datas[0] + datas[1])
    assert bulk_pair["bulkA"]._get_bulk_client("bulkB").shm_frames \
        + bulk_pair["bulkA"]._get_bulk_client("bulkB").tcp_frames > 0


def test_chunked_broadcast_sizeless_receiver(bulk_pair):
    """A receiver with no size template reassembles a chunked
    broadcast."""
    worlds = _worlds(bulk_pair)
    payload = np.arange((16 << 20) // 8, dtype=np.int64)
    out = {}

    def root():
        worlds["bulkA"].refresh_rank_hosts()
        worlds["bulkA"].broadcast(0, 0, payload)

    def receiver():
        worlds["bulkB"].refresh_rank_hosts()
        out[1] = worlds["bulkB"].broadcast(0, 1, np.empty(0))

    run_threads([root, receiver], timeout=30)
    np.testing.assert_array_equal(out[1], payload)
    assert out[1].flags.writeable


def test_large_allgather_cross_host(bulk_pair):
    worlds = _worlds(bulk_pair)
    n = (6 << 20) // 4
    datas = {0: np.full(n, 1, np.int32), 1: np.full(n, 2, np.int32)}
    out = {}

    def rank_fn(host, rank):
        w = worlds[host]
        w.refresh_rank_hosts()
        out[rank] = w.allgather(rank, datas[rank])

    run_threads([lambda: rank_fn("bulkA", 0), lambda: rank_fn("bulkB", 1)],
                timeout=30)
    expected = np.concatenate([datas[0], datas[1]])
    for rank in (0, 1):
        np.testing.assert_array_equal(out[rank], expected)


def test_bulk_falls_back_to_rpc_without_server():
    """A peer with only the RPC plane still gets large payloads, and the
    outage is remembered."""
    base = next_port_base()
    register_host_alias("fbA", "127.0.0.1", base)
    register_host_alias("fbB", "127.0.0.1", base + 1000)
    brokers = {h: PointToPointBroker(h) for h in ("fbA", "fbB")}
    server_b = PointToPointServer(brokers["fbB"])
    MessageEndpointServer.start(server_b)  # the RPC plane alone
    try:
        d = _decision(GROUP + 1, ["fbA", "fbB"])
        for b in brokers.values():
            b.set_up_local_mappings_from_decision(d)
        payload = b"z" * (BULK_THRESHOLD + 1)
        brokers["fbA"].send_message(GROUP + 1, 0, 1, payload)
        got = brokers["fbB"].recv_message(GROUP + 1, 0, 1, timeout=WAIT)
        assert bytes(got) == payload
        assert brokers["fbA"]._bulk_down("fbB")
    finally:
        MessageEndpointServer.stop(server_b)
        for b in brokers.values():
            b.clear()
        clear_host_aliases()


def test_interleaved_mixed_size_collectives_stress(bulk_pair):
    """Allreduces alternating across the bulk and RPC planes and sizes:
    the ordering state holds across plane switches on one queue."""
    worlds = _worlds(bulk_pair)
    sizes = [100, (9 << 20) // 4, 1000, (12 << 20) // 4, 64,
             BULK_THRESHOLD // 4 + 1]
    out = {}

    def rank_fn(host, rank):
        w = worlds[host]
        w.refresh_rank_hosts()
        acc = []
        for i, n in enumerate(sizes):
            got = w.allreduce(rank, np.full(n, rank + i, np.int32),
                              MpiOp.SUM)
            acc.append((int(got[0]), int(got[-1])))
        out[rank] = acc

    run_threads([lambda: rank_fn("bulkA", 0), lambda: rank_fn("bulkB", 1)])
    for i in range(len(sizes)):
        expected = (0 + i) + (1 + i)
        assert out[0][i] == (expected, expected)
        assert out[1][i] == (expected, expected)


def test_bulk_server_survives_garbage(bulk_pair):
    """Garbage (short junk, an absurd size claim) drops that connection;
    the server keeps serving."""
    ip, port = resolve_host("bulkB", BULK_PORT)
    s = socket.create_connection((ip, port), timeout=5)
    s.sendall(b"\x01\x02garbage")
    s.close()
    s = socket.create_connection((ip, port), timeout=5)
    s.sendall(_pack_raw(0, 123, -5, 2, 0, 0, 1 << 62))
    time.sleep(0.2)
    s.close()
    payload = b"q" * (BULK_THRESHOLD + 5)
    bulk_pair["bulkA"].send_message(GROUP, 0, 1, payload)
    got = bulk_pair["bulkB"].recv_message(GROUP, 0, 1, timeout=WAIT)
    assert bytes(got) == payload


@needs_shm
def test_same_machine_bulk_rides_shm_ring(bulk_pair):
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    payloads = [bytes(np.arange(BULK_THRESHOLD + i * 1000,
                                dtype=np.uint8) % 251) for i in range(4)]
    for p in payloads:
        a.send_message(GROUP, 0, 1, p)
    for p in payloads:
        assert bytes(b.recv_message(GROUP, 0, 1, timeout=WAIT)) == p
    client = a._get_bulk_client("bulkB")
    assert client.rings(), "no ring ever announced"
    assert client.shm_frames >= len(payloads)


def test_large_frames_stripe_across_connections(bulk_pair, monkeypatch):
    """Large sequenced frames round-robin across 2 data stripes, and
    the receiver restores their order."""
    monkeypatch.setattr(bulk_mod, "BULK_STRIPES", 2)
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    payloads = [bytes([i]) * (BULK_THRESHOLD + i) for i in range(6)]
    for p in payloads:
        a.send_message(GROUP, 0, 1, p)
    for i, p in enumerate(payloads):
        got = b.recv_message(GROUP, 0, 1, timeout=WAIT)
        assert bytes(got) == p, f"frame {i} out of order or corrupt"
    used = [s for s in a._get_bulk_client("bulkB").stripes()
            if s.sock is not None]
    assert len(used) >= 2, "large frames never spread across stripes"


@needs_shm
def test_small_data_frames_ride_control_ring(bulk_pair):
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    payloads = [bytes([i]) * 2048 for i in range(8)]
    for p in payloads:
        a.send_message(GROUP, 0, 1, p)
    for p in payloads:
        got = b.recv_message(GROUP, 0, 1, timeout=WAIT)
        assert isinstance(got, bytes) and got == p
    ctrl = a._get_bulk_client("bulkB").stripes()[0]
    assert ctrl.ring is not None, "control stripe ring never announced"
    assert ctrl.shm_frames >= len(payloads)


def test_coordination_channel_stays_on_rpc(bulk_pair):
    from faabric_tpu_torch.transport.ptp_remote import _RPC_FRAMES

    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    coord_before = _RPC_FRAMES[COORD_CHANNEL].value
    a.send_message(GROUP, 0, 1, b"\x00", channel=COORD_CHANNEL)
    got = b.recv_message(GROUP, 0, 1, timeout=WAIT, channel=COORD_CHANNEL)
    assert bytes(got) == b"\x00"
    assert "bulkB" not in a._bulk_clients
    assert _RPC_FRAMES[COORD_CHANNEL].value == coord_before + 1


@needs_shm
def test_shm_plane_concurrent_multirank_traffic(bulk_pair):
    """Four rank streams wrap every ring many times at once: each
    stream's order and bytes hold, and the shm counters account for
    nearly all the bytes."""
    d = SchedulingDecision(app_id=GROUP + 7, group_id=GROUP + 7)
    for i in range(4):
        d.add_message("bulkA", 10 + i, i, i)
    for i in range(4):
        d.add_message("bulkB", 20 + i, 4 + i, 4 + i)
    for br in bulk_pair.values():
        br.set_up_local_mappings_from_decision(d)
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    shm_bytes_0 = bulk_mod._BULK_TX_BYTES["shm"].value
    n_frames, frame_elems = 24, 600_000
    sent_bytes, errors = {}, []

    def sender(src, dst):
        try:
            total = 0
            for i in range(n_frames):
                payload = np.full(frame_elems, (src * 31 + i) % 251,
                                  np.uint8).tobytes()
                a.send_message(GROUP + 7, src, dst, payload)
                total += len(payload)
            sent_bytes[(src, dst)] = total
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(f"sender {src}->{dst}: {e!r}")

    def receiver(src, dst):
        try:
            for i in range(n_frames):
                got = b.recv_message(GROUP + 7, src, dst, timeout=30)
                arr = np.frombuffer(got, np.uint8)
                assert arr.size == frame_elems
                assert arr[0] == arr[-1] == (src * 31 + i) % 251, (
                    f"stream {src}->{dst} frame {i} corrupt/reordered")
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(f"receiver {src}->{dst}: {e!r}")

    pairs = [(0, 4), (1, 5), (2, 6), (3, 7)]
    threads = [threading.Thread(target=fn, args=p)
               for p in pairs for fn in (sender, receiver)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    client = a._get_bulk_client("bulkB")
    assert client.shm_frames >= n_frames * len(pairs) * 0.9
    moved = bulk_mod._BULK_TX_BYTES["shm"].value - shm_bytes_0
    assert moved >= 0.9 * sum(sent_bytes.values()), moved


def test_shm_disabled_env_falls_back_to_tcp(bulk_pair, monkeypatch):
    monkeypatch.setenv("SHM_BULK", "0")
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    payload = bytes(np.arange(BULK_THRESHOLD, dtype=np.uint8) % 251)
    a.send_message(GROUP, 0, 1, payload)
    assert bytes(b.recv_message(GROUP, 0, 1, timeout=WAIT)) == payload
    client = a._get_bulk_client("bulkB")
    assert client.shm_frames == 0 and client.tcp_frames == 1


@needs_shm
def test_duplicate_ring_attach_refused(bulk_pair):
    """A second announce of a live ring's name must not start a second
    consumer on the SPSC ring."""
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    a.send_message(GROUP, 0, 1, b"x" * (BULK_THRESHOLD + 1))
    b.recv_message(GROUP, 0, 1, timeout=WAIT)
    client = a._get_bulk_client("bulkB")
    used = [s for s in client.stripes()
            if s.ring is not None and s.shm_frames > 0]
    assert used, "no stripe carried the frame on its ring"
    name = used[0].ring.name
    server = b.test_ptp_server._bulk_server
    assert name in server._attached_rings
    ip, port = resolve_host("bulkB", BULK_PORT)
    s = socket.create_connection((ip, port), timeout=5)
    try:
        raw = name.encode()
        s.sendall(_pack_raw(0, 0, 0, 0, 0, len(raw), SHM_ANNOUNCE) + raw)
        s.settimeout(5)
        assert s.recv(1) == b"\x00"  # the NACK
        assert list(server._attached_rings) == [name]
        drains = [t for t in threading.enumerate()
                  if t.name == f"bulk/shm-drain@{name[-12:]}"]
        assert len(drains) == 1
        payload = bytes(np.arange(BULK_THRESHOLD * 2, dtype=np.uint8) % 251)
        a.send_message(GROUP, 0, 1, payload)
        assert bytes(b.recv_message(GROUP, 0, 1, timeout=WAIT)) == payload
    finally:
        s.close()


@needs_shm
def test_ring_attach_nack_falls_back_to_tcp(bulk_pair, monkeypatch):
    """A refused attach puts the stripe on TCP at once."""
    monkeypatch.setattr(bulk_mod, "BULK_STRIPES", 0)
    monkeypatch.setattr(BulkServer, "_start_ring_drain",
                        lambda self, name, stop: None)
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    payload = bytes(np.arange(BULK_THRESHOLD + 7, dtype=np.uint8) % 251)
    t0 = time.perf_counter()
    a.send_message(GROUP, 0, 1, payload)
    first_s = time.perf_counter() - t0
    assert bytes(b.recv_message(GROUP, 0, 1, timeout=WAIT)) == payload
    stripe = a._get_bulk_client("bulkB").stripes()[0]
    assert stripe.ring is None and stripe.ring_refused
    assert first_s < 4.0
    t0 = time.perf_counter()
    a.send_message(GROUP, 0, 1, payload)
    assert time.perf_counter() - t0 < 1.0
    assert bytes(b.recv_message(GROUP, 0, 1, timeout=WAIT)) == payload


@needs_shm
def test_ring_push_timeout_declares_ring_dead(bulk_pair, monkeypatch):
    """A push timeout after a good attach abandons the ring and sends
    the frame on TCP."""
    monkeypatch.setattr(bulk_mod, "BULK_STRIPES", 0)
    a, b = bulk_pair["bulkA"], bulk_pair["bulkB"]
    a.send_message(GROUP, 0, 1, b"y" * (BULK_THRESHOLD + 1))
    b.recv_message(GROUP, 0, 1, timeout=WAIT)
    stripe = a._get_bulk_client("bulkB").stripes()[0]
    assert stripe.ring is not None
    monkeypatch.setattr(stripe.ring, "push", lambda *args, **kw: False)
    payload = bytes(np.arange(BULK_THRESHOLD + 3, dtype=np.uint8) % 251)
    a.send_message(GROUP, 0, 1, payload)
    assert bytes(b.recv_message(GROUP, 0, 1, timeout=WAIT)) == payload
    assert stripe.ring is None and stripe.ring_refused


def test_bulk_server_stop_races_connection_churn():
    """stop() while connections churn completes and leaves no handler
    thread of this server behind."""

    class _NullBroker:
        def deliver(self, *a, **k):
            pass

        def deliver_many(self, *a, **k):
            pass

    srv = BulkServer(_NullBroker(), port_offset=next_port_base())
    srv.start()
    stop_churn = threading.Event()

    def churn():
        while not stop_churn.is_set():
            try:
                socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=0.5).close()
            except OSError:
                return

    churners = [threading.Thread(target=churn) for _ in range(4)]
    for t in churners:
        t.start()
    time.sleep(0.2)
    with srv._lock:
        handlers = list(srv._threads)
    srv.stop()
    stop_churn.set()
    for t in churners:
        t.join(timeout=5.0)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            t.is_alive() for t in handlers):
        time.sleep(0.05)
    assert not [t.name for t in handlers if t.is_alive()]
    assert srv._listener is None and not srv._conns


# ---------------------------------------------------------------------------
# Across the packages: a reference broker and a port broker
# ---------------------------------------------------------------------------

class MixedPair:
    """``refX`` is a reference broker, ``portY`` a port broker, on two
    aliases of one port slot, each alias registered in both packages'
    tables; both hold the same group's mappings."""

    def __init__(self) -> None:
        from faabric_tpu.batch_scheduler.decision import (
            SchedulingDecision as RefDecision,
        )
        from faabric_tpu.transport import common as ref_common
        from faabric_tpu.transport.point_to_point import (
            PointToPointBroker as RefBroker,
        )
        from faabric_tpu.transport.ptp_remote import (
            PointToPointServer as RefServer,
        )

        self.ref_common = ref_common
        base = next_port_base()
        for register in (ref_common.register_host_alias,
                         register_host_alias):
            register("refX", "127.0.0.1", base)
            register("portY", "127.0.0.1", base + 1000)
        self.ref = RefBroker("refX")
        self.port = PointToPointBroker("portY")
        self.servers = []
        try:
            for s in (RefServer(self.ref), PointToPointServer(self.port)):
                s.start()
                self.servers.append(s)
            rd = RefDecision(app_id=GROUP + 9, group_id=GROUP + 9)
            pd = SchedulingDecision(app_id=GROUP + 9, group_id=GROUP + 9)
            for d in (rd, pd):
                d.add_message("refX", 1, 0, 0)
                d.add_message("portY", 2, 1, 1)
            self.ref.set_up_local_mappings_from_decision(rd)
            self.port.set_up_local_mappings_from_decision(pd)
        except BaseException:
            self.close()
            raise

    def ref_to_port(self, payloads):
        for p in payloads:
            self.ref.send_message(GROUP + 9, 0, 1, p, must_order=True)
        return [self.port.recv_message(GROUP + 9, 0, 1, timeout=WAIT)
                for _ in payloads]

    def port_to_ref(self, payloads):
        for p in payloads:
            self.port.send_message(GROUP + 9, 1, 0, p)
        return [self.ref.recv_message(GROUP + 9, 1, 0, must_order=True,
                                      timeout=WAIT) for _ in payloads]

    def close(self) -> None:
        for s in self.servers:
            s.stop()
        self.ref.clear()
        self.port.clear()
        self.ref_common.clear_host_aliases()
        clear_host_aliases()


@pytest.fixture
def mixed_pair():
    pytest.importorskip("jax")
    from faabric_tpu.transport.codec import reset_wire_governor as ref_reset

    from tests.test_torch_mpi_world import reset_reference_links

    ref_reset()
    reset_reference_links()
    pair = MixedPair()
    try:
        yield pair
    finally:
        pair.close()
        ref_reset()
        # The reference's sends recorded these links as measured
        reset_reference_links()


def _payloads(n=3, size=BULK_THRESHOLD * 3, seed=0):
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 256, size, dtype=np.uint8)
    out = [first]
    for i in range(1, n):
        nxt = out[-1].copy()
        nxt[i * 4096:i * 4096 + 2048] ^= 0x5A
        out.append(nxt)
    return [p.tobytes() for p in out]


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_interop_raw_frames_over_tcp(mixed_pair, monkeypatch, direction):
    monkeypatch.setenv("SHM_BULK", "0")
    payloads = _payloads() + [b"small" * 10]
    got = getattr(mixed_pair, direction)(payloads)
    assert [bytes(g) for g in got] == payloads
    sender = mixed_pair.ref if direction == "ref_to_port" \
        else mixed_pair.port
    dst = "portY" if direction == "ref_to_port" else "refX"
    client = sender._get_bulk_client(dst)
    assert client.shm_frames == 0 and not client.rings()


@needs_shm
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_interop_frames_over_a_ring(mixed_pair, direction):
    payloads = _payloads() + [b"small" * 10]
    got = getattr(mixed_pair, direction)(payloads)
    assert [bytes(g) for g in got] == payloads
    sender = mixed_pair.ref if direction == "ref_to_port" \
        else mixed_pair.port
    dst = "portY" if direction == "ref_to_port" else "refX"
    client = sender._get_bulk_client(dst)
    assert client.rings() and client.shm_frames >= len(payloads)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_interop_delta_coded_frames(mixed_pair, monkeypatch, direction):
    """Forced delta on both governors, rings off: the first frame ships
    full and the next ones as deltas against it, decoded bitwise by the
    other package's receiver cache."""
    from faabric_tpu.transport.codec import set_wire_codec as ref_set

    monkeypatch.setenv("SHM_RING_BYTES", "0")
    set_wire_codec("delta")
    ref_set("delta")
    payloads = _payloads(n=4)
    got = getattr(mixed_pair, direction)(payloads)
    assert [bytes(g) for g in got] == payloads
    sender = mixed_pair.ref if direction == "ref_to_port" \
        else mixed_pair.port
    dst = "portY" if direction == "ref_to_port" else "refX"
    client = sender._get_bulk_client(dst)
    assert client.coded_frames == len(payloads)
    assert client.escape_frames == 0
