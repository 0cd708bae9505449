"""The port's two-host MPI world against the JAX package's.

Counterpart of ``tests/unit/test_mpi.py``: the same fixture (6 ranks,
3 + 3 on two loopback host aliases, live point-to-point servers, ports
from ``tests/conftest.py::next_port_base``) is built once for
``faabric_tpu`` and once for the port, and every program runs on both
with the same numpy inputs. Results are compared rank by rank: the
algorithms and fold orders are the same, so integers and host-path
floats agree bit for bit. Each case also holds the result against numpy,
as its reference counterpart does. Where the reference reads the
algorithm a collective took from its trace spans, the port's
``MpiWorld.rungs`` says it. Both packages' worlds cross hosts on their
data planes (shm rings between these aliases of one machine); the
quantised link has its cases in ``test_torch_quant.py``.
"""

import dataclasses
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from faabric_tpu.batch_scheduler.decision import (  # noqa: E402
    SchedulingDecision as RefDecision,
)
from faabric_tpu.mpi import MpiOp as RefOp  # noqa: E402
from faabric_tpu.mpi import MpiWorld as RefWorld  # noqa: E402
from faabric_tpu.mpi import UserOp as RefUserOp  # noqa: E402
from faabric_tpu.mpi import types as ref_types  # noqa: E402
from faabric_tpu.transport import common as ref_common  # noqa: E402
from faabric_tpu.transport.point_to_point import (  # noqa: E402
    PointToPointBroker as RefBroker,
)
from faabric_tpu.transport.ptp_remote import (  # noqa: E402
    PointToPointServer as RefServer,
)

from faabric_tpu_torch.batch_scheduler import SchedulingDecision  # noqa: E402
from faabric_tpu_torch.mpi import MpiOp, MpiWorld, UserOp  # noqa: E402
from faabric_tpu_torch.mpi import types as port_types  # noqa: E402
from faabric_tpu_torch.transport import common as port_common  # noqa: E402
from faabric_tpu_torch.transport.point_to_point import (  # noqa: E402
    PointToPointBroker,
)
from faabric_tpu_torch.transport.ptp_remote import (  # noqa: E402
    PointToPointServer,
)

GROUP = 4242


@dataclasses.dataclass
class Pkg:
    """One package's MPI names, so one program runs on either."""
    name: str
    World: type
    Broker: type
    Server: type
    Decision: type
    MpiOp: object
    UserOp: type
    types: object
    common: object


REF = Pkg("faabric_tpu", RefWorld, RefBroker, RefServer, RefDecision, RefOp,
          RefUserOp, ref_types, ref_common)
PORT = Pkg("faabric_tpu_torch", MpiWorld, PointToPointBroker,
           PointToPointServer, SchedulingDecision, MpiOp, UserOp, port_types,
           port_common)


class Cluster:
    """One package's world of ``len(hosts)`` ranks over live brokers:
    ``hosts[r]`` is rank r's host alias."""

    def __init__(self, pk: Pkg, offsets: list[int], hosts: list[str],
                 group: int, servers: bool = True,
                 ips: dict | None = None) -> None:
        self.pk = pk
        self.hosts = hosts
        self.group = group
        names = list(dict.fromkeys(hosts))
        for h, off in zip(names, offsets):
            pk.common.register_host_alias(h, (ips or {}).get(h, "127.0.0.1"),
                                          off)
        self.brokers = {h: pk.Broker(h) for h in names}
        self.servers = ([pk.Server(b) for b in self.brokers.values()]
                        if servers else [])
        for s in self.servers:
            s.start()
        self.worlds = self.add_world(group)

    def add_world(self, group: int) -> dict:
        d = self.pk.Decision(app_id=group, group_id=group)
        for rank, host in enumerate(self.hosts):
            d.add_message(host, 2000 + rank, rank, rank,
                          mpi_port=8020 + rank, device_id=rank)
        for b in self.brokers.values():
            b.set_up_local_mappings_from_decision(d)
        return {h: self.pk.World(b, group, len(self.hosts), group)
                for h, b in self.brokers.items()}

    def world(self, rank: int, worlds: dict | None = None):
        return (worlds or self.worlds)[self.hosts[rank]]

    def each_world(self):
        return list(self.worlds.values())

    def set(self, **attrs) -> None:
        """The same attributes on every host's world object (algorithm
        choices must agree across hosts)."""
        for w in self.each_world():
            for k, v in attrs.items():
                setattr(w, k, v)

    def run(self, fn, n: int | None = None, timeout: float = 60.0) -> dict:
        """``fn(world, rank, pk)`` on a thread per rank; results by rank."""
        from tests.conftest import run_threads

        n = len(self.hosts) if n is None else n
        results = {}

        def runner(rank):
            def run():
                results[rank] = fn(self.world(rank), rank, self.pk)
            return run

        run_threads([runner(r) for r in range(n)], timeout=timeout)
        return results

    def close(self) -> None:
        for s in self.servers:
            s.stop()
        for b in self.brokers.values():
            b.clear()
        self.pk.common.clear_host_aliases()


def reset_reference_links() -> None:
    """Forget the links the reference measured in this process (its comm
    matrix and perf store). It picks schedule families and wire codecs
    from them; the port measures none and takes every link as slow, as
    the reference does for an unmeasured one. A test that moves bytes
    through the reference resets them before and after, so that no later
    test in its worker reads its links."""
    from faabric_tpu.telemetry import get_comm_matrix
    from faabric_tpu.telemetry.perfprofile import reset_perf_profile

    get_comm_matrix().reset()
    reset_perf_profile()


class Pair:
    def __init__(self, hosts: list[str], group: int = GROUP,
                 servers: bool = True, ips: dict | None = None) -> None:
        from tests.conftest import next_port_base

        reset_reference_links()
        # One port slot for both: the reference's hosts at its first two
        # offsets, the port's at the third and halfway past it
        base = next_port_base()
        self.ref = Cluster(REF, [base, base + 1000], hosts, group, servers,
                           ips)
        try:
            self.port = Cluster(PORT, [base + 2000, base + 2500], hosts,
                                group, servers, ips)
        except BaseException:
            self.ref.close()
            raise

    def set(self, **attrs) -> None:
        self.ref.set(**attrs)
        self.port.set(**attrs)

    def both(self, fn, n: int | None = None) -> dict:
        """Run ``fn`` on both packages' worlds; the results must agree
        rank by rank. Returns the port's."""
        want = self.ref.run(fn, n)
        got = self.port.run(fn, n)
        assert sorted(got) == sorted(want)
        for r in want:
            assert_same(got[r], want[r], f"rank {r}")
        return got

    def close(self) -> None:
        self.ref.close()
        self.port.close()
        reset_reference_links()


def assert_same(got, want, where: str) -> None:
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        assert got.shape == want.shape, (where, got.shape, want.shape)
        assert np.array_equal(got, want), where
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif dataclasses.is_dataclass(want):
        assert dataclasses.astuple(got) == dataclasses.astuple(want), where
    else:
        assert got == want, (where, got, want)


TWO_HOSTS = ["mpiA"] * 3 + ["mpiB"] * 3
SCATTERED = ["scatA" if r % 2 == 0 else "scatB" for r in range(6)]


@pytest.fixture
def pair():
    p = Pair(TWO_HOSTS)
    yield p
    p.close()


@pytest.fixture
def scattered():
    p = Pair(SCATTERED, group=GROUP + 7)
    yield p
    p.close()


def per_rank_data(rank, n=8, dtype=np.float64):
    return np.random.RandomState(rank).rand(n).astype(dtype)


# ---------------------------------------------------------------------------
# The wire form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.uint16,
                                   np.float32, np.float64, "double_int"])
def test_wire_payload_bytes_match_reference(dtype):
    rng = np.random.default_rng(3)
    if dtype == "double_int":
        arr = np.zeros(5, dtype=port_types.DOUBLE_INT_DTYPE)
        arr["val"], arr["loc"] = rng.standard_normal(5), np.arange(5)
    else:
        arr = (rng.standard_normal(37) * 50).astype(dtype)
    for msg_type in (MpiOp.SUM, 12, 100):
        mt_ref = ref_types.MpiMessageType(int(msg_type) % 13
                                          if msg_type != 100 else 100)
        mt = port_types.MpiMessageType(int(mt_ref))
        want = ref_types.pack_mpi_payload(mt_ref, arr, request_id=77)
        assert port_types.pack_mpi_payload(mt, arr, request_id=77) == want
        wire = port_types.MpiWirePayload(mt, arr, 77)
        assert wire.to_bytes() == want and len(wire) == len(want)
        assert b"".join(bytes(b) for b in wire.buffers()) == want
        got_t, got, rid = port_types.unpack_mpi_payload(want)
        ref_t, ref_arr, ref_rid = ref_types.unpack_mpi_payload(want)
        assert (int(got_t), rid) == (int(ref_t), ref_rid)
        assert_same(got, ref_arr, "unpacked")
        assert got.flags.writeable
    assert port_types.mpi_dtype_for(arr.dtype) == ref_types.mpi_dtype_for(
        arr.dtype)
    for code in ref_types.MpiDataType:
        assert port_types.np_dtype_for(port_types.MpiDataType(int(code))) \
            == ref_types.np_dtype_for(code)


# ---------------------------------------------------------------------------
# Point-to-point
# ---------------------------------------------------------------------------

def test_send_recv_cross_host(pair):
    data = np.arange(100, dtype=np.float64)

    def fn(world, rank, pk):
        if rank == 0:
            world.send(0, 5, data)
        if rank == 5:
            arr, status = world.recv(0, 5)
            return arr, status
        return None

    got = pair.both(fn)
    np.testing.assert_array_equal(got[5][0], data)
    assert got[5][1].source == 0 and got[5][1].count == 100


def test_sendrecv(pair):
    def fn(world, rank, pk):
        if rank not in (1, 2):
            return None
        other = 3 - rank
        return world.sendrecv(np.full(4, rank, np.int32), rank, other,
                              other, rank)[0]

    got = pair.both(fn)
    np.testing.assert_array_equal(got[1], np.full(4, 2, np.int32))


def test_isend_irecv_wait(pair):
    payload = np.arange(10, dtype=np.int64)

    def fn(world, rank, pk):
        if rank == 3:
            rid = world.isend(3, 4, payload)
            assert world.await_async(3, rid) is None
            return world.pending_requests(3)
        if rank == 4:
            return world.await_async(4, world.irecv(3, 4))
        return None

    got = pair.both(fn)
    assert got[3] == 0
    np.testing.assert_array_equal(got[4][0], payload)


def test_message_ordering_per_channel(pair):
    def fn(world, rank, pk):
        if rank == 0:
            for i in range(50):
                world.send(0, 1, np.array([i], np.int32))
                world.send(0, 4, np.array([i], np.int32))
        if rank in (1, 4):
            return [int(world.recv(0, rank)[0][0]) for _ in range(50)]
        return None

    got = pair.both(fn)
    assert got[1] == got[4] == list(range(50))


def test_isend_remote_async_with_ordering(pair):
    """A remote isend runs on the send worker (the caller may reuse its
    buffer at once) and a later blocking send never overtakes it."""
    def fn(world, rank, pk):
        if rank == 0:
            buf = np.full(300_000, 7, dtype=np.int32)
            rid = world.isend(0, 3, buf)
            buf[:] = -1
            world.send(0, 3, np.array([99], np.int32))
            world.await_async(0, rid)
        elif rank == 3:
            first, _ = world.recv(0, 3)
            second, _ = world.recv(0, 3)
            return first, second
        return None

    got = pair.both(fn)
    assert got[3][0].size == 300_000 and int(got[3][0][0]) == 7
    assert got[3][1].tolist() == [99]


def test_probe_and_iprobe(pair):
    def fn(world, rank, pk):
        if rank == 1:
            world.send(1, 0, np.arange(40, dtype=np.int32))
            world.send(1, 3, np.arange(7, dtype=np.int16))
        if rank in (0, 3):
            deadline = time.time() + 30
            st = None
            while st is None and time.time() < deadline:
                st = world.iprobe(1, rank)
            st2 = world.probe(1, rank, timeout=5.0)
            arr, st3 = world.recv(1, rank)
            return st, st2, arr, st3, world.iprobe(1, rank)
        return None

    got = pair.both(fn, n=4)
    st, st2, arr, st3, after = got[0]
    assert st.count == st2.count == st3.count == 40 and int(arr[-1]) == 39
    assert after is None
    assert got[3][0].count == 7  # a probe of a message from another host


def test_waitall_waitany(pair):
    def fn(world, rank, pk):
        if rank == 0:
            rids = [world.irecv(src, 0) for src in (1, 2, 3)]
            idx, first = world.waitany(0, rids, timeout=10.0)
            rest = world.waitall(0, [r for i, r in enumerate(rids)
                                     if i != idx])
            return sorted([int(first[0][0])] + [int(r[0][0]) for r in rest])
        if rank in (1, 2, 3):
            world.send(rank, 0, np.full(4, rank * 10, dtype=np.int32))
        return None

    assert pair.both(fn, n=4)[0] == [10, 20, 30]


def test_request_free_discards_arrived_message(pair):
    def fn(world, rank, pk):
        if rank == 4:
            world.send(4, 0, np.array([111], np.int32))
            world.send(4, 0, np.array([222], np.int32))
        elif rank == 0:
            rid = world.irecv(4, 0)
            deadline = time.monotonic() + 30.0
            while not world.request_ready(0, rid) \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            world.request_free(0, rid)
            return world.pending_requests(0), int(world.recv(4, 0)[0][0])
        return None

    assert pair.both(fn)[0] == (0, 222)


def test_exec_graph_accounting(pair):
    def fn(world, rank, pk):
        world.record_exec_graph = True
        if rank == 0:
            world.send(0, 1, np.zeros(1))
            world.send(0, 4, np.zeros(1))
            world.send(0, 1, np.zeros(1))
        elif rank in (1, 4):
            for _ in range(2 if rank == 1 else 1):
                world.recv(0, rank)
        return None

    pair.both(fn)
    got = pair.port.world(0).exec_graph_details()
    assert got == pair.ref.world(0).exec_graph_details()
    assert got["mpi-msgcount-torank-1"] == 2
    assert got["mpi-msgcount-torank-4"] == 1


def test_migration_blocked_with_pending_async(pair):
    for cluster in (pair.ref, pair.port):
        world = cluster.world(0)
        world.irecv(0, 0)
        with pytest.raises(RuntimeError, match="pending async"):
            world.prepare_migration(0)


# ---------------------------------------------------------------------------
# Collectives over two hosts
# ---------------------------------------------------------------------------

def test_broadcast_leader_tree(pair):
    data = np.arange(16, dtype=np.float32)

    def fn(world, rank, pk):
        return world.broadcast(2, rank, data if rank == 2 else np.empty(0))

    got = pair.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(got[r], data)


@pytest.mark.parametrize("op,npop", [("SUM", np.add), ("MAX", np.maximum),
                                     ("MIN", np.minimum),
                                     ("PROD", np.multiply)])
@pytest.mark.parametrize("n", [8, 1_100_000])
def test_allreduce_matches_numpy(pair, op, npop, n):
    """Small payloads take the leader tree; large ones the ring, since
    both hosts are this machine (the reference's _hier_wins)."""
    expected = per_rank_data(0, n)
    for r in range(1, 6):
        expected = npop(expected, per_rank_data(r, n))

    def fn(world, rank, pk):
        return world.allreduce(rank, per_rank_data(rank, n), pk.MpiOp[op])

    got = pair.both(fn)
    for r in range(6):
        np.testing.assert_allclose(got[r], expected, rtol=1e-12)
        assert pair.port.world(r).rungs[(r, "allreduce")] == (
            "tree" if n == 8 else "ring")


def test_reduce_to_nonzero_root(pair):
    def fn(world, rank, pk):
        return world.reduce(rank, 4, per_rank_data(rank), pk.MpiOp.SUM)

    got = pair.both(fn)
    np.testing.assert_allclose(got[4], sum(per_rank_data(r)
                                           for r in range(6)), rtol=1e-12)
    assert all(got[r] is None for r in range(6) if r != 4)


@pytest.mark.parametrize("n", [4, 5_000_000])
def test_reduce_chunked_and_broadcast_chunked(pair, n):
    """Above two chunks, reduce and broadcast stream in chunks (a
    CHUNK_HEADER ahead of a broadcast's stream)."""
    def fn(world, rank, pk):
        red = world.reduce(rank, 1, per_rank_data(rank, n), pk.MpiOp.SUM)
        bc = world.broadcast(4, rank, per_rank_data(9, n) if rank == 4
                             else np.empty(0))
        return red, bc

    got = pair.both(fn)
    np.testing.assert_array_equal(got[5][1], per_rank_data(9, n))


def test_gather_allgather(pair):
    expected = np.concatenate([per_rank_data(r, 4) for r in range(6)])

    def fn(world, rank, pk):
        return (world.gather(rank, 0, per_rank_data(rank, 4)),
                world.gather(rank, 4, per_rank_data(rank, 4)),
                world.allgather(rank, per_rank_data(rank, 4)))

    got = pair.both(fn)
    np.testing.assert_array_equal(got[0][0], expected)
    np.testing.assert_array_equal(got[4][1], expected)
    for r in range(6):
        np.testing.assert_array_equal(got[r][2], expected)


def test_scatter(pair):
    root_data = np.arange(24, dtype=np.float64)

    def fn(world, rank, pk):
        return world.scatter(1, rank, root_data if rank == 1
                             else np.empty(0), 4)

    got = pair.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(got[r], root_data[r * 4:(r + 1) * 4])


def test_scan(pair):
    datas = [per_rank_data(r, 5) for r in range(6)]
    prefixes = np.cumsum(np.stack(datas), axis=0)

    def fn(world, rank, pk):
        out = world.scan(rank, datas[rank], pk.MpiOp.SUM)
        key = next(iter(world._sched_cache._entries))
        return out, world._sched_cache.family_of(key)

    got = pair.both(fn)
    for r in range(6):
        assert got[r][1] == "scan.hier"
        np.testing.assert_allclose(got[r][0], prefixes[r], rtol=1e-12)


def test_alltoall(pair):
    mats = {r: np.arange(12, dtype=np.int32) + 100 * r for r in range(6)}

    def fn(world, rank, pk):
        return world.alltoall(rank, mats[rank])

    got = pair.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(got[r], np.concatenate(
            [mats[s].reshape(6, 2)[r] for s in range(6)]))


def test_barrier(pair):
    hits = {"faabric_tpu": [], "faabric_tpu_torch": []}
    done = {"faabric_tpu": [], "faabric_tpu_torch": []}

    def fn(world, rank, pk):
        hits[pk.name].append(rank)
        world.barrier(rank)
        done[pk.name].append(len(hits[pk.name]))
        return None

    pair.both(fn)
    # Nobody left the barrier before every rank had reached it
    assert done["faabric_tpu_torch"] == [6] * 6 == done["faabric_tpu"]


def test_reduce_scatter(pair):
    def fn(world, rank, pk):
        return world.reduce_scatter(rank, np.arange(12, dtype=np.int64)
                                    + rank, pk.MpiOp.SUM)

    got = pair.both(fn)
    total = sum(np.arange(12, dtype=np.int64) + r for r in range(6))
    for r in range(6):
        np.testing.assert_array_equal(got[r], total[r * 2:(r + 1) * 2])


def test_gatherv_scatterv(pair):
    def fn(world, rank, pk):
        out = world.gatherv(rank, 0, np.full(rank + 1, rank, np.int32))
        world.barrier(rank)
        counts = [world.size - r for r in range(world.size)]
        if rank == 0:
            flat = np.concatenate([np.full(c, i, np.int32)
                                   for i, c in enumerate(counts)])
            got = world.scatterv(0, 0, flat, counts)
        else:
            got = world.scatterv(0, rank, None, None)
        return out, got

    got = pair.both(fn)
    data, counts = got[0][0]
    assert counts == [r + 1 for r in range(6)]
    for r in range(6):
        np.testing.assert_array_equal(got[r][1],
                                      np.full(6 - r, r, np.int32))


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_alltoallv_matches_numpy_across_dtypes(pair, dtype):
    counts = {r: [(r + s) % 4 + 1 for s in range(6)] for r in range(6)}
    datas = {r: (np.arange(sum(counts[r])) * 10 + r).astype(dtype)
             for r in range(6)}

    def fn(world, rank, pk):
        return world.alltoallv(rank, datas[rank], counts[rank])

    got = pair.both(fn)
    for r in range(6):
        parts = [datas[s][sum(counts[s][:r]):sum(counts[s][:r + 1])]
                 for s in range(6)]
        np.testing.assert_array_equal(got[r][0], np.concatenate(parts))
        assert got[r][1] == [counts[s][r] for s in range(6)]


def test_minloc_maxloc_allreduce(pair):
    def fn(world, rank, pk):
        pairs = np.zeros(3, dtype=pk.types.DOUBLE_INT_DTYPE)
        pairs["val"] = [float(rank == 0), float((rank + 1) % world.size),
                        1.0]
        pairs["loc"] = rank
        return (world.allreduce(rank, pairs, pk.MpiOp.MINLOC),
                world.allreduce(rank, pairs, pk.MpiOp.MAXLOC))

    got = pair.both(fn)
    assert got[0][0]["loc"][2] == 0 and got[0][0]["val"][0] == 0.0
    assert got[0][1]["val"][2] == 1.0 and got[0][1]["loc"][2] == 0


def test_user_op_allreduce_and_scan(pair):
    vals = [np.array([r - 3, 3 - r, r], np.int64) for r in range(6)]

    def fn(world, rank, pk):
        absmax = pk.UserOp(lambda a, b: np.where(np.abs(b) > np.abs(a), b, a),
                           name="absmax")
        return (world.allreduce(rank, vals[rank], absmax),
                world.scan(rank, np.array([rank + 1], np.int64),
                           pk.UserOp(np.add, name="sum")))

    got = pair.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(got[r][0], [-3, 3, 5])
        assert int(got[r][1][0]) == (r + 1) * (r + 2) // 2


def test_two_concurrent_worlds_are_isolated(pair):
    second = {c.pk.name: c.add_world(GROUP + 777)
              for c in (pair.ref, pair.port)}

    def fn(world_a, rank, pk):
        cluster = pair.ref if pk is REF else pair.port
        world_b = cluster.world(rank, second[pk.name])
        out_a = world_a.allreduce(rank, np.full(8, rank, np.int64),
                                  pk.MpiOp.SUM)
        got = None
        if rank == 0:
            world_b.send(0, 5, np.array([1234], np.int64))
        if rank == 5:
            got = world_b.recv(0, 5)[0]
        out_b = world_b.allreduce(rank, np.full(8, rank * 10, np.int64),
                                  pk.MpiOp.SUM)
        return int(out_a[0]), int(out_b[0]), got

    got = pair.both(fn)
    assert all(got[r][:2] == (15, 150) for r in range(6))
    assert got[5][2].tolist() == [1234]


# ---------------------------------------------------------------------------
# One host: the rings (the reference's single-host ring tests)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_host(monkeypatch):
    """A 4-rank world of each package on one host, with no servers; the
    chunk thresholds shrunk on both classes so small payloads ride the
    rings."""
    for cls in (RefWorld, MpiWorld):
        monkeypatch.setattr(cls, "CHUNK_BYTES", 64)
        monkeypatch.setattr(cls, "CHUNK_BYTES_LOCAL", 64)
    made = []

    def make(n):
        p = Pair(["ringhost"] * n, group=77 + n, servers=False)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


@pytest.mark.parametrize("op", ["SUM", "MAX"])
@pytest.mark.parametrize("world_size", [2, 3, 4])
def test_allreduce_ring_single_host(one_host, op, world_size):
    p = one_host(world_size)
    datas = {r: per_rank_data(r, 1003) for r in range(world_size)}
    orig = {r: datas[r].copy() for r in range(world_size)}

    def fn(world, rank, pk):
        return world.allreduce(rank, datas[rank], pk.MpiOp[op])

    got = p.both(fn)
    npop = np.add if op == "SUM" else np.maximum
    expected = datas[0]
    for r in range(1, world_size):
        expected = npop(expected, datas[r])
    for r in range(world_size):
        np.testing.assert_allclose(got[r], expected, rtol=1e-12)
        np.testing.assert_array_equal(datas[r], orig[r])
        assert datas[r].flags.writeable
        assert p.port.world(r).rungs[(r, "allreduce")] == "ring"


@pytest.mark.parametrize("world_size", [2, 3, 4])
def test_reduce_scatter_and_allgather_ring(one_host, world_size):
    p = one_host(world_size)
    k = 97
    datas = {r: per_rank_data(r, world_size * k) for r in range(world_size)}
    ag = {r: per_rank_data(100 + r, k) for r in range(world_size)}

    def fn(world, rank, pk):
        rs = world.reduce_scatter(rank, datas[rank], pk.MpiOp.SUM)
        out = world.allgather(rank, ag[rank])
        return rs, out, rs.flags.writeable and out.flags.writeable

    got = p.both(fn)
    total = sum(datas.values())
    for r in range(world_size):
        np.testing.assert_allclose(got[r][0], total[r * k:(r + 1) * k],
                                   rtol=1e-12)
        np.testing.assert_array_equal(
            got[r][1], np.concatenate([ag[q] for q in range(world_size)]))
        assert got[r][2]


# ---------------------------------------------------------------------------
# Topology and the hierarchical compositions
# ---------------------------------------------------------------------------

def test_world_topology_object_and_locality_helpers(pair):
    for cluster in (pair.ref, pair.port):
        world = cluster.world(0)
        t = world.topology()
        assert t.hosts == ("mpiA", "mpiB") and t.leaders == (0, 3)
        assert t.hierarchical and t.hosts_contiguous()
        assert world.topology() is t
        assert world.ranks_on_host("mpiB") == [3, 4, 5]
        assert world.local_leader("mpiB") == 3
        assert world.hosts() == ["mpiA", "mpiB"]
        assert world.device_for_rank(5) == 5
    assert pair.port.world(0).topology().to_dict() == \
        pair.ref.world(0).topology().to_dict()


def _force_hier(pair, enabled):
    pair.set(hier_enabled="force" if enabled else False,
             CHUNK_BYTES=64 * 1024)


@pytest.mark.parametrize("collective", ["allreduce", "reduce_scatter",
                                        "allgather"])
def test_hier_bitwise_matches_flat(pair, collective):
    """The composed paths (intra-host reduce-scatter, leader ring,
    redistribution) against the flat ones, bit for bit on int64."""
    rng = np.random.default_rng(11)
    n = 30_000 if collective == "allgather" else 120_000
    datas = {r: rng.integers(-9999, 9999, n).astype(np.int64)
             for r in range(6)}

    def fn(world, rank, pk):
        if collective == "allgather":
            return world.allgather(rank, datas[rank].copy())
        return getattr(world, collective)(rank, datas[rank].copy(),
                                          pk.MpiOp.SUM)

    _force_hier(pair, False)
    flat = pair.both(fn)
    _force_hier(pair, True)
    hier = pair.both(fn)
    total = sum(datas.values())
    want = {"allreduce": lambda r: total,
            "reduce_scatter": lambda r: total[r * 20_000:(r + 1) * 20_000],
            "allgather": lambda r: np.concatenate(
                [datas[q] for q in range(6)])}[collective]
    for r in range(6):
        np.testing.assert_array_equal(hier[r], flat[r])
        np.testing.assert_array_equal(hier[r], want(r))
        assert hier[r].flags.writeable
        assert pair.port.world(r).rungs[(r, collective)] == "hier"


def test_hier_fallbacks_stay_flat(pair):
    """Knob off, a payload under two chunks, a non-commuting op and a
    plain True on one machine keep the flat paths; a commuting op that
    promotes its dtype still composes."""
    data = np.full(200_000, 1, dtype=np.int64)

    def algos(fn):
        pair.both(fn)
        return {pair.port.world(r).rungs[(r, "allreduce")]
                for r in range(6)}

    _force_hier(pair, False)
    assert "hier" not in algos(
        lambda w, r, pk: w.allreduce(r, data.copy(), pk.MpiOp.SUM))
    _force_hier(pair, True)
    small = np.full(64, 1, dtype=np.int64)
    assert algos(lambda w, r, pk: w.allreduce(r, small.copy(),
                                              pk.MpiOp.SUM)) == {"tree"}
    assert "hier" not in algos(lambda w, r, pk: w.allreduce(
        r, data.copy(), pk.UserOp(lambda a, b: a + b, commute=False)))
    assert algos(lambda w, r, pk: w.allreduce(r, data.copy(), pk.UserOp(
        lambda a, b: (a + b).astype(np.float64)))) == {"hier"}
    pair.set(hier_enabled=True)
    assert algos(lambda w, r, pk: w.allreduce(r, data.copy(),
                                              pk.MpiOp.SUM)) == {"ring"}


@pytest.mark.parametrize("primary_is_ours", [True, False])
def test_host_under_the_primary_address_is_this_machine(monkeypatch,
                                                         primary_is_ours):
    """A host registered under this machine's primary interface address
    is this machine in both packages, so a large allreduce takes the ring
    as on loopback; where ``OVERRIDE_HOST_IP`` names another address, the
    same host is another machine and the allreduce composes over hosts.
    (The override also keeps the reference off its route lookup towards
    a public address.)"""
    from faabric_tpu_torch.util.network import (
        get_primary_ip_for_this_host,
        is_local_ip,
    )

    monkeypatch.delenv("OVERRIDE_HOST_IP", raising=False)
    primary = get_primary_ip_for_this_host()
    if primary.startswith("127."):
        pytest.skip("this machine has no interface besides loopback")
    assert is_local_ip(primary) and not is_local_ip("198.51.100.7")
    monkeypatch.setenv("OVERRIDE_HOST_IP",
                       primary if primary_is_ours else "198.51.100.7")
    p = Pair(TWO_HOSTS, group=GROUP + 11, ips={"mpiB": primary})
    try:
        for cluster in (p.ref, p.port):
            w = cluster.world(0)
            assert w._all_hosts_same_machine() is primary_is_ours
            assert w._hier_wins() is not primary_is_ours
        p.set(CHUNK_BYTES=64 * 1024)
        n = 200_000
        datas = {r: np.random.default_rng(r).integers(-999, 999, n)
                 for r in range(6)}

        def fn(world, rank, pk):
            return world.allreduce(rank, datas[rank].copy(), pk.MpiOp.SUM)

        got = p.both(fn)
        total = sum(datas.values())
        for r in range(6):
            np.testing.assert_array_equal(got[r], total)
            assert p.port.world(r).rungs[(r, "allreduce")] == (
                "ring" if primary_is_ours else "hier")
    finally:
        p.close()


def test_hier_reduce_scatter_scattered_placement(scattered):
    topo = scattered.port.world(0).topology()
    assert topo.hierarchical and not topo.hosts_contiguous()
    rng = np.random.default_rng(21)
    datas = {r: rng.integers(-9999, 9999, 120_000).astype(np.int64)
             for r in range(6)}

    def fn(world, rank, pk):
        return world.reduce_scatter(rank, datas[rank].copy(), pk.MpiOp.SUM)

    _force_hier(scattered, False)
    flat = scattered.both(fn)
    _force_hier(scattered, True)
    hier = scattered.both(fn)
    total = sum(datas.values())
    for r in range(6):
        np.testing.assert_array_equal(hier[r], flat[r])
        np.testing.assert_array_equal(hier[r],
                                      total[r * 20_000:(r + 1) * 20_000])
        assert scattered.port.world(r).rungs[(r, "reduce_scatter")] == "hier"


# ---------------------------------------------------------------------------
# Communicators and the Cartesian topology
# ---------------------------------------------------------------------------

def test_cartesian_topology_and_user_dims(pair):
    def fn(world, rank, pk):
        if rank != 0:
            return None
        default = [world.cart_rank(world.cart_coords(r)) for r in range(6)]
        dims = world.cart_create((3, 2, 1))
        out = (default, dims, world.cart_coords(5),
               world.cart_rank((-1, 0, 0)), world.cart_shift(0, 0, 1))
        with pytest.raises(ValueError, match="do not tile"):
            world.cart_create((4, 2))
        world.cart_create(None)
        return out + (world.cart_dims(), world.cart_shift(4, 1, -1))

    got = pair.both(fn, n=1)[0]
    assert got[0] == list(range(6)) and got[1] == (3, 2, 1)
    assert got[2] == (2, 1, 0) and got[4] == (4, 2) and got[5] == (2, 3)


def test_comm_split_even_odd(pair):
    def fn(world, rank, pk):
        sub, new_rank = world.split(rank, color=rank % 2)
        out = sub.allreduce(new_rank, np.full(4, rank, np.int64),
                            pk.MpiOp.SUM)
        return sub.size, new_rank, int(out[0])

    got = pair.both(fn)
    for r in range(6):
        assert got[r] == (3, r // 2, 6 if r % 2 == 0 else 9)


def test_comm_split_key_reorders_and_undefined_opts_out(pair):
    def fn(world, rank, pk):
        if rank == 5:
            return world.split(rank, color=-1)
        sub, new_rank = world.split(rank, color=7, key=-rank)
        got = None
        if new_rank == 0:
            sub.send(0, 4, np.array([42], np.int64))
        if new_rank == 4:
            got = sub.recv(0, 4)[0]
        sub.barrier(new_rank)
        return sub.size, new_rank, got

    got = pair.both(fn)
    assert got[5] == (None, -1)
    for r in range(5):
        assert got[r][:2] == (5, 4 - r)
    assert got[0][2].tolist() == [42]


def test_comm_dup_is_isolated(pair):
    def fn(world, rank, pk):
        dup, dr = world.dup(rank)
        out = None
        if rank == 0:
            dup.send(0, 4, np.array([111], np.int64))
            world.send(0, 4, np.array([222], np.int64))
        if rank == 4:
            out = (world.recv(0, 4)[0], dup.recv(0, 4)[0])
        world.barrier(rank)
        return dup.size, dr, out

    got = pair.both(fn)
    assert got[4][2][0].tolist() == [222] and got[4][2][1].tolist() == [111]


def test_comm_create_group(pair):
    members = [1, 3, 4]

    def fn(world, rank, pk):
        sub, new_rank = world.create_group_comm(rank, members)
        if sub is None:
            return None, new_rank
        return (sub.allreduce(new_rank, np.full(2, rank, np.int64),
                              pk.MpiOp.SUM), new_rank)

    got = pair.both(fn)
    for r in members:
        assert got[r][1] == members.index(r) and got[r][0][0] == sum(members)


def test_comm_split_type_shared(pair):
    def fn(world, rank, pk):
        sub, new_rank = world.split_type_shared(rank)
        return sub.size, new_rank, int(sub.allreduce(
            new_rank, np.array([rank], np.int64), pk.MpiOp.SUM)[0])

    got = pair.both(fn)
    for r in range(6):
        assert got[r] == (3, r % 3, 3 if r < 3 else 12)


def test_comm_create_collective_over_all(pair):
    group = [4, 0, 2]

    def fn(world, rank, pk):
        color = 0 if rank in group else -1
        key = group.index(rank) if rank in group else 0
        sub, new_rank = world.split(rank, color, key)
        if sub is None:
            return None
        return new_rank, int(sub.allreduce(
            new_rank, np.array([rank], np.int64), pk.MpiOp.SUM)[0])

    got = pair.both(fn)
    for r in group:
        assert got[r] == (group.index(r), 6)


# ---------------------------------------------------------------------------
# The schedule compiler's callers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.int16])
def test_alltoall_sched_bitwise_vs_direct(pair, dtype):
    rng = np.random.RandomState(7)
    mats = {r: (rng.rand(6 * 5) * 100).astype(dtype) for r in range(6)}

    def fn(world, rank, pk):
        return world.alltoall(rank, mats[rank])

    out = {}
    for mode in (False, "force"):
        pair.set(sched_enabled=mode)
        out[mode] = pair.both(fn)
    for r in range(6):
        want = np.concatenate([mats[s].reshape(6, 5)[r] for s in range(6)])
        np.testing.assert_array_equal(out[False][r], want)
        np.testing.assert_array_equal(out["force"][r], want)
    assert pair.port.world(0).rungs[(0, "alltoall")] == "sched:hier"


def test_alltoall_sched_scattered_placement(scattered):
    mats = {r: np.arange(18, dtype=np.int64) + 1000 * r for r in range(6)}
    scattered.set(sched_enabled="force")

    def fn(world, rank, pk):
        return world.alltoall(rank, mats[rank])

    got = scattered.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(got[r], np.concatenate(
            [mats[s].reshape(6, 3)[r] for s in range(6)]))


@pytest.mark.parametrize("dtype", [np.float64, np.int16])
def test_scatterv_sched_tree_bitwise_vs_direct(pair, dtype):
    counts = [r + 1 for r in range(6)]
    flat = (np.arange(sum(counts)) * 3 + 1).astype(dtype)
    root = 2

    def fn(world, rank, pk):
        if rank == root:
            return world.scatterv(root, rank, flat, counts)
        return world.scatterv(root, rank, None, None)

    out = {}
    for mode in (False, "force"):
        pair.set(sched_enabled=mode)
        out[mode] = pair.both(fn)
    offsets = np.cumsum([0] + counts[:-1])
    for r in range(6):
        want = flat[offsets[r]:offsets[r] + counts[r]]
        np.testing.assert_array_equal(out[False][r], want)
        np.testing.assert_array_equal(out["force"][r], want)
        assert out["force"][r].flags.writeable


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_scan_sched_matches_chain_and_numpy(pair, dtype):
    datas = {r: (np.arange(40) % 7 + r).astype(dtype) for r in range(6)}
    prefixes = np.cumsum(np.stack([datas[r] for r in range(6)]), axis=0)

    def fn(world, rank, pk):
        return world.scan(rank, datas[rank], pk.MpiOp.SUM)

    out = {}
    for mode in (False, "force"):
        pair.set(sched_enabled=mode)
        out[mode] = pair.both(fn)
    for r in range(6):
        np.testing.assert_allclose(out["force"][r], prefixes[r], rtol=1e-12)
        np.testing.assert_allclose(out[False][r], prefixes[r], rtol=1e-12)


def test_scan_sched_scattered_placement_uses_chain(scattered):
    datas = {r: np.arange(10, dtype=np.int64) + r for r in range(6)}
    scattered.set(sched_enabled="force")

    def fn(world, rank, pk):
        out = world.scan(rank, datas[rank], pk.MpiOp.SUM)
        key = next(iter(world._sched_cache._entries))
        return out, world._sched_cache.family_of(key)

    got = scattered.both(fn)
    prefixes = np.cumsum(np.stack([datas[r] for r in range(6)]), axis=0)
    for r in range(6):
        assert got[r][1] == "scan.chain"
        np.testing.assert_array_equal(got[r][0], prefixes[r])


def test_scan_user_op_through_scheduler(pair):
    def matprod(a, b):
        return (np.asarray(a).reshape(2, 2)
                @ np.asarray(b).reshape(2, 2)).reshape(-1)

    datas = {r: np.array([1, r + 1, 0, 1], dtype=np.int64) for r in range(6)}

    def fn(world, rank, pk):
        return world.scan(rank, datas[rank], pk.UserOp(matprod,
                                                       commute=False))

    got = pair.both(fn)
    acc = datas[0]
    for r in range(1, 6):
        acc = matprod(acc, datas[r])
        np.testing.assert_array_equal(got[r].reshape(-1), acc)


def test_sched_reduction_lowerings_bitwise_vs_handwritten(pair):
    _force_hier(pair, True)
    rng = np.random.RandomState(3)
    n = 6 * 40_000
    datas = {r: rng.randint(-10_000, 10_000, n).astype(np.int64)
             for r in range(6)}

    def fn(world, rank, pk):
        return (world.allreduce(rank, datas[rank].copy(), pk.MpiOp.SUM),
                world.reduce_scatter(rank, datas[rank].copy(), pk.MpiOp.SUM),
                world.allgather(rank, datas[rank][:60_000].copy()))

    pair.set(sched_enabled=False)
    legacy = pair.both(fn)
    pair.set(sched_enabled="force", sched_reductions=True)
    sched = pair.both(fn)
    total = sum(datas.values())
    for r in range(6):
        assert_same(sched[r], legacy[r], f"rank {r}")
        np.testing.assert_array_equal(sched[r][0], total)
    assert pair.port.world(0).rungs[(0, "allreduce")].startswith("sched:")


def test_sched_cache_recompiles_after_remap(pair):
    mats = {r: np.arange(12, dtype=np.int64) + r for r in range(6)}

    def fn(world, rank, pk):
        return world.alltoall(rank, mats[rank])

    pair.set(sched_enabled="force")
    pair.both(fn)
    for cluster in (pair.ref, pair.port):
        for w in cluster.each_world():
            assert w._sched_cache.compiles == 1
            w.prepare_migration(0)
    got = pair.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(got[r], np.concatenate(
            [mats[s].reshape(6, 2)[r] for s in range(6)]))
    for cluster in (pair.ref, pair.port):
        for w in cluster.each_world():
            assert w._sched_cache.compiles == 2
            assert len({key[0] for key in w._sched_cache._entries}) == 2
            for keys in w._sched_seen.values():
                assert all(k[0] == w._topology_gen for k in keys)


# ---------------------------------------------------------------------------
# The device plane over two hosts
# ---------------------------------------------------------------------------

def test_device_plane_verdict_over_two_hosts_matches_reference(pair):
    """The registration exchange runs over the two-host world; a world
    whose ranks span two hosts of one process is refused by both
    registries (the host split and the process split disagree), and
    the collectives stay on the host ladder."""
    def fn(world, rank, pk):
        device = "cpu" if pk is PORT else None
        active = world.activate_device_plane(rank, device=device)
        out = world.allreduce(rank, np.full(4, rank, np.float32),
                              pk.MpiOp.SUM)
        return active, out

    got = pair.both(fn)
    assert all(got[r][0] is False for r in range(6))
    assert all(pair.port.world(r).device_plane() is None for r in range(6))


# ---------------------------------------------------------------------------
# The environment knobs: both packages read them at import, so each case
# sets one in a subprocess before either package loads and runs the same
# program on both there. No test sets them in this process.
# ---------------------------------------------------------------------------

_KNOB_PROGRAM = r'''
import json, sys, threading, time
import numpy as np
from tests.test_torch_mpi_world import Cluster, REF, PORT, TWO_HOSTS, assert_same
from tests.test_torch_mpi import make_worlds, on_ranks
import faabric_tpu.mpi.world as ref_world
import faabric_tpu_torch.mpi.world as port_world
import faabric_tpu.device_plane.plane as ref_plane
import faabric_tpu_torch.device_plane.plane as port_plane

base, case = int(sys.argv[1]), sys.argv[2]
out = {"knobs": [[getattr(m, k) for m in (ref_world, port_world)] for k in (
    "RING_CHUNK_BYTES", "HIER_COLLECTIVES", "SCHED_COLLECTIVES",
    "DEVICE_PLANE_ENABLED")] + [[ref_plane.DEVICE_PLANE_TIMEOUT_S,
                                 port_plane.DEVICE_PLANE_TIMEOUT_S]]}


def release_ports():
    """Close the sockets the parent held on this slot's point-to-point
    ports while this interpreter started (see ``_run_knob_case``)."""
    import os

    for fd in filter(None, os.environ.pop("KNOB_HELD_FDS", "").split(",")):
        os.close(int(fd))


def both_clusters(fn, record=False):
    """fn on a 3 + 3 world of each package; results must agree bit for
    bit. Returns the port's cluster after the run."""
    release_ports()
    ref = Cluster(REF, [base, base + 1000], TWO_HOSTS, 4300)
    port = Cluster(PORT, [base + 2000, base + 2500], TWO_HOSTS, 4300)
    try:
        for c in (ref, port):
            c.set(record_exec_graph=record)
        want, got = ref.run(fn), port.run(fn)
        for r in want:
            assert_same(got[r], want[r], f"rank {r}")
        w = port.world(0)
        out["attrs"] = [[c.world(0).hier_enabled, c.world(0).sched_enabled]
                        for c in (ref, port)]
        out["rungs"] = sorted({str(v) for v in
                               (port.world(r).rungs.get((r, case_kind))
                                for r in range(6))})
        if record:
            out["graphs"] = [[c.world(r).exec_graph_details()
                              for r in range(6)] for c in (ref, port)]
    finally:
        ref.close()
        port.close()


def data(rank, n, dtype):
    return np.random.RandomState(rank).uniform(0.5, 1.5, n).astype(dtype)


if case in ("hier", "ring"):
    case_kind = "allreduce"
    n, dtype = ((3_000_000, np.float32) if case == "hier"
                else (1_200_000, np.float64))
    both_clusters(lambda w, r, pk: w.allreduce(r, data(r, n, dtype),
                                               pk.MpiOp.SUM),
                  record=case == "ring")
elif case == "sched":
    case_kind = "alltoall"
    both_clusters(lambda w, r, pk: w.alltoall(
        r, np.arange(r * 600, r * 600 + 600, dtype=np.int64)))
elif case == "plane":
    ref, port = make_worlds(960)
    out["active"] = [sorted({bool(v) for v in on_ranks(
        w, lambda w, r, d=d: w.activate_device_plane(r, **d)).values()})
        for w, d in ((ref, {}), (port, {"device": "cpu"}))]
    want, got = (on_ranks(w, lambda w, r: w.allreduce(
        r, np.full(64, r + 1, np.int32), pk.MpiOp.SUM))
        for w, pk in ((ref, REF), (port, PORT)))
    for r in want:
        assert_same(got[r], want[r], f"rank {r}")
    # One rank arrives after the others' rendezvous window closed: each
    # plane disables itself and the ranks meet on the host ladder
    def late(w, r, pk):
        if r == 3:
            time.sleep(1.0)
        return w.allreduce(r, np.full(64, r + 1, np.int32), pk.MpiOp.SUM)
    if all(out["active"][i] == [True] for i in range(2)):
        plane_objs = [w.device_plane() for w in (ref, port)]
        want, got = (on_ranks(w, lambda w, r, pk=pk: late(w, r, pk))
                     for w, pk in ((ref, REF), (port, PORT)))
        for r in want:
            assert_same(got[r], want[r], f"rank {r}")
        out["disabled"] = [(p.disabled_reason or "").split(":")[0]
                           for p in plane_objs]
    ref.broker.clear()
    port.broker.clear()
print("RESULT " + json.dumps(out))
'''


def _run_knob_case(env: dict, case: str, timeout: float = 240.0) -> dict:
    """The knob program in a fresh interpreter, ``env`` over ours.

    The interpreter takes seconds to import both packages before it
    binds its slot's ports, and another xdist worker could take the slot
    meanwhile. So the slot's point-to-point ports are held by listening
    sockets from here on, and the program closes its inherited copies
    just before its servers bind them."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tests.conftest import next_port_base
    from tests.test_torch_mpi import _hold_ports

    root = Path(__file__).resolve().parents[1]
    for _ in range(20):
        base = next_port_base()
        held = _hold_ports(
            (base + off + p for off in (0, 1000, 2000, 2500)
             for p in (port_common.POINT_TO_POINT_ASYNC_PORT,
                       port_common.POINT_TO_POINT_SYNC_PORT)), listen=True)
        if held:
            break
    assert held, "no port slot with its point-to-point ports free"
    fds = [s.fileno() for s in held]
    try:
        child = subprocess.Popen(
            [sys.executable, "-c", _KNOB_PROGRAM, str(base), case],
            cwd=root, env={**os.environ, **env,
                           "KNOB_HELD_FDS": ",".join(map(str, fds))},
            pass_fds=fds, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    finally:
        # The child holds its own copies now
        for s in held:
            s.close()
    try:
        stdout, stderr = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise
    proc = subprocess.CompletedProcess(child.args, child.returncode, stdout,
                                       stderr)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[-1][len("RESULT "):])


def _knob(out: dict, index: int):
    ref, port = out["knobs"][index]
    assert ref == port, (index, ref, port)
    return port


def test_hier_collectives_force_is_read_by_both_packages():
    """``FAABRIC_HIER_COLLECTIVES=force``: over two loopback hosts both
    worlds compose hierarchically, and an allreduce SUM of 3,000,000
    float32 a rank (uniform(0.5, 1.5) from RandomState(rank)) agrees bit
    for bit on every rank; the port's rung is "hier" on all six."""
    out = _run_knob_case({"FAABRIC_HIER_COLLECTIVES": "force"}, "hier")
    assert _knob(out, 1) == "force"
    assert out["attrs"] == [["force", True]] * 2
    assert out["rungs"] == ["hier"]


@pytest.mark.parametrize("value,attr", [("0", False), ("off", False)])
def test_hier_collectives_off_keeps_both_flat(value, attr):
    out = _run_knob_case({"FAABRIC_HIER_COLLECTIVES": value}, "hier")
    assert _knob(out, 1) is attr
    assert out["attrs"] == [[attr, True]] * 2
    assert out["rungs"] == ["ring"]


@pytest.mark.parametrize("value,attr,rung", [
    ("0", False, "direct"), ("force", "force", "sched:")])
def test_sched_collectives_knob_picks_the_same_path(value, attr, rung):
    """``FAABRIC_SCHED_COLLECTIVES``: off runs alltoall as the direct
    loop, force as a verified schedule, on both; results agree."""
    out = _run_knob_case({"FAABRIC_SCHED_COLLECTIVES": value}, "sched")
    assert _knob(out, 2) == attr
    assert out["attrs"] == [[True, attr]] * 2
    assert len(out["rungs"]) == 1 and out["rungs"][0].startswith(rung)


def test_ring_chunk_bytes_splits_the_ring_alike():
    """``FAABRIC_RING_CHUNK_BYTES``: the flat ring of a 9,600,000-byte
    contribution sends the same messages to each rank in both packages
    (exec-graph counts), and other counts than at the 2 MiB default."""
    small = _run_knob_case({"FAABRIC_RING_CHUNK_BYTES": "65536"}, "ring")
    assert _knob(small, 0) == 65536
    assert small["rungs"] == ["ring"]
    ref_graphs, port_graphs = small["graphs"]
    assert port_graphs == ref_graphs
    default = _run_knob_case({}, "ring")
    assert _knob(default, 0) == 2 * 1024 * 1024
    assert default["graphs"][0] == default["graphs"][1]
    assert default["graphs"][1] != port_graphs


def test_device_plane_knob_refuses_activation_on_both():
    """``FAABRIC_DEVICE_PLANE=0``: every rank's activation returns False
    on both packages, and the allreduce runs on the host ladder."""
    out = _run_knob_case({"FAABRIC_DEVICE_PLANE": "0"}, "plane")
    assert _knob(out, 3) is False
    assert out["active"] == [[False], [False]]
    assert "disabled" not in out


def test_device_plane_timeout_knob_gives_the_same_verdict():
    """``FAABRIC_DEVICE_PLANE_TIMEOUT=0.2``: a rank that comes a second
    late finds both planes disabled by a rendezvous timeout, and the
    ranks agree on the host ladder."""
    out = _run_knob_case({"FAABRIC_DEVICE_PLANE_TIMEOUT": "0.2"}, "plane")
    assert _knob(out, 4) == 0.2
    assert _knob(out, 3) is True
    assert out["active"] == [[True], [True]]
    assert out["disabled"] == ["rendezvous timeout"] * 2
