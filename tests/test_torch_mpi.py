"""The port's MPI layer against the JAX package's, on the same inputs.

Schedules (lowerings, verifier verdicts, family choice), the topology,
the reduce ops and a 4-rank world's host ladder: send/recv, barrier,
abort, the selection-sync round and the tree and ring collectives. The
inputs are numpy arrays from a seed; both worlds are threads of this
process over their own brokers. The device plane is
``test_torch_device_plane.py``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from faabric_tpu.batch_scheduler.decision import (  # noqa: E402
    SchedulingDecision as RefDecision,
)
from faabric_tpu.mpi import MpiWorld as RefWorld  # noqa: E402
from faabric_tpu.mpi import schedule as ref_schedule  # noqa: E402
from faabric_tpu.mpi import schedule_compile as ref_compile  # noqa: E402
from faabric_tpu.mpi import topology as ref_topology  # noqa: E402
from faabric_tpu.mpi.topology import Topology as RefTopology  # noqa: E402
from faabric_tpu.mpi.topology import interleave_hosts  # noqa: E402
from faabric_tpu.mpi.types import MpiOp as RefOp  # noqa: E402
from faabric_tpu.mpi.types import UserOp as RefUserOp  # noqa: E402
from faabric_tpu.mpi.types import apply_op as ref_apply_op  # noqa: E402
from faabric_tpu.transport.point_to_point import (  # noqa: E402
    PointToPointBroker as RefBroker,
)

from faabric_tpu_torch.batch_scheduler import SchedulingDecision  # noqa: E402
from faabric_tpu_torch.mpi import (  # noqa: E402
    MpiOp,
    MpiWorld,
    MpiWorldAborted,
    UserOp,
    apply_op,
)
from faabric_tpu_torch.mpi import schedule as port_schedule  # noqa: E402
from faabric_tpu_torch.mpi import schedule_compile as port_compile  # noqa: E402
from faabric_tpu_torch.mpi import topology as port_topology  # noqa: E402
from faabric_tpu_torch.mpi.topology import Topology  # noqa: E402
from faabric_tpu_torch.transport import PointToPointBroker  # noqa: E402

N = 4

# The reference selftest's topology matrix (schedule_compile.selftest)
SHAPES = {
    "1x4": {r: "h0" for r in range(4)},
    "2x1": {0: "h0", 1: "h1"},
    "2x3-gang": {r: f"h{r // 3}" for r in range(6)},
    "4x3-scattered": interleave_hosts([f"h{i}" for i in range(4)], 12),
    "uneven-3-2-1": {0: "h0", 1: "h0", 2: "h0", 3: "h1", 4: "h1", 5: "h2"},
    "2x2-scattered": interleave_hosts(["h0", "h1"], 4),
    "4x1": {r: f"h{r}" for r in range(4)},
}


def run_threads_results(fns, timeout=60.0):
    from tests.conftest import run_threads

    results = {}

    def runner(i, fn):
        def run():
            results[i] = fn()
        return run

    run_threads([runner(i, fn) for i, fn in enumerate(fns)],
                timeout=timeout)
    return results


def make_worlds(app_id, n=N):
    """A 4-rank single-host world of each package, devices 0..n-1."""
    ref_broker, broker = RefBroker("mpi"), PointToPointBroker("mpi")
    ref_d = RefDecision(app_id=app_id, group_id=app_id)
    d = SchedulingDecision(app_id=app_id, group_id=app_id)
    for r in range(n):
        ref_d.add_message("mpi", app_id * 10 + r, r, r, device_id=r)
        d.add_message("mpi", app_id * 10 + r, r, r, device_id=r)
    ref_broker.set_up_local_mappings_from_decision(ref_d)
    broker.set_up_local_mappings_from_decision(d)
    ref, port = RefWorld(ref_broker, app_id, n, app_id), \
        MpiWorld(broker, app_id, n, app_id)
    ref.refresh_rank_hosts()
    port.refresh_rank_hosts()
    return ref, port


@pytest.fixture
def worlds():
    ref, port = make_worlds(930)
    yield ref, port
    ref.broker.clear()
    port.broker.clear()


def on_ranks(world, fn, n=N):
    return run_threads_results([lambda r=r: fn(world, r) for r in range(n)])


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _steps_of(sched):
    return {r: [(st.op, st.peer, st.keys, st.syms, st.dst, st.a, st.b,
                 st.src, st.phase) for st in steps]
            for r, steps in sched.steps.items()}


def _compile_both(family, coll, rank_hosts, root):
    """(reference schedule or its error, port schedule or its error)."""
    out = []
    for mod, topo_cls in ((ref_compile, RefTopology),
                          (port_compile, Topology)):
        try:
            out.append(mod.compile_schedule(family, coll,
                                            topo_cls(rank_hosts), root=root))
        except mod.ScheduleError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", ref_compile.FAMILIES)
def test_compile_schedule_matches_reference(shape, family):
    assert port_compile.FAMILIES == ref_compile.FAMILIES
    rank_hosts = SHAPES[shape]
    colls = (["scatter", "scatterv"] if family.startswith("scatter.")
             else [family.split(".")[0]])
    roots = (sorted({0, len(rank_hosts) - 1})
             if family.startswith("scatter.") else [0])
    for coll in colls:
        for root in roots:
            ref, port = _compile_both(family, coll, rank_hosts, root)
            if isinstance(ref, Exception):
                assert isinstance(port, Exception), (family, coll, root)
                assert str(port) == str(ref)
                continue
            assert port.verified and port.name == ref.name
            assert port.collective == ref.collective
            assert port.size == ref.size and port.spec == ref.spec
            assert _steps_of(port) == _steps_of(ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_topology_matches_reference(shape):
    devices = {r: r % 2 for r in SHAPES[shape]}
    ref = RefTopology(SHAPES[shape], rank_devices=devices)
    port = Topology(SHAPES[shape], rank_devices=devices)
    assert port.to_dict() == ref.to_dict() and repr(port) == repr(ref)
    assert port == Topology.from_rank_hosts(SHAPES[shape])
    for name in ("hosts_contiguous", "mesh_contiguous", "cross_host_pairs"):
        assert getattr(port, name)() == getattr(ref, name)(), name
    for name in ("n_hosts", "single_host", "one_rank_per_host",
                 "hierarchical"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("leader_of", "is_leader", "local_rank", "device_of"):
        assert [getattr(port, name)(r) for r in range(port.size)] \
            == [getattr(ref, name)(r) for r in range(ref.size)], name
    for host in ref.hosts:
        assert port.devices_on_host(host) == ref.devices_on_host(host)
    assert port_topology.leader_ring(port) == ref_topology.leader_ring(ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", [True, "force"])
def test_choose_family_matches_reference(shape, mode):
    """Both packages read measured links from their perf stores; given
    empty stores and comm matrices (every link unmeasured) they pick the
    same families."""
    from faabric_tpu.telemetry.commmatrix import CommMatrix
    from faabric_tpu.telemetry.perfprofile import PerfProfileStore

    from faabric_tpu_torch.telemetry.commmatrix import (
        CommMatrix as PortMatrix,
    )
    from faabric_tpu_torch.telemetry.perfprofile import (
        PerfProfileStore as PortStore,
    )

    for coll in ("alltoall", "scatter", "scatterv", "scan", "allreduce",
                 "reduce_scatter", "allgather"):
        ref = ref_compile.choose_family(
            coll, RefTopology(SHAPES[shape]), 1 << 20, mode,
            store=PerfProfileStore(), matrix=CommMatrix())
        port = port_compile.choose_family(
            coll, Topology(SHAPES[shape]), 1 << 20, mode,
            store=PortStore(), matrix=PortMatrix())
        assert port == ref, (shape, coll)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("gibs", [None, 0.2, 1.99, 2.0, 40.0])
@pytest.mark.parametrize("mode", [True, "force"])
def test_choose_family_matches_reference_from_same_store(shape, gibs,
                                                         mode):
    """Both packages' stores observe the same big frames toward every
    host at ``gibs`` GiB/s: the families and the worst measured rate
    agree, and a fast link flips the composed families to flat."""
    from faabric_tpu.telemetry.commmatrix import CommMatrix
    from faabric_tpu.telemetry.perfprofile import PerfProfileStore

    from faabric_tpu_torch.telemetry.commmatrix import (
        CommMatrix as PortMatrix,
    )
    from faabric_tpu_torch.telemetry.perfprofile import (
        PerfProfileStore as PortStore,
    )

    ref_store, port_store = PerfProfileStore(), PortStore()
    hosts = sorted(set(SHAPES[shape].values()))
    if gibs is not None:
        nbytes = 8 << 20
        for store in (ref_store, port_store):
            for host in hosts:
                for _ in range(3):
                    store.observe(host, "bulk-tcp", nbytes,
                                  nbytes / (gibs * (1 << 30)))
    ref_topo, port_topo = RefTopology(SHAPES[shape]), Topology(SHAPES[shape])
    assert port_compile.measured_cross_gibs(
        port_topo, port_topo.host_of(0), store=port_store,
        matrix=PortMatrix()) == ref_compile.measured_cross_gibs(
        ref_topo, ref_topo.host_of(0), store=ref_store, matrix=CommMatrix())
    for coll in ("alltoall", "scatter", "scatterv", "scan", "allreduce",
                 "reduce_scatter", "allgather"):
        ref = ref_compile.choose_family(coll, ref_topo, 1 << 20, mode,
                                        store=ref_store, matrix=CommMatrix())
        port = port_compile.choose_family(coll, port_topo, 1 << 20, mode,
                                          store=port_store,
                                          matrix=PortMatrix())
        assert port == ref, (shape, coll)
    if gibs == 40.0 and mode is True and len(hosts) > 1:
        assert port_compile.choose_family(
            "alltoall", port_topo, 1 << 20, mode, store=port_store,
            matrix=PortMatrix()) == "alltoall.flat"


class _StubStore:
    def __init__(self, gibs):
        self.gibs = gibs
        self.calls = []

    def link_gibs(self, dst, plane=None, min_bytes=0):
        self.calls.append((dst, plane, min_bytes))
        return self.gibs


class _EmptyMatrix:
    def snapshot(self):
        return {}


def test_selection_reads_link_gibs_and_flips_on_bandwidth():
    """The reference's selection cases, on the port's compiler."""
    topo = Topology(SHAPES["4x3-scattered"])
    fast = _StubStore(port_compile.FAST_LINK_GIBS * 4)
    assert port_compile.choose_family(
        "alltoall", topo, 1 << 20, True, store=fast,
        matrix=_EmptyMatrix()) == "alltoall.flat"
    # one query per remote host of the topology
    assert len(fast.calls) == 3
    assert all(plane == "bulk-tcp" for _, plane, _ in fast.calls)
    slow = _StubStore(port_compile.FAST_LINK_GIBS / 10)
    assert port_compile.choose_family(
        "alltoall", topo, 1 << 20, True, store=slow,
        matrix=_EmptyMatrix()) == "alltoall.hier"
    assert port_compile.choose_family(
        "alltoall", topo, 1 << 20, True, store=_StubStore(None),
        matrix=_EmptyMatrix()) == "alltoall.hier"


def test_selection_default_path_reads_the_global_perf_store(monkeypatch):
    import faabric_tpu_torch.telemetry.perfprofile as perfprofile

    stub = _StubStore(port_compile.FAST_LINK_GIBS * 4)
    monkeypatch.setattr(perfprofile, "get_perf_store", lambda: stub)
    assert port_compile.choose_family(
        "alltoall", Topology(SHAPES["2x3-gang"]), 1 << 20, True,
        matrix=_EmptyMatrix()) == "alltoall.flat"
    assert stub.calls, "selection never read get_perf_store().link_gibs"


def test_selection_survives_metrics_off_null_store():
    from faabric_tpu_torch.telemetry.perfprofile import NULL_PERF_STORE

    assert port_compile.choose_family(
        "alltoall", Topology(SHAPES["2x3-gang"]), 1 << 20, True,
        store=NULL_PERF_STORE, matrix=_EmptyMatrix()) == "alltoall.hier"


def test_selection_comm_matrix_fallback():
    class _Matrix:
        def snapshot(self):
            # 1 GiB in 0.1 s toward rank 3 (on h1): a 10 GiB/s link
            return {"cells": [{
                "src": "0", "dst": "3", "plane": "bulk-tcp",
                "bytes": 1 << 30, "bytes_raw": 1 << 30, "lat_sum": 0.1,
            }]}

    topo = Topology(SHAPES["2x3-gang"])
    assert port_compile.measured_cross_gibs(
        topo, "h0", store=_StubStore(None), matrix=_Matrix()) == \
        pytest.approx(10.0, rel=0.01)
    assert port_compile.choose_family(
        "alltoall", topo, 1 << 20, True, store=_StubStore(None),
        matrix=_Matrix()) == "alltoall.flat"


def _pingpong(mod):
    Step = mod.Step
    steps = {
        0: (Step("send", peer=1, keys=(("in", 0),), syms=(("blk", 0),)),
            Step("copy", dst=("out", 0), src=("in", 0)),
            Step("recv", peer=1, keys=(("out", 1),), syms=(("blk", 1),))),
        1: (Step("send", peer=0, keys=(("in", 0),), syms=(("blk", 1),)),
            Step("copy", dst=("out", 1), src=("in", 0)),
            Step("recv", peer=0, keys=(("out", 0),), syms=(("blk", 0),))),
    }
    return mod.Schedule(name="test.allgather", collective="allgather",
                        size=2, steps=steps)


def _corrupt(mod, how):
    """The corrupted schedules of the reference's tests/unit/
    test_schedule.py, built from ``mod``'s classes."""
    Step, Schedule = mod.Step, mod.Schedule
    if how == "missing_element":
        s = _pingpong(mod)
        s.steps[1] = tuple(x for x in s.steps[1] if x.op != "send")
        return s
    if how == "double_delivery":
        s = _pingpong(mod)
        s.steps[0] = s.steps[0] + (Step("copy", dst=("out", 0),
                                        src=("in", 0)),)
        return s
    if how == "double_counted_fold":
        return Schedule(name="test.scan", collective="scan", size=1, steps={
            0: (Step("copy", dst=("tmp", "a"), src=("in", 0)),
                Step("fold", dst=("out", 0), a=("tmp", "a"),
                     b=("in", 0)))})
    if how == "framing":
        s = _pingpong(mod)
        s.steps[0] = s.steps[0][:2] + (
            Step("recv", peer=1, keys=(("out", 1),), syms=(("blk", 9),)),)
        return s
    if how == "deadlock":
        return Schedule(name="test.allgather", collective="allgather",
                        size=2, steps={
            0: (Step("recv", peer=1, keys=(("out", 1),),
                     syms=(("blk", 1),)),
                Step("copy", dst=("out", 0), src=("in", 0))),
            1: (Step("recv", peer=0, keys=(("out", 0),),
                     syms=(("blk", 0),)),
                Step("copy", dst=("out", 1), src=("in", 0)))})
    if how == "undelivered":
        s = _pingpong(mod)
        s.steps[0] = (s.steps[0][0],) + s.steps[0]
        return s
    if how == "corrupted_compiled":
        compiled = {ref_schedule: ref_compile,
                    port_schedule: port_compile}[mod].compile_schedule(
            "alltoall.hier", "alltoall",
            {ref_schedule: RefTopology, port_schedule: Topology}[mod](
                SHAPES["4x3-scattered"]))
        s = Schedule(name=compiled.name, collective=compiled.collective,
                     size=compiled.size, steps=dict(compiled.steps),
                     spec=dict(compiled.spec))
        s.steps[5] = s.steps[5][:-1]
        return s
    raise AssertionError(how)


@pytest.mark.parametrize("how,match", [
    ("missing_element", None), ("double_delivery", "double delivery"),
    ("double_counted_fold", "double-counts"), ("framing", "framing"),
    ("deadlock", "deadlock"), ("undelivered", "undelivered"),
    ("corrupted_compiled", None)])
def test_verifier_rejects_what_the_reference_rejects(how, match):
    errors = []
    for mod in (ref_schedule, port_schedule):
        with pytest.raises(mod.ScheduleVerificationError,
                           match=match) as e:
            mod.verify_schedule(_corrupt(mod, how))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert port_schedule.verify_schedule(_pingpong(port_schedule)).verified


def test_schedule_cache_compiles_once_and_refuses_unverified(worlds):
    from faabric_tpu_torch.mpi.schedule import (
        ScheduleCache,
        ScheduleError,
    )
    from faabric_tpu_torch.mpi.types import MpiMessageType

    _ref, port = worlds
    cache = ScheduleCache()
    topo = Topology(SHAPES["1x4"])
    calls = []

    def compile_fn():
        calls.append(1)
        return port_compile.compile_schedule("alltoall.flat", "alltoall",
                                             topo)

    a = cache.get_or_compile(("k",), "alltoall.flat", compile_fn)
    b = cache.get_or_compile(("k",), "alltoall.flat", compile_fn)
    assert a is b and len(calls) == 1
    assert cache.stats() == {"entries": 1, "compiles": 1, "hits": 1}
    with pytest.raises(ScheduleError, match="unverified"):
        port._run_schedule(0, _pingpong(port_schedule), {}, None,
                           lambda s, e: 1, MpiMessageType.NORMAL)


# ---------------------------------------------------------------------------
# Reduce ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,dtype", [
    (op, dtype) for op in ("SUM", "MAX", "MIN", "PROD", "BAND", "BOR",
                           "LAND", "LOR")
    for dtype in (np.int32, np.float32, np.int64)
    if not (op in ("BAND", "BOR") and dtype == np.float32)])
def test_apply_op_matches_reference_on_arrays_and_tensors(op, dtype):
    import torch

    rng = np.random.default_rng(3)
    a = rng.integers(-50, 50, 64).astype(dtype)
    b = rng.integers(-50, 50, 64).astype(dtype)
    want = ref_apply_op(RefOp[op], a, b)
    got = apply_op(MpiOp[op], a, b)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_t = apply_op(MpiOp[op], torch.from_numpy(a), torch.from_numpy(b))
    assert got_t.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_user_op_and_minloc_match_reference():
    rng = np.random.default_rng(4)
    a = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    fn = lambda x, y: x * 2 + y  # noqa: E731
    np.testing.assert_array_equal(apply_op(UserOp(fn), a, b),
                                  ref_apply_op(RefUserOp(fn), a, b))
    pairs = np.dtype([("val", "<f8"), ("loc", "<i4")])
    x = np.array([(1.0, 3), (2.0, 1)], dtype=pairs)
    y = np.array([(1.0, 2), (0.5, 4)], dtype=pairs)
    for op in ("MINLOC", "MAXLOC"):
        np.testing.assert_array_equal(apply_op(MpiOp[op], x, y),
                                      ref_apply_op(RefOp[op], x, y))


# ---------------------------------------------------------------------------
# The world's host ladder
# ---------------------------------------------------------------------------

def test_send_recv_barrier_and_abort(worlds):
    _ref, port = worlds
    data = np.arange(12, dtype=np.int32).reshape(3, 4)

    def ranks(w, r):
        arr = None
        if r == 0:
            w.send(0, 1, data)
            data[0, 0] = 99  # MPI: the sender may reuse its buffer
        elif r == 1:
            arr, status = w.recv(0, 1)
            assert arr.flags.writeable and status.count == 12
        w.barrier(r)
        return arr

    out = on_ranks(port, ranks)
    np.testing.assert_array_equal(out[1], np.arange(12).reshape(3, 4))
    assert out[0] is None

    def wait_then_abort(w, r):
        if r == 0:
            with pytest.raises(MpiWorldAborted, match="boom"):
                w.recv(1, 0)
            return True
        if r == 1:
            w.abort("boom")
        return None

    assert on_ranks(port, wait_then_abort)[0]


def _hold_ports(ports, listen: bool = False) -> list:
    """Sockets on every port of ``ports``, or [] when one is taken. No
    other socket can bind a held port: a listening one (bound with
    SO_REUSEADDR, so that connections of the port's last user still in
    TIME_WAIT do not stop it) blocks every bind, and one bound without
    SO_REUSEADDR and not listening blocks them too and refuses every
    connect (but connections in TIME_WAIT stop it from binding)."""
    import socket

    held = []
    for port in ports:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            if listen:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("0.0.0.0", port))
            if listen:
                s.listen(1)
        except OSError:
            s.close()
            for h in held:
                h.close()
            return []
        held.append(s)
    return held


def _refusing_port_pair() -> tuple[int, list]:
    """Two consecutive ports, bound and not listening: a connect to
    either is refused, and no other socket can bind them while held. The
    first is the kernel's choice, from the ephemeral range (above every
    port slot of ``tests/conftest.py``), so no fixture's recent
    connections hold it."""
    import socket

    for _ in range(50):
        first = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        first.bind(("0.0.0.0", 0))
        port = first.getsockname()[1]
        second = _hold_ports([port + 1])
        if second:
            return port, [first, *second]
        first.close()
    raise AssertionError("no two consecutive free ports")


def test_send_to_another_host_raises():
    """A send to a rank on a host that runs no point-to-point server
    raises to the sender at once (the connection is refused); it does
    not hang or vanish. The world watches its group, so the refused
    send aborts it, as the reference's broker does: the sender gets
    MpiWorldAborted naming the host, caused by the transport's
    RpcError."""
    from tests.conftest import next_port_base

    from faabric_tpu_torch.transport import (
        clear_host_aliases,
        register_host_alias,
    )
    from faabric_tpu_torch.transport.client import RpcError
    from faabric_tpu_torch.transport.common import (
        POINT_TO_POINT_ASYNC_PORT,
        POINT_TO_POINT_SYNC_PORT,
    )

    # "No server at hB" must hold across xdist workers too, where another
    # worker's fixture may serve any port slot: hB's point-to-point
    # ports are two held ports outside every slot
    port, held = _refusing_port_pair()
    assert POINT_TO_POINT_SYNC_PORT == POINT_TO_POINT_ASYNC_PORT + 1
    register_host_alias("hA", "127.0.0.1", next_port_base())
    register_host_alias("hB", "127.0.0.1", port - POINT_TO_POINT_ASYNC_PORT)
    broker = PointToPointBroker("hA")
    try:
        d = SchedulingDecision(app_id=931, group_id=931)
        d.add_message("hA", 1, 0, 0)
        d.add_message("hB", 2, 1, 1)
        broker.set_up_local_mappings_from_decision(d)
        world = MpiWorld(broker, 931, 2, 931)
        with pytest.raises(MpiWorldAborted, match="hB") as err:
            world.send(0, 1, np.zeros(4, np.float32))
        assert isinstance(err.value.__cause__, RpcError)
        assert broker.group_aborted(931) == err.value.reason
    finally:
        broker.clear()
        clear_host_aliases()
        for s in held:
            s.close()


def test_send_to_another_host_arrives():
    """A send to a rank on another host crosses to that host's broker
    over the point-to-point server and arrives whole (the two-host suite
    is ``test_torch_mpi_world.py``)."""
    from tests.conftest import next_port_base

    from faabric_tpu_torch.transport import (
        clear_host_aliases,
        register_host_alias,
    )
    from faabric_tpu_torch.transport.ptp_remote import PointToPointServer

    base = next_port_base()
    register_host_alias("hA", "127.0.0.1", base)
    register_host_alias("hB", "127.0.0.1", base + 1000)
    brokers = {h: PointToPointBroker(h) for h in ("hA", "hB")}
    server = PointToPointServer(brokers["hB"])
    server.start()
    try:
        d = SchedulingDecision(app_id=931, group_id=931)
        d.add_message("hA", 1, 0, 0)
        d.add_message("hB", 2, 1, 1)
        for b in brokers.values():
            b.set_up_local_mappings_from_decision(d)
        sender = MpiWorld(brokers["hA"], 931, 2, 931)
        receiver = MpiWorld(brokers["hB"], 931, 2, 931)
        data = np.arange(4, dtype=np.float32)
        sender.send(0, 1, data)
        arr, status = receiver.recv(0, 1, timeout=10.0)
        np.testing.assert_array_equal(arr, data)
        assert arr.flags.writeable and status.count == 4
    finally:
        server.stop()
        for b in brokers.values():
            b.clear()
        clear_host_aliases()


def _collective(name, datas, op=None):
    def fn(w, r):
        if name == "allgather":
            return w.allgather(r, datas[r].copy())
        if op is None:
            return getattr(w, name)(r, datas[r].copy())
        return getattr(w, name)(r, datas[r].copy(), op)
    return fn


@pytest.mark.parametrize("size", [60, 3_000_000])
@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD", "user"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_host_allreduce_matches_reference(worlds, size, op, dtype):
    """Small payloads take the tree, large ones the ring, as in the
    reference: same fold order, so the results agree bit for bit."""
    ref, port = worlds
    rng = np.random.default_rng(size)
    datas = {r: (rng.integers(-100, 100, size) if dtype == np.int32
                 else rng.uniform(0.5, 1.5, size)).astype(dtype)
             for r in range(N)}
    fn = lambda a, b: np.maximum(a, b) - 1  # noqa: E731
    ref_op = RefUserOp(fn) if op == "user" else RefOp[op]
    port_op = UserOp(fn) if op == "user" else MpiOp[op]
    want = on_ranks(ref, _collective("allreduce", datas, ref_op))
    got = on_ranks(port, _collective("allreduce", datas, port_op))
    for r in range(N):
        assert got[r].dtype == want[r].dtype and got[r].flags.writeable
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("size", [64, 2_200_000])
def test_host_allgather_and_reduce_scatter_match_reference(worlds, size):
    ref, port = worlds
    rng = np.random.default_rng(size + 1)
    datas = {r: rng.standard_normal(size).astype(np.float32)
             for r in range(N)}
    for name, op in (("allgather", None), ("reduce_scatter", "SUM")):
        want = on_ranks(ref, _collective(
            name, datas, None if op is None else RefOp[op]))
        got = on_ranks(port, _collective(
            name, datas, None if op is None else MpiOp[op]))
        for r in range(N):
            np.testing.assert_array_equal(got[r], want[r])


def test_selection_sync_round_matches_reference(worlds):
    """_sched_get: rank 0 chooses, the others learn the family from the
    selection broadcast; the port's schedule equals the reference's."""
    ref, port = worlds
    key = dict(collective="alltoall", dtype=np.float32, nbytes=4096)
    want = on_ranks(ref, lambda w, r: w._sched_get(r, **key))
    got = on_ranks(port, lambda w, r: w._sched_get(r, **key))
    again = on_ranks(port, lambda w, r: w._sched_get(r, **key))
    for r in range(N):
        assert got[r][1] == want[r][1] == "alltoall.flat"
        assert _steps_of(got[r][0]) == _steps_of(want[r][0])
        assert again[r][0] is got[r][0]  # no second round, cache hit
    assert port._sched_cache.stats()["compiles"] == 1


def test_run_schedule_alltoall_matches_reference(worlds):
    """The generic runner over a schedule with multi-key sends and
    per-block recvs."""
    from faabric_tpu.mpi.types import MpiMessageType as RefMsg

    from faabric_tpu_torch.mpi.types import MpiMessageType

    ref, port = worlds
    rng = np.random.default_rng(9)
    datas = {r: rng.integers(0, 1000, N * 5).astype(np.int32)
             for r in range(N)}
    topo = SHAPES["1x4"]

    def run(w, r, mod, topo_cls, msg):
        sched = mod.compile_schedule("alltoall.flat", "alltoall",
                                     topo_cls(topo))
        env = {("in", j): datas[r][j * 5:(j + 1) * 5] for j in range(N)}
        w._run_schedule(r, sched, env, None, lambda s, e: 5, msg)
        return np.concatenate([np.asarray(env[("out", j)])
                               for j in range(N)])

    want = on_ranks(ref, lambda w, r: run(w, r, ref_compile, RefTopology,
                                          RefMsg.ALLTOALL))
    got = on_ranks(port, lambda w, r: run(w, r, port_compile, Topology,
                                          MpiMessageType.ALLTOALL))
    for r in range(N):
        np.testing.assert_array_equal(got[r], want[r])


def test_ranks_run_concurrent_collectives_under_a_short_switch_interval(
        worlds):
    """Many small collectives on rank threads with a shortened switch
    interval: a lost update in the queues or the schedule ledger would
    show as a wrong sum or a hang."""
    import sys

    _ref, port = worlds
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def many(w, r):
            return [int(w.allreduce(r, np.array([r + i], np.int64))[0])
                    for i in range(50)]
        out = on_ranks(port, many)
    finally:
        sys.setswitchinterval(old)
    want = [sum(range(N)) + N * i for i in range(50)]
    assert all(out[r] == want for r in range(N))
