"""The port's device plane against the JAX package's, on the same inputs.

4-rank worlds of each package on threads of this process: the JAX
world's plane runs on the conftest's virtual CPU devices, the port's on
``device="cpu"``, where the ring permute takes its kernel's plain
version. Collectives with the plane active and off, ring_permute, the
``allgather.ring`` schedule through the runner, the registry's
verdicts, the copy accounting of resident and host rounds, and the
fallback ladder. Integer results must agree exactly; float32 within
rtol 1e-6, because the two planes may sum in another order.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from faabric_tpu.mpi import MpiOp as RefOp  # noqa: E402
from faabric_tpu.mpi.types import UserOp as RefUserOp  # noqa: E402

from faabric_tpu_torch.batch_scheduler import SchedulingDecision  # noqa: E402
from faabric_tpu_torch.device_plane import (  # noqa: E402
    MeshMismatch,
    device_copy_totals,
    registration_row,
    reset_device_copy_totals,
    resolve_mesh,
)
from faabric_tpu_torch.mpi import MpiOp, MpiWorld, UserOp  # noqa: E402
from faabric_tpu_torch.mpi.types import MpiMessageType  # noqa: E402
from faabric_tpu_torch.transport import PointToPointBroker  # noqa: E402
from tests.test_torch_mpi import N, make_worlds, on_ranks  # noqa: E402

F32_RTOL = 1e-6
# The JAX package's own float16 PROD test (tests/unit/test_device_plane.py)
F16_RTOL = 1e-5


@pytest.fixture
def worlds():
    ref, port = make_worlds(940)
    yield ref, port
    ref.broker.clear()
    port.broker.clear()


def activate(ref, port):
    assert all(on_ranks(ref, lambda w, r: w.activate_device_plane(r)
                        ).values())
    assert all(on_ranks(port, lambda w, r: w.activate_device_plane(
        r, device="cpu")).values())
    return ref.device_plane(), port.device_plane()


def assert_agree(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.dtype(dtype).kind == "f":
        rtol = F16_RTOL if np.dtype(dtype) == np.float16 else F32_RTOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def inputs(kind, dtype, seed, n_elems=N * 64):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        # PROD over 4 ranks stays well inside fp32's range
        return {r: rng.uniform(0.5, 1.5, n_elems).astype(dtype)
                for r in range(N)}
    return {r: rng.integers(-999, 999, n_elems).astype(dtype)
            for r in range(N)}


def call(kind, datas, op, as_tensor):
    def fn(w, r):
        x = datas[r].copy()
        if as_tensor:
            x = torch.from_numpy(x)
        if kind == "allgather":
            return w.allgather(r, x)
        return getattr(w, kind)(r, x, op)
    return fn


# ---------------------------------------------------------------------------
# Collectives: the port's plane and host ladder against the JAX world's
# ---------------------------------------------------------------------------

CASES = [("allreduce", op) for op in ("SUM", "MAX", "MIN", "PROD")] + [
    ("allgather", None), ("reduce_scatter", "SUM")]


# float16 only with the plane active: the JAX world's host ladder has no
# MPI datatype for it
PLANE_DTYPES = [(plane, dtype) for plane in ("active", "off")
                for dtype in (np.int32, np.float32)] + [("active", np.float16)]


@pytest.mark.parametrize("kind,op", CASES)
@pytest.mark.parametrize("plane,dtype", PLANE_DTYPES)
def test_collectives_match_the_jax_world(worlds, kind, op, dtype, plane):
    ref, port = worlds
    if plane == "active":
        activate(ref, port)
    datas = inputs(kind, dtype, seed=len(kind) + (op or "").__len__())
    want = on_ranks(ref, call(kind, datas, op and RefOp[op], False))
    rounds_before = (dict(port.device_plane().summary()["rounds"])
                     if plane == "active" else {})
    for as_tensor in (False, True):
        got = on_ranks(port, call(kind, datas, op and MpiOp[op], as_tensor))
        for r in range(N):
            # Result residency follows the input on the plane; the host
            # ladder always answers in numpy
            assert isinstance(got[r], torch.Tensor) == (
                as_tensor and plane == "active")
            assert_agree(got[r], want[r], dtype)
    if plane == "active":
        rounds = port.device_plane().summary()["rounds"]
        assert rounds[kind] == rounds_before.get(kind, 0) + 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float16_prod_rounds_once_as_the_jax_world(worlds, seed):
    """The JAX plane's PROD multiplies the gathered float16 shards in
    float32 and rounds once (jnp.prod); the port's plane matches it at
    the JAX test's rtol, where folding in float16 step by step missed on
    about a third of the elements by up to 2 ulp."""
    ref, port = worlds
    activate(ref, port)
    rng = np.random.default_rng(seed)
    datas = {r: rng.uniform(0.5, 1.5, 4096).astype(np.float16)
             for r in range(N)}
    want = on_ranks(ref, call("allreduce", datas, RefOp.PROD, False))
    got = on_ranks(port, call("allreduce", datas, MpiOp.PROD, True))
    for r in range(N):
        assert_agree(got[r], want[r], np.float16)


def test_user_op_takes_the_host_ladder_on_both(worlds):
    ref, port = worlds
    activate(ref, port)
    datas = inputs("allreduce", np.int32, 5)
    fn = lambda a, b: np.maximum(a, b) - 1  # noqa: E731
    want = on_ranks(ref, call("allreduce", datas, RefUserOp(fn), False))
    got = on_ranks(port, call("allreduce", datas, UserOp(fn), False))
    for r in range(N):
        assert_agree(got[r], want[r], np.int32)
    assert "allreduce" not in port.device_plane().summary()["rounds"]


@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float16])
def test_ring_permute_matches_the_jax_plane(worlds, shift, dtype):
    ref, port = worlds
    ref_plane, plane = activate(ref, port)
    datas = inputs("ring", dtype, shift)
    want = on_ranks(ref, lambda w, r: ref_plane.ring_permute(
        r, datas[r].copy(), shift))
    dev = {r: torch.from_numpy(datas[r].copy()) for r in range(N)}
    reset_device_copy_totals()
    got = on_ranks(port, lambda w, r: plane.ring_permute(r, dev[r], shift))
    assert device_copy_totals()["count"] == 0
    for r in range(N):
        assert isinstance(got[r], torch.Tensor)
        assert not got[r].data_ptr() == dev[r].data_ptr()
        assert_agree(got[r], want[r], dtype)
        np.testing.assert_array_equal(got[r].numpy(),
                                      datas[(r - shift) % N])
    # host payloads: placed and read back, each counted
    got = on_ranks(port, lambda w, r: plane.ring_permute(
        r, datas[r].copy(), shift))
    tot = device_copy_totals()["by_reason"]
    assert tot["h2d.input"]["count"] == N
    assert tot["d2h.readback"]["count"] == N
    for r in range(N):
        assert isinstance(got[r], np.ndarray)
        assert_agree(got[r], want[r], dtype)
    # shift 0 is the identity, no rendezvous
    assert plane.ring_permute(0, dev[0], 0) is dev[0]


def _run_ring_schedule(world, compile_mod, topo_cls, msg, datas, as_tensor):
    sched = compile_mod.compile_schedule("allgather.ring", "allgather",
                                         topo_cls({r: "mpi"
                                                   for r in range(N)}))
    assert sched.spec["targets"] == {"ring": "device-ring"}
    k = datas[0].size

    def fn(w, r):
        x = datas[r].copy()
        env = {("in", 0): torch.from_numpy(x) if as_tensor else x}
        w._run_schedule(r, sched, env, None, lambda sym, e: k, msg)
        return np.concatenate([np.asarray(env[("out", q)])
                               for q in range(N)])
    return on_ranks(world, fn)


@pytest.mark.parametrize("mode", ["device", "inactive"])
def test_allgather_ring_schedule_matches_the_jax_world(worlds, mode):
    """The annotated ring phase runs on the plane (three ring rounds for
    four ranks) when the plane is active; with no plane the same schedule
    runs its host steps. Both give the JAX world's allgather."""
    from faabric_tpu.mpi import schedule_compile as ref_compile
    from faabric_tpu.mpi.topology import Topology as RefTopology
    from faabric_tpu.mpi.types import MpiMessageType as RefMsg

    from faabric_tpu_torch.mpi import schedule_compile as port_compile
    from faabric_tpu_torch.mpi.topology import Topology

    ref, port = worlds
    if mode == "device":
        activate(ref, port)
    datas = {r: np.arange(32, dtype=np.int32) + 1000 * r for r in range(N)}
    want = _run_ring_schedule(ref, ref_compile, RefTopology, RefMsg.ALLGATHER,
                              datas, False)
    expected = np.concatenate([datas[r] for r in range(N)])
    for as_tensor in (False, True):
        reset_device_copy_totals()
        got = _run_ring_schedule(port, port_compile, Topology,
                                 MpiMessageType.ALLGATHER, datas, as_tensor)
        for r in range(N):
            np.testing.assert_array_equal(got[r], want[r])
            np.testing.assert_array_equal(got[r], expected)
        tot = device_copy_totals()
        if mode == "device" and as_tensor:
            assert tot["count"] == 0  # resident rounds move no bytes
        if mode != "device" and as_tensor:
            # every host send of a tensor block is one counted staging
            assert tot["by_reason"]["d2h.staging"]["count"] > 0
    if mode == "device":
        rounds = port.device_plane().summary()["rounds"]
        assert rounds["ring_permute"] == 2 * (N - 1)
    else:
        assert port.device_plane() is None


@pytest.mark.parametrize("steps,rank,shift", [
    ([("send", 1, "out", 0), ("recv", 3, "out", 3)], 0, 1),
    ([("send", 1, "out", 0), ("recv", 3, "out", 3),
      ("send", 1, "out", 3), ("recv", 3, "out", 2)], 0, 1),
    ([("send", 3, "out", 1), ("recv", 3, "out", 3)], 1, 2),
    ([("send", 1, "out", 0)], 0, None),                       # odd count
    ([("recv", 3, "out", 3), ("send", 1, "out", 0)], 0, None),  # order
    ([("send", 1, "out", 0), ("recv", 2, "out", 2)], 0, None),  # neighbours
    ([("send", 0, "out", 0), ("recv", 0, "out", 0)], 0, None),  # shift 0
])
def test_ring_target_parses_pairs_as_the_reference(steps, rank, shift):
    from faabric_tpu.device_plane.pallas_ring import (
        DeviceRingTarget as RefTarget,
    )
    from faabric_tpu.mpi.schedule import Step as RefStep

    from faabric_tpu_torch.device_plane.ring import DeviceRingTarget
    from faabric_tpu_torch.mpi.schedule import Step

    def build(step_cls):
        return [step_cls(op, peer=peer, keys=((key, blk),),
                         syms=(("blk", blk),), phase="ring")
                for op, peer, key, blk in steps]

    want = RefTarget._parse_pairs(build(RefStep), rank, N)
    got = DeviceRingTarget._parse_pairs(build(Step), rank, N)
    assert [p[2] for p in got] == [p[2] for p in want]
    if shift is None:
        assert got == []
    else:
        assert got and all(p[2] == shift for p in got)


# ---------------------------------------------------------------------------
# Registry verdicts (the reference's test_resolve_mesh_verdicts, with
# several ranks on one device accepted)
# ---------------------------------------------------------------------------

def _rows(device="cpu", n=N):
    return np.stack([registration_row(r, torch.device(device))
                     for r in range(n)])


def test_resolve_mesh_verdicts():
    good = _rows()
    assert resolve_mesh(good, N, local_ranks=range(N)) \
        == [torch.device("cpu")] * N
    bad = good.copy()
    bad[1, 0] = 0
    with pytest.raises(MeshMismatch, match="registered twice"):
        resolve_mesh(bad, N, range(N))
    bad = good.copy()
    bad[2, 2] = -1
    with pytest.raises(MeshMismatch, match="registered no device"):
        resolve_mesh(bad, N, range(N))
    with pytest.raises(MeshMismatch, match="registered no device"):
        resolve_mesh(np.stack([registration_row(r, None) for r in range(N)]),
                     N, range(N))
    bad = good.copy()
    bad[3, 1] = 7  # a device type this backend does not have
    with pytest.raises(MeshMismatch, match="not in this backend"):
        resolve_mesh(bad, N, range(N))
    with pytest.raises(MeshMismatch, match="disagrees with device"):
        resolve_mesh(good, N, local_ranks=range(1, N))
    bad = good.copy()
    bad[0, 3] = 99  # rank 0 registered from another process
    with pytest.raises(MeshMismatch, match="another process"):
        resolve_mesh(bad, N, local_ranks=range(1, N))
    with pytest.raises(MeshMismatch, match="rows for a"):
        resolve_mesh(good[:2], N, range(N))
    bad = good.copy()
    bad[:, 0] = [0, 1, 2, 5]
    with pytest.raises(MeshMismatch, match="is not 0"):
        resolve_mesh(bad, N, range(N))


def test_resolve_mesh_refuses_several_cards(monkeypatch):
    """Cards this process does not have are not in the backend; local
    ranks on two cards, or on the CPU and a card, refuse activation."""
    cuda0 = _rows("cuda:0")
    with pytest.raises(MeshMismatch, match="not in this backend"):
        resolve_mesh(cuda0, N, range(N))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_mesh(cuda0, N, range(N)) == [torch.device("cuda", 0)] * N
    split = cuda0.copy()
    split[2:, 2] = 1
    with pytest.raises(MeshMismatch, match="multi-card planes"):
        resolve_mesh(split, N, range(N))
    mixed = np.concatenate([_rows("cpu")[:2], cuda0[2:]])
    with pytest.raises(MeshMismatch, match="span devices"):
        resolve_mesh(mixed, N, range(N))


def test_aliased_devices_activate_where_the_reference_refuses():
    """Device ids [0, 1, 0, 1]: the JAX mesh needs distinct devices and
    refuses; the port's ranks share one device by design and activate.
    Both worlds then agree on an allreduce."""
    from faabric_tpu.batch_scheduler.decision import (
        SchedulingDecision as RefDecision,
    )
    from faabric_tpu.mpi import MpiWorld as RefWorld
    from faabric_tpu.transport.point_to_point import (
        PointToPointBroker as RefBroker,
    )

    ref_broker, broker = RefBroker("alias"), PointToPointBroker("alias")
    ref_d, d = RefDecision(941, 941), SchedulingDecision(941, 941)
    for r in range(N):
        ref_d.add_message("alias", r, r, r, device_id=r % 2)
        d.add_message("alias", r, r, r, device_id=r % 2)
    ref_broker.set_up_local_mappings_from_decision(ref_d)
    broker.set_up_local_mappings_from_decision(d)
    ref, port = RefWorld(ref_broker, 941, N, 941), MpiWorld(broker, 941, N,
                                                            941)
    try:
        assert not any(on_ranks(ref, lambda w, r: w.activate_device_plane(
            r)).values())
        assert all(on_ranks(port, lambda w, r: w.activate_device_plane(
            r, device="cpu")).values())
        datas = inputs("allreduce", np.int32, 7)
        want = on_ranks(ref, call("allreduce", datas, RefOp.SUM, False))
        got = on_ranks(port, call("allreduce", datas, MpiOp.SUM, True))
        for r in range(N):
            assert_agree(got[r], want[r], np.int32)
        assert port.device_plane().summary()["rounds"]["allreduce"] == 1
    finally:
        ref_broker.clear()
        broker.clear()


def test_missing_device_assignment_refuses_activation():
    broker = PointToPointBroker("nodev")
    d = SchedulingDecision(942, 942)
    for r in range(N):
        d.add_message("nodev", r, r, r)
    broker.set_up_local_mappings_from_decision(d)
    world = MpiWorld(broker, 942, N, 942)
    try:
        assert not any(on_ranks(world, lambda w, r: w.activate_device_plane(
            r)).values())
        assert world.device_plane() is None
    finally:
        broker.clear()


# ---------------------------------------------------------------------------
# Copy accounting (the reference's test_device_resident.py)
# ---------------------------------------------------------------------------

def test_resident_allreduce_moves_zero_copies_and_matches_host(worlds):
    _ref, port = worlds
    _, plane = activate(*worlds)
    datas = inputs("allreduce", np.int32, 3, 1000)
    host_out = on_ranks(port, call("allreduce", datas, MpiOp.SUM, False))
    dev = {r: torch.from_numpy(datas[r].copy()) for r in range(N)}
    reset_device_copy_totals()
    dev_out = on_ranks(port, lambda w, r: w.allreduce(r, dev[r]))
    tot = device_copy_totals()
    assert tot["count"] == 0 and tot["bytes"] == 0, tot
    ptrs = set()
    for r in range(N):
        out = dev_out[r]
        assert isinstance(out, torch.Tensor) and out.device == plane.device
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), host_out[r])
        # each rank owns its result; none aliases an input
        ptrs.add(out.data_ptr())
        np.testing.assert_array_equal(dev[r].numpy(), datas[r])
    assert len(ptrs) == N
    assert not ptrs & {dev[r].data_ptr() for r in range(N)}
    dev_out[0][0] += 1  # mutating one rank's result leaves the others
    assert int(dev_out[1][0]) == int(host_out[1][0])


def test_host_round_counts_one_input_and_one_readback_per_rank(worlds):
    _ref, port = worlds
    activate(*worlds)
    datas = inputs("allgather", np.float32, 4, 64)
    for kind, op in (("allreduce", MpiOp.SUM), ("allgather", None),
                     ("reduce_scatter", MpiOp.SUM)):
        reset_device_copy_totals()
        on_ranks(port, call(kind, datas, op, False))
        tot = device_copy_totals()["by_reason"]
        assert set(tot) == {"h2d.input", "d2h.readback"}, tot
        assert tot["h2d.input"] == {"count": N, "bytes": N * 64 * 4}
        assert tot["d2h.readback"]["count"] == N


def test_mixed_residency_round_stages_the_resident_deposit(worlds):
    _ref, port = worlds
    activate(*worlds)
    datas = {r: np.full(64, r + 1, np.int32) for r in range(N)}
    dev0 = torch.from_numpy(datas[0].copy())
    reset_device_copy_totals()
    out = on_ranks(port, lambda w, r: w.allreduce(
        r, dev0 if r == 0 else datas[r].copy()))
    tot = device_copy_totals()["by_reason"]
    assert tot["d2h.staging"]["count"] == 1, tot
    assert tot["h2d.input"]["count"] == N, tot
    for r in range(N):
        np.testing.assert_array_equal(np.asarray(out[r]),
                                      np.full(64, N * (N + 1) // 2))


def test_ineligible_tensor_stages_exactly_once_per_rank(worlds):
    _ref, port = worlds
    activate(*worlds)
    dev = {r: torch.full((64,), r, dtype=torch.int32) for r in range(N)}
    op = UserOp(lambda a, b: np.maximum(a, b))
    reset_device_copy_totals()
    out = on_ranks(port, lambda w, r: w.allreduce(r, dev[r], op))
    tot = device_copy_totals()["by_reason"]
    assert set(tot) == {"d2h.staging"}
    assert tot["d2h.staging"] == {"count": N, "bytes": N * 64 * 4}
    for r in range(N):
        np.testing.assert_array_equal(out[r], np.full(64, N - 1))


def test_inactive_plane_stages_tensors_once(worlds):
    _ref, port = worlds
    dev = {r: torch.full((32,), r + 1, dtype=torch.int32) for r in range(N)}
    reset_device_copy_totals()
    out = on_ranks(port, lambda w, r: w.allreduce(r, dev[r]))
    assert device_copy_totals()["by_reason"]["d2h.staging"]["count"] == N
    for r in range(N):
        assert isinstance(out[r], np.ndarray)
        np.testing.assert_array_equal(out[r], np.full(32, N * (N + 1) // 2))


# ---------------------------------------------------------------------------
# Eligibility and the fallback ladder
# ---------------------------------------------------------------------------

def test_eligibility_matches_the_reference_table(worlds):
    """The reference's table for numpy payloads, except 64-bit types:
    JAX without x64 would narrow them and refuses, torch keeps them and
    the port admits them (the stated divergence)."""
    ref_plane, plane = activate(*worlds)
    user = (UserOp(lambda a, b: a + b), RefUserOp(lambda a, b: a + b))
    cases = []
    for dtype in (np.float32, np.int32, np.uint8, np.int16, np.float16,
                  bool, np.complex64, np.int64, np.float64, np.uint64):
        for kind, size, ops in (
                ("allreduce", 64, ("SUM", "PROD", "MAX", "LAND", "user")),
                ("allreduce", 0, ("SUM",)),
                ("reduce_scatter", N * 4, ("SUM", "MAX")),
                ("reduce_scatter", N * 4 + 1, ("SUM",)),
                ("allgather", 8, (None,)), ("ring_permute", 8, (None,))):
            for op in ops:
                cases.append((kind, np.ones(size, dtype), op))
    for kind, arr, op in cases:
        port_op, ref_op = ((None, None) if op is None
                           else user if op == "user"
                           else (MpiOp[op], RefOp[op]))
        want = ref_plane.eligible(kind, arr, ref_op)
        got = plane.eligible(kind, arr, port_op)
        if arr.dtype.itemsize == 8 and arr.dtype.kind in "iuf":
            assert not want
            assert got == plane.eligible(kind, arr.astype(np.int32), port_op)
        else:
            assert got == want, (kind, arr.dtype, arr.size, op)
    # tensors: same table, and bfloat16 refused as numpy kind "V" is
    assert plane.eligible("allreduce", torch.ones(8), MpiOp.SUM)
    assert not plane.eligible("allreduce", torch.ones(8, dtype=torch.bfloat16),
                              MpiOp.SUM)
    assert not plane.eligible("allgather", torch.ones(8, dtype=torch.bool))


def test_64bit_payloads_ride_the_plane_exactly(worlds):
    ref, port = worlds
    activate(ref, port)
    big = 2 ** 40
    datas = {r: np.full(64, big + r, np.int64) for r in range(N)}
    want = on_ranks(ref, call("allreduce", datas, RefOp.SUM, False))
    got = on_ranks(port, call("allreduce", datas, MpiOp.SUM, True))
    assert int(want[0][0]) > 2 ** 31
    for r in range(N):
        assert got[r].dtype == torch.int64
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    fdatas = {r: np.full(16, 1.0 + 1e-12 * (r + 1)) for r in range(N)}
    want = on_ranks(ref, call("allreduce", fdatas, RefOp.SUM, False))
    got = on_ranks(port, call("allreduce", fdatas, MpiOp.SUM, True))
    for r in range(N):
        assert got[r].dtype == torch.float64
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    assert port.device_plane().summary()["rounds"]["allreduce"] == 2


def test_backend_error_disables_the_plane_and_falls_back(worlds):
    """A host (numpy) round's backend error: the reference's contract."""
    _ref, port = worlds
    _, plane = activate(*worlds)

    def boom(*a, **k):
        raise RuntimeError("injected backend failure")

    plane._compute = boom
    datas = {r: np.full(64, r + 1, np.int32) for r in range(N)}
    out = on_ranks(port, lambda w, r: w.allreduce(r, datas[r].copy()))
    for r in range(N):
        np.testing.assert_array_equal(out[r], np.full(64, N * (N + 1) // 2))
    assert plane.disabled_reason is not None
    assert not plane.eligible("allreduce", datas[0], MpiOp.SUM)
    out = on_ranks(port, lambda w, r: w.allgather(r, np.full(8, r, np.int32)))
    expected = np.concatenate([np.full(8, r, np.int32) for r in range(N)])
    for r in range(N):
        np.testing.assert_array_equal(out[r], expected)


def on_ranks_raising(world, fn) -> dict:
    """``fn`` on every rank; each rank's exception (None if it returned)."""
    def guarded(w, r):
        try:
            fn(w, r)
        except Exception as e:  # noqa: BLE001 — the test reads it
            return e
        return None
    return on_ranks(world, guarded)


@pytest.mark.parametrize("path", ["allreduce", "allgather.ring"])
def test_backend_error_on_resident_tensors_raises(worlds, monkeypatch, path):
    """A resident round whose kernel fails reaches every rank's caller:
    no host result, no staging copy, and the plane stays enabled. The
    ring's wrapper is made to take the kernel route and its build fails,
    as a kernel that does not build on the card would."""
    import faabric_tpu_torch.device_plane.ring as ring_mod
    from faabric_tpu_torch.mpi import schedule_compile
    from faabric_tpu_torch.ops import _build
    from faabric_tpu_torch.ops.ring_permute import ring_permute

    def no_build():
        raise RuntimeError("injected: kernel build failed")

    def kernel_route(ins, shift):
        _build.kernels().ring_permute(ins, None, shift)

    _ref, port = worlds
    _, plane = activate(*worlds)
    monkeypatch.setattr(_build, "kernels", no_build)
    monkeypatch.setattr(ring_mod, "ring_permute", kernel_route)
    reset_device_copy_totals()
    if path == "allreduce":
        plane._compute = lambda *a: no_build()
        dev = {r: torch.full((64,), r + 1, dtype=torch.int32)
               for r in range(N)}
        errs = on_ranks_raising(port, lambda w, r: w.allreduce(r, dev[r]))
    else:
        sched = schedule_compile.compile_schedule(
            "allgather.ring", "allgather", port.topology())
        dev = {r: torch.arange(32, dtype=torch.int32) + 1000 * r
               for r in range(N)}
        errs = on_ranks_raising(port, lambda w, r: w._run_schedule(
            r, sched, {("in", 0): dev[r]}, None, lambda sym, e: 32,
            MpiMessageType.ALLGATHER))
    for r in range(N):
        assert isinstance(errs[r], RuntimeError), errs[r]
        assert "injected" in str(errs[r])
    assert device_copy_totals()["count"] == 0
    assert plane.disabled_reason is None
    # the wrapper itself still takes the plain version for CPU tensors
    assert torch.equal(ring_permute([dev[0], dev[1]], 1)[1], dev[0])


def test_waiter_outlasts_a_slow_executor(worlds, monkeypatch):
    import time

    import faabric_tpu_torch.device_plane.plane as plane_mod

    _ref, port = worlds
    _, plane = activate(*worlds)
    monkeypatch.setattr(plane_mod, "DEVICE_PLANE_TIMEOUT_S", 0.05)
    orig = plane._execute

    def slow_execute(*args, **kwargs):
        time.sleep(0.4)
        return orig(*args, **kwargs)

    plane._execute = slow_execute
    out = on_ranks(port, lambda w, r: w.allreduce(
        r, np.full(64, r + 1, np.int32)))
    for r in range(N):
        np.testing.assert_array_equal(out[r], np.full(64, N * (N + 1) // 2))
    assert plane.disabled_reason is None


def test_reactivation_replaces_a_disabled_plane(worlds):
    _ref, port = worlds
    _, dead = activate(*worlds)
    dead.disable("injected")
    assert all(on_ranks(port, lambda w, r: w.activate_device_plane(
        r, device="cpu")).values())
    fresh = port.device_plane()
    assert fresh is not dead and fresh.disabled_reason is None
    on_ranks(port, lambda w, r: w.allreduce(r, np.full(32, r + 1, np.int32)))
    assert fresh.summary()["rounds"] == {"allreduce": 1}


def test_migration_remap_drops_the_rung(worlds):
    _ref, port = worlds
    activate(*worlds)
    assert port.device_plane() is not None
    port.prepare_migration(0)
    assert port.device_plane() is None
    port.refresh_rank_hosts()
    assert all(on_ranks(port, lambda w, r: w.activate_device_plane(
        r, device="cpu")).values())
    assert port.device_plane() is not None
