"""The port's mesh substrate against the JAX package's.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
gives it; the port runs 8 ranks that all alias the one ``cpu`` device.
Each case feeds both the same numpy inputs from a seed: mesh layout,
every ``DeviceCollectives`` op, the world's device collectives, ring
attention forward and backward (JAX runs its Pallas flash kernels in
interpret mode; the port's wrappers take their plain versions on the
CPU, and the ring rotations the ring-permute kernel's), and the loader
with a mesh.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from faabric_tpu.data import DataLoader as JaxDataLoader  # noqa: E402
from faabric_tpu.data import TokenDataset as JaxTokenDataset  # noqa: E402
from faabric_tpu.mpi import MpiOp as JaxMpiOp  # noqa: E402
from faabric_tpu.ops.flash_attention import (  # noqa: E402
    _reference_attention as jax_reference_attention,
)
from faabric_tpu.parallel import DeviceCollectives as JaxCollectives  # noqa: E402
from faabric_tpu.parallel import MeshConfig as JaxMeshConfig  # noqa: E402
from faabric_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from faabric_tpu.parallel import ring_attention as jax_ring_attention  # noqa: E402
from faabric_tpu.parallel import shard_sequence as jax_shard_sequence  # noqa: E402
from faabric_tpu_torch.batch_scheduler import SchedulingDecision  # noqa: E402
from faabric_tpu_torch.data import DataLoader, TokenDataset  # noqa: E402
from faabric_tpu_torch.mpi import MpiOp, MpiWorld  # noqa: E402
from faabric_tpu_torch.ops import _build  # noqa: E402
from faabric_tpu_torch.parallel import (  # noqa: E402
    DeviceCollectives,
    MeshConfig,
    ShardSpec,
    build_mesh,
    local_devices_for_ids,
    mesh_from_group,
    ring_attention,
    shard_sequence,
)
from faabric_tpu_torch.transport import PointToPointBroker  # noqa: E402

N = 8
CPU = torch.device("cpu")


def cpu_ranks(n=N):
    return [CPU] * n


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp,sp", [(2, 2, 2), (2, 4, 1), (8, 1, 1),
                                      (1, 2, 4)])
def test_build_mesh_gives_rank_i_jax_device_i_coordinates(dp, tp, sp):
    jmesh = jax_build_mesh(jax.devices()[:N], JaxMeshConfig(dp=dp, tp=tp,
                                                            sp=sp))
    mesh = build_mesh(cpu_ranks(), MeshConfig(dp=dp, tp=tp, sp=sp))
    assert mesh.shape == dict(jmesh.shape)
    want = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(mesh.ranks, want)
    for r in range(N):
        assert mesh.rank_at(**mesh.coords(r)) == r
    # Groups along an axis: the ranks JAX's axis runs through, in order
    for axis in ("dp", "tp", "sp"):
        ax = jmesh.axis_names.index(axis)
        jax_groups = sorted(map(list, np.moveaxis(want, ax, -1)
                                .reshape(-1, jmesh.shape[axis])))
        assert sorted(mesh.groups(axis)) == jax_groups


@pytest.mark.parametrize("kw,n", [(dict(tp=3), 8), (dict(dp=3, tp=2), 8),
                                  (dict(tp=2, sp=2), 6)])
def test_mesh_config_resolve_raises_as_jax(kw, n):
    with pytest.raises(ValueError) as want:
        JaxMeshConfig(**kw).resolve(n)
    with pytest.raises(ValueError) as got:
        MeshConfig(**kw).resolve(n)
    assert str(got.value) == str(want.value)
    assert MeshConfig(tp=2, sp=2).resolve(8) == JaxMeshConfig(
        tp=2, sp=2).resolve(8)


def test_shard_spec_places_and_gathers_like_named_sharding():
    """Each rank's piece is the shard JAX puts on the same-numbered
    device, and gather reassembles the whole."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jmesh = jax_build_mesh(jax.devices()[:N], JaxMeshConfig(tp=2, sp=2))
    mesh = build_mesh(cpu_ranks(), MeshConfig(tp=2, sp=2))
    x = np.random.RandomState(0).rand(4, 8, 6).astype(np.float32)
    for spec in [("dp", "sp"), (None, None, "tp"), ("tp", None),
                 (("dp", "tp"), "sp"), ()]:
        jx = jax.device_put(x, NamedSharding(jmesh, P(*spec)))
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in jx.addressable_shards}
        pieces = ShardSpec(mesh, spec).shard(x)
        for r, piece in enumerate(pieces):
            np.testing.assert_array_equal(piece.numpy(), by_dev[r])
        np.testing.assert_array_equal(
            ShardSpec(mesh, spec).gather(pieces).numpy(), x)
        # Every rank's piece is a tensor of its own
        assert len({p.data_ptr() for p in pieces}) == N


def test_mesh_from_group_maps_the_groups_devices():
    broker = PointToPointBroker("meshhost")
    d = SchedulingDecision(app_id=61, group_id=61)
    for rank in range(4):
        d.add_message("meshhost", 500 + rank, rank, rank, device_id=3 - rank)
    broker.set_up_local_mappings_from_decision(d)
    mesh = mesh_from_group(broker, 61, range(4), MeshConfig(tp=2),
                           device_type="cpu")
    assert mesh.shape["dp"] == 2 and mesh.shape["tp"] == 2
    assert mesh.rank_devices == cpu_ranks(4)
    broker.clear()


# ---------------------------------------------------------------------------
# DeviceCollectives against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def colls():
    return (DeviceCollectives(cpu_ranks()),
            JaxCollectives(jax.devices()[:N]))


def per_rank(shape=(16,), dtype=np.float32, seed0=0, lo=0.0, hi=1.0):
    out = []
    for r in range(N):
        a = np.random.RandomState(seed0 + r).uniform(lo, hi, shape)
        out.append(a.astype(dtype))
    return out


def run_both(colls, method, bufs, *args, jax_reshape=None, **kw):
    """The method on both sides from the same buffers: the port's per-rank
    outputs and the JAX output as per-rank host arrays (or the one
    replicated array)."""
    port, jcol = colls
    got = port.to_per_rank(getattr(port, method)(port.shard_stacked(bufs),
                                                 *args, **kw))
    jx = jcol.shard_stacked(bufs)
    if jax_reshape is not None:
        jx = jx.reshape(jax_reshape)
    jargs = [JaxMpiOp(int(a)) if isinstance(a, MpiOp) else a for a in args]
    return got, getattr(jcol, method)(jx, *jargs, **kw)


DTYPES = {"float32": (np.float32, torch.float32),
          "int32": (np.int32, torch.int32),
          "float16": (np.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def typed_bufs(dtype, shape=(64,), lo=0.5, hi=1.5, seed0=0):
    """Per-rank buffers of ``dtype`` from one seed: numpy arrays for JAX
    (ml_dtypes for bfloat16) and their port tensors, the same values."""
    np_dt, t_dt = DTYPES[dtype]
    raw = per_rank(shape=shape, lo=lo, hi=hi, seed0=seed0)
    if dtype == "int32":
        raw = [np.floor(b) for b in raw]
    return ([b.astype(np_dt) for b in raw],
            [torch.tensor(b).to(t_dt) for b in raw])


def run_typed(colls, method, dtype, op, **kw):
    port, jcol = colls
    jbufs, tbufs = typed_bufs(dtype, **kw)
    got = [t.float().numpy() for t in getattr(port, method)(tbufs, op)]
    want = np.asarray(jax.device_get(getattr(jcol, method)(
        jcol.shard_stacked(jbufs), JaxMpiOp(int(op))))).astype(np.float32)
    return got, want.reshape(N, *got[0].shape)


# Every op in every dtype; 16-bit floats at the JAX tests' float16 PROD
# rtol (1e-5), which for them means bit for bit: PROD of a 16-bit float
# and SUM of bfloat16 fold in float32 and round once, as JAX does on the
# CPU, the rest fold in the dtype
ALLREDUCE_CASES = [(op, dt) for op in (MpiOp.SUM, MpiOp.MAX, MpiOp.MIN,
                                       MpiOp.PROD)
                   for dt in ("float32", "int32", "float16", "bfloat16")] + [
    (op, dt) for op in (MpiOp.LAND, MpiOp.LOR) for dt in ("int32",
                                                          "float32")]


@pytest.mark.parametrize("op,dtype", ALLREDUCE_CASES,
                         ids=[f"{o.name}-{d}" for o, d in ALLREDUCE_CASES])
def test_allreduce_matches_jax(colls, op, dtype):
    lo, hi = (-1, 2) if op in (MpiOp.LAND, MpiOp.LOR) else (
        (-50, 50) if dtype == "int32" and op != MpiOp.PROD else (0.5, 1.5))
    got, want = run_typed(colls, "allreduce", dtype, op, lo=lo, hi=hi)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g, want[r], rtol=1e-5 if dtype in (
            "float32", "float16", "bfloat16") else 0)


@pytest.mark.parametrize("op", [MpiOp.SUM, MpiOp.PROD, MpiOp.MAX, MpiOp.MIN])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_scan_matches_jax(colls, op, dtype):
    """Inclusive prefixes, folded prefix by prefix in the dtype as
    jnp.cumsum and jnp.cumprod do."""
    got, want = run_typed(colls, "scan", dtype, op)
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-5 if dtype ==
                                   "float32" else 0)


@pytest.mark.parametrize("op,n_loops,dtype", [
    (MpiOp.SUM, 1, np.float32), (MpiOp.SUM, 4, np.float32),
    (MpiOp.SUM, 3, np.int32), (MpiOp.MAX, 3, np.float32),
    (MpiOp.MIN, 2, np.int32)])
def test_allreduce_loop_matches_jax_and_one_allreduce(colls, op, n_loops,
                                                      dtype):
    if np.issubdtype(dtype, np.integer):
        bufs = [np.full(16, 8 * (r + 1), dtype) for r in range(N)]
    else:
        bufs = per_rank()
    got, want = run_both(colls, "allreduce_loop", bufs, n_loops, op)
    want = jax.device_get(want)
    single, _ = run_both(colls, "allreduce", bufs, op)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g, want[r], rtol=1e-5)
        np.testing.assert_allclose(g, single[r], rtol=1e-5)
        if not np.issubdtype(dtype, np.floating):
            np.testing.assert_array_equal(g, single[r])


def test_allreduce_loop_and_reduce_scatter_refuse_other_ops(colls):
    port, _ = colls
    xs = port.shard_stacked(per_rank(shape=(8,)))
    with pytest.raises(NotImplementedError):
        port.allreduce_loop(xs, 2, MpiOp.PROD)
    with pytest.raises(NotImplementedError):
        port.reduce_scatter(xs, MpiOp.MAX)
    with pytest.raises(NotImplementedError):
        port.scan(xs, MpiOp.LAND)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_allgather_matches_jax(colls, dtype):
    bufs = [b.astype(dtype) for b in per_rank(shape=(4,), lo=0, hi=100)]
    got, want = run_both(colls, "allgather", bufs, jax_reshape=(N * 4,))
    for g in got:
        np.testing.assert_array_equal(g, np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_scatter_matches_jax(colls, dtype):
    k = 3
    got, want = run_typed(colls, "reduce_scatter", dtype, MpiOp.SUM,
                          shape=(N * k,))
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-6)
        assert got[r].shape == (k,)


def test_alltoall_matches_jax(colls):
    bufs = per_rank(shape=(N, 2))
    got, want = run_both(colls, "alltoall", bufs)
    want = jax.device_get(want)
    for r in range(N):
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("root", [0, 5])
def test_broadcast_matches_jax(colls, root):
    bufs = per_rank()
    got, want = run_both(colls, "broadcast", bufs, root=root)
    for g in got:
        np.testing.assert_array_equal(g, np.asarray(want))


@pytest.mark.parametrize("pairs", [[(1, 3)], [(0, 2), (3, 1)],
                                   [(i, (i + 1) % N) for i in range(N)],
                                   [(i, (i + 3) % N) for i in range(N)],
                                   [(i, (i - 1) % N) for i in range(N)]],
                         ids=["send_recv", "two_pairs", "shift1", "shift3",
                              "shift-1"])
def test_permute_matches_jax(colls, pairs):
    bufs = per_rank(shape=(8,))
    got, want = run_both(colls, "permute", bufs, pairs)
    want = jax.device_get(want)
    for r in range(N):
        np.testing.assert_array_equal(got[r], want[r])


def test_send_recv_and_shift_match_jax(colls):
    bufs = [np.full(8, r, np.float32) for r in range(N)]
    got, want = run_both(colls, "send_recv", bufs, 1, 3)
    np.testing.assert_array_equal(np.stack(got), jax.device_get(want))
    got, want = run_both(colls, "shift", bufs, 2)
    np.testing.assert_array_equal(np.stack(got), jax.device_get(want))


def test_permute_refuses_a_rank_twice(colls):
    port, _ = colls
    xs = port.shard_stacked(per_rank())
    with pytest.raises(ValueError, match="at most once"):
        port.permute(xs, [(0, 1), (2, 1)])


def test_outputs_are_tensors_of_their_own(colls):
    """Ranks share the cpu device, yet no output aliases another rank's
    or an input."""
    port, _ = colls
    xs = port.shard_stacked(per_rank())
    ptrs = {x.data_ptr() for x in xs}
    for out in (port.allreduce(xs), port.allgather(xs), port.broadcast(xs),
                port.shift(xs), port.allreduce(xs, MpiOp.MAX)):
        new = {o.data_ptr() for o in out}
        assert len(new) == N and not new & ptrs


def test_a_buffer_off_its_rank_device_is_refused():
    coll = DeviceCollectives([CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="its device is meta"):
        coll.allreduce([torch.ones(2), torch.ones(2)])


def test_addressable_forms_wait_for_cross_process_planes(colls):
    """In one process every rank is addressable: the addressable forms
    give the JAX package's shards, and both refuse a missing local rank.
    Across processes (tests/test_torch_distributed.py) the other
    processes' ranks are None here and raise in addressable_shard."""
    port, ref = colls
    bufs = {r: b for r, b in enumerate(per_rank((3, 2), seed0=40))}
    xs = port.shard_stacked_addressable(bufs, (3, 2), np.float32)
    got = ref.shard_stacked_addressable(bufs, (3, 2), np.float32)
    for r in range(N):
        want = ref.addressable_shard(got, r).reshape(3, 2)
        assert port.addressable_shard(xs, r).dtype == torch.float32
        np.testing.assert_array_equal(port.addressable_shard(xs, r).numpy(),
                                      want)
    for coll in (port, ref):
        with pytest.raises(KeyError, match="no buffer was supplied"):
            coll.shard_stacked_addressable({0: bufs[0]}, (3, 2), np.float32)
    assert port.local_ranks == list(range(N)) and not port.multiprocess


# ---------------------------------------------------------------------------
# The differentiable forms
# ---------------------------------------------------------------------------

def leaves_of(bufs):
    return [torch.tensor(b, requires_grad=True) for b in bufs]


@pytest.mark.parametrize("method,args", [
    ("allreduce", ()), ("allgather", ()), ("allgather", (1,)),
    ("shift", (1,)), ("shift", (3,)), ("permute", ([(0, 2), (5, 1)],))])
def test_collective_gradients_equal_autograd_of_the_plain_version(
        colls, method, args):
    """Each rank's output weighted by its own cotangent: the gradient
    through the collective's backward (itself a collective) equals
    autograd through the same function written as plain tensor ops."""
    port, _ = colls
    bufs = per_rank(shape=(4, 3))
    cots = [torch.tensor(c) for c in per_rank(
        shape=(4 * N, 3) if method == "allgather" and not args else
        (4, 3 * N) if method == "allgather" else (4, 3), seed0=40)]

    def plain(xs):
        if method == "allreduce":
            total = sum(xs[1:], xs[0])
            return [total] * N
        if method == "allgather":
            return [torch.cat(xs, *args)] * N
        pairs = (args[0] if method == "permute" else
                 [(i, (i + args[0]) % N) for i in range(N)])
        out = [torch.zeros_like(x) for x in xs]
        for s, t in pairs:
            out[t] = xs[s]
        return out

    xs, ys = leaves_of(bufs), leaves_of(bufs)
    sum((o * c).sum() for o, c in zip(getattr(port, method)(xs, *args),
                                      cots)).backward()
    sum((o * c).sum() for o, c in zip(plain(ys), cots)).backward()
    for x, y in zip(xs, ys):
        # A rank no pair reads from gets zeros (autograd leaves None)
        want = torch.zeros_like(y) if y.grad is None else y.grad
        torch.testing.assert_close(x.grad, want, rtol=1e-6, atol=1e-6)


def test_shift_runs_the_ring_permute_wrapper_forward_and_backward(
        colls, monkeypatch):
    """A whole-ring rotation over ranks of one device goes through
    ``ops/ring_permute.py::ring_permute``, once forward and once (the
    inverse shift) backward, strided views included (made contiguous
    there); a partial permutation does not."""
    import importlib

    rp = importlib.import_module("faabric_tpu_torch.ops.ring_permute")
    port, _ = colls
    calls = []
    real = rp.ring_permute
    monkeypatch.setattr(rp, "ring_permute",
                        lambda ins, shift, outs=None: calls.append(shift)
                        or real(ins, shift, outs))
    xs = leaves_of(per_rank(shape=(5,)))
    out = port.shift(xs, 3)
    sum(o.sum() * (r + 1) for r, o in enumerate(out)).backward()
    assert calls == [3, N - 3]
    for r, x in enumerate(xs):
        assert torch.all(x.grad == (r + 3) % N + 1)
    port.permute(port.shard_stacked(per_rank()), [(0, 1)])
    assert calls == [3, N - 3]
    # Transposed views forward, non-contiguous cotangents backward
    base = leaves_of(per_rank(shape=(5, 3)))
    views = [b.t() for b in base]
    assert not views[0].is_contiguous()
    out = port.shift(views, 1)
    assert calls == [3, N - 3, 1]
    for r, o in enumerate(out):
        assert torch.equal(o, views[(r - 1) % N])
    weights = torch.arange(15.0).reshape(5, 3).t()
    sum(o.mul(weights).sum() * (r + 1) for r, o in enumerate(out)).backward()
    assert calls == [3, N - 3, 1, N - 1]
    for r, b in enumerate(base):
        assert torch.equal(b.grad, weights.t() * ((r + 1) % N + 1))


# ---------------------------------------------------------------------------
# local_devices_for_ids and the world's device collectives
# ---------------------------------------------------------------------------

def test_local_devices_for_ids_admits_aliasing_on_purpose(monkeypatch):
    """The JAX package raises where two ids wrap onto one chip; the port
    wraps them onto the local devices and lets ranks share one."""
    assert local_devices_for_ids([0, 5, 2, 2], "cpu") == cpu_ranks(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert local_devices_for_ids([0, 1, 2, 3, 7]) == [
        torch.device("cuda", i) for i in (0, 1, 0, 1, 1)]


def test_local_devices_for_ids_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        local_devices_for_ids([0, 1])


def world_over(n, app_id, device_ids):
    broker = PointToPointBroker("devhost")
    d = SchedulingDecision(app_id=app_id, group_id=app_id)
    for rank in range(n):
        d.add_message("devhost", 3000 + rank, rank, rank,
                      device_id=device_ids[rank])
    broker.set_up_local_mappings_from_decision(d)
    return broker, MpiWorld(broker, app_id, n, app_id)


def test_world_device_collectives_end_to_end():
    """``MpiWorld.device_collectives`` maps the planner's devices of the
    ranks (group mappings) and runs an allreduce over them."""
    broker, world = world_over(N, 99, list(range(N)))
    coll = world.device_collectives("cpu")
    assert coll.n == N and coll.devices == cpu_ranks()
    assert world.device_collectives("cpu") is coll
    bufs = [np.full(8, float(r), dtype=np.float32) for r in range(N)]
    out = coll.allreduce(coll.shard_stacked(bufs))
    np.testing.assert_allclose(coll.to_per_rank(out)[0],
                               np.full(8, sum(range(N)), dtype=np.float32))
    broker.clear()


def test_world_device_send_recv():
    broker, world = world_over(4, 8080, [0, 1, 2, 3])
    coll = world.device_collectives("cpu")
    x = coll.shard_stacked([np.full(8, r + 1, np.float32) for r in range(4)])
    out = coll.to_per_rank(world.device_send_recv(x, 2, 0, "cpu"))
    np.testing.assert_array_equal(out[0], np.full(8, 3, np.float32))
    np.testing.assert_array_equal(out[2], np.zeros(8, np.float32))
    # Two disjoint pairs, then a ring shift of the 4 ranks
    out = coll.to_per_rank(coll.permute(x, [(0, 2), (3, 1)]))
    np.testing.assert_array_equal(out[2], np.full(8, 1, np.float32))
    np.testing.assert_array_equal(out[1], np.full(8, 4, np.float32))
    out = coll.to_per_rank(coll.shift(x, 1))
    for r in range(4):
        np.testing.assert_array_equal(out[r],
                                      np.full(8, (r - 1) % 4 + 1, np.float32))
    broker.clear()


# ---------------------------------------------------------------------------
# Ring attention against the JAX package's
# ---------------------------------------------------------------------------

def qkv(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


def gather_seq(mesh, outs):
    """The whole (B, S, H, D) from the per-rank blocks (dp replicas agree)."""
    return ShardSpec(mesh, (None, "sp")).gather(outs).detach().numpy()


@pytest.mark.parametrize("sp,causal,shape", [
    (2, True, (2, 512, 4, 32)), (4, True, (2, 512, 4, 32)),
    (8, True, (2, 512, 4, 32)), (4, False, (1, 256, 2, 16)),
    (1, True, (1, 64, 2, 16))])
def test_ring_attention_matches_jax(sp, causal, shape):
    jmesh = jax_build_mesh(jax.devices()[:N], JaxMeshConfig(dp=N // sp, sp=sp))
    mesh = build_mesh(cpu_ranks(), MeshConfig(dp=N // sp, sp=sp))
    arrays = qkv(*shape, seed=3 if not causal else 0)
    if sp == 1:
        want = jax_ring_attention(*map(jnp.asarray, arrays), jmesh)
    else:
        want = jax_ring_attention(*(jax_shard_sequence(jnp.asarray(a), jmesh)
                                    for a in arrays), jmesh, causal=causal)
    got = ring_attention(*(shard_sequence(a, mesh) for a in arrays), mesh,
                         causal=causal)
    np.testing.assert_allclose(gather_seq(mesh, got), np.asarray(want),
                               atol=2e-5)
    # And the plain attention of the whole sequence
    ref = jax_reference_attention(*map(jnp.asarray, arrays), causal=causal)
    np.testing.assert_allclose(gather_seq(mesh, got), np.asarray(ref),
                               atol=2e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_gradients_match_jax(sp):
    jmesh = jax_build_mesh(jax.devices()[:N], JaxMeshConfig(dp=N // sp, sp=sp))
    mesh = build_mesh(cpu_ranks(), MeshConfig(dp=N // sp, sp=sp))
    arrays = qkv(1, 256, 2, 16, seed=11)

    def loss_ring(q, k, v):
        return jnp.sum(jax_ring_attention(q, k, v, jmesh) ** 2)

    want = jax.grad(loss_ring, argnums=(0, 1, 2))(
        *(jax_shard_sequence(jnp.asarray(a), jmesh) for a in arrays))
    blocks = [shard_sequence(a, mesh) for a in arrays]
    for leaves in blocks:
        for t in leaves:
            t.requires_grad_()
    out = ring_attention(*blocks, mesh)
    # Every dp replica computes the whole loss: weight each by 1/dp
    (sum((o ** 2).sum() for o in out) / mesh.shape["dp"]).backward()
    spec = ShardSpec(mesh, (None, "sp"))
    for leaves, w in zip(blocks, want):
        # A block's gradient is the sum over its dp replicas' copies
        grads = [t.grad for t in leaves]
        summed = [sum(grads[g] for g in group)
                  for group in spec.replica_groups()]
        whole = torch.cat([summed[i] for i in np.argsort(
            [spec.block_index(group[0])[1]
             for group in spec.replica_groups()])], dim=1)
        np.testing.assert_allclose(whole.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3)


def test_ring_schedule_folds_i_plus_one_blocks_and_rotates_n_minus_one(
        monkeypatch):
    """The causal ring of 4: rank i folds blocks 0..i (10 flash calls, the
    diagonal's causal), K and V rotate 3 times each; future blocks are
    never attended."""
    mesh = build_mesh(cpu_ranks(4), MeshConfig(dp=1, sp=4))
    calls = []

    def block(q, k, v, causal):
        from faabric_tpu_torch.ops.flash_attention import flash_attention_with_lse

        calls.append((int(q[0, 0, 0, 0]), int(k[0, 0, 0, 0]), causal))
        return flash_attention_with_lse(q, k, v, causal)

    # Block i's entries all equal i, so a call names its two blocks
    x = torch.arange(4.0).repeat_interleave(8)[None, :, None, None].expand(
        1, 32, 1, 16).contiguous()
    shifts = []
    real_shift = DeviceCollectives.shift

    def counted(self, xs, disp=1):
        shifts.append(disp)
        return real_shift(self, xs, disp)

    monkeypatch.setattr(DeviceCollectives, "shift", counted)
    ring_attention(*(shard_sequence(x, mesh) for _ in range(3)), mesh,
                   block=block)
    assert sorted(calls) == sorted(
        [(i, j, i == j) for i in range(4) for j in range(i + 1)])
    assert shifts == [1] * 6


# ---------------------------------------------------------------------------
# The loader with a mesh
# ---------------------------------------------------------------------------

def test_loader_with_mesh_stages_the_jax_loaders_shards():
    jmesh = jax_build_mesh(jax.devices()[:N], JaxMeshConfig(tp=2, sp=2))
    mesh = build_mesh(cpu_ranks(), MeshConfig(tp=2, sp=2))
    corpus = np.random.RandomState(0).randint(0, 100, 4 * 16 * 3 + 1).astype(
        np.int32)
    want = list(JaxDataLoader(JaxTokenDataset(corpus, 16), 4, mesh=jmesh,
                              seed=2))
    got = list(DataLoader(TokenDataset(corpus, 16), 4, seed=2, mesh=mesh))
    assert len(got) == len(want) == 3
    for (tok, tgt), (jtok, jtgt) in zip(got, want):
        for pieces, jarr in ((tok, jtok), (tgt, jtgt)):
            by_dev = {s.device.id: np.asarray(s.data)
                      for s in jarr.addressable_shards}
            assert len(pieces) == N
            for r, piece in enumerate(pieces):
                assert piece.dtype == torch.int32
                np.testing.assert_array_equal(piece.numpy(), by_dev[r])


def test_loader_with_mesh_checks_dp_and_drop_last():
    mesh = build_mesh(cpu_ranks(), MeshConfig(tp=2, sp=2))
    ds = TokenDataset(np.arange(200, dtype=np.int32), 8)
    with pytest.raises(ValueError, match="dp=2"):
        DataLoader(ds, 3, mesh=mesh)
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(ds, 4, mesh=mesh, drop_last=False)


def test_cpu_ranks_launch_no_kernel():
    """On CPU tensors every wrapper took its plain version."""
    mesh = build_mesh(cpu_ranks(4), MeshConfig(dp=1, sp=4))
    _build.reset_launch_counts()
    arrays = qkv(1, 64, 2, 16)
    ring_attention(*(shard_sequence(a, mesh) for a in arrays), mesh)
    assert sum(_build.LAUNCHES.values()) == 0
