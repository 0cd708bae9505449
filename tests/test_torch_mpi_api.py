"""The port's guest MPI API, windows, registry and guest path.

The API and windows run the same programs as the JAX package's
(``faabric_tpu/mpi/api.py``, ``mpi/window.py``) over the two-host
fixture of ``test_torch_mpi_world.py`` (6 ranks, 3 + 3, live servers),
and the results must agree rank by rank; the cases mirror the API and
window tests of ``tests/unit/test_mpi.py``. Then the whole path on the
CPU: a port planner and two ``WorkerRuntime``s with
``TorchExecutorFactory(device="cpu")`` gang-schedule torch guests
through rank 0's ``ctx.mpi_world()``; they run ``chip_smoke.py``'s MPI
suite (the reference's dist programs) with tensor and numpy payloads,
and its data-parallel trainer (the reference's ``fn_train``) at a small
width, whose parameters after 3 steps must match ``jax.grad`` of
``faabric_tpu.models.loss_fn`` averaged over the same shards with the
same SGD, and be bitwise equal across the ranks.
"""

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from faabric_tpu.mpi import api as ref_api  # noqa: E402
from faabric_tpu.mpi import window as ref_window  # noqa: E402

import chip_smoke  # noqa: E402
from faabric_tpu_torch.executor import TorchExecutorFactory  # noqa: E402
from faabric_tpu_torch.mpi import MpiWorldRegistry  # noqa: E402
from faabric_tpu_torch.mpi import api as port_api  # noqa: E402
from faabric_tpu_torch.mpi import window as port_window  # noqa: E402
from faabric_tpu_torch.proto import Message  # noqa: E402
from tests.test_torch_mpi_world import (  # noqa: E402
    PORT,
    REF,
    TWO_HOSTS,
    Pair,
)

API = {REF.name: ref_api, PORT.name: port_api}
WINDOW = {REF.name: ref_window, PORT.name: port_window}


@pytest.fixture
def pair():
    p = Pair(TWO_HOSTS)
    yield p
    p.close()


# ---------------------------------------------------------------------------
# The API against the JAX package's on the same program
# ---------------------------------------------------------------------------

def test_api_program_matches_reference(pair):
    """Every collective and point-to-point call of the API, through an
    explicit communicator handle, on the same inputs."""
    def fn(world, rank, pk):
        api = API[pk.name]
        comm = api.MpiComm(world, rank)
        out = {"rank": api.mpi_comm_rank(comm),
               "size": api.mpi_comm_size(comm)}
        n = api.mpi_comm_size(comm)
        right, left = (rank + 1) % n, (rank - 1) % n
        mine = np.arange(4, dtype=np.int64) + 10 * rank
        out["bcast"] = api.mpi_bcast(mine if rank == 1 else None, 1, comm)
        out["scatter"] = api.mpi_scatter(
            np.arange(n * 2, dtype=np.float32) if rank == 0 else None, 2, 0,
            comm)
        out["gather"] = api.mpi_gather(mine, 3, comm)
        out["allgather"] = api.mpi_allgather(mine, comm)
        out["reduce"] = api.mpi_reduce(mine, api.MPI_MAX, 2, comm)
        out["allreduce"] = api.mpi_allreduce(mine, api.MPI_SUM, comm)
        out["scan"] = api.mpi_scan(mine, api.MPI_PROD, comm)
        out["alltoall"] = api.mpi_alltoall(
            np.arange(n, dtype=np.int32) * (rank + 1), comm)
        out["reduce_scatter"] = api.mpi_reduce_scatter(
            np.arange(n * 2, dtype=np.int64) + rank, api.MPI_SUM, comm)
        out["gatherv"] = api.mpi_gatherv(np.full(rank + 1, rank), 0, comm)
        out["scatterv"] = api.mpi_scatterv(
            np.arange(sum(range(1, n + 1))) if rank == 5 else None,
            list(range(1, n + 1)), 5, comm)
        out["alltoallv"] = api.mpi_alltoallv(
            np.arange(sum(range(1, n + 1))) + rank, list(range(1, n + 1)),
            comm)
        out["allgatherv"] = api.mpi_allgatherv(np.full(rank + 1, rank,
                                                       np.int32), comm)
        out["sendrecv"] = api.mpi_sendrecv(np.array([rank]), right, left,
                                           comm)[0]
        req_r = api.mpi_irecv(left, comm)
        req_s = api.mpi_isend(np.array([rank * 7]), right, comm)
        done = api.mpi_waitall([req_r, req_s], comm)
        out["isend"] = (done[0][0], done[1])
        api.mpi_barrier(comm)
        if rank == 0:
            api.mpi_send(np.arange(40, dtype=np.int32), 4, comm)
            api.mpi_rsend(np.arange(3, dtype=np.int16), 4, comm)
        if rank == 4:
            st = api.mpi_probe(0, comm)
            out["probe"] = api.mpi_get_count(st)
            out["recv"] = api.mpi_recv(0, comm)[0]
            deadline = time.monotonic() + 30
            while api.mpi_iprobe(0, comm) is None \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            req = api.mpi_irecv(0, comm)
            flag, res = False, None
            while not flag:
                flag, res = api.mpi_test(req, comm)
            out["test"] = res[0]
            out["test_again"] = api.mpi_test(req, comm)
        out["cart"] = (api.mpi_cart_create([3, 2], comm),
                       api.mpi_cart_get(comm),
                       api.mpi_cart_rank((4, -1), comm),
                       api.mpi_cart_shift(1, 1, comm))
        out["topology"] = api.mpi_topology(comm).to_dict()
        api.mpi_barrier(comm)
        return out

    got = pair.both(fn)
    n = 6
    for r in range(n):
        np.testing.assert_array_equal(got[r]["bcast"],
                                      np.arange(4) + 10)
        np.testing.assert_array_equal(
            got[r]["allreduce"], sum(np.arange(4) + 10 * q for q in range(n)))
        assert int(got[r]["sendrecv"][0]) == (r - 1) % n
        assert int(got[r]["isend"][0][0]) == 7 * ((r - 1) % n)
    assert got[4]["probe"] == 40
    np.testing.assert_array_equal(got[4]["test"], np.arange(3))
    assert got[4]["test_again"] == (True, None)


def test_subcommunicators_through_the_api(pair):
    def fn(world, rank, pk):
        api = API[pk.name]
        comm = api.MpiComm(world, rank)
        split = api.mpi_comm_split(rank % 2, -rank, comm)
        none = api.mpi_comm_split(api.MPI_UNDEFINED if rank == 0 else 1,
                                  0, comm)
        dup = api.mpi_comm_dup(comm)
        group = api.mpi_group_incl(api.mpi_comm_group(comm), [5, 1, 3])
        created = api.mpi_comm_create_group(group, 3, comm) \
            if rank in group else None
        over_all = api.mpi_comm_create(group, comm)
        shared = api.mpi_comm_split_type(api.MPI_COMM_TYPE_SHARED, 0, comm)
        sums = [int(api.mpi_allreduce(np.array([rank]), api.MPI_SUM, c)[0])
                for c in (split, dup, shared)]
        if created is not None:
            sums.append(int(api.mpi_allreduce(
                np.array([rank]), api.MPI_SUM, created)[0]))
            sums.append(api.mpi_comm_rank(created))
        if over_all is not api.MPI_COMM_NULL:
            sums.append(api.mpi_comm_rank(over_all))
        # An isend/irecv on the split communicator: a handle with no comm
        # argument resolves against the world it ran on
        nxt = (split.rank + 1) % split.size
        prv = (split.rank - 1) % split.size
        r_req = api.mpi_irecv(prv, split)
        s_req = api.mpi_isend(np.array([rank]), nxt, split)
        sums.append(int(api.mpi_wait(r_req)[0][0]))
        api.mpi_wait(s_req)
        for c in (split, dup, shared):
            api.mpi_comm_free(c)
        api.mpi_group_free(group)
        return sums, none is api.MPI_COMM_NULL, split.rank, split.size

    got = pair.both(fn)
    assert got[0][1] and not got[1][1]
    assert [got[r][2] for r in range(6)] == [2, 2, 1, 1, 0, 0]


def test_local_api_surface_matches_reference():
    """The calls that need no world: dims_create, derived types, thread
    levels, version, user ops, memory, request handles."""
    for api in (ref_api, port_api):
        assert api.mpi_dims_create(12, 2) == [4, 3]
        assert api.mpi_dims_create(8, 3) == [2, 2, 2]
        assert api.mpi_dims_create(7, 2) == [7, 1]
        t = api.mpi_type_contiguous(5, 15)  # DOUBLE
        assert api.mpi_type_size(t) == 40
        assert api.mpi_type_size(api.mpi_type_contiguous(3, t)) == 120
        assert api.mpi_type_size(np.int16) == 2
        assert api.mpi_type_commit(t) == api.MPI_SUCCESS and t.committed
        api.mpi_type_free(t)
        assert not t.committed
        assert api.mpi_get_version() == (3, 1)
        assert api.mpi_query_thread() == api.MPI_THREAD_SERIALIZED
        assert api.mpi_alloc_mem(10).size == 4096
        assert api.mpi_free_mem(None) == api.MPI_SUCCESS
        op = api.mpi_op_create(np.add, commute=False, name="add")
        assert (op.commute, op.name) == (False, "add")
        assert api.mpi_op_free(op) == api.MPI_SUCCESS
        assert not api.mpi_initialized()
        with pytest.raises(api.MpiError, match="not initialised"):
            api.mpi_comm_rank()
        with pytest.raises(api.MpiError, match="MPI_COMM_NULL"):
            api.mpi_comm_size(api.MPI_COMM_NULL)
        with pytest.raises(api.MpiError, match="code 3"):
            api.mpi_abort(errorcode=3)
        with pytest.raises(api.MpiError, match="cannot span"):
            api.mpi_win_create()
    for n in range(1, 65):
        for d in (1, 2, 3):
            assert port_api.mpi_dims_create(n, d) == \
                ref_api.mpi_dims_create(n, d)


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

def test_shared_window_put_get_fence(pair):
    def fn(world, rank, pk):
        win_mod, api = WINDOW[pk.name], API[pk.name]
        sub, subrank = world.split_type_shared(rank)
        win, seg = api.mpi_win_allocate_shared(16, api.MpiComm(sub, subrank))
        try:
            for target in range(sub.size):
                api.mpi_put(np.array([subrank], np.uint8), target, subrank,
                            win)
            api.mpi_win_fence(win)
            other = (subrank + 1) % sub.size
            peer, size = api.mpi_win_shared_query(win, other)
            out = (seg[:sub.size].copy(), peer[:sub.size].copy(), size,
                   api.mpi_win_get_attr(win, win_mod.MPI_WIN_SIZE),
                   api.mpi_win_get_attr(win, win_mod.MPI_WIN_DISP_UNIT),
                   api.mpi_win_get_attr(win, win_mod.MPI_WIN_BASE).size,
                   api.mpi_get(other, 3, 0, win))
            api.mpi_win_fence(win)
        finally:
            api.mpi_win_free(win)
        return out

    got = pair.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(got[r][0], [0, 1, 2])
        np.testing.assert_array_equal(got[r][1], [0, 1, 2])
        assert got[r][2:6] == (16, 16, 1, 16)
        np.testing.assert_array_equal(got[r][6], [0, 1, 2])


def test_shared_window_rejects_cross_host_world(pair):
    def fn(world, rank, pk):
        if rank == 0:
            with pytest.raises(RuntimeError, match="co-located"):
                WINDOW[pk.name].allocate_shared(world, rank, 16)
        return None

    pair.both(fn)


def test_window_bounds_and_free_semantics(pair):
    def fn(world, rank, pk):
        sub, subrank = world.split_type_shared(rank)
        win = WINDOW[pk.name].allocate_shared(sub, subrank, 8)
        with pytest.raises(ValueError, match="overruns"):
            win.put(np.zeros(9, np.uint8), 0, 0)
        with pytest.raises(ValueError, match="overruns"):
            win.get(0, 4, 6)
        win.free()
        win.free()  # idempotent
        with pytest.raises(RuntimeError, match="freed"):
            win.put(np.zeros(1, np.uint8), 0, 0)
        return win.offsets, win.sizes

    got = pair.both(fn)
    assert got[0] == ([0, 8, 16], [8, 8, 8])


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

class _Planner:
    """A planner client that records the chained ranks."""

    def __init__(self, group_id=77):
        self.requests = []
        self.group_id = group_id

    def call_functions(self, req):
        self.requests.append(req)
        return type("Decision", (), {"group_id": self.group_id})()


def _msg(rank, size=4, world_id=9, group_id=0):
    return Message(id=100 + rank, app_id=5, user="u", function="f",
                   mpi_rank=rank, mpi_world_id=world_id,
                   mpi_world_size=size, group_id=group_id)


def test_registry_chains_ranks_and_refuses_a_duplicate():
    planner = _Planner()
    reg = MpiWorldRegistry(broker=None, planner_client=planner)
    world = reg.create_world(_msg(0))
    assert (world.id, world.size, world.group_id) == (9, 4, 77)
    (req,) = planner.requests
    assert [(m.mpi_rank, m.app_idx, m.group_idx, m.is_mpi, m.mpi_world_id,
             m.mpi_world_size, m.app_id) for m in req.messages] == [
        (r, r, r, True, 9, 4, 5) for r in (1, 2, 3)]
    with pytest.raises(ValueError, match="already exists"):
        reg.create_world(_msg(0))
    assert reg.get_or_initialise_world(_msg(2)) is world
    assert reg.has_world(9) and reg.get_world(9) is world
    solo = MpiWorldRegistry(broker=None).create_world(_msg(0, size=1,
                                                           world_id=3,
                                                           group_id=8))
    assert solo.group_id == 8
    with pytest.raises(RuntimeError, match="No planner client"):
        MpiWorldRegistry(broker=None).create_world(_msg(0))


def test_registry_join_waits_for_the_creators_world():
    """A rank dispatched while rank 0 still chains the others joins the
    creator's world object, never one of its own (co-located ranks share
    the device plane's rendezvous through it)."""
    import threading

    release = threading.Event()

    class SlowPlanner(_Planner):
        def call_functions(self, req):
            joined.start()
            release.wait(10)
            return super().call_functions(req)

    reg = MpiWorldRegistry(broker=None, planner_client=SlowPlanner())
    got = {}
    joined = threading.Thread(
        target=lambda: got.setdefault("w", reg.get_or_initialise_world(
            _msg(1))))
    creator = threading.Thread(
        target=lambda: got.setdefault("c", reg.create_world(_msg(0))))
    creator.start()
    time.sleep(0.2)
    assert "w" not in got  # still waiting on the reservation
    release.set()
    creator.join(10)
    joined.join(10)
    assert got["w"] is got["c"]


def test_registry_destroy_and_clear():
    class Broker:
        cleared = []

        def clear_group(self, gid):
            self.cleared.append(gid)

    broker = Broker()
    reg = MpiWorldRegistry(broker=broker, planner_client=_Planner())
    world = reg.create_world(_msg(0))
    reg.destroy_world(9)
    assert not reg.has_world(9) and broker.cleared == [world.group_id]
    reg.create_world(_msg(0, world_id=10))
    reg.clear()
    assert not reg.has_world(10)


def test_mpi_context_outside_a_task_raises():
    from faabric_tpu_torch.mpi import MpiContext, get_mpi_context

    with pytest.raises(RuntimeError, match="No executor context"):
        get_mpi_context()
    ctx = MpiContext(MpiWorldRegistry(broker=None))
    assert not ctx.is_mpi()
    with pytest.raises(RuntimeError, match="not initialised"):
        ctx.world
    with pytest.raises(ValueError, match="Only rank 0"):
        ctx.create_world(_msg(1))


# ---------------------------------------------------------------------------
# The whole path on the CPU: guests gang-scheduled through the planner
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=64, attention_impl="reference", norm_impl="reference")
SEQ, PER_RANK, STEPS, LR, RANKS = 32, 2, 3, 0.5, 4


@pytest.fixture
def guests():
    """``make(hosts)``: a port planner and a started worker runtime per
    (name, slots) entry, on aliased ports, running torch guests on the
    CPU; returns the first worker's planner client."""
    from tests.conftest import next_port_base

    booted = []

    def make(hosts: dict):
        server, workers = chip_smoke.start_cluster(
            hosts, TorchExecutorFactory(device="cpu"), base=next_port_base())
        booted.append((server, workers))
        return workers[0].planner_client

    yield make
    for server, workers in booted:
        chip_smoke.stop_cluster(server, workers)


def _trainer_job(np_params, corpus):
    from faabric_tpu_torch.models import ModelConfig, params_from_jax

    cfg = ModelConfig(**SMALL, compute_dtype=torch.float32)

    def batch(step, rank, device):
        b = torch.as_tensor(corpus[step, rank * PER_RANK:
                                   (rank + 1) * PER_RANK], device=device)
        return b[:, :-1], b[:, 1:]

    return {"tensors": True, "steps": STEPS, "lr": LR, "params": {},
            "model": lambda device: params_from_jax(np_params, cfg,
                                                    device=device),
            "batch": batch}


def _jax_trainer(corpus):
    """The reference's fn_train on one process: each rank's jax.grad of
    faabric_tpu.models.loss_fn on its shard, averaged, SGD."""
    from faabric_tpu.models import ModelConfig as JaxConfig
    from faabric_tpu.models import init_params
    from faabric_tpu.models import loss_fn as jax_loss_fn

    jcfg = JaxConfig(**SMALL, compute_dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    grad_fn = jax.jit(jax.grad(jax_loss_fn), static_argnums=(3,))
    for step in range(STEPS):
        grads = None
        for r in range(RANKS):
            b = jnp.asarray(corpus[step, r * PER_RANK:(r + 1) * PER_RANK],
                            dtype=jnp.int32)
            g = grad_fn(params, b[:, :-1], b[:, 1:], jcfg)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        params = jax.tree.map(lambda p, g: p - LR * (g / RANKS), params,
                              grads)
    return np_params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("layout", ["two_hosts", "one_host"])
def test_guests_run_the_mpi_suite_and_train_through_mpi_world(
        guests, layout, monkeypatch):
    """Rank 0's ``ctx.mpi_world()`` chains ranks 1-3 through the planner.
    Over two hosts (2 + 2) the suite runs with CPU-tensor and numpy
    payloads and the gradient crosses hosts on the flat ring (both hosts
    are this machine; the chunk threshold is shrunk so this width's
    gradient is a ring payload, as the flagship's is); on one host (4
    slots) the guests' device plane on the CPU device carries the
    gradient allreduce."""
    from faabric_tpu_torch.models import ModelConfig, params_from_jax
    from faabric_tpu_torch.mpi import MpiWorld

    monkeypatch.setattr(MpiWorld, "CHUNK_BYTES", 64 * 1024)

    hosts = ({"gA": 2, "gB": 2} if layout == "two_hosts" else {"g1": 4})
    corpus = np.random.RandomState(0).randint(
        0, SMALL["vocab_size"], (STEPS, RANKS * PER_RANK, SEQ + 1))
    np_params, want_params = _jax_trainer(corpus)
    job = _trainer_job(np_params, corpus)
    chip_smoke.register_mpi_guests(job)
    client = guests(hosts)

    for tensors in (True, False):
        job["tensors"] = tensors
        results, _ = chip_smoke.run_gang(client, "suite", RANKS, timeout=60)
        outs = chip_smoke.guest_outputs(results, "suite")
        assert sorted(o["host"] for o in outs) == sorted(
            h for h, n in hosts.items() for _ in range(n))
        assert [o["rank"] for o in outs] == list(range(RANKS))
        assert outs[0]["rungs"]["scan"].startswith("sched:")

    results, _ = chip_smoke.run_gang(client, "ddp", RANKS, timeout=120)
    outs = chip_smoke.guest_outputs(results, "ddp")
    two = layout == "two_hosts"
    assert all(o["plane"] is not two for o in outs)
    assert {o["rungs"]["allreduce"] for o in outs} == (
        {"ring"} if two else {"device"})
    got = job["params"]
    assert all(torch.equal(got[0], got[r]) for r in range(1, RANKS))

    cfg = ModelConfig(**SMALL, compute_dtype=torch.float32)
    want = params_from_jax(want_params, cfg, device="cpu")
    start = params_from_jax(np_params, cfg, device="cpu")
    off = 0
    for (name, p), p0 in zip(want.named_parameters(), start.parameters()):
        n = p.numel()
        mine = got[0][off:off + n].view_as(p)
        off += n
        rel = float((mine - p.detach()).norm() / p.detach().norm())
        assert rel <= 1e-5, (name, rel)
        # The update itself, which the initial weights would hide
        step = (p - p0).detach()
        assert float(step.norm()) > 0, name  # it trained
        rel_d = float((mine - p0.detach() - step).norm() / step.norm())
        assert rel_d <= 1e-4, (name, rel_d)
    assert off == got[0].numel()


def test_guests_bind_the_api_with_mpi_init(guests):
    """``mpi_init`` inside a guest creates (rank 0) or joins the task's
    world and binds it to the executor thread: every later call of the
    API uses MPI_COMM_WORLD, as the reference's guests do."""
    from faabric_tpu_torch.executor import register_function

    @register_function("mpi", "api")
    def guest(ctx):
        api = port_api
        assert not api.mpi_initialized()
        assert api.mpi_init_thread(api.MPI_THREAD_MULTIPLE) == \
            api.MPI_THREAD_SERIALIZED
        rank, size = api.mpi_comm_rank(), api.mpi_comm_size()
        total = api.mpi_allreduce(torch.tensor([rank + 1]), api.MPI_SUM)
        host = api.mpi_get_processor_name()
        assert api.mpi_wtime() > 0 and api.mpi_topology().size == size
        api.mpi_barrier()
        api.mpi_finalize()
        assert api.mpi_finalized() and not api.mpi_initialized()
        return f"{rank}/{size}/{int(total[0])}/{host}".encode()

    client = guests({"apiA": 2, "apiB": 2})
    results, _ = chip_smoke.run_gang(client, "api", RANKS, timeout=60)
    outs = [m.output_data.decode() for m in results]
    assert [o.split("/")[:3] for o in outs] == [
        [str(r), "4", "10"] for r in range(RANKS)]
    assert sorted(o.split("/")[3] for o in outs) == ["apiA"] * 2 + ["apiB"] * 2
