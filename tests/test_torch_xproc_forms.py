"""The training-side parallel forms across processes: the port against
itself in one process and against the JAX package.

Two processes of one CPU device plane (four entries each, joined at a
coordinator, the ``--steps-child`` pair of
``tests/test_torch_distributed.py``) run, over meshes laid in the
reference's pipeline order (``PP_ORDER``: every pair along an axis of
stride 2 spans the processes):

- GPipe on its explicit backward schedule over (dp 2, tp 2, pp 2), every
  pp hop crossing, remat on (2 steps);
- the dense step at (dp 2, sp 2, tp 2) with ``attention_impl="ring"``,
  every sp ring crossing (2 steps);
- ``make_moe_train_step`` over (dp 2, tp 2, ep 2), ep crossing (1 step);
- MoE stages over (dp 2, pp 2, ep 2) under 1F1B and under GPipe, every
  pp hop crossing (1 step each);
- ``make_pp_loss`` over (dp 2, tp 2, pp 2), every pp hop crossing, its
  copies backpropagated with ``backward_copies`` in both processes;
- every collective that was single-process before, with its backward:
  alltoall, scan (SUM, PROD, MAX, MIN), broadcast, allreduce MAX, MIN
  and PROD, ``allreduce_loop``; and ``ring_attention`` itself.

Each process's losses, whole weights and last step's gradients, and its
ranks' collective outputs and input gradients, are bitwise the port's
single-process mesh of 8 CPU ranks on one intra-op thread; and within
the mirrored single-process tests' tolerances of the JAX package on the
conftest's 8 devices. In this process, over meshes of plane devices of
which another process holds half: what each process holds, and that a
group inside the process makes no exchange round.

The children import the port and nothing of JAX.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import (  # noqa: F401 — a fixture
    N_PROCS,
    _one_thread,
    _plane_entries,
    step_weights,
    steps_across_processes,
)
from tests.test_torch_procs import (
    COLLECTIVE_FORMS,
    FORM_LAYOUTS,
    FORM_RUNS,
    PP_ORDER,
    STEP_CFG,
    STEP_RUNS,
    collective_inputs,
    moe_step_config,
    moe_step_params,
    step_config,
)

FORMS = (*COLLECTIVE_FORMS, "ring_attention")


@pytest.fixture(scope="module")
def form_runs(step_weights, tmp_path_factory):  # noqa: F811
    """``FORM_RUNS``, ``FORM_LAYOUTS`` and the collectives in two
    processes joined at a coordinator: (their reports, their step
    results, their collective results)."""
    from tests.test_torch_mpi import _hold_ports
    from tests.test_torch_multiprocess import port_slot
    from tests.test_torch_procs import load_collective_runs, load_step_runs

    out = tmp_path_factory.mktemp("form-runs")
    for _ in range(20):
        reports = steps_across_processes(
            (*FORM_RUNS, *FORM_LAYOUTS, "collectives"), step_weights[0],
            str(out),
            port_slot(), lambda ports: _hold_ports(ports, listen=True))
        if reports:
            break
    assert len(reports) == N_PROCS
    for i, rep in enumerate(reports):
        assert rep["ok"], f"process {i}: {rep['err']}"
    return (reports,
            [load_step_runs(str(out / f"{i}.npz")) for i in range(N_PROCS)],
            [load_collective_runs(str(out / f"{i}-collectives.npz"))
             for i in range(N_PROCS)])


@pytest.fixture(scope="module")
def single_forms(step_weights):  # noqa: F811
    """The same runs over the port's single-process mesh of 8 CPU ranks,
    on one intra-op thread as the children."""
    from tests.test_torch_procs import plane_collective_runs, plane_step_runs

    cpu = [torch.device("cpu")] * 8
    return _one_thread(lambda: (plane_step_runs(
        cpu, step_weights[1], (*FORM_RUNS, *FORM_LAYOUTS)),
                                plane_collective_runs(cpu)))


# ---------------------------------------------------------------------------
# Bitwise across the processes
# ---------------------------------------------------------------------------

def test_forms_split_the_ranks_and_cross_the_processes(form_runs):
    """In ``PP_ORDER`` each process holds ranks (0, 1, 4, 5) or (2, 3, 6,
    7), and every pair along the form's axis (pp, sp or ep) spans the
    two processes; neither child loaded JAX or the JAX package."""
    reports, _, _ = form_runs
    for run in FORM_RUNS:
        assert reports[0]["ranks"][run] == [0, 1, 4, 5], run
        assert reports[1]["ranks"][run] == [2, 3, 6, 7], run
        assert all(rep["crossing"][run] for rep in reports), run
    assert all(rep["jax"] == [] for rep in reports)
    # The other layouts: GPipe with half of each stage in each process,
    # and a ring of 4 whose positions 0-1 and 2-3 lie in one process each
    assert [rep["ranks"]["gpipe_split"] for rep in reports] == [
        [0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(rep["crossing"]["ring_sp4"] for rep in reports)


@pytest.mark.parametrize("run", (*FORM_RUNS, *FORM_LAYOUTS))
def test_form_steps_are_bitwise_one_process(form_runs, single_forms, run):
    """Both processes' losses, whole weights after the steps and last
    step's gradients are bitwise the single-process mesh's: each form
    runs one code path in one process and in several, its rounds fold
    in rank order with the single-process code, and every backward
    round is an exact adjoint or a replay of the single-process
    autograd."""
    _, runs, _ = form_runs
    want = single_forms[0][run]
    for got in runs:
        assert [float(x) for x in got[run]["losses"]] == want["losses"]
        for kind in ("params", "grads"):
            assert set(got[run][kind]) == set(want[kind])
            for name, arr in want[kind].items():
                assert np.array_equal(got[run][kind][name], arr), (kind, name)


@pytest.mark.parametrize("form", FORMS)
def test_collectives_are_bitwise_one_process(form_runs, single_forms, form):
    """Each process's ranks' outputs and input gradients are bitwise the
    single-process collectives' (ring attention's: q's, k's and v's
    gradients), and a rank's input takes a gradient exactly where it
    does in one process (a broadcast's at the root alone)."""
    _, _, colls = form_runs
    want = single_forms[1][form]
    mine = sorted(set(colls[0][form]["out"]) | set(colls[1][form]["out"]))
    assert mine == list(range(8))
    for got in colls:
        for kind in ("out", "grad"):
            assert set(got[form][kind]) == set(want[kind]) & set(
                got[form]["out"]), kind
            for r, arr in got[form][kind].items():
                assert np.array_equal(arr, want[kind][r]), (kind, r)


def test_replayed_backward_refuses_inputs_changed_in_place(form_runs):
    """An allreduce MAX's local inputs changed in place between its
    forward and its backward make the backward raise in both processes,
    as autograd's version check does in one process: the replay never
    computes a gradient at the changed values."""
    from tests.test_torch_procs import changed_input_error

    reports, _, _ = form_runs
    for rep in reports:
        assert "modified by an inplace operation" in rep["inplace"], rep
    one = _one_thread(lambda: changed_input_error(
        [torch.device("cpu")] * 8))
    assert "modified by an inplace operation" in one


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _draws(seed: int, steps: int) -> list:
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, STEP_CFG["vocab_size"], (8, 16))
                  .astype(np.int32) for _ in range(2)) for _ in range(steps)]


def _jax_form(run: str) -> tuple[list, dict, dict]:
    """The JAX package's steps of ``run`` on the conftest's 8 devices,
    from ``init_params(PRNGKey(0))`` (the ``step_weights``) or the MoE
    runs' weights: (losses, whole weights by leaf name, the last step's
    gradients by leaf name, or {} where the step keeps them)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from faabric_tpu.models import ModelConfig as JaxConfig
    from faabric_tpu.models import data_sharding as jax_data_sharding
    from faabric_tpu.models import init_train_state as jax_init_train_state
    from faabric_tpu.models import make_train_step as jax_make_train_step
    from faabric_tpu.models.moe import MoEConfig as JaxMoEConfig
    from faabric_tpu.models.moe import make_moe_train_step as jax_moe_step
    from faabric_tpu.models.moe import moe_loss_fn as jax_moe_loss_fn
    from faabric_tpu.models.train import make_optimizer as jax_make_optimizer
    from faabric_tpu.parallel import MeshConfig as JaxMeshConfig
    from faabric_tpu.parallel import build_mesh as jax_build_mesh
    from faabric_tpu.parallel.pipeline import (
        init_pp_train_state as jax_init_pp_train_state,
        make_pp_loss as jax_make_pp_loss,
        make_pp_train_step as jax_make_pp_train_step,
        microbatch as jax_microbatch,
        pp_data_sharding as jax_pp_data_sharding,
    )

    from faabric_tpu_torch.models.transformer import _leaves
    from faabric_tpu_torch.parallel import stack_block_params

    spec = STEP_RUNS[run]
    draws = _draws(spec["seed"], spec["steps"])
    plain = {k: v for k, v in STEP_CFG.items()
             if k not in ("attention_impl", "norm_impl")}
    ds = sorted(jax.devices()[:8], key=lambda d: d.id)
    mesh = jax_build_mesh([ds[i] for i in spec["order"]],
                          JaxMeshConfig(**spec["axes"]))
    losses = []
    if spec.get("family") == "moe":
        # Unsharded: the same function; under pp the aux is off (the
        # reference's aux_loss_weight = 0 semantics)
        aux = 0.0 if spec.get("schedule") else moe_step_config().aux_loss_weight
        jcfg = JaxMoEConfig(**plain, n_experts=moe_step_config().n_experts,
                            aux_loss_weight=aux, compute_dtype=jnp.float32)
        p = jax.tree.map(jnp.asarray, moe_step_params())
        opt = jax_make_optimizer()
        state = opt.init(p)
        step = jax_moe_step(jcfg, None, opt)
        grads = {}
        for tok, tgt in draws:
            grads = jax.grad(jax_moe_loss_fn)(p, jnp.asarray(tok),
                                              jnp.asarray(tgt), jcfg)
            p, state, loss = step(p, state, jnp.asarray(tok),
                                  jnp.asarray(tgt))
            losses.append(float(loss))
        p, grads = (jax.tree.map(np.asarray, t) for t in (p, grads))
        if spec.get("schedule"):
            p, grads = stack_block_params(p), stack_block_params(grads)
        return losses, dict(_leaves(p)), dict(_leaves(grads))
    if spec.get("loss"):
        # jax.grad of the reference's make_pp_loss, no update
        jcfg = JaxConfig(**plain, compute_dtype=jnp.float32)
        p, _ = jax_init_pp_train_state(jax.random.PRNGKey(0), jcfg, mesh)
        tok, tgt = (jax.device_put(jax_microbatch(a, 2),
                                   jax_pp_data_sharding(mesh))
                    for a in draws[0])
        loss_of = jax_make_pp_loss(jcfg, mesh)
        loss, grads = jax.value_and_grad(lambda p: loss_of(p, tok, tgt))(p)
        p, grads = (jax.tree.map(np.asarray, t) for t in (p, grads))
        return [float(loss)], dict(_leaves(p)), dict(_leaves(grads))
    if run == "ring":
        jcfg = JaxConfig(**plain, attention_impl="ring",
                         compute_dtype=jnp.float32)
        p, state = jax_init_train_state(jax.random.PRNGKey(0), jcfg, mesh)
        step = jax_make_train_step(jcfg, mesh)
        batch = jax_data_sharding(mesh)
    else:
        jcfg = JaxConfig(**plain, compute_dtype=jnp.float32)
        p, state = jax_init_pp_train_state(jax.random.PRNGKey(0), jcfg, mesh)
        step = jax_make_pp_train_step(jcfg, mesh, n_microbatches=2,
                                      schedule_name=spec["schedule"])
        batch = NamedSharding(mesh, P("dp", None))
    for tok, tgt in draws:
        p, state, loss = step(p, state, jax.device_put(tok, batch),
                              jax.device_put(tgt, batch))
        losses.append(float(loss))
    return losses, dict(_leaves(jax.tree.map(np.asarray, p))), {}


@pytest.mark.parametrize("run", FORM_RUNS)
def test_form_steps_match_the_jax_package(form_runs, run):
    """The two processes' steps against the JAX package's
    ``make_pp_train_step(schedule_name="gpipe")`` over the same mesh,
    its dense step with ``attention_impl="ring"`` (its
    ``ring_attention``), ``make_moe_train_step`` (for MoE stages with
    the aux off) and ``jax.grad`` of its ``make_pp_loss``, from the same
    weights and batches: the losses within 1e-5, the weights as
    ``assert_adam_close`` holds them, and a MoE or ``make_pp_loss``
    run's gradients within 1e-5 per parameter."""
    from tests.test_torch_train import assert_adam_close

    want_losses, want, want_grads = _jax_form(run)
    _, runs, _ = form_runs
    for got in runs:
        np.testing.assert_allclose([float(x) for x in got[run]["losses"]],
                                   want_losses, atol=1e-5)
        assert set(got[run]["params"]) == set(want)
        assert_adam_close(got[run]["params"], want, 2e-6, 3e-4,
                          len(want_losses))
        for name, g in want_grads.items():
            np.testing.assert_allclose(got[run]["grads"][name], g, atol=1e-5,
                                       err_msg=name)


def _jax_collective(form: str):
    """The JAX package's ``DeviceCollectives`` on the conftest's 8
    devices over :func:`collective_inputs`: (per-rank outputs, per-rank
    input gradients or None where a form takes none)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from faabric_tpu.mpi.types import MpiOp as JaxMpiOp
    from faabric_tpu.parallel import DeviceCollectives as JaxCollectives

    bufs, cots, _ = collective_inputs()
    col = JaxCollectives(jax.devices()[:8])
    method, kw = COLLECTIVE_FORMS[form]
    kw = {k: JaxMpiOp[v] if k == "op" else v for k, v in kw.items()}
    x = col.shard_stacked(bufs)
    c = jnp.asarray(np.stack(cots))

    def fn(x):
        return getattr(col, method)(x, **kw)

    out = np.asarray(fn(x))
    if method == "allreduce_loop":
        return out, None
    if method == "broadcast":
        # One replicated output: each rank's copy's cotangent, summed
        out = np.broadcast_to(out, (8, *out.shape))
        return out, np.asarray(jax.grad(
            lambda x: jnp.sum(fn(x) * c.sum(0)))(x))
    if method == "allreduce" and kw["op"] != JaxMpiOp.PROD:
        # pmax and pmin have no derivative: the same reduction over the
        # stacked buffers, written with jnp
        red = jnp.max if kw["op"] == JaxMpiOp.MAX else jnp.min
        return out, np.asarray(jax.grad(
            lambda x: jnp.sum(red(x, axis=0)[None] * c))(jnp.asarray(
                np.stack(bufs))))
    return out, np.asarray(jax.grad(lambda x: jnp.sum(fn(x) * c))(x))


def _jax_ring():
    """JAX's ``ring_attention`` over (dp 2, sp 2, tp 2) in ``PP_ORDER``
    on :func:`collective_inputs`' q, k, v: (the whole output, the
    gradients of q, k and v under the whole output cotangent, times the
    dp x tp replicas that each hold a block)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from faabric_tpu.parallel import MeshConfig as JaxMeshConfig
    from faabric_tpu.parallel import build_mesh as jax_build_mesh
    from faabric_tpu.parallel.ring_attention import (
        ring_attention as jax_ring_attention,
        shard_sequence as jax_shard_sequence,
    )

    _, _, (q, k, v, dout) = collective_inputs()
    ds = sorted(jax.devices()[:8], key=lambda d: d.id)
    mesh = jax_build_mesh([ds[i] for i in PP_ORDER],
                          JaxMeshConfig(sp=2, tp=2))
    blocks = [jax_shard_sequence(jnp.asarray(a), mesh) for a in (q, k, v)]
    out = jax_ring_attention(*blocks, mesh)
    grads = jax.grad(lambda *a: 4 * jnp.sum(jax_ring_attention(*a, mesh)
                                            * dout), argnums=(0, 1, 2))(
        *blocks)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("form", FORMS)
def test_collectives_match_the_jax_package(form_runs, form):
    """Each process's ranks' outputs and input gradients against the JAX
    package's ``DeviceCollectives`` and ``ring_attention`` on the same
    buffers and cotangents: 1e-5 for the collectives (fp32, folds in
    another order), and the single-process ring test's tolerances for
    ring attention (2e-5 forward; 2e-4 and 1e-3 relative for the
    gradients, each block's summed over its four replicas)."""
    _, _, colls = form_runs
    if form == "ring_attention":
        from faabric_tpu_torch.parallel import (
            MeshConfig,
            ShardSpec,
            build_mesh,
        )

        want_out, want_grads = _jax_ring()
        spec = ShardSpec(build_mesh([torch.device("cpu")] * 8,
                                    MeshConfig(sp=2, tp=2)), (None, "sp"))
        every = {**colls[0][form]["out"], **colls[1][form]["out"]}
        grads = {**colls[0][form]["grad"], **colls[1][form]["grad"]}
        got = spec.gather([torch.from_numpy(every[r]) for r in range(8)])
        np.testing.assert_allclose(got.numpy(), want_out, atol=2e-5)
        s_l = want_out.shape[1] // 2
        for i, want in enumerate(want_grads):
            for sp in range(2):
                group = [r for r in range(8)
                         if spec.block_index(r)[1] == sp]
                summed = sum(torch.from_numpy(grads[r][i]) for r in group)
                np.testing.assert_allclose(
                    summed.numpy(), want[:, sp * s_l:(sp + 1) * s_l],
                    atol=2e-4, rtol=1e-3)
        return
    want_out, want_grad = _jax_collective(form)
    for got in colls:
        for r, arr in got[form]["out"].items():
            np.testing.assert_allclose(arr, want_out[r], rtol=1e-5,
                                       atol=1e-5)
        if want_grad is None:
            assert got[form]["grad"] == {}
            continue
        for r in got[form]["out"]:
            g = got[form]["grad"].get(r, np.zeros_like(want_grad[r]))
            np.testing.assert_allclose(g, want_grad[r], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Layouts over plane devices, in this process
# ---------------------------------------------------------------------------

def _rounds_or_none(fn):
    """(the value of ``fn()``, the exchange rounds it made), or (None,
    the error) where it tried to start a round (this process joined no
    plane)."""
    from faabric_tpu_torch.device_plane import xproc

    before = xproc.round_total()
    try:
        got = fn()
    except RuntimeError as e:
        assert "needs a joined device plane" in str(e), e
        return None, e
    return got, xproc.round_total() - before


@pytest.mark.parametrize("axes,crossing", [("tp", False), ("pp", True)])
def test_collective_forms_over_a_split_mesh_exchange_only_across(axes,
                                                                 crossing):
    """alltoall, scan and ``allreduce_loop`` through ``Mesh.over`` over a
    mesh of plane devices in ``PP_ORDER``: along tp, whose pairs lie in
    this process, each is this process's ranks' single-process result
    with no exchange round; along pp, whose pairs span the processes,
    each goes to an exchange round."""
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh

    mesh = build_mesh(_plane_entries(PP_ORDER), MeshConfig(tp=2, pp=2))
    one = build_mesh([torch.device("cpu")] * 8, MeshConfig(tp=2, pp=2))
    xs = [torch.full((2, 3), float(r + 1)) for r in range(8)]
    mine = [x if r in mesh.local_ranks else None for r, x in enumerate(xs)]
    for kind, kw in (("alltoall", {}), ("scan", {"op": MpiOp.MAX}),
                     ("allreduce_loop", {"n": 2})):
        got, rounds = _rounds_or_none(
            lambda: mesh.over(axes, mine, kind, **kw))
        assert (got is None) == crossing, kind
        if crossing:
            continue
        assert rounds == 0
        want = one.over(axes, xs, kind, **kw)
        for r in range(8):
            if r in mesh.local_ranks:
                assert torch.equal(got[r], want[r]), (kind, r)
            else:
                assert got[r] is None


@pytest.mark.parametrize("order,crossing", [(tuple(range(8)), False),
                                            (PP_ORDER, True)])
def test_ring_attention_over_plane_devices(order, crossing):
    """Ring attention over (dp 2, sp 2, tp 2) of plane devices: where
    every ring lies in this process its ranks' outputs are the
    single-process mesh's with no exchange round; where the rings span
    the processes the first rotation goes to an exchange round."""
    from faabric_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
        ring_attention,
        shard_sequence,
    )

    _, _, (q, k, v, _) = collective_inputs()
    mesh = build_mesh(_plane_entries(order), MeshConfig(sp=2, tp=2))
    one = build_mesh([torch.device("cpu")] * 8, MeshConfig(sp=2, tp=2))
    want = ring_attention(*(shard_sequence(a, one) for a in (q, k, v)), one)
    got, rounds = _rounds_or_none(lambda: ring_attention(
        *(shard_sequence(a, mesh) for a in (q, k, v)), mesh))
    assert (got is None) == crossing
    if not crossing:
        assert rounds == 0
        assert [r for r, y in enumerate(got) if y is not None] == \
            mesh.local_ranks == [0, 1, 2, 3]
        for r in mesh.local_ranks:
            assert torch.equal(got[r], want[r])


@pytest.mark.parametrize("family", ["moe", "moe_pipeline", "gpipe"])
def test_models_over_plane_devices_hold_their_ranks(family):
    """A ``ShardedMoETransformer`` over (dp 2, tp 2, ep 2) and a
    ``PipelinedTransformer`` (MoE or dense stages over pp 2) over plane
    devices in ``PP_ORDER`` build leaves for this process's ranks alone,
    equal to the single-process model's; a pipeline's stages whose ranks
    all live in the other process hold no rank here."""
    from faabric_tpu_torch.models import params_from_jax
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh

    moe = family.startswith("moe")
    cfg = moe_step_config() if moe else step_config()
    params = moe_step_params() if moe else _dense_params()
    axes = ({"tp": 2, "ep": 2} if family == "moe" else
            {"pp": 2, "ep": 2} if moe else {"tp": 2, "pp": 2})
    mesh = build_mesh(_plane_entries(PP_ORDER), MeshConfig(**axes))
    one = params_from_jax(params, cfg, mesh=build_mesh(
        [torch.device("cpu")] * 8, MeshConfig(**axes)))
    model = params_from_jax(params, cfg, mesh=mesh)
    assert mesh.local_ranks == [0, 1, 4, 5]
    assert [sh is not None for sh in model.shards()] == \
        [r in mesh.local_ranks for r in range(8)]
    state = model.state_dict()
    assert set(state) == {k for k in one.state_dict()
                          if int(k.split(".")[1]) in mesh.local_ranks}
    for name, v in state.items():
        assert torch.equal(v, one.state_dict()[name]), name
    if family != "moe":
        # Stage 0's ranks all live here, stage 1's all in the other
        assert [s.mesh.local_ranks for s in model.stages] == \
            [[0, 1, 2, 3], []]


def _dense_params() -> dict:
    from faabric_tpu_torch.models import Transformer, params_to_numpy

    return params_to_numpy(Transformer(
        step_config(), device="cpu",
        generator=torch.Generator().manual_seed(0)))
