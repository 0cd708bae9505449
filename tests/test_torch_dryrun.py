"""The port's sharded model and train step, and its ``dryrun_multichip``
(stages 1-5), against the JAX package on a (dp, tp, sp) mesh.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on 8 ranks aliasing the ``cpu`` device. Both start from the
same JAX ``init_params`` weights and ``RandomState`` batches, at the
reference dry run's tiny config (vocab 128, d_model 32, 2 layers, 4
heads, d_ff 64, fp32 compute). On the CPU, "auto" attention resolves to
the plain one on both sides (K/V gathered over sp); the ring schedule
inside the model is held by the ``attention_impl="ring"`` cases.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from faabric_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from faabric_tpu.models import data_sharding as jax_data_sharding  # noqa: E402
from faabric_tpu.models import forward as jax_forward  # noqa: E402
from faabric_tpu.models import init_params  # noqa: E402
from faabric_tpu.models import init_train_state as jax_init_train_state  # noqa: E402
from faabric_tpu.models import loss_fn as jax_loss_fn  # noqa: E402
from faabric_tpu.models import make_optimizer as jax_make_optimizer  # noqa: E402
from faabric_tpu.models import make_train_step as jax_make_train_step  # noqa: E402
from faabric_tpu.models import param_shardings as jax_param_shardings  # noqa: E402
from faabric_tpu.models.transformer import resolve_impls as jax_resolve  # noqa: E402
from faabric_tpu.parallel import MeshConfig as JaxMeshConfig  # noqa: E402
from faabric_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from faabric_tpu_torch.entry import DRYRUN_CONFIG, dryrun_multichip  # noqa: E402
from faabric_tpu_torch.models import (  # noqa: E402
    ShardedTransformer,
    data_sharding,
    forward,
    init_train_state,
    loss_fn,
    make_multi_step,
    make_optimizer,
    make_train_step,
    param_shardings,
    params_from_jax,
    params_to_numpy,
    resolve_impls,
    shard_params,
)
from faabric_tpu_torch.models.transformer import _leaves  # noqa: E402
from faabric_tpu_torch.parallel import MeshConfig, build_mesh  # noqa: E402
from tests.test_torch_train import assert_adam_close, leaves  # noqa: E402

N = 8
CPU = torch.device("cpu")
TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_seq=32)


def configs(**changes):
    kw = {**TINY, **changes}
    return (JaxConfig(**kw, compute_dtype=jnp.float32),
            dataclasses.replace(DRYRUN_CONFIG, **changes))


def meshes(n, dp=-1, tp=1, sp=1):
    return (jax_build_mesh(jax.devices()[:n], JaxMeshConfig(dp=dp, tp=tp,
                                                             sp=sp)),
            build_mesh([CPU] * n, MeshConfig(dp=dp, tp=tp, sp=sp)))


def dryrun_mesh_config(n):
    """The reference dry run's rule: tp 2 for an even gang, sp 2 where n
    is a multiple of 8."""
    tp = 2 if n % 2 == 0 else 1
    return dict(tp=tp, sp=2 if n % (tp * 2 * 2) == 0 else 1)


def dryrun_batch(dp, sp, vocab=128):
    rng = np.random.RandomState(0)
    b, s = max(2, 2 * dp), max(8, 8 * sp)
    return (rng.randint(0, vocab, (b, s), dtype=np.int32),
            rng.randint(0, vocab, (b, s), dtype=np.int32))


def np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed), cfg))


@functools.lru_cache(maxsize=None)
def jax_dryrun_step(n, accum_steps=1):
    """JAX's stage 3 on n virtual devices: (loss, updated params)."""
    jcfg, _ = configs()
    jmesh, _ = meshes(n, **dryrun_mesh_config(n))
    params, state = jax_init_train_state(jax.random.PRNGKey(0), jcfg, jmesh)
    tok, tgt = dryrun_batch(jmesh.shape["dp"], jmesh.shape["sp"])
    step = jax_make_train_step(jcfg, jmesh, accum_steps=accum_steps)
    params, _, loss = step(params, state,
                           jax.device_put(tok, jax_data_sharding(jmesh)),
                           jax.device_put(tgt, jax_data_sharding(jmesh)))
    return float(loss), jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# Specs and impl resolution
# ---------------------------------------------------------------------------

def test_param_shardings_are_the_jax_packages_specs():
    jcfg, cfg = configs()
    jmesh, mesh = meshes(N, tp=2, sp=2)
    want = jax_param_shardings(jmesh, jcfg)
    got = param_shardings(mesh, cfg)
    flat_want = dict(_leaves(jax.tree.map(lambda s: s, want,
                                          is_leaf=lambda x: hasattr(x, "spec"))))
    for name, spec in _leaves(got):
        assert spec.spec == tuple(flat_want[name].spec), name


@pytest.mark.parametrize("att,norm,sp", [
    ("flash", "fused", 2), ("flash", "fused", 1), ("ring", "reference", 1),
    ("ring", "reference", 2), ("reference", "fused", 2),
    ("auto", "auto", 2)])
def test_resolve_impls_under_a_mesh_as_jax(att, norm, sp):
    """On the CPU both sides resolve "auto" to the plain versions; under
    a mesh flash over a split sequence becomes the ring and the fused
    norm the plain one. The port's "auto" on CUDA is its own (flash)."""
    jcfg, cfg = configs(attention_impl=att, norm_impl=norm)
    jmesh, mesh = meshes(N, tp=2, sp=sp)
    want = jax_resolve(jcfg, jmesh)
    got = resolve_impls(cfg, CPU, mesh)
    assert (got.attention_impl, got.norm_impl) == (want.attention_impl,
                                                   want.norm_impl)
    on_card = resolve_impls(dataclasses.replace(cfg, attention_impl="auto",
                                                norm_impl="auto"),
                            torch.device("cuda"), mesh)
    assert (on_card.attention_impl, on_card.norm_impl) == (
        "ring" if sp > 1 else "flash", "reference")


def test_sharded_model_refuses_wrong_shapes_and_meshes():
    _, cfg = configs()
    _, mesh = meshes(N, tp=2, sp=2)
    params = np_params(configs()[0])
    bad = dict(params, lm_head=params["lm_head"][:, :64])
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, cfg, mesh=mesh)
    # tp = 8 does not split the 4 heads
    _, wide = meshes(N, tp=8)
    with pytest.raises(ValueError, match="does not split into 8 over tp"):
        params_from_jax(params, cfg, mesh=wide)
    model = params_from_jax(params, cfg, mesh=mesh)
    tok = data_sharding(mesh).shard(dryrun_batch(2, 2)[0])
    with pytest.raises(ValueError, match="token shards"):
        forward(model, tok[:4])


# ---------------------------------------------------------------------------
# Forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("att,dp,tp,sp", [
    ("reference", 2, 2, 2), ("ring", 2, 2, 2), ("reference", 2, 4, 1),
    ("ring", 1, 2, 4), ("flash", 2, 4, 1)])
def test_sharded_forward_matches_unsharded_and_jax(att, dp, tp, sp):
    """Logits gathered from the ranks against the port's unsharded
    forward and JAX's sharded one (atol 2e-4, as the JAX test holds its
    sharded forward to its single-device one)."""
    jcfg, cfg = configs(attention_impl=att)
    jmesh, mesh = meshes(N, dp=dp, tp=tp, sp=sp)
    params = np_params(jcfg, seed=1)
    tok = np.random.RandomState(0).randint(0, 128, (4, 16), dtype=np.int32)
    model = params_from_jax(params, cfg, mesh=mesh)
    with torch.no_grad():
        logits = forward(model, data_sharding(mesh).shard(tok))
        plain = forward(params_from_jax(params, cfg, device="cpu"),
                        torch.as_tensor(tok))
    assert all(lg.shape == (4 // dp, 16 // sp, 128) for lg in logits)
    got = data_sharding(mesh).gather(logits).numpy()
    np.testing.assert_allclose(got, plain.numpy(), atol=2e-4)
    if att != "flash":  # JAX's interpret-mode flash takes no head dim 8
        want = jax.jit(lambda p, t: jax_forward(p, t, jcfg, jmesh))(
            jax.device_put(init_params(jax.random.PRNGKey(1), jcfg),
                           jax_param_shardings(jmesh, jcfg)),
            jax.device_put(tok, jax_data_sharding(jmesh)))
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_gradients_match_jax_per_parameter(n):
    """Each shard's gradient after the allreduce over its holders, the
    whole assembled from the shards, against ``jax.grad`` of the sharded
    loss (fp32, atol 1e-6 rtol 1e-4 as the unsharded case); every copy of
    a shard holds the same gradient bit for bit; and the gradient norm
    over one copy of each shard is the whole model's (the clip norm)."""
    jcfg, cfg = configs()
    jmesh, mesh = meshes(n, **dryrun_mesh_config(n))
    params = np_params(jcfg)
    tok, tgt = dryrun_batch(mesh.shape["dp"], mesh.shape["sp"])
    want = jax.jit(jax.grad(jax_loss_fn), static_argnums=(3, 4))(
        jax.device_put(init_params(jax.random.PRNGKey(0), jcfg),
                       jax_param_shardings(jmesh, jcfg)),
        jax.device_put(tok, jax_data_sharding(jmesh)),
        jax.device_put(tgt, jax_data_sharding(jmesh)), jcfg, jmesh)
    model = params_from_jax(params, cfg, mesh=mesh)
    spec = data_sharding(mesh)
    losses = loss_fn(model, spec.shard(tok), spec.shard(tgt))
    assert len({x.item() for x in losses}) == 1
    losses[0].backward()
    model.allreduce_grads()
    want_flat = dict(_leaves(jax.tree.map(np.asarray, want)))
    for name, pspec in model.specs.items():
        grads = [p.grad for p in model.copies(name)]
        for group in pspec.replica_groups():
            assert all(torch.equal(grads[group[0]], grads[r]) for r in group)
        np.testing.assert_allclose(pspec.gather(grads).numpy(),
                                   want_flat[name], atol=1e-6, rtol=1e-4,
                                   err_msg=name)
    norm = torch.nn.utils.get_total_norm(
        [p.grad for p in model.unique_parameters()])
    np.testing.assert_allclose(float(norm), float(optax.global_norm(want)),
                               rtol=1e-5)


@pytest.mark.parametrize("n,accum_steps", [(2, 1), (4, 1), (8, 1), (8, 2)])
def test_sharded_train_step_matches_jax(n, accum_steps):
    """One AdamW step of the dry run's stage 3 from ``init_params(PRNGKey
    (0))``: the loss within 1e-5 of JAX's (5.2668 at n = 8), and the
    updated parameters as ``assert_adam_close`` holds them (every element
    within lr, all but one in a thousand within 2e-6)."""
    jcfg, cfg = configs()
    _, mesh = meshes(n, **dryrun_mesh_config(n))
    want_loss, want_params = jax_dryrun_step(n, accum_steps)
    model = params_from_jax(np_params(jcfg), cfg, mesh=mesh)
    spec = make_optimizer()
    opt = spec.init(model)
    step = make_train_step(cfg, spec, accum_steps=accum_steps)
    tok, tgt = (data_sharding(mesh).shard(a)
                for a in dryrun_batch(mesh.shape["dp"], mesh.shape["sp"]))
    losses = step(model, opt, tok, tgt)
    assert len(losses) == n
    np.testing.assert_allclose(float(losses[0]), want_loss, atol=1e-5)
    if n == 8:
        assert round(float(losses[0]), 4) == 5.2668
    assert_adam_close(params_to_numpy(model), want_params, 2e-6, 3e-4, 1)


@pytest.mark.parametrize("sp", [2, 4])
def test_train_steps_with_ring_attention_match_jax(sp):
    """Three steps with ``attention_impl="ring"`` over an sp mesh (the
    JAX test's case): the losses within 1e-5 of JAX's ring run, falling.
    On the CPU this is the one check of the ring schedule inside the
    model, since "auto" resolves to the plain attention on both sides."""
    kw = dict(vocab_size=64, max_seq=64, attention_impl="ring")
    jcfg, cfg = configs(**kw)
    dp = 8 // sp // 2 or 1
    n = dp * sp
    jmesh, mesh = meshes(n, dp=dp, sp=sp)
    rng = np.random.RandomState(13)
    tok = rng.randint(0, 64, (4, 64), dtype=np.int32)
    tgt = rng.randint(0, 64, (4, 64), dtype=np.int32)
    jparams, jstate = jax_init_train_state(jax.random.PRNGKey(0), jcfg, jmesh,
                                           jax_make_optimizer())
    jstep = jax_make_train_step(jcfg, jmesh, jax_make_optimizer())
    model = params_from_jax(np_params(jcfg), cfg, mesh=mesh)
    spec = make_optimizer()
    opt = spec.init(model)
    step = make_train_step(cfg, spec)
    shard = data_sharding(mesh).shard
    want, got = [], []
    for _ in range(3):
        jparams, jstate, jl = jstep(
            jparams, jstate, jax.device_put(tok, jax_data_sharding(jmesh)),
            jax.device_put(tgt, jax_data_sharding(jmesh)))
        want.append(float(jl))
        got.append(float(step(model, opt, shard(tok), shard(tgt))[0]))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[-1] < got[0]


def test_multi_step_on_a_mesh_repeats_single_steps_bitwise():
    jcfg, cfg = configs()
    _, mesh = meshes(N, **dryrun_mesh_config(N))
    params = np_params(jcfg)
    shard = data_sharding(mesh).shard
    batches = [dryrun_batch(2, 2), tuple(a[::-1].copy()
                                         for a in dryrun_batch(2, 2))]
    a = params_from_jax(params, cfg, mesh=mesh)
    opt_a = make_optimizer().init(a)
    step = make_train_step(cfg)
    singles = [step(a, opt_a, shard(t), shard(y))[0] for t, y in batches]
    b = params_from_jax(params, cfg, mesh=mesh)
    opt_b = make_optimizer().init(b)
    # Per-step batches: a leading step axis on every rank's shard
    tok, tgt = ([torch.stack(pieces) for pieces in zip(
        *(shard(bt[i]) for bt in batches))] for i in range(2))
    last = make_multi_step(cfg)(b, opt_b, tok, tgt, 2)
    assert torch.equal(last[0], singles[-1])
    for x, y in zip(leaves(params_to_numpy(a)), leaves(params_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


def test_init_train_state_on_a_mesh_shards_the_unsharded_draw():
    _, cfg = configs()
    _, mesh = meshes(N, **dryrun_mesh_config(N))
    plain, _ = init_train_state(torch.Generator().manual_seed(5), cfg, "cpu")
    sharded, opt = init_train_state(torch.Generator().manual_seed(5), cfg,
                                    mesh=mesh)
    assert isinstance(sharded, ShardedTransformer)
    for x, y in zip(leaves(params_to_numpy(plain)),
                    leaves(params_to_numpy(sharded))):
        np.testing.assert_array_equal(x, y)
    assert len(opt.param_groups[0]["params"]) == N * len(list(
        plain.parameters()))
    again = shard_params(plain, mesh, cfg)
    for x, y in zip(leaves(params_to_numpy(again)),
                    leaves(params_to_numpy(sharded))):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# dryrun_multichip end to end
# ---------------------------------------------------------------------------

def dryrun_np_params(stages=("train", "pp", "moe", "moe_pp")) -> dict:
    """The JAX package's weights for each stage of the dry run, from the
    reference's keys: ``init_params`` at 0 (stage 3) and 2 (3b),
    ``init_moe_params`` at 1 (stage 4) and 3 (stage 5: two layers, no
    aux)."""
    from faabric_tpu.models.moe import MoEConfig as JaxMoEConfig
    from faabric_tpu.models.moe import init_moe_params

    jcfg, _ = configs()
    moe = JaxMoEConfig(**{**TINY, "n_layers": 1}, n_experts=2,
                       compute_dtype=jnp.float32)
    make = {"train": lambda: init_params(jax.random.PRNGKey(0), jcfg),
            "pp": lambda: init_params(jax.random.PRNGKey(2), jcfg),
            "moe": lambda: init_moe_params(jax.random.PRNGKey(1), moe),
            "moe_pp": lambda: init_moe_params(jax.random.PRNGKey(3),
                                              dataclasses.replace(
                                                  moe, n_layers=2,
                                                  aux_loss_weight=0.0))}
    return {k: jax.tree.map(np.asarray, make[k]()) for k in stages}


@functools.lru_cache(maxsize=None)
def jax_dryrun_later_stages(n):
    """JAX's stages 3b and 4 on n virtual devices, as
    ``__graft_entry__.py`` runs them on the one ``RandomState(0)``: the
    GPipe loss and the MoE step's loss."""
    from faabric_tpu.models.moe import make_moe_train_step as jax_moe_step
    from faabric_tpu.models.moe import moe_param_shardings
    from faabric_tpu.parallel.pipeline import (
        make_pp_loss,
        microbatch,
        pp_data_sharding,
        pp_param_shardings,
        stack_block_params,
    )

    jcfg, _ = configs()
    mc = dryrun_mesh_config(n)
    tok, _ = dryrun_batch(n // (mc["tp"] * mc["sp"]), mc["sp"])
    rng = np.random.RandomState(0)
    for _ in range(2):  # stage 3's draws
        rng.randint(0, 128, tok.shape, dtype=np.int32)
    devices = jax.devices()[:n]
    pp_mesh = jax_build_mesh(devices, JaxMeshConfig(
        tp=2 if n % 4 == 0 else 1, sp=2 if n % 16 == 0 else 1, pp=2))
    pbatch = 4 * pp_mesh.shape["dp"]
    ptok, ptgt = (rng.randint(0, 128, (pbatch, tok.shape[1]), dtype=np.int32)
                  for _ in range(2))
    raw = init_params(jax.random.PRNGKey(2), jcfg)
    pp_loss = jax.jit(make_pp_loss(jcfg, pp_mesh))(
        jax.device_put(stack_block_params(raw),
                       pp_param_shardings(pp_mesh, jcfg)),
        *(jax.device_put(microbatch(jnp.asarray(a), 4),
                         pp_data_sharding(pp_mesh)) for a in (ptok, ptgt)))
    moe_params = dryrun_np_params(("moe",))["moe"]
    from faabric_tpu.models.moe import MoEConfig as JaxMoEConfig

    moe_cfg = JaxMoEConfig(**{**TINY, "n_layers": 1}, n_experts=2,
                           compute_dtype=jnp.float32)
    moe_mesh = jax_build_mesh(devices, JaxMeshConfig(tp=1, ep=2))
    opt = jax_make_optimizer()
    params = jax.device_put(moe_params, moe_param_shardings(moe_mesh, moe_cfg))
    mb = max(2, 2 * moe_mesh.shape["dp"])
    mtok = jnp.asarray(rng.randint(0, 128, (mb, 16), dtype=np.int32))
    _, _, moe_loss = jax_moe_step(moe_cfg, moe_mesh, opt)(
        params, opt.init(params), mtok, mtok)
    return float(pp_loss), float(moe_loss)


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip_stages_one_to_three_match_jax(n):
    """Stages 1-3 on CPU ranks from JAX's weights: the gang through the
    port's planner, the stage-2 allreduce, and a stage-3 loss within 1e-5
    of JAX's ``make_train_step`` on the same mesh (5.2668 at n = 8)."""
    from faabric_tpu_torch.executor import get_executor_factory
    from tests.conftest import next_port_base

    want, _ = jax_dryrun_step(n)
    result = dryrun_multichip(n, device="cpu",
                              np_params=dryrun_np_params(("train",)),
                              port_base=next_port_base())
    assert abs(result.loss - want) <= 1e-5
    if n == 8:
        assert round(result.loss, 4) == 5.2668
    with pytest.raises(RuntimeError):
        get_executor_factory()


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip_stages_3b_to_5_match_jax(n):
    """Stages 3b-5 from JAX's weights (each stage's own key): at n = 8
    the reference's four numbers (``MULTICHIP_r05.json``: loss 5.2668,
    pp_loss 5.3683, moe_loss 5.4997, moe_pp_loss 5.3607) to 4 places; at
    n = 4 the pp and MoE losses within 1e-5 of JAX's stages run here,
    and stage 5 skipped as the reference skips it. The run's own checks
    (pp against dense, GPipe against 1F1B, 1F1B against the stage-3 step,
    the MoE pipeline against ``moe_loss_fn``, all at 1e-4) pass inside
    it."""
    from tests.conftest import next_port_base

    result = dryrun_multichip(n, device="cpu", np_params=dryrun_np_params(),
                              port_base=next_port_base())
    if n == 8:
        assert [round(x, 4) for x in result] == [5.2668, 5.3683, 5.4997,
                                                 5.3607]
    else:
        pp_loss, moe_loss = jax_dryrun_later_stages(n)
        assert abs(result.pp_loss - pp_loss) <= 1e-5
        assert abs(result.moe_loss - moe_loss) <= 1e-5
        assert result.moe_pp_loss is None


def test_dryrun_multichip_from_the_ports_own_init():
    from tests.conftest import next_port_base

    result = dryrun_multichip(4, device="cpu", port_base=next_port_base())
    assert np.isfinite(result.loss) and 4.0 < result.loss < 6.0
    assert all(np.isfinite(x) and 4.0 < x < 6.0 for x in result[1:3])
    assert result.moe_pp_loss is None
    odd = dryrun_multichip(3, device="cpu", port_base=next_port_base())
    assert np.isfinite(odd.loss) and odd[1:] == (None, None, None)


def test_dryrun_multichip_leaves_the_callers_state_and_refuses_a_busy_planner(
        monkeypatch):
    """The run removes only the host and the two aliases it made; a
    planner that already holds hosts is refused, not wiped; and the tiny
    config's head dim 8 on the card raises before stage 1."""
    import faabric_tpu_torch.entry as entry_mod
    from faabric_tpu_torch.planner import get_planner
    from faabric_tpu_torch.transport import (
        register_host_alias,
        unregister_host_alias,
    )
    from faabric_tpu_torch.transport.common import get_host_alias_offset
    from tests.conftest import next_port_base

    planner = get_planner()
    register_host_alias("callers-host", "127.0.0.1", 5)
    try:
        assert np.isfinite(dryrun_multichip(2, device="cpu",
                                            port_base=next_port_base()).loss)
        assert get_host_alias_offset("callers-host") == 5
        assert get_host_alias_offset("dryrun-host") == 0
        assert planner.get_available_hosts() == []
        planner.register_host("callers-worker", 4)
        try:
            with pytest.raises(RuntimeError, match="already holds hosts"):
                dryrun_multichip(2, device="cpu")
            assert planner.is_host_registered("callers-worker")
        finally:
            planner.remove_host("callers-worker")
    finally:
        unregister_host_alias("callers-host")
    monkeypatch.setattr(entry_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="head dim 8"):
        dryrun_multichip(2)
    # The MoE stages' config is held to the kernels' head dims too
    wide = dataclasses.replace(DRYRUN_CONFIG, d_model=64, n_heads=1)
    with pytest.raises(ValueError, match="head dim 8"):
        dryrun_multichip(2, cfg=wide)
