"""The port's pipeline (``parallel/pipeline.py``) against the JAX package.

Mirrors ``tests/unit/test_pipeline.py`` case by case at its tolerances.
Both sides start from the same JAX ``init_params`` weights and
``RandomState`` batches (fp32 compute). The port runs 8 ranks that all
alias the ``cpu`` device; its losses and per-parameter gradients are
held against the JAX package's dense (pp = 1) ``loss_fn`` and
``jax.grad``, which is what the reference's own pipeline tests hold its
pipeline to, and the two schedules against each other. On the CPU every
pp hop takes the ring-permute kernel's plain version; the hop counts
are held to ``hop_counts`` here and the kernel's launches on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 15).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from faabric_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from faabric_tpu.models import init_params  # noqa: E402
from faabric_tpu.models import init_train_state as jax_init_train_state  # noqa: E402
from faabric_tpu.models import loss_fn as jax_loss_fn  # noqa: E402
from faabric_tpu.models import make_optimizer as jax_make_optimizer  # noqa: E402
from faabric_tpu.models import make_train_step as jax_make_train_step  # noqa: E402
from faabric_tpu.models.moe import MoEConfig as JaxMoEConfig  # noqa: E402
from faabric_tpu.models.moe import init_moe_params  # noqa: E402
from faabric_tpu.models.moe import moe_loss_fn as jax_moe_loss_fn  # noqa: E402
from faabric_tpu.parallel import MeshConfig as JaxMeshConfig  # noqa: E402
from faabric_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from faabric_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from faabric_tpu_torch.models import (  # noqa: E402
    ModelConfig,
    MoEConfig,
    Transformer,
    init_train_state,
    loss_fn,
    make_optimizer,
    params_from_jax,
    params_to_numpy,
    restore_train_state,
    save_train_state,
)
from faabric_tpu_torch.models.transformer import _leaves, _tree  # noqa: E402
from faabric_tpu_torch.parallel import MeshConfig, build_mesh  # noqa: E402
from faabric_tpu_torch.parallel.pipeline import (  # noqa: E402
    PipelinedTransformer,
    bubble_fraction,
    hop_counts,
    init_pp_train_state,
    make_pp_1f1b_value_and_grad,
    make_pp_loss,
    make_pp_train_step,
    microbatch,
    n_ticks,
    n_ticks_1f1b,
    pp_data_sharding,
    pp_param_shardings,
    ring_slots,
    schedule,
    stack_block_params,
    unstack_block_params,
)

CPU = torch.device("cpu")
TINY = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_ff=64,
            max_seq=32)
MOE = dict(vocab_size=32, d_model=16, n_layers=2, n_heads=2, d_ff=32,
           max_seq=16, n_experts=4, aux_loss_weight=0.0, remat=False)


def configs(**changes):
    kw = {**TINY, **changes}
    return (JaxConfig(**kw, compute_dtype=jnp.float32),
            ModelConfig(**kw, compute_dtype=torch.float32))


def moe_configs(**changes):
    kw = {**MOE, **changes}
    return (JaxMoEConfig(**kw, compute_dtype=jnp.float32),
            MoEConfig(**kw, compute_dtype=torch.float32))


def data(batch=16, seq=32, seed=0, vocab=64):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (batch, seq)).astype(np.int32),
            rng.randint(0, vocab, (batch, seq)).astype(np.int32))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def mesh8(**shape):
    return build_mesh([CPU] * 8, MeshConfig(**shape))


def shard_mb(mesh, arr, m):
    return pp_data_sharding(mesh).shard(microbatch(arr, m))


def pp_grads(model) -> dict:
    """The model's gradients, gathered from the shards, in the dense
    (per-layer) layout, by name."""
    stacked = _tree({n: spec.gather([p.grad for p in model.copies(n)])
                     for n, spec in model.specs.items()})
    return {n: g.numpy() for n, g in _leaves(unstack_block_params(stacked))}


@functools.lru_cache(maxsize=None)
def jax_dense(seed, data_seed, batch=16, n_layers=4):
    """JAX's dense loss and per-parameter gradients (by name)."""
    jcfg, _ = configs(n_layers=n_layers)
    params = init_params(jax.random.PRNGKey(seed), jcfg)
    tok, tgt = data(batch=batch, seed=data_seed)
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn),
                          static_argnums=(3,))(params, tok, tgt, jcfg)
    return float(loss), dict(_leaves(np_tree(grads)))


@functools.lru_cache(maxsize=None)
def jax_moe(seed, data_seed):
    """JAX's MoE loss (aux 0) and per-parameter gradients (by name)."""
    jcfg, _ = moe_configs()
    params = init_moe_params(jax.random.PRNGKey(seed), jcfg)
    tok, tgt = data(batch=4, seq=16, seed=data_seed, vocab=32)
    loss, grads = jax.jit(jax.value_and_grad(jax_moe_loss_fn),
                          static_argnums=(3,))(params, tok, tgt, jcfg)
    return float(loss), dict(_leaves(np_tree(grads)))


def assert_grads(got: dict, want: dict, atol: float) -> None:
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# Schedule math and layout
# ---------------------------------------------------------------------------

def test_schedule_math():
    assert n_ticks(1, 4) == 4
    assert n_ticks(4, 8) == 11
    assert bubble_fraction(1, 4) == 0.0
    assert bubble_fraction(2, 2) == pytest.approx(1 / 3)
    sched = schedule(3, 4)
    assert len(sched) == 6
    assert sched[0] == [0, None, None]
    assert sched[2] == [2, 1, 0]
    assert sched[5] == [None, None, 3]
    seen = {(s, m) for row in sched for s, m in enumerate(row) if m is not None}
    assert seen == {(s, m) for s in range(3) for m in range(4)}
    for s_, m_ in [(1, 1), (2, 4), (3, 4), (4, 8), (2, 3)]:
        assert schedule(s_, m_) == jax_pipeline.schedule(s_, m_)
        assert n_ticks(s_, m_) == jax_pipeline.n_ticks(s_, m_)
        assert bubble_fraction(s_, m_) == jax_pipeline.bubble_fraction(s_, m_)


def test_microbatch_reshape():
    tokens, _ = data(batch=8)
    for x in (tokens, torch.as_tensor(tokens)):
        mb = microbatch(x, 4)
        assert tuple(mb.shape) == (4, 2, 32)
        np.testing.assert_array_equal(np.asarray(mb),
                                      np.asarray(jax_pipeline.microbatch(
                                          jnp.asarray(tokens), 4)))
        with pytest.raises(ValueError):
            microbatch(x, 3)


def test_stack_unstack_roundtrip():
    jcfg, _ = configs()
    params = np_tree(init_params(jax.random.PRNGKey(0), jcfg))
    stacked = stack_block_params(params)
    want = np_tree(jax_pipeline.stack_block_params(params))
    assert dict(_leaves(stacked)).keys() == dict(_leaves(want)).keys()
    for (_, a), (_, b) in zip(_leaves(stacked), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    for (na, a), (nb, b) in zip(_leaves(unstack_block_params(stacked)),
                                _leaves(params)):
        assert na == nb
        np.testing.assert_array_equal(a, b)
    # Tensors stack as tensors
    model = Transformer(configs()[1], device="cpu")
    back = unstack_block_params(stack_block_params(
        {"embed": model.embed, "ln_f": model.ln_f, "lm_head": model.lm_head,
         "blocks": [{k: getattr(b, k) for k in ("ln1", "w1")}
                    for b in model.blocks]}))
    assert torch.equal(back["blocks"][2]["w1"], model.blocks[2].w1)


@pytest.mark.parametrize("moe", [False, True])
def test_pp_param_shardings_are_the_jax_packages_specs(moe):
    jcfg, cfg = moe_configs() if moe else configs()
    shape = dict(dp=2, pp=2, ep=2) if moe else dict(dp=2, tp=2, pp=2)
    jmesh = jax_build_mesh(jax.devices()[:8], JaxMeshConfig(**shape))
    want = jax.tree.map(lambda s: tuple(s.spec),
                        jax_pipeline.pp_param_shardings(jmesh, jcfg),
                        is_leaf=lambda x: hasattr(x, "spec"))
    got = pp_param_shardings(mesh8(**shape), cfg)
    assert set(got["stacked"]) == set(want["stacked"])
    for name, spec in _leaves(got):
        part = name.split(".")
        w = want[part[0]] if len(part) == 1 else want["stacked"][part[1]]
        assert spec.spec == w, name
    assert pp_data_sharding(mesh8(**shape)).spec == (None, "dp", "sp")


# ---------------------------------------------------------------------------
# Numerics against the dense (pp = 1) path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pp,tp", [(2, 1), (4, 1), (2, 2)])
def test_pipeline_loss_matches_dense(pp, tp):
    jcfg, cfg = configs()
    ref, _ = jax_dense(0, 0)
    mesh = mesh8(dp=8 // (pp * tp), tp=tp, pp=pp)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = data()
    losses = make_pp_loss(cfg, mesh)(model, shard_mb(mesh, tok, 4),
                                     shard_mb(mesh, tgt, 4))
    assert len({float(x) for x in losses}) == 1
    assert abs(float(losses[0]) - ref) < 1e-5


def test_pipeline_gradients_match_dense():
    """GPipe's gradients, each summed over the ranks holding it, against
    ``jax.grad`` of the dense loss per parameter (2e-5); every copy of a
    shard holds the same gradient."""
    jcfg, cfg = configs()
    _, want = jax_dense(0, 3)
    mesh = mesh8(dp=4, pp=2)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = data(seed=3)
    loss = make_pp_loss(cfg, mesh)(model, shard_mb(mesh, tok, 4),
                                   shard_mb(mesh, tgt, 4))
    loss[0].backward()
    model.allreduce_grads()
    assert_grads(pp_grads(model), want, 2e-5)
    for name, spec in model.specs.items():
        grads = [p.grad for p in model.copies(name)]
        for group in spec.replica_groups():
            assert all(torch.equal(grads[group[0]], grads[r]) for r in group)


def test_pipeline_train_step_matches_dense():
    """Three AdamW steps on pp = 2 track JAX's dense steps (rtol 1e-5),
    from ``init_train_state(PRNGKey(1))``."""
    jcfg, cfg = configs()
    tok, tgt = data(seed=5)
    jopt = jax_make_optimizer()
    params, state = jax_init_train_state(jax.random.PRNGKey(1), jcfg, None,
                                         jopt)
    start = np_tree(params)
    jstep = jax_make_train_step(jcfg, None, jopt)
    dense = []
    for _ in range(3):
        params, state, loss = jstep(params, state, jnp.asarray(tok),
                                    jnp.asarray(tgt))
        dense.append(float(loss))
    mesh = mesh8(dp=4, pp=2)
    spec = make_optimizer()
    model = PipelinedTransformer(cfg, mesh, start)
    opt = spec.init(model)
    step = make_pp_train_step(cfg, spec, n_microbatches=4)
    got = [float(step(model, opt, tok, tgt)[0]) for _ in range(3)]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, dense, rtol=1e-5)


def test_pipeline_rejects_bad_configs():
    mesh = mesh8(dp=4, pp=2)
    with pytest.raises(ValueError, match="not divisible"):
        make_pp_loss(ModelConfig(**{**TINY, "n_layers": 3}), mesh)
    with pytest.raises(ValueError, match="MoE config"):
        make_pp_loss(configs()[1], mesh8(dp=2, ep=2, pp=2))
    with pytest.raises(ValueError, match="Unknown pipeline schedule"):
        make_pp_train_step(configs()[1], schedule_name="interleaved")
    # A schedule refuses a model of another config, and a plain model
    _, cfg = configs()
    model = PipelinedTransformer(cfg, mesh, np_tree(init_params(
        jax.random.PRNGKey(0), configs()[0])))
    tok = shard_mb(mesh, data()[0], 4)
    with pytest.raises(ValueError, match="schedule built for"):
        make_pp_loss(dataclasses.replace(cfg, rope_theta=500.0), mesh)(
            model, tok, tok)
    with pytest.raises(TypeError, match="PipelinedTransformer"):
        make_pp_loss(cfg, mesh)(Transformer(cfg, device="cpu"), tok, tok)
    with pytest.raises(ValueError, match="token shards"):
        make_pp_loss(cfg, mesh)(model, tok[:4], tok[:4])


def test_pipeline_deep_config_pp4_tp2():
    """8 layers over pp = 4 stages with tp = 2 (dp = 1): loss matches
    dense."""
    jcfg, cfg = configs(n_layers=8)
    ref, _ = jax_dense(4, 9, batch=4, n_layers=8)
    mesh = mesh8(dp=1, tp=2, pp=4)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_params(jax.random.PRNGKey(4), jcfg)))
    tok, tgt = data(batch=4, seed=9)
    loss = make_pp_loss(cfg, mesh)(model, shard_mb(mesh, tok, 4),
                                   shard_mb(mesh, tgt, 4))
    assert abs(float(loss[0]) - ref) < 1e-5


def test_pipeline_checkpoint_interop(tmp_path):
    """A pipelined model saves its weights in the dense layout, the one
    checkpoint format: they restore into a fresh pipeline (same next
    loss), into a dense model and into a pipeline of another mesh, and
    equal ``unstack_block_params`` of the stepped weights."""
    jcfg, cfg = configs()
    mesh = mesh8(dp=4, pp=2)
    spec = make_optimizer()
    model, opt = init_pp_train_state(torch.Generator().manual_seed(6), cfg,
                                     mesh, spec)
    step = make_pp_train_step(cfg, spec, n_microbatches=4)
    tok, tgt = data(seed=7)
    step(model, opt, tok, tgt)
    path = str(tmp_path / "ck.pt")
    save_train_state(path, model, opt, step=1)

    fresh, fresh_opt = init_pp_train_state(torch.Generator().manual_seed(9),
                                           cfg, mesh, spec)
    assert restore_train_state(path, fresh, fresh_opt) == 1
    saved = torch.load(path, weights_only=True)["params"]
    want = unstack_block_params(params_to_numpy(model))
    for (na, a), (nb, b) in zip(_leaves(saved), _leaves(want)):
        assert na == nb
        np.testing.assert_array_equal(a.numpy(), b)
    # Same weights and optimizer state: the same next step, bit for bit
    a = float(step(model, opt, tok, tgt)[0])
    b = float(step(fresh, fresh_opt, tok, tgt)[0])
    assert a == b
    # The weights alone restore into other layouts of the config
    dense = Transformer(cfg, device="cpu")
    assert restore_train_state(path, dense) == 1
    other = PipelinedTransformer(cfg, mesh8(dp=1, tp=2, pp=4), want)
    restore_train_state(path, other)
    flat = dict(_leaves(params_to_numpy(dense)))
    for n, x in _leaves(unstack_block_params(params_to_numpy(other))):
        np.testing.assert_array_equal(x, flat[n])
    tok_d, tgt_d = (torch.as_tensor(x) for x in data(seed=11))
    with torch.no_grad():
        np.testing.assert_allclose(
            float(loss_fn(dense, tok_d, tgt_d)),
            float(make_pp_loss(cfg, mesh)(
                params_from_jax(params_to_numpy(dense), cfg, mesh=mesh),
                shard_mb(mesh, tok_d, 4), shard_mb(mesh, tgt_d, 4))[0]),
            rtol=1e-6)


def test_checkpoint_of_the_older_format_raises_naming_it(tmp_path):
    """A file that holds the model's state_dict (the format before one
    format for every layout) is refused with a ValueError naming it, not
    a KeyError; its weights still load through ``load_state_dict``."""
    _, cfg = configs()
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    opt = make_optimizer().init(model)
    path = str(tmp_path / "old.pt")
    torch.save({"model": model.state_dict(), "opt": opt.state_dict(),
                "step": 3}, path)
    fresh = Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="older format"):
        restore_train_state(path, fresh)
    fresh.load_state_dict(torch.load(path, weights_only=True)["model"])
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_params_from_jax_takes_either_layout_and_gives_the_pipelines_back():
    jcfg, cfg = configs()
    params = np_tree(init_params(jax.random.PRNGKey(2), jcfg))
    stacked = np_tree(jax_pipeline.stack_block_params(params))
    mesh = mesh8(dp=2, tp=2, pp=2)
    for tree in (params, stacked):
        model = params_from_jax(tree, cfg, mesh=mesh)
        assert isinstance(model, PipelinedTransformer)
        for (na, a), (nb, b) in zip(_leaves(params_to_numpy(model)),
                                    _leaves(stacked)):
            assert na == nb
            np.testing.assert_array_equal(a, b)
    plain = params_from_jax(stacked, cfg, device="cpu")
    for (na, a), (nb, b) in zip(_leaves(params_to_numpy(plain)),
                                _leaves(params)):
        assert na == nb
        np.testing.assert_array_equal(a, b)
    # Each rank holds its stage's slab, split over tp
    r = mesh.rank_at(dp=1, tp=1, pp=1)
    np.testing.assert_array_equal(
        model.ranks[r].stacked.wqkv.detach().numpy(),
        stacked["stacked"]["wqkv"][2:, :, :, 2:])


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

def test_1f1b_schedule_math():
    assert n_ticks_1f1b(1, 4) == 4
    assert n_ticks_1f1b(4, 8) == 14
    assert ring_slots(1) == 1
    assert ring_slots(4) == 7
    for s_ in (2, 3, 4):
        for s in range(s_):
            assert 2 * (s_ - 1) - 2 * s < ring_slots(s_)
        assert n_ticks_1f1b(s_, 5) == jax_pipeline.n_ticks_1f1b(s_, 5)
        assert ring_slots(s_) == jax_pipeline.ring_slots(s_)
    assert hop_counts(2, 4) == {"gpipe": 8, "1f1b": 10, "loss": 4}


@pytest.mark.parametrize("pp,tp,m", [(2, 1, 4), (4, 1, 8), (2, 2, 4)])
def test_1f1b_loss_and_grads_match_autodiff_gpipe(pp, tp, m):
    """1F1B against GPipe (loss 1e-5, gradients 3e-5 per parameter), and
    both against ``jax.grad`` of the dense loss."""
    jcfg, cfg = configs()
    ref, want = jax_dense(0, 5)
    mesh = mesh8(dp=8 // (pp * tp), tp=tp, pp=pp)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = (shard_mb(mesh, a, m) for a in data(seed=5))
    loss_1f1b = make_pp_1f1b_value_and_grad(cfg, mesh)(model, tok, tgt)
    g_1f1b = pp_grads(model)
    model.zero_grad(set_to_none=True)
    loss_ref = make_pp_loss(cfg, mesh)(model, tok, tgt)
    loss_ref[0].backward()
    model.allreduce_grads()
    g_ref = pp_grads(model)
    assert abs(float(loss_1f1b[0]) - float(loss_ref[0])) < 1e-5
    assert abs(float(loss_1f1b[0]) - ref) < 1e-5
    assert_grads(g_1f1b, g_ref, 3e-5)
    assert_grads(g_1f1b, want, 3e-5)


def test_1f1b_train_step_matches_gpipe_schedule():
    tokens, targets = data(seed=9)
    _, cfg = configs()
    mesh = mesh8(dp=4, pp=2)
    losses = {}
    for name in ("gpipe", "1f1b"):
        model, opt = init_pp_train_state(torch.Generator().manual_seed(1),
                                         cfg, mesh)
        step = make_pp_train_step(cfg, n_microbatches=4, schedule_name=name)
        losses[name] = [float(step(model, opt, tokens, targets)[0])
                        for _ in range(3)]
    np.testing.assert_allclose(losses["1f1b"], losses["gpipe"], atol=2e-5)
    assert losses["1f1b"][-1] < losses["1f1b"][0]


@pytest.mark.parametrize("seed_rank", [0, 5])
def test_gpipe_loss_backward_is_the_steps_schedule(seed_rank):
    """``make_pp_loss``'s copies backpropagate through GPipe's explicit
    schedule: seeding any one rank's copy with 1 gives every weight
    bitwise the gradient the step's schedule leaves (each head seeded
    with 1), as the loss allreduce's backward gives every share the sum
    of the copies' cotangents."""
    from faabric_tpu_torch.parallel.pipeline import _gpipe_value_and_grad

    jcfg, cfg = configs()
    mesh = mesh8(dp=2, tp=2, pp=2)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = (shard_mb(mesh, a, 4) for a in data(seed=8))
    want_loss = _gpipe_value_and_grad(model, tok, tgt)
    want = pp_grads(model)
    model.zero_grad(set_to_none=True)
    loss = make_pp_loss(cfg, mesh)(model, tok, tgt)
    assert all(torch.equal(a, b) for a, b in zip(loss, want_loss))
    loss[seed_rank].backward()
    model.allreduce_grads()
    got = pp_grads(model)
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_array_equal(got[name], g, err_msg=name)


@pytest.mark.parametrize("schedule_name", ["gpipe", "1f1b"])
def test_hops_are_whole_ring_shifts_of_the_schedules_count(schedule_name,
                                                           monkeypatch):
    """Every stage-to-stage hop is one whole-ring shift per pp group,
    through ``ring_permute`` (the kernel on the card), and a step makes
    ``hop_counts`` of them: forward and backward for GPipe, one each way
    a tick for 1F1B, none after the last tick."""
    import importlib

    ring_mod = importlib.import_module("faabric_tpu_torch.ops.ring_permute")
    calls = []
    real = ring_mod.ring_permute

    def counted(ins, shift, outs=None):
        calls.append((len(ins), shift % len(ins)))
        return real(ins, shift, outs)

    monkeypatch.setattr(ring_mod, "ring_permute", counted)
    _, cfg = configs()
    mesh = mesh8(dp=2, tp=2, pp=2)
    model, opt = init_pp_train_state(torch.Generator().manual_seed(1), cfg,
                                     mesh)
    step = make_pp_train_step(cfg, n_microbatches=4,
                              schedule_name=schedule_name)
    step(model, opt, *data(seed=2))
    groups = mesh.size // mesh.shape["pp"]
    assert len(calls) == hop_counts(2, 4)[schedule_name] * groups
    assert all(n == 2 for n, _ in calls)
    calls.clear()
    with torch.no_grad():
        make_pp_loss(cfg, mesh)(model, *(shard_mb(mesh, a, 4)
                                         for a in data(seed=2)))
    assert len(calls) == hop_counts(2, 4)["loss"] * groups


def test_init_pp_train_state_draws_as_init_train_state():
    _, cfg = configs()
    mesh = mesh8(dp=2, tp=2, pp=2)
    model, opt = init_pp_train_state(torch.Generator().manual_seed(3), cfg,
                                     mesh)
    plain, _ = init_train_state(torch.Generator().manual_seed(3), cfg, "cpu")
    flat = dict(_leaves(params_to_numpy(plain)))
    for name, x in _leaves(unstack_block_params(params_to_numpy(model))):
        np.testing.assert_array_equal(x, flat[name])
    assert len(opt.param_groups[0]["params"]) == len(list(model.parameters()))
    # One copy of each shard: the whole model's weights once each
    n_unique = sum(p.numel() for p in model.unique_parameters())
    assert n_unique == sum(p.numel() for p in plain.parameters())


# ---------------------------------------------------------------------------
# MoE stages: pp x ep (x tp)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [dict(dp=2, pp=2, ep=2),
                                   dict(pp=2, ep=2, tp=2)])
def test_pipeline_moe_loss_matches_global(shape):
    """MoE stages in the pipeline (experts over ep, their hidden over tp,
    layers over pp): the loss equals JAX's unsharded ``moe_loss_fn`` with
    aux 0 (1e-5)."""
    jcfg, cfg = moe_configs()
    ref, _ = jax_moe(0, 3)
    mesh = mesh8(**shape)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_moe_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = data(batch=4, seq=16, seed=3, vocab=32)
    loss = make_pp_loss(cfg, mesh)(model, shard_mb(mesh, tok, 2),
                                   shard_mb(mesh, tgt, 2))
    assert abs(float(loss[0]) - ref) < 1e-5


@pytest.mark.parametrize("shape", [dict(dp=2, pp=2, ep=2),
                                   dict(pp=2, ep=2, tp=2)])
def test_pipeline_moe_gradients_of_both_schedules_match_jax_grad(shape):
    """GPipe's and 1F1B's gradients through MoE stages (routing, the
    ep-local experts, the allreduces over tp and ep) against ``jax.grad``
    of JAX's unsharded ``moe_loss_fn`` per parameter (3e-5)."""
    jcfg, cfg = moe_configs()
    _, want = jax_moe(0, 3)
    mesh = mesh8(**shape)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_moe_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = (shard_mb(mesh, a, 2)
                for a in data(batch=4, seq=16, seed=3, vocab=32))
    loss = make_pp_loss(cfg, mesh)(model, tok, tgt)
    loss[0].backward()
    model.allreduce_grads()
    assert_grads(pp_grads(model), want, 3e-5)
    make_pp_1f1b_value_and_grad(cfg, mesh)(model, tok, tgt)
    assert_grads(pp_grads(model), want, 3e-5)


def test_pipeline_moe_train_step_schedules_agree():
    _, cfg = moe_configs()
    tokens, targets = data(batch=4, seq=16, seed=11, vocab=32)
    mesh = mesh8(dp=2, pp=2, ep=2)
    losses = {}
    for name in ("gpipe", "1f1b"):
        model, opt = init_pp_train_state(torch.Generator().manual_seed(1),
                                         cfg, mesh)
        step = make_pp_train_step(cfg, n_microbatches=2, schedule_name=name)
        losses[name] = [float(step(model, opt, tokens, targets)[0])
                        for _ in range(3)]
    np.testing.assert_allclose(losses["1f1b"], losses["gpipe"], atol=2e-5)
    assert losses["1f1b"][-1] < losses["1f1b"][0]


def test_pipeline_moe_rejects_bad_ep():
    _, cfg = moe_configs(n_experts=6)
    with pytest.raises(ValueError, match="divisible by ep"):
        make_pp_loss(cfg, mesh8(pp=2, ep=4))


# ---------------------------------------------------------------------------
# Sequence parallelism inside pipeline stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [dict(dp=2, sp=2, pp=2),
                                   dict(sp=2, pp=2, tp=2)])
def test_pipeline_sp_loss_matches_dense(shape):
    jcfg, cfg = configs()
    ref, _ = jax_dense(0, 0)
    mesh = mesh8(**shape)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = data()
    loss = make_pp_loss(cfg, mesh)(model, shard_mb(mesh, tok, 4),
                                   shard_mb(mesh, tgt, 4))
    assert abs(float(loss[0]) - ref) < 1e-5


def test_pipeline_sp_1f1b_gradients_match_dense():
    jcfg, cfg = configs()
    _, want = jax_dense(0, 0)
    mesh = mesh8(dp=2, sp=2, pp=2)
    model = PipelinedTransformer(
        cfg, mesh, np_tree(init_params(jax.random.PRNGKey(0), jcfg)))
    tok, tgt = data()
    make_pp_1f1b_value_and_grad(cfg, mesh)(model, shard_mb(mesh, tok, 4),
                                           shard_mb(mesh, tgt, 4))
    assert_grads(pp_grads(model), want, 3e-5)


def test_pipeline_sp_train_step_schedules_agree():
    _, cfg = configs()
    tokens, targets = data(seed=13)
    mesh = mesh8(dp=2, sp=2, pp=2)
    losses = {}
    for name in ("gpipe", "1f1b"):
        model, opt = init_pp_train_state(torch.Generator().manual_seed(1),
                                         cfg, mesh)
        step = make_pp_train_step(cfg, n_microbatches=4, schedule_name=name)
        losses[name] = [float(step(model, opt, tokens, targets)[0])
                        for _ in range(3)]
    np.testing.assert_allclose(losses["1f1b"], losses["gpipe"], atol=2e-5)
    assert losses["1f1b"][-1] < losses["1f1b"][0]


def test_pipeline_moe_sp_rejected():
    _, cfg = moe_configs()
    with pytest.raises(ValueError, match="compose with sp"):
        make_pp_loss(cfg, mesh8(sp=2, pp=2, ep=2))
    with pytest.raises(ValueError, match="compose with sp"):
        PipelinedTransformer(cfg, mesh8(sp=2, pp=2, ep=2), np_tree(
            init_moe_params(jax.random.PRNGKey(0), moe_configs()[0])))


def test_pipeline_stage_body_is_plain_whatever_the_config_asks():
    """The stage body runs plain attention and norm, as the reference's
    ignores ``attention_impl``: "flash" and "ring" give the plain
    loss bit for bit and launch nothing."""
    jcfg, cfg = configs()
    params = np_tree(init_params(jax.random.PRNGKey(0), jcfg))
    mesh = mesh8(dp=2, sp=2, pp=2)
    tok, tgt = (shard_mb(mesh, a, 4) for a in data())
    losses = []
    for att in ("reference", "flash", "ring"):
        c = dataclasses.replace(cfg, attention_impl=att, norm_impl="fused")
        model = PipelinedTransformer(c, mesh, params)
        assert model.stage_cfg.attention_impl == "reference"
        with torch.no_grad():
            losses.append(float(make_pp_loss(c, mesh)(model, tok, tgt)[0]))
    assert losses[0] == losses[1] == losses[2]
