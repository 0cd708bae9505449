"""The port's MoE family (``models/moe.py``) against the JAX package.

Mirrors ``tests/unit/test_moe.py`` case by case at its tolerances, and
adds per-parameter gradients against ``jax.grad`` and the router's tie
order. Both sides start from the same JAX ``init_moe_params`` weights
and ``RandomState`` batches (fp32 compute). The sharded cases run 8
ranks that all alias the ``cpu`` device; on the CPU attention and norm
take their plain versions on both sides.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from faabric_tpu.models.moe import MoEConfig as JaxMoEConfig  # noqa: E402
from faabric_tpu.models.moe import _moe_layer as jax_moe_layer  # noqa: E402
from faabric_tpu.models.moe import init_moe_params  # noqa: E402
from faabric_tpu.models.moe import make_moe_train_step as jax_make_moe_step  # noqa: E402
from faabric_tpu.models.moe import moe_dispatch_combine as jax_dispatch  # noqa: E402
from faabric_tpu.models.moe import moe_forward as jax_moe_forward  # noqa: E402
from faabric_tpu.models.moe import moe_loss_fn as jax_moe_loss_fn  # noqa: E402
from faabric_tpu.models.moe import moe_param_shardings as jax_moe_shardings  # noqa: E402
from faabric_tpu.models.train import make_optimizer as jax_make_optimizer  # noqa: E402
from faabric_tpu.parallel import MeshConfig as JaxMeshConfig  # noqa: E402
from faabric_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from faabric_tpu_torch.models import (  # noqa: E402
    MoEConfig,
    MoETransformer,
    ShardedTransformer,
    data_sharding,
    init_moe_train_state,
    make_moe_train_step,
    make_optimizer,
    moe_forward,
    moe_loss_fn,
    moe_param_shardings,
    params_from_jax,
    params_to_numpy,
    restore_train_state,
    save_train_state,
)
from faabric_tpu_torch.models.moe import (  # noqa: E402
    _capacity,
    _moe_layer,
    moe_dispatch_combine,
)
from faabric_tpu_torch.models.transformer import _leaves  # noqa: E402
from faabric_tpu_torch.parallel import MeshConfig, build_mesh  # noqa: E402

CPU = torch.device("cpu")
BASE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_seq=64, n_experts=4)


def configs(**changes):
    kw = {**BASE, **changes}
    return (JaxMoEConfig(**kw, compute_dtype=jnp.float32),
            MoEConfig(**kw, compute_dtype=torch.float32))


def batch(b=4, s=32, seed=0, vocab=128):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int32),
            rng.randint(0, vocab, (b, s)).astype(np.int32))


def np_params(jcfg, seed):
    return jax.tree.map(np.asarray, init_moe_params(jax.random.PRNGKey(seed),
                                                    jcfg))


def mesh8(**shape):
    return build_mesh([CPU] * 8, MeshConfig(**shape))


def by_name(tree) -> dict:
    return {n: np.asarray(a) for n, a in _leaves(tree)}


def sharded_grads(model) -> dict:
    return {n: spec.gather([p.grad for p in model.copies(n)]).numpy()
            for n, spec in model.specs.items()}


def blk_of(params, i=0):
    """Block i of a pytree as the attribute object the port's layer
    takes."""
    return type("Blk", (), {k: torch.tensor(np.asarray(v))
                            for k, v in params["blocks"][i].items()})


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(seed, data_seed, **changes):
    jcfg, _ = configs(**changes)
    tok, tgt = batch(seed=data_seed)
    loss, grads = jax.jit(jax.value_and_grad(jax_moe_loss_fn),
                          static_argnums=(3,))(
        init_moe_params(jax.random.PRNGKey(seed), jcfg), tok, tgt, jcfg)
    return float(loss), by_name(jax.tree.map(np.asarray, grads))


@functools.lru_cache(maxsize=None)
def jax_steps(seed, data_seed, n, **changes):
    """n steps of JAX's unsharded MoE train step: the losses."""
    jcfg, _ = configs(**changes)
    opt = jax_make_optimizer()
    params = init_moe_params(jax.random.PRNGKey(seed), jcfg)
    state = opt.init(params)
    step = jax_make_moe_step(jcfg, None, opt)
    tok, tgt = batch(seed=data_seed)
    losses = []
    for _ in range(n):
        params, state, loss = step(params, state, jnp.asarray(tok),
                                   jnp.asarray(tgt))
        losses.append(float(loss))
    return losses


# ---------------------------------------------------------------------------
# The reference's cases
# ---------------------------------------------------------------------------

def test_moe_forward_shapes_and_aux():
    jcfg, cfg = configs()
    params = np_params(jcfg, 0)
    tokens, _ = batch()
    logits, aux = moe_forward(params_from_jax(params, cfg, device="cpu"),
                              torch.as_tensor(tokens))
    assert tuple(logits.shape) == (4, 32, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert 0.9 < float(aux) < float(cfg.n_experts)
    want, want_aux = jax.jit(jax_moe_forward, static_argnums=(2,))(
        init_moe_params(jax.random.PRNGKey(0), jcfg), tokens, jcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


@pytest.mark.parametrize("shape", [dict(dp=2, tp=2, ep=2), dict(dp=4, ep=2),
                                   dict(dp=2, sp=2, ep=2),
                                   dict(dp=1, tp=2, ep=4)])
def test_moe_sharded_matches_single_device(shape):
    """The sharded MoE (routing alike on every rank, each rank's experts,
    allreduces over tp and ep) against the unsharded one: logits at 2e-4,
    aux at 1e-5, every rank's aux the same."""
    jcfg, cfg = configs()
    params = np_params(jcfg, 1)
    tokens, _ = batch()
    with torch.no_grad():
        ref, aux_ref = moe_forward(params_from_jax(params, cfg, device="cpu"),
                                   torch.as_tensor(tokens))
        mesh = mesh8(**shape)
        model = params_from_jax(params, cfg, mesh=mesh)
        assert isinstance(model, ShardedTransformer)
        out, aux = moe_forward(model, data_sharding(mesh).shard(tokens))
    np.testing.assert_allclose(data_sharding(mesh).gather(out).numpy(),
                               ref.numpy(), atol=2e-4)
    assert len({float(a) for a in aux}) == 1
    np.testing.assert_allclose(float(aux[0]), float(aux_ref), atol=1e-5)


def test_moe_train_step_reduces_loss_on_ep_mesh():
    """Four steps over (dp 2, ep 4): falling, finite, and within 1e-5 of
    JAX's unsharded steps from the same weights."""
    jcfg, cfg = configs()
    mesh = mesh8(dp=2, tp=1, ep=4)
    spec = make_optimizer()
    model = params_from_jax(np_params(jcfg, 0), cfg, mesh=mesh)
    opt = spec.init(model)
    step = make_moe_train_step(cfg, spec)
    shard = data_sharding(mesh).shard
    tokens, targets = batch()
    losses = [float(step(model, opt, shard(tokens), shard(targets))[0])
              for _ in range(4)]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(x) for x in losses)
    np.testing.assert_allclose(losses, jax_steps(0, 0, 4), atol=1e-5)


def test_moe_capacity_drops_overflow_tokens():
    """Capacity factor 0.25: most tokens drop to the residual; loss and
    gradients finite and equal to JAX's (gradients per parameter,
    1e-5)."""
    kw = dict(n_layers=1, capacity_factor=0.25)
    jcfg, cfg = configs(**kw)
    model = params_from_jax(np_params(jcfg, 0), cfg, device="cpu")
    tokens, targets = batch()
    loss = moe_loss_fn(model, torch.as_tensor(tokens), torch.as_tensor(targets))
    assert torch.isfinite(loss)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    want_loss, want = jax_value_and_grad(0, 0, **kw)
    assert abs(float(loss) - want_loss) < 1e-5
    for name, p in _leaves(params_to_numpy(model)):
        got = dict(model.named_parameters())[name].grad.numpy()
        np.testing.assert_allclose(got, want[name], atol=1e-5, err_msg=name)


def test_moe_top2_routing_matches_manual():
    """Top-2 with ample capacity: the layer equals a dense per-token
    mixture of the two selected experts with renormalised gates, and
    JAX's layer."""
    jcfg, cfg = configs(vocab_size=16, d_model=8, n_layers=1, n_heads=2,
                        d_ff=16, max_seq=8, router_top_k=2,
                        capacity_factor=4.0)
    params = np_params(jcfg, 3)
    blk = blk_of(params)
    x = np.random.RandomState(3).randn(1, 8, 8).astype(np.float32)
    out, _ = _moe_layer(torch.as_tensor(x), blk, cfg)
    logits = x @ params["blocks"][0]["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    w1, w2 = params["blocks"][0]["w1"], params["blocks"][0]["w2"]
    expected = np.zeros_like(x)
    for t in range(8):
        top2 = np.argsort(probs[0, t])[::-1][:2]
        g = probs[0, t, top2] / probs[0, t, top2].sum()
        for gi, ei in zip(g, top2):
            h = x[0, t] @ w1[ei]
            gelu = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                          * (h + 0.044715 * h ** 3)))
            expected[0, t] += gi * (gelu @ w2[ei])
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-4)
    want, _ = jax.jit(lambda x, b: jax_moe_layer(x, b, jcfg, None))(
        x, params["blocks"][0])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_moe_dropped_tokens_pass_residual_only():
    """Every token forced to expert 0 with room for two: the first two
    (slot order) get its output, the rest exactly zero."""
    jcfg, cfg = configs(vocab_size=16, d_model=8, n_layers=1, n_heads=2,
                        d_ff=16, max_seq=8, router_top_k=1,
                        capacity_factor=1.0)
    params = np_params(jcfg, 4)
    router = np.zeros((8, 4), np.float32)
    router[:, 0] = 100.0
    params["blocks"][0]["router"] = router
    blk = blk_of(params)
    x = (np.abs(np.random.RandomState(4).randn(1, 8, 8)) + 0.1).astype(
        np.float32)
    assert _capacity(cfg, 8) == 2
    out, _ = _moe_layer(torch.as_tensor(x), blk, cfg)
    out = out.numpy()
    assert np.abs(out[0, :2]).max() > 0
    np.testing.assert_allclose(out[0, 2:], 0.0, atol=1e-7)
    want, _ = jax.jit(lambda x, b: jax_moe_layer(x, b, jcfg, None))(
        x, params["blocks"][0])
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-6)


def test_moe_top2_train_step_on_ep_mesh():
    jcfg, cfg = configs(max_seq=32, router_top_k=2)
    mesh = mesh8(dp=2, ep=4)
    spec = make_optimizer()
    model = params_from_jax(np_params(jcfg, 5), cfg, mesh=mesh)
    opt = spec.init(model)
    step = make_moe_train_step(cfg, spec)
    tokens = np.random.RandomState(5).randint(0, 128, (4, 32)).astype(np.int32)
    shard = data_sharding(mesh).shard
    losses = [float(step(model, opt, shard(tokens), shard(tokens))[0])
              for _ in range(3)]
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# Gradients, routing order, layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [None, dict(dp=2, tp=2, ep=2),
                                   dict(dp=2, sp=2, ep=2)])
def test_moe_gradients_match_jax_grad_per_parameter(shape):
    """``moe_loss_fn``'s gradients (aux included), unsharded and sharded
    (each shard's summed over its holders, the aux counted once over the
    tp/ep/sp replicas), against ``jax.grad`` per parameter (1e-5)."""
    jcfg, cfg = configs()
    params = np_params(jcfg, 1)
    tokens, targets = batch(seed=2)
    want_loss, want = jax_value_and_grad(1, 2)
    if shape is None:
        model = params_from_jax(params, cfg, device="cpu")
        loss = moe_loss_fn(model, torch.as_tensor(tokens),
                           torch.as_tensor(targets))
        loss.backward()
        got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    else:
        mesh = mesh8(**shape)
        model = params_from_jax(params, cfg, mesh=mesh)
        shard = data_sharding(mesh).shard
        losses = moe_loss_fn(model, shard(tokens), shard(targets))
        assert len({float(x) for x in losses}) == 1
        loss = losses[0]
        loss.backward()
        model.allreduce_grads()
        got = sharded_grads(model)
    assert abs(float(loss) - want_loss) < 1e-5
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_break_to_the_lowest_expert(k):
    """A zero router ties every expert for every token: the choice goes
    to the lowest index, as ``lax.top_k`` breaks ties, and dispatch,
    combine and aux equal JAX's exactly."""
    jcfg, cfg = configs(router_top_k=k, capacity_factor=2.0)
    x = np.random.RandomState(6).randn(2, 16, 32).astype(np.float32)
    router = np.zeros((32, 4), np.float32)
    got = moe_dispatch_combine(torch.as_tensor(x), torch.as_tensor(router), cfg)
    want = jax.jit(lambda x, r: jax_dispatch(x, r, jcfg))(x, router)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dispatch = got[0].numpy()
    # Experts 0..k-1 take every token up to capacity, no other expert any
    assert dispatch[:, :, k:].sum() == 0
    assert dispatch[:, :, :k].sum() == 2 * k * min(16, _capacity(cfg, 16))


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 0.5), (3, 1.0)])
def test_moe_dispatch_combine_matches_jax(k, cf):
    jcfg, cfg = configs(router_top_k=k, capacity_factor=cf)
    rng = np.random.RandomState(k)
    x = rng.randn(3, 32, 32).astype(np.float32)
    router = (rng.randn(32, 4) / np.sqrt(32)).astype(np.float32)
    got = moe_dispatch_combine(torch.as_tensor(x), torch.as_tensor(router), cfg)
    want = jax.jit(lambda x, r: jax_dispatch(x, r, jcfg))(x, router)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6)


def test_moe_param_shardings_are_the_jax_packages_specs():
    jcfg, cfg = configs()
    shape = dict(dp=2, tp=2, ep=2)
    jmesh = jax_build_mesh(jax.devices()[:8], JaxMeshConfig(**shape))
    want = dict(_leaves(jax.tree.map(lambda s: tuple(s.spec),
                                     jax_moe_shardings(jmesh, jcfg),
                                     is_leaf=lambda x: hasattr(x, "spec"))))
    for name, spec in _leaves(moe_param_shardings(mesh8(**shape), cfg)):
        assert spec.spec == want[name], name


def test_moe_checkpoint_restores_across_layouts(tmp_path):
    """A sharded MoE model's checkpoint (the dense layout's weights)
    restores into an unsharded model with the same forward, and into a
    fresh sharded one with its optimizer: the same next step."""
    _, cfg = configs(n_layers=1)
    mesh = mesh8(dp=2, tp=2, ep=2)
    spec = make_optimizer()
    model, opt = init_moe_train_state(torch.Generator().manual_seed(2), cfg,
                                      optimizer=spec, mesh=mesh)
    plain, _ = init_moe_train_state(torch.Generator().manual_seed(2), cfg,
                                    device="cpu")
    for (na, a), (nb, b) in zip(_leaves(params_to_numpy(model)),
                                _leaves(params_to_numpy(plain))):
        np.testing.assert_array_equal(a, b)
    step = make_moe_train_step(cfg, spec)
    shard = data_sharding(mesh).shard
    tokens, targets = batch(seed=8)
    step(model, opt, shard(tokens), shard(targets))
    path = str(tmp_path / "moe.pt")
    save_train_state(path, model, opt, step=1)
    assert restore_train_state(path, plain) == 1
    with torch.no_grad():
        a = data_sharding(mesh).gather(moe_forward(model, shard(tokens))[0])
        b = moe_forward(plain, torch.as_tensor(tokens))[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)
    fresh, fresh_opt = init_moe_train_state(torch.Generator().manual_seed(7),
                                            cfg, optimizer=spec, mesh=mesh)
    assert restore_train_state(path, fresh, fresh_opt) == 1
    assert float(step(model, opt, shard(tokens), shard(targets))[0]) == float(
        step(fresh, fresh_opt, shard(tokens), shard(targets))[0])


def test_moe_models_refuse_the_dense_entry_points():
    from faabric_tpu_torch.models import ModelConfig, forward, loss_fn

    _, cfg = configs()
    model = MoETransformer(cfg, device="cpu")
    sharded = params_from_jax(params_to_numpy(model), cfg, mesh=mesh8(dp=8))
    tok, tgt = batch(b=8)
    with pytest.raises(TypeError, match="MoEConfig model runs through its own"):
        forward(sharded, data_sharding(sharded.mesh).shard(tok))
    with pytest.raises(TypeError, match="MoEConfig model runs through its own"):
        loss_fn(model, torch.as_tensor(tok), torch.as_tensor(tgt))
    # A MoE tree does not load into the dense config of the same widths
    dense = ModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(ModelConfig)})
    with pytest.raises(ValueError, match="do not fit"):
        params_from_jax(params_to_numpy(model), dense, mesh=mesh8(dp=8))
