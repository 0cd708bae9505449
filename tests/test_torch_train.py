"""PyTorch port's training path against the JAX package.

Small size (vocab 128, d_model 64, 2 layers, 4 heads, S 32) in fp32
compute, so that the comparison is of the algorithm and not of where
each framework rounds to bf16. The JAX ``init_params`` weights reach the
port through ``params_from_jax`` and come back through
``params_to_numpy``; tokens come from ``np.random.RandomState``. The JAX
side runs ``attention_impl="flash"`` and ``norm_impl="fused"``, so its
Pallas forward and backward kernels run in interpret mode; the port runs
the same choices, whose wrappers take the kernels' plain versions on the
CPU.
"""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from faabric_tpu.data import DataLoader as JaxDataLoader  # noqa: E402
from faabric_tpu.data import TokenDataset as JaxTokenDataset  # noqa: E402
from faabric_tpu.models import loss_fn as jax_loss_fn  # noqa: E402
from faabric_tpu.models import make_optimizer as jax_make_optimizer  # noqa: E402
from faabric_tpu.models import make_train_step as jax_make_train_step  # noqa: E402
from faabric_tpu.models.evaluate import (  # noqa: E402
    evaluate_perplexity as jax_evaluate_perplexity,
)
from faabric_tpu_torch.data import DataLoader, TokenDataset  # noqa: E402
from faabric_tpu_torch.models import (  # noqa: E402
    Transformer,
    evaluate_perplexity,
    init_train_state,
    loss_fn,
    make_multi_step,
    make_optimizer,
    make_train_step,
    params_to_numpy,
    restore_train_state,
    save_train_state,
)
from faabric_tpu_torch.models.transformer import _BLOCK_KEYS  # noqa: E402
from faabric_tpu_torch.models.train import _update  # noqa: E402
from tests.test_torch_models import SMALL, pair, tokens_np  # noqa: E402

KERNELS = ("flash", "fused")


def batch(b=4, s=32, seed=1):
    return tokens_np((b, s), seed=seed), tokens_np((b, s), seed=seed + 100)


def as_t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def grads_np(model):
    """The model's gradients in the JAX pytree layout."""
    def g(p):
        return p.grad.numpy().copy()

    return {"embed": g(model.embed),
            "blocks": [{name: g(getattr(blk, name)) for name in _BLOCK_KEYS}
                       for blk in model.blocks],
            "ln_f": g(model.ln_f), "lm_head": g(model.lm_head)}


def assert_adam_close(got, want, tight, lr, steps):
    """Parameters after AdamW steps from gradients that agree to fp32
    summation order. Adam's first update is about g / (|g| + eps), so an
    element whose gradient is within that noise of zero may move by up to
    lr either way: every element is held to lr per step, and all but one
    in a thousand to ``tight``."""
    for g, w in zip(leaves(got), leaves(want)):
        err = np.abs(g - w)
        assert err.max() <= lr * steps, err.max()
        assert np.mean(err > tight) <= 1e-3, np.sort(err.ravel())[-5:]


# ---------------------------------------------------------------------------
# Gradients and steps against the JAX package
# ---------------------------------------------------------------------------

# fp32: both sides sum in other orders; the largest gradients are ~0.1
@pytest.mark.parametrize("impls", [("reference", "reference"), KERNELS],
                         ids=["reference", "flash_fused"])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_gradients_match_jax_per_parameter(impls, remat):
    params, jcfg, model = pair("float32", *impls, remat=remat)
    tok, tgt = batch()
    want = jax.grad(jax_loss_fn)(params, jnp.asarray(tok), jnp.asarray(tgt),
                                 jcfg)
    loss_fn(model, *as_t(tok, tgt)).backward()
    got = grads_np(model)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4)


def test_three_step_trajectory_and_params_match_jax():
    """Three AdamW steps with clipping from the same weights: the losses
    agree to 1e-5, the parameters as assert_adam_close says (bulk 2e-6)."""
    params, jcfg, model = pair("float32", *KERNELS)
    tok, tgt = batch()
    jopt = jax_make_optimizer(lr=3e-3, clip_norm=0.5)
    jstate = jopt.init(params)
    jstep = jax_make_train_step(jcfg, None, jopt)
    opt_spec = make_optimizer(lr=3e-3, clip_norm=0.5)
    opt = opt_spec.init(model)
    step = make_train_step(model.cfg, opt_spec)
    jlosses, losses = [], []
    for _ in range(3):
        params, jstate, jl = jstep(params, jstate, jnp.asarray(tok),
                                   jnp.asarray(tgt))
        jlosses.append(float(jl))
        losses.append(float(step(model, opt, *as_t(tok, tgt))))
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    assert losses[-1] < losses[0]
    assert_adam_close(params_to_numpy(model), params, 2e-6, 3e-3, 3)


def jax_schedule(lr, warmup_steps, total_steps):
    """The schedule faabric_tpu.models.make_optimizer builds, from optax's
    own schedule functions."""
    if total_steps:
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=max(1, warmup_steps),
            decay_steps=max(total_steps, warmup_steps + 1))
    if warmup_steps:
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup_steps),
             optax.constant_schedule(lr)], [warmup_steps])
    return optax.constant_schedule(lr)


SCHEDULES = {"warmup_cosine": (2e-3, 3, 12), "warmup_hold": (2e-3, 4, None),
             "constant": (2e-3, 0, None)}


@pytest.mark.parametrize("form", sorted(SCHEDULES))
def test_schedule_matches_optax_step_by_step(form):
    """Learning rate of every update, the first included (optax's count
    starts at 0), against optax in fp32 (rtol 1e-6)."""
    lr, warmup, total = SCHEDULES[form]
    spec = make_optimizer(lr=lr, warmup_steps=warmup, total_steps=total)
    want = jax_schedule(lr, warmup, total)
    for count in range(20):
        np.testing.assert_allclose(spec.schedule(count),
                                   float(want(count)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("form", sorted(SCHEDULES))
@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_optimizer_updates_match_optax(form, clip_norm):
    """Eight updates of two parameters with fixed random gradients: the
    JAX package's make_optimizer (optax adamw, schedule, global-norm clip)
    against the port's AdamW, schedule and clip (fp32, rtol 1e-5)."""
    lr, warmup, total = SCHEDULES[form]
    rng = np.random.RandomState(3)
    init = {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              init.items()} for _ in range(8)]

    tx = jax_make_optimizer(lr=lr, warmup_steps=warmup, total_steps=total,
                            clip_norm=clip_norm)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)

    module = torch.nn.Module()
    module.a = torch.nn.Parameter(torch.tensor(init["a"]))
    module.b = torch.nn.Parameter(torch.tensor(init["b"]))
    spec = make_optimizer(lr=lr, warmup_steps=warmup, total_steps=total,
                          clip_norm=clip_norm)
    opt = spec.init(module)
    for g in grads:
        module.a.grad, module.b.grad = (torch.tensor(g["a"]),
                                        torch.tensor(g["b"]))
        _update(module, opt, spec)
    for name in ("a", "b"):
        np.testing.assert_allclose(getattr(module, name).detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# Step variants
# ---------------------------------------------------------------------------

def tiny_state(seed=3, **overrides):
    _, _, model = pair("float32", *KERNELS, seed=seed, **overrides)
    spec = make_optimizer()
    return model, spec.init(model), spec


def test_gradient_accumulation_matches_full_batch():
    """accum_steps=4 gives the full batch's loss and update (equal
    microbatches; fp32 sums in another order: loss 1e-6, parameters as
    assert_adam_close says, bulk 1e-6)."""
    tok, tgt = as_t(*batch(b=8))
    outs = {}
    for accum in (1, 4):
        model, opt, spec = tiny_state()
        step = make_train_step(model.cfg, spec, accum_steps=accum)
        loss = step(model, opt, tok, tgt)
        outs[accum] = (float(loss), params_to_numpy(model))
    assert abs(outs[1][0] - outs[4][0]) < 1e-6
    assert_adam_close(outs[4][1], outs[1][1], 1e-6, 3e-4, 1)
    model, opt, spec = tiny_state()
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(model.cfg, spec, accum_steps=3)(model, opt, tok, tgt)


def test_multi_step_matches_sequential_steps():
    """n steps in one call equal n calls of the step (bit for bit on the
    CPU), with one reused batch or one batch per step."""
    tok, tgt = as_t(*batch())
    model, opt, spec = tiny_state()
    step = make_train_step(model.cfg, spec)
    for _ in range(3):
        loss_seq = step(model, opt, tok, tgt)
    want = params_to_numpy(model)

    model, opt, spec = tiny_state()
    run = make_multi_step(model.cfg, spec)
    loss_run = run(model, opt, tok, tgt, 3)
    assert float(loss_run) == float(loss_seq)
    for a, b in zip(leaves(params_to_numpy(model)), leaves(want)):
        np.testing.assert_array_equal(a, b)

    model, opt, spec = tiny_state()
    tok3, tgt3 = torch.stack([tok] * 3), torch.stack([tgt] * 3)
    assert float(run(model, opt, tok3, tgt3, 3)) == float(loss_seq)
    with pytest.raises(ValueError, match="per-step batches"):
        run(model, opt, tok3, tgt3, 4)


def test_remat_recomputes_the_same_gradients():
    """Remat changes what is kept, not what is computed: bit-identical
    gradients on the CPU."""
    tok, tgt = as_t(*batch())
    grads = []
    for remat in (True, False):
        model, _, _ = tiny_state(remat=remat)
        loss_fn(model, tok, tgt).backward()
        grads.append(leaves(grads_np(model)))
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)


def test_step_refuses_a_model_of_another_config():
    """The step runs the model's own config and refuses a model built
    from another one than the step was made for, before any update."""
    import dataclasses

    model, opt, spec = tiny_state()
    before = params_to_numpy(model)
    step = make_train_step(dataclasses.replace(model.cfg, remat=False), spec)
    with pytest.raises(ValueError, match="step built for"):
        step(model, opt, *as_t(*batch()))
    for a, b in zip(leaves(params_to_numpy(model)), leaves(before)):
        np.testing.assert_array_equal(a, b)


def test_init_train_state_builds_model_and_adamw():
    spec = make_optimizer(lr=1e-3, weight_decay=0.1)
    model, opt = init_train_state(torch.Generator().manual_seed(0),
                                  pair()[2].cfg, "cpu", spec)
    assert isinstance(model, Transformer) and model.device.type == "cpu"
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.1
    assert len(group["params"]) == len(list(model.parameters()))


# ---------------------------------------------------------------------------
# Data, evaluation, checkpoints
# ---------------------------------------------------------------------------

def test_loader_batches_match_jax_loader_for_two_epochs(tmp_path):
    corpus = np.random.RandomState(0).randint(0, 128, 2000).astype(np.int32)
    path = tmp_path / "corpus.bin"
    corpus.tofile(path)
    jl = JaxDataLoader(JaxTokenDataset(corpus, 16), 8, seed=5)
    tl = DataLoader(TokenDataset.from_file(str(path), 16), 8, device="cpu",
                    seed=5)
    assert len(tl) == len(jl)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for (jx, jy), (tx, ty) in zip(jb, tb):
            assert tx.dtype == torch.int32 and tx.shape == (8, 16)
            np.testing.assert_array_equal(tx.numpy(), jx)
            np.testing.assert_array_equal(ty.numpy(), jy)


def test_loader_prefetch_thread_exits_when_an_epoch_is_abandoned():
    ds = TokenDataset(np.arange(4000, dtype=np.int32), 16)
    loader = DataLoader(ds, 2, device="cpu", prefetch=1)
    before = threading.active_count()
    for _ in zip(range(2), loader):
        pass
    for t in threading.enumerate():
        if t.name == "data/prefetch":
            t.join(timeout=5)
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="batch_size"):
        DataLoader(TokenDataset(np.arange(40, dtype=np.int32), 16), 4,
                   device="cpu")


def test_evaluate_perplexity_matches_jax():
    """Mean NLL over two batches from the same weights (fp32: 1e-5)."""
    params, jcfg, model = pair("float32", *KERNELS)
    batches = [batch(seed=s) for s in (5, 6)]
    want = jax_evaluate_perplexity(
        params, jcfg, [tuple(map(jnp.asarray, b)) for b in batches])
    got = evaluate_perplexity(model, [as_t(*b) for b in batches] * 2,
                              max_batches=2)
    assert got["tokens"] == want["tokens"] == 2 * 4 * 32
    assert abs(got["nll"] - want["nll"]) < 1e-5
    assert abs(got["perplexity"] - want["perplexity"]) < 1e-5 * want["perplexity"]
    with pytest.raises(ValueError, match="no batches"):
        evaluate_perplexity(model, [])


def test_save_restore_continues_like_an_uninterrupted_run(tmp_path):
    """Save after two steps of a warmup-cosine run, run two more; a fresh
    model and optimizer restored from the file run the same two steps to
    the same losses and parameters, bit for bit on the CPU."""
    tok, tgt = as_t(*batch())
    spec = make_optimizer(lr=3e-3, warmup_steps=1, total_steps=6,
                          clip_norm=1.0)
    model, opt, _ = tiny_state()
    opt = spec.init(model)
    step = make_train_step(model.cfg, spec)
    for _ in range(2):
        step(model, opt, tok, tgt)
    path = str(tmp_path / "state.pt")
    save_train_state(path, model, opt, step=2)
    after = [float(step(model, opt, tok, tgt)) for _ in range(2)]

    fresh, _, _ = tiny_state(seed=9)
    fresh_opt = spec.init(fresh)
    assert restore_train_state(path, fresh, fresh_opt) == 2
    assert [float(step(fresh, fresh_opt, tok, tgt)) for _ in range(2)] == after
    for a, b in zip(leaves(params_to_numpy(fresh)),
                    leaves(params_to_numpy(model))):
        np.testing.assert_array_equal(a, b)

    with pytest.raises((OSError, RuntimeError)):
        save_train_state(str(tmp_path / "missing" / "state.pt"), model, opt)
    assert not list((tmp_path).glob("**/*.tmp"))


def test_params_to_numpy_inverts_params_from_jax():
    params, _, model = pair()
    for a, b in zip(leaves(params_to_numpy(model)), leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert SMALL["n_layers"] == len(params_to_numpy(model)["blocks"])
