"""PyTorch port's model and serving path against the JAX package.

Small size (vocab 128, d_model 64, 2 layers, 4 heads, S 64). The JAX
``init_params`` weights reach the port through ``params_from_jax``, so
both sides compute the same function from the same numbers; tokens come
from ``np.random.RandomState``. The port runs on the CPU, where its
wrappers take their kernels' plain versions; the JAX side runs its Pallas
kernels in interpret mode.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy
jax_generate_mod = importlib.import_module("faabric_tpu.models.generate")

from faabric_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from faabric_tpu.models import forward as jax_forward  # noqa: E402
from faabric_tpu.models import init_params  # noqa: E402
from faabric_tpu.models import loss_fn as jax_loss_fn  # noqa: E402
from faabric_tpu_torch.models import (  # noqa: E402
    ModelConfig,
    Transformer,
    forward,
    forward_with_cache,
    generate,
    init_kv_cache,
    loss_fn,
    params_from_jax,
    resolve_impls,
)
from faabric_tpu_torch.models.generate import _filter_logits, _pick_token  # noqa: E402

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=128)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")


def pair(dtype="float32", attention_impl="reference", norm_impl="reference",
         seed=0, **overrides):
    """(JAX params, JAX config, port model) holding the same weights."""
    jd, td = DTYPES[dtype]
    kw = {**SMALL, **overrides, "attention_impl": attention_impl,
          "norm_impl": norm_impl}
    jcfg = JaxConfig(**kw, compute_dtype=jd)
    params = init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ModelConfig(**kw, compute_dtype=td), device="cpu")
    return params, jcfg, model


def assert_logits_close(got, want, dtype):
    """fp32 compute: the frameworks sum in other orders (2e-4). bf16
    compute: bf16 rounds at other places in the two frameworks and the
    differences travel through the layers, so the bound is two bf16 ulps
    (8 significant bits) of the largest |logit|, with a mean error below
    one ulp at |logit| = 1 (7.8e-3)."""
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 2e-4, err.max()
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert err.max() <= 2 * ulp, (err.max(), ulp)
    assert err.mean() <= 7.8e-3, err.mean()


def tokens_np(shape, vocab=128, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def test_params_from_jax_is_bit_exact():
    params, _, model = pair()
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  np.asarray(params["embed"]))
    np.testing.assert_array_equal(model.blocks[1].wqkv.detach().numpy(),
                                  np.asarray(params["blocks"][1]["wqkv"]))
    np.testing.assert_array_equal(model.lm_head.detach().numpy(),
                                  np.asarray(params["lm_head"]))


@pytest.mark.parametrize("impls", [("reference", "reference"),
                                   ("flash", "fused")],
                         ids=["reference", "flash_fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(impls, dtype):
    params, jcfg, model = pair(dtype, *impls)
    tok = tokens_np((2, 64))
    want = np.asarray(jax_forward(params, jnp.asarray(tok), jcfg))
    with torch.no_grad():
        got = forward(model, torch.as_tensor(tok)).numpy()
    assert got.shape == (2, 64, 128) and got.dtype == np.float32
    assert_logits_close(got, want, dtype)


def test_loss_fn_matches_jax():
    params, jcfg, model = pair()
    tok, tgt = tokens_np((2, 64), seed=1), tokens_np((2, 64), seed=2)
    want = float(jax_loss_fn(params, jnp.asarray(tok), jnp.asarray(tgt), jcfg))
    with torch.no_grad():
        got = float(loss_fn(model, torch.as_tensor(tok), torch.as_tensor(tgt)))
    assert abs(got - want) <= 1e-5, (got, want)


def test_loss_fn_gradients_flow_on_the_plain_path():
    _, _, model = pair()
    tok = torch.as_tensor(tokens_np((2, 16), seed=3))
    loss_fn(model, tok, tok).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


@pytest.mark.parametrize("prefill_chunk", [0, 5])
def test_greedy_generate_matches_jax(prefill_chunk):
    """fp32 greedy tokens identical to JAX, whole and chunked prefill."""
    params, jcfg, model = pair(seed=7)
    prompt = tokens_np((2, 12), seed=7)
    want = np.asarray(jax_generate_mod.generate(
        params, jnp.asarray(prompt), jcfg, 10, prefill_chunk=prefill_chunk))
    got = generate(model, torch.as_tensor(prompt), 10,
                   prefill_chunk=prefill_chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_decode_step_matches_full_forward():
    """Cache correctness: the decode step's logits equal the full
    forward's last position over prompt + token (fp32, 1e-4)."""
    _, _, model = pair(seed=4)
    prompt = torch.as_tensor(tokens_np((2, 20), seed=4))
    with torch.inference_mode():
        cache = init_kv_cache(model.cfg, 2, CPU)
        first = forward_with_cache(model, prompt, cache, 0)
        torch.testing.assert_close(first, forward(model, prompt),
                                   atol=1e-4, rtol=0)
        tok = first[:, -1].argmax(-1).to(torch.int32)
        step = forward_with_cache(model, tok[:, None], cache, 20)
        full = forward(model, torch.cat([prompt, tok[:, None]], dim=1))
    torch.testing.assert_close(step[:, -1], full[:, -1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, 1.0), (0.7, 0, 0.9), (1.3, 20, 0.5), (1.0, 0, 0.3)])
def test_sampling_masks_match_jax(monkeypatch, temperature, top_k, top_p):
    """The logits JAX's _pick_token hands to its sampler equal the
    port's filtered logits on the same fixed input."""
    logits = np.random.RandomState(11).randn(3, 128).astype(np.float32) * 3
    seen = []

    def capture(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.zeros(lg.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jax_generate_mod._pick_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                                 False, jnp.float32(temperature), top_k,
                                 top_p < 1.0, jnp.float32(top_p))
    got = _filter_logits(torch.as_tensor(logits), temperature, top_k,
                         top_p).numpy()
    want = seen[0]
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = ~np.isinf(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)


def test_sampled_tokens_follow_the_mask_and_the_generator():
    logits = torch.as_tensor(
        np.random.RandomState(12).randn(4, 128).astype(np.float32))
    allowed = ~torch.isinf(_filter_logits(logits, 1.0, 8, 0.9))
    draws = [_pick_token(logits, torch.Generator().manual_seed(s), False,
                         1.0, 8, 0.9) for s in range(20)]
    for d in draws:
        assert d.dtype == torch.int32
        assert allowed[torch.arange(4), d.long()].all()
    again = _pick_token(logits, torch.Generator().manual_seed(3), False,
                        1.0, 8, 0.9)
    assert torch.equal(again, draws[3])
    _, _, model = pair()
    out = generate(model, torch.as_tensor(tokens_np((2, 8))), 6,
                   generator=torch.Generator().manual_seed(0),
                   temperature=0.8, top_k=10, top_p=0.95)
    assert out.shape == (2, 6) and int(out.min()) >= 0 and int(out.max()) < 128


def test_generate_refuses_past_max_seq():
    _, _, model = pair(max_seq=16)
    with pytest.raises(ValueError, match="max_seq"):
        generate(model, torch.as_tensor(tokens_np((1, 10))), 8)


def test_entry_matches_graft_entry():
    """The port's entry() config and tokens, with the JAX entry()'s
    weights, give the JAX entry()'s logits (bf16 compute)."""
    import __graft_entry__

    from faabric_tpu_torch.entry import ENTRY_CONFIG, entry

    jfn, (jparams, jtokens) = __graft_entry__.entry()
    want = np.asarray(jfn(jparams, jtokens))
    fn, (model, tokens) = entry(device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), ENTRY_CONFIG,
                            device="cpu")
    got = fn(model, tokens).numpy()
    assert got.shape == want.shape == (2, 128, 2048)
    assert_logits_close(got, want, "bfloat16")


def test_init_draws_the_jax_distributions():
    cfg = ModelConfig(**SMALL)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert model.blocks[0].wqkv.shape == (64, 3, 4, 16)
    assert model.blocks[0].wo.shape == (4, 16, 64)
    assert torch.equal(model.ln_f, torch.ones(64))
    for p, fan_in in [(model.embed, 64), (model.blocks[0].w2, 128)]:
        assert p.dtype == torch.float32
        assert abs(float(p.detach().std()) * fan_in ** 0.5 - 1.0) < 0.1


def test_resolve_impls_picks_kernels_on_cuda_only():
    cfg = ModelConfig(**SMALL)
    on_cpu = resolve_impls(cfg, torch.device("cpu"))
    on_cuda = resolve_impls(cfg, torch.device("cuda", 0))
    assert (on_cpu.attention_impl, on_cpu.norm_impl) == ("reference",
                                                         "reference")
    assert (on_cuda.attention_impl, on_cuda.norm_impl) == ("flash", "fused")
    with pytest.raises(ValueError, match="ring"):
        resolve_impls(ModelConfig(attention_impl="ring"), CPU)
