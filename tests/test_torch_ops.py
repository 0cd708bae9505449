"""PyTorch port's kernels against the JAX package.

On the CPU each port wrapper runs its kernel's plain version; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
Inputs come from numpy with a fixed seed and reach both sides as the
same arrays. ``test_torch_cuda.py`` holds the CUDA kernels against these
plain versions on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from faabric_tpu.ops.flash_attention import (  # noqa: E402
    _reference_attention as jax_reference_attention,
    flash_attention as jax_flash_attention,
    flash_attention_with_lse as jax_flash_with_lse,
    merge_attention_blocks as jax_merge,
)
from faabric_tpu.ops.rms_norm import (  # noqa: E402
    _reference_rms_norm as jax_reference_rms_norm,
    rms_norm as jax_rms_norm,
)
from faabric_tpu_torch.ops.flash_attention import (  # noqa: E402
    _reference_attention,
    flash_attention,
    flash_attention_with_lse,
    merge_attention_blocks,
)
from faabric_tpu_torch.ops.rms_norm import rms_norm  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(arr, dtype="float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.tensor(np.asarray(arr)).to(td)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def qkv_np(b=2, s_q=128, s_k=None, h=2, d=32, seed=0):
    rng = np.random.RandomState(seed)
    s_k = s_q if s_k is None else s_k
    return (rng.randn(b, s_q, h, d).astype(np.float32),
            rng.randn(b, s_k, h, d).astype(np.float32),
            rng.randn(b, s_k, h, d).astype(np.float32))


# ---------------------------------------------------------------------------
# RMS norm
# ---------------------------------------------------------------------------

# fp32: summation order only. bf16: both sides compute in fp32 and round
# once (rows are a multiple of the JAX kernel's 128-row block, so JAX runs
# its kernel), so at most one bf16 ulp at |out| < 8 (0.03125).
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3.2e-2)])
def test_rms_norm_plain_matches_jax_kernel(dtype, atol):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 128, 64).astype(np.float32)
    scale = rng.rand(64).astype(np.float32)
    jx, tx = both(x, dtype)
    js, ts = both(scale)
    out = rms_norm(tx, ts)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    np.testing.assert_allclose(as_np(out), as_np(jax_rms_norm(jx, js)),
                               atol=atol)


def test_rms_norm_ragged_rows_match_jax_reference_in_fp32():
    """Rows not a multiple of 128 (JAX takes its reference there)."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 37, 48).astype(np.float32)
    scale = rng.rand(48).astype(np.float32)
    (jx, tx), (js, ts) = both(x), both(scale)
    np.testing.assert_allclose(as_np(rms_norm(tx, ts)),
                               as_np(jax_reference_rms_norm(jx, js)),
                               atol=1e-5)


def test_rms_norm_gradients_match_jax_vjp():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 128, 32).astype(np.float32)
    scale = rng.rand(32).astype(np.float32)
    g = rng.randn(2, 128, 32).astype(np.float32)
    (jx, tx), (js, ts), (jg, tg) = both(x), both(scale), both(g)
    _, vjp = jax.vjp(jax_rms_norm, jx, js)
    jgx, jgs = vjp(jg)
    tx.requires_grad_()
    ts.requires_grad_()
    rms_norm(tx, ts).backward(tg)
    np.testing.assert_allclose(as_np(tx.grad), as_np(jgx), atol=1e-4)
    np.testing.assert_allclose(as_np(ts.grad), as_np(jgs), atol=1e-4)


def test_rms_norm_rejects_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rms_norm(x, torch.empty(8, device="meta"))


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# (s_q, s_k, causal): causal, non-causal, cross length with the
# end-aligned mask, ragged lengths (no multiple of any tile), and ragged
# cross length
FLASH_CASES = {
    "causal": (256, 256, True),
    "non_causal": (128, 128, False),
    "cross_length": (128, 256, True),
    "ragged": (100, 100, True),
    "ragged_cross_non_causal": (60, 100, False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_with_lse_matches_jax_fp32(case):
    """Out and lse against JAX flash_attention_with_lse at the fp32
    tolerance of tests/unit/test_ops.py (2e-5)."""
    s_q, s_k, causal = FLASH_CASES[case]
    q, k, v = qkv_np(s_q=s_q, s_k=s_k, seed=3)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    jo, jl = jax_flash_with_lse(jq, jk, jv, causal)
    to, tl = flash_attention_with_lse(tq, tk, tv, causal)
    assert to.shape == tq.shape and tl.shape == (2 * 2, s_q)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(as_np(to), as_np(jo), atol=2e-5)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=2e-5)
    np.testing.assert_allclose(
        as_np(flash_attention(tq, tk, tv, causal)),
        as_np(jax_flash_attention(jq, jk, jv, causal)), atol=2e-5)


def test_flash_bf16_matches_jax():
    """bf16 at the tolerance of test_flash_attention_bf16_forward_and_
    gradients (3e-2): the JAX kernel rounds unnormalised p to bf16, the
    plain version rounds the normalised probabilities."""
    q, k, v = qkv_np(b=1, s_q=256, h=2, d=16, seed=23)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "bfloat16") for a in (q, k, v))
    jo, jl = jax_flash_with_lse(jq, jk, jv)
    to, tl = flash_attention_with_lse(tq, tk, tv)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(to), as_np(jo), atol=3e-2)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=3e-2)


def test_flash_causal_short_keys_takes_plain_version():
    """Causal s_q > s_k: fully masked rows get the uniform softmax of the
    reference on both sides."""
    q, k, v = qkv_np(s_q=64, s_k=32, seed=5)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    np.testing.assert_allclose(as_np(flash_attention(tq, tk, tv)),
                               as_np(jax_flash_attention(jq, jk, jv)),
                               atol=2e-5)


def test_reference_attention_matches_jax():
    q, k, v = qkv_np(s_q=64, s_k=96, seed=6)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    for causal in (True, False):
        np.testing.assert_allclose(
            as_np(_reference_attention(tq, tk, tv, causal)),
            as_np(jax_reference_attention(jq, jk, jv, causal)), atol=2e-5)


def test_merge_attention_blocks_matches_jax():
    q, k, v = qkv_np(s_q=256, h=2, d=16, seed=19)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    jparts = [jax_flash_with_lse(jq, jk[:, sl], jv[:, sl], False)
              for sl in (slice(0, 128), slice(128, 256))]
    tparts = [flash_attention_with_lse(tq, tk[:, sl], tv[:, sl], False)
              for sl in (slice(0, 128), slice(128, 256))]
    jo, jl = jax_merge([p[0] for p in jparts], [p[1] for p in jparts])
    to, tl = merge_attention_blocks([p[0] for p in tparts],
                                    [p[1] for p in tparts])
    np.testing.assert_allclose(as_np(to), as_np(jo), atol=2e-5)
    np.testing.assert_allclose(as_np(tl), as_np(jl), atol=2e-5)
    # ... and the merge equals attention over the union of the blocks
    full, full_lse = flash_attention_with_lse(tq, tk, tv, False)
    np.testing.assert_allclose(as_np(to), as_np(full), atol=2e-5)
    np.testing.assert_allclose(as_np(tl), as_np(full_lse), atol=2e-4)


def test_flash_kernel_path_refuses_gradients():
    q, k, v = (torch.tensor(a, requires_grad=True) for a in qkv_np(s_q=64))
    with pytest.raises(NotImplementedError, match="next slice"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape


def test_flash_plain_fallback_gradients_match_jax():
    """The semantic fallback (causal s_q > s_k) differentiates through
    the plain version, as the JAX fallback does."""
    q, k, v = qkv_np(b=1, s_q=48, s_k=32, h=2, d=16, seed=8)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    jg = jax.grad(lambda q, k, v: jnp.sum(jax_flash_attention(q, k, v) ** 2),
                  argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    (flash_attention(*ts) ** 2).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(as_np(t.grad), as_np(g), atol=2e-4)


def test_flash_rejects_other_devices():
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
