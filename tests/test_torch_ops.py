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
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    _flash_forward as jax_flash_forward,
    _fold_heads as jax_fold_heads,
    _reference_attention as jax_reference_attention,
    _reference_lse as jax_reference_lse,
    flash_attention as jax_flash_attention,
    flash_attention_with_lse as jax_flash_with_lse,
    merge_attention_blocks as jax_merge,
    _run_bwd_kernels as jax_run_bwd_kernels,
)
from faabric_tpu.ops.rms_norm import (  # noqa: E402
    _reference_rms_norm as jax_reference_rms_norm,
    rms_norm as jax_rms_norm,
)
from faabric_tpu_torch.ops import _build  # noqa: E402
from faabric_tpu_torch.ops.flash_attention import (  # noqa: E402
    BODIES,
    _bwd_body,
    _fwd_body,
    _kernel_flash,
    _reference_attention,
    _reference_bwd_dq_with_delta,
    _reference_flash_bwd,
    _reference_lse,
    _row_correction,
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


def test_rms_norm_bf16_gradients_match_jax_vjp():
    """bf16: the backward differentiates the JAX package's
    ``_reference_rms_norm`` (products in x's dtype). gx agrees with
    jax.vjp within one bf16 ulp at |gx| < 8 (the file's bf16 tolerance,
    3.2e-2). g_scale sums 256 rows of bf16 products: the port equals the
    fp32-accumulated sum of JAX's own products (jnp.sum) bit for bit,
    where XLA's vjp on the CPU accumulates the same products in bf16."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 128, 512).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 512).astype(np.float32)
    g = rng.randn(2, 128, 512).astype(np.float32)
    (jx, tx), (jg, tg) = both(x, "bfloat16"), both(g, "bfloat16")
    js, ts = both(scale)
    _, vjp = jax.vjp(jax_rms_norm, jx, js)
    jgx, _ = vjp(jg)
    tx.requires_grad_()
    ts.requires_grad_()
    rms_norm(tx, ts).backward(tg)
    assert tx.grad.dtype == torch.bfloat16 and ts.grad.dtype == torch.float32
    assert np.abs(as_np(jgx)).max() < 8
    np.testing.assert_allclose(as_np(tx.grad), as_np(jgx), atol=3.2e-2)
    var = jnp.mean(jnp.square(jx.astype(jnp.float32)), -1, keepdims=True)
    normed = jx * jax.lax.rsqrt(var + 1e-6).astype(jnp.bfloat16)
    want_gs = jnp.sum((jg * normed).reshape(-1, 512), axis=0)
    np.testing.assert_array_equal(as_np(ts.grad), as_np(want_gs))


def test_kernel_build_runs_once_for_concurrent_first_callers(monkeypatch):
    """Executor threads may call ``kernels()`` first at the same time:
    one build runs, and every caller gets its result."""
    import threading

    calls = []
    started = threading.Event()

    def slow_load():
        calls.append(1)
        started.set()
        threading.Event().wait(0.2)
        return object()

    monkeypatch.setattr(_build, "_load", slow_load)
    monkeypatch.setattr(_build, "_kernels", None)
    got = [None] * 8
    barrier = threading.Barrier(8)

    def call(i):
        barrier.wait(10)
        got[i] = _build.kernels()

    ts = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert len(calls) == 1 and started.is_set()
    assert all(k is got[0] for k in got) and got[0] is not None


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """count_launch is a locked read-modify-write: no count is lost when
    threads count at once (switch interval shortened to interleave)."""
    import sys
    import threading

    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count():
            for _ in range(2000):
                _build.count_launch("k", "k.body")

        ts = [threading.Thread(target=count) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert dict(_build.LAUNCHES) == {"k": 16000, "k.body": 16000}


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


# (s_q, s_k, causal) as in the JAX package's gradient tests
# (tests/unit/test_ops.py): there its Pallas dQ and dK/dV kernels run in
# interpret mode; here the Function's backward takes the kernels' plain
# version on the CPU
GRAD_CASES = {
    "causal": (256, 256, True),
    "non_causal": (256, 256, False),
    "cross_length": (128, 256, True),
}


def torch_grads(fn, *arrays):
    ts = [torch.as_tensor(a).clone().requires_grad_() for a in arrays]
    fn(*ts).backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_gradients_match_jax(case):
    """jax.grad through JAX's flash backward kernels against the port's
    Function, loss sum(out^2), at the JAX tests' atol 2e-4, rtol 1e-3."""
    s_q, s_k, causal = GRAD_CASES[case]
    q, k, v = qkv_np(b=1, s_q=s_q, s_k=s_k, h=2, d=16, seed=9)
    jg = jax.grad(lambda q, k, v: jnp.sum(
        jax_flash_attention(q, k, v, causal) ** 2), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    tg = torch_grads(lambda q, k, v: (flash_attention(q, k, v, causal) ** 2
                                      ).sum(), q, k, v)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(as_np(got), as_np(want), atol=2e-4,
                                   rtol=1e-3)


def test_flash_with_lse_gradients_including_lse_cotangent_match_jax():
    """A loss that uses the lse output (test_ops.py's
    test_flash_with_lse_gradients_including_lse_cotangent): g_lse folds
    into the row correction on both sides. atol 2e-4, rtol 1e-3."""
    q, k, v = qkv_np(b=1, s_q=256, h=2, d=16, seed=17)

    def jloss(q, k, v):
        out, lse = jax_flash_with_lse(q, k, v)
        return jnp.sum(out ** 2) + 0.3 * jnp.sum(jnp.sin(lse))

    def tloss(q, k, v):
        out, lse = flash_attention_with_lse(q, k, v)
        return (out ** 2).sum() + 0.3 * torch.sin(lse).sum()

    def tloss_plain(q, k, v):
        out = _reference_attention(q, k, v)
        return (out ** 2).sum() + 0.3 * torch.sin(_reference_lse(q, k, True)).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tg = torch_grads(tloss, q, k, v)
    for got, want, plain in zip(tg, jg, torch_grads(tloss_plain, q, k, v)):
        np.testing.assert_allclose(as_np(got), as_np(want), atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(as_np(got), as_np(plain), atol=2e-4,
                                   rtol=1e-3)


def test_flash_lse_only_loss_takes_no_output_cotangent():
    """Only lse reaches the loss: the output's cotangent stays None, dv is
    zero, and dq, dk equal autograd through the plain lse (fp32, 1e-5)."""
    q, k, v = qkv_np(b=1, s_q=64, h=2, d=16, seed=4)
    got = torch_grads(lambda q, k, v: flash_attention_with_lse(q, k, v)[1]
                      .sum(), q, k, v)
    want = torch_grads(lambda q, k: _reference_lse(q, k, True).sum(), q, k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-5)
    assert not got[2].any()


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("with_g_lse", [False, True])
def test_reference_flash_bwd_matches_jax_vjp_and_autograd(case, with_g_lse):
    """The kernels' plain version, fed the forward's lse and the row
    correction, against JAX's vjp through its backward kernels and
    against torch autograd through the plain attention and lse (fp32:
    atol 2e-4, rtol 1e-3)."""
    s_q, s_k, causal = GRAD_CASES[case]
    q, k, v = qkv_np(b=1, s_q=s_q, s_k=s_k, h=2, d=16, seed=12)
    rng = np.random.RandomState(13)
    g = rng.randn(1, s_q, 2, 16).astype(np.float32)
    g_lse = rng.randn(2, s_q).astype(np.float32) if with_g_lse else None

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_with_lse(q, k, v, causal),
                     jq, jk, jv)
    jg = vjp((jnp.asarray(g), jnp.asarray(
        g_lse if with_g_lse else np.zeros((2, s_q), np.float32))))

    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    tgo = torch.tensor(g)
    out, lse = flash_attention_with_lse(tq, tk, tv, causal)
    delta = _row_correction(tgo, out,
                            torch.tensor(g_lse) if with_g_lse else None)
    got = _reference_flash_bwd(tq, tk, tv, tgo, lse, delta, causal)

    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    loss = (_reference_attention(*ts, causal) * tgo).sum()
    if with_g_lse:
        loss = loss + (_reference_lse(ts[0], ts[1], causal)
                       * torch.tensor(g_lse)).sum()
    autograd = torch.autograd.grad(loss, ts)
    for a, want, plain in zip(got, jg, autograd):
        np.testing.assert_allclose(as_np(a), as_np(want), atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(as_np(a), as_np(plain), atol=2e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("with_g_lse", [False, True])
def test_reference_dq_with_delta_matches_jax_bwd_kernels(case, with_g_lse):
    """The dQ kernel's plain version, row correction included, against
    JAX's _run_bwd_kernels (its Pallas dQ kernel in interpret mode) fed
    the same cotangents: dQ and Δ = rowsum(dO·O) − g_lse, which JAX
    computes there outside its kernels (fp32: atol 2e-4, rtol 1e-3)."""
    s_q, s_k, causal = GRAD_CASES[case]
    q, k, v = qkv_np(b=1, s_q=s_q, s_k=s_k, h=2, d=16, seed=14)
    rng = np.random.RandomState(15)
    g = rng.randn(1, s_q, 2, 16).astype(np.float32)
    g_lse = rng.randn(2, s_q).astype(np.float32) if with_g_lse else None

    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jout, jlse = jax_flash_forward(jq, jk, jv, causal, DEFAULT_BLOCK_Q,
                                   DEFAULT_BLOCK_K)
    assert jlse is not None  # JAX ran its kernels
    jg_lse = None if g_lse is None else jnp.asarray(g_lse)
    jdq, _, _ = jax_run_bwd_kernels(jq, jk, jv, jg, jout, jlse, causal,
                                    DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K,
                                    g_lse=jg_lse)
    jdelta = jnp.sum(jax_fold_heads(jg) * jax_fold_heads(jout), axis=-1)
    if g_lse is not None:
        jdelta = jdelta - jg_lse

    tq, tk, tv, tg = (torch.tensor(a) for a in (q, k, v, g))
    out, lse = flash_attention_with_lse(tq, tk, tv, causal)
    dq, delta = _reference_bwd_dq_with_delta(
        tq, tk, tv, tg, out, lse,
        None if g_lse is None else torch.tensor(g_lse), causal)
    assert delta.shape == (2, s_q) and delta.dtype == torch.float32
    np.testing.assert_allclose(as_np(delta), as_np(jdelta), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(as_np(dq), as_np(jdq), atol=2e-4, rtol=1e-3)


def _routing_operands(dtype=torch.bfloat16, d=64, layout="contiguous"):
    """q, k, v, dO and O on the CPU in the layouts the model and the
    tests hand the backward."""
    b, s, h = 2, 96, 4
    if layout == "qkv_views":  # views of one (B, S, 3, H, D) product
        qkv = torch.zeros(b, s, 3, h, d, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    elif layout == "odd_head_stride":  # (B, S, H, D + 1) sliced to D
        q = k = v = torch.zeros(b, s, h, d + 1, dtype=dtype)[..., :d]
    elif layout == "pair_offset":  # two values past a 16-byte boundary
        q = k = v = torch.zeros(b * s * h * d + 2, dtype=dtype)[2:].view(
            b, s, h, d)
    elif layout == "head_stride_68":  # even strides, not 16-byte ones
        q = k = v = torch.zeros(b, s, h, d + 4, dtype=dtype)[..., :d]
    elif layout == "single_batch_odd_stride":  # a dim of extent 1
        q = k = v = torch.zeros(1, s, h, d, dtype=dtype).as_strided(
            (1, s, h, d), (7, h * d, d, 1))
    else:
        q = k = v = torch.zeros(b, s, h, d, dtype=dtype)
    do = torch.zeros(q.shape, dtype=dtype)
    return q, k, v, do, torch.zeros(q.shape, dtype=dtype)


@pytest.mark.parametrize("dtype,d,layout,body", [
    ("bfloat16", 64, "contiguous", "wgmma"),
    ("bfloat16", 64, "qkv_views", "wgmma"),
    ("bfloat16", 64, "single_batch_odd_stride", "wgmma"),
    ("bfloat16", 64, "pair_offset", "mma"),
    ("bfloat16", 64, "head_stride_68", "mma"),
    ("bfloat16", 64, "odd_head_stride", "fma"),
    ("bfloat16", 32, "contiguous", "mma"),
    ("bfloat16", 16, "contiguous", "mma"),
    ("bfloat16", 128, "contiguous", "fma"),
    ("float32", 64, "contiguous", "fma"),
    ("float32", 16, "contiguous", "fma"),
])
def test_bwd_body_routes_by_dtype_head_dim_and_layout(dtype, d, layout, body):
    """The backward body a shape takes is decided from the operands
    alone: wgmma for bf16 at D = 64 that TMA can describe, mma for other
    bf16 with D <= 64 and 4-byte bf16 pairs, fma for the rest; the dQ
    and dK/dV passes agree when O is laid out like q."""
    q, k, v, do, out = _routing_operands(DTYPES[dtype][1], d, layout)
    assert _bwd_body(q, k, v, do) == body
    assert _bwd_body(q, k, v, do, out) == body


@pytest.mark.parametrize("dtype,d,layout,body", [
    ("bfloat16", 64, "contiguous", "wgmma"),
    ("bfloat16", 64, "qkv_views", "wgmma"),
    ("bfloat16", 64, "single_batch_odd_stride", "wgmma"),
    ("bfloat16", 64, "pair_offset", "mma"),
    ("bfloat16", 64, "head_stride_68", "mma"),
    ("bfloat16", 64, "odd_head_stride", "fma"),
    ("bfloat16", 32, "contiguous", "mma"),
    ("bfloat16", 16, "qkv_views", "mma"),
    ("bfloat16", 128, "contiguous", "mma"),
    ("float32", 64, "contiguous", "fma"),
    ("float32", 64, "qkv_views", "fma"),
])
def test_fwd_body_routes_by_dtype_head_dim_and_layout(dtype, d, layout, body):
    """The forward body a shape takes is decided from q, k and v alone:
    wgmma for bf16 at D = 64 that TMA can describe, mma for other bf16
    whose pairs are 4-byte aligned (any head dim), fma for the rest."""
    q, k, v, _, _ = _routing_operands(DTYPES[dtype][1], d, layout)
    assert _fwd_body(q, k, v) == body


def test_fwd_body_reads_every_operand():
    """One operand that TMA cannot describe moves the forward off wgmma."""
    q, k, _, _, _ = _routing_operands()
    v = torch.zeros(2, 96, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert _fwd_body(q, k, k) == "wgmma"
    assert _fwd_body(q, k, v) == "mma"
    assert _fwd_body(v, k, k) == "mma"


class _RecordingKernels:
    """Stands in for the built kernels: records the forward's body code
    and fails with CUDA error ``rc`` when it is not 0, as the bindings
    do."""

    def __init__(self, rc=0):
        self.rc, self.bodies = rc, []

    def flash_fwd(self, q, k, v, out, lse, scale, causal, body):
        self.bodies.append(body)
        if self.rc:
            raise RuntimeError(f"flash_fwd: CUDA error {self.rc} at launch")


@pytest.mark.parametrize("dtype,d,layout,asked,body", [
    ("bfloat16", 64, "qkv_views", None, "wgmma"),
    ("bfloat16", 64, "contiguous", "mma", "mma"),
    ("bfloat16", 32, "contiguous", None, "mma"),
    ("float32", 64, "contiguous", None, "fma"),
])
def test_kernel_flash_passes_its_body_and_counts_it(monkeypatch, dtype, d,
                                                    layout, asked, body):
    """The forward's launch passes the body's code to the kernels and
    counts one launch under the kernel's name and one under its body's."""
    q, k, v, _, _ = _routing_operands(DTYPES[dtype][1], d, layout)
    fake = _RecordingKernels()
    monkeypatch.setattr(_build, "kernels", lambda: fake)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    out, lse = _kernel_flash(q, k, v, True, asked)
    assert fake.bodies == [BODIES[body]]
    assert dict(_build.LAUNCHES) == {"flash_attention": 1,
                                     f"flash_attention.{body}": 1}
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (2 * 4, 96) and lse.dtype == torch.float32


def test_kernel_flash_raises_when_its_body_fails(monkeypatch):
    """A wgmma body that fails to encode, build or launch raises to the
    caller: no launch is counted and no other body is tried."""
    q, k, v, _, _ = _routing_operands()
    fake = _RecordingKernels(rc=1)
    monkeypatch.setattr(_build, "kernels", lambda: fake)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _kernel_flash(q, k, v, True)
    assert fake.bodies == [BODIES["wgmma"]]
    assert not _build.LAUNCHES


def test_bwd_body_reads_the_layout_of_o_for_the_dq_pass():
    """O only reaches the dQ pass's tensor maps: an O whose strides TMA
    cannot describe moves the dQ pass off wgmma, not the dK/dV pass."""
    q, k, v, do, _ = _routing_operands()
    out = torch.zeros(2, 96, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert _bwd_body(q, k, v, do) == "wgmma"
    assert _bwd_body(q, k, v, do, out) == "mma"


def test_flash_bf16_gradients_match_jax():
    """bf16 (test_ops.py's test_flash_attention_bf16_forward_and_gradients):
    both sides round P and dS to bf16 before their products. The port's
    gradients and JAX's are each held to the plain bf16 autograd's own
    distance from the fp32 gradient of the same (bf16-rounded) inputs:
    max within 2x, mean within 1.25x."""
    q, k, v = qkv_np(b=1, s_q=256, h=2, d=16, seed=23)
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]

    def loss(attn):
        return lambda q, k, v: (attn(q, k, v).float() ** 2).sum()

    fp32 = torch_grads(loss(_reference_attention), *(t.float() for t in bf))
    plain = torch_grads(loss(_reference_attention), *bf)
    port = torch_grads(loss(flash_attention), *bf)
    jg = jax.grad(lambda q, k, v: jnp.sum(
        jax_flash_attention(q, k, v).astype(jnp.float32) ** 2),
        argnums=(0, 1, 2))(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    for ref, p, got, want in zip(fp32, plain, port, jg):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        err_plain = (p.float() - ref).abs()
        for g in (got.float(), torch.tensor(as_np(want))):
            err = (g - ref).abs()
            assert err.max() <= 2 * err_plain.max()
            assert err.mean() <= 1.25 * err_plain.mean()


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
