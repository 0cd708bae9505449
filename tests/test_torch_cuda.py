"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and skips without one: the kernels have
no CPU mode. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` because the suite's conftest sets up JAX.)
"""

import pytest
import torch

from faabric_tpu_torch.ops import _build
from faabric_tpu_torch.ops.flash_attention import (
    _kernel_flash_bwd_dkv,
    _kernel_flash_bwd_dq,
    _reference_attention,
    _reference_flash_bwd,
    _reference_lse,
    _row_correction,
    flash_attention,
    flash_attention_with_lse,
)
from faabric_tpu_torch.ops.rms_norm import _reference_rms_norm, rms_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


# fp32: summation order only. bf16: both compute in fp32 and round once,
# so a different summation order moves at most one ulp of |out| < 8.
@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(4096, 512), (8, 512), (333, 1000),
                                    (5, 8192)])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3.2e-2)])
def test_rms_norm_kernel_matches_plain(cuda_device, rows, d, dtype, atol):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = torch.randn(rows, d, device=cuda_device, generator=gen).to(DTYPES[dtype])
    scale = torch.rand(d, device=cuda_device, generator=gen)
    before = _build.LAUNCHES["rms_norm"]
    out = rms_norm(x, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rms_norm"] == before + 1
    assert out.dtype == x.dtype
    torch.testing.assert_close(out.float(),
                               _reference_rms_norm(x, scale).float(),
                               atol=atol, rtol=0)


# bf16 at the JAX package's bf16 flash tolerance (3e-2): the kernel rounds
# unnormalised p, the plain version the normalised probabilities. fp32:
# order of the fp32 sums over up to 2048 keys.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s_q,s_k,h,d,causal", [
    (8, 512, 512, 8, 64, True),
    (2, 128, 512, 8, 64, True),
    (2, 256, 256, 4, 64, False),
    (1, 2048, 2048, 8, 64, True),
    (2, 100, 157, 2, 32, True),
    (1, 130, 130, 2, 128, False),
    (1, 64, 64, 2, 16, True),
])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_flash_kernel_matches_plain(cuda_device, b, s_q, s_k, h, d, causal,
                                    dtype, atol):
    gen = torch.Generator(device=cuda_device).manual_seed(s_q * d + s_k)
    q, k, v = (torch.randn(b, s, h, d, device=cuda_device, generator=gen
                           ).to(DTYPES[dtype]) for s in (s_q, s_k, s_k))
    before = _build.LAUNCHES["flash_attention"]
    out, lse = flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(),
                               _reference_attention(q, k, v, causal).float(),
                               atol=atol, rtol=0)
    torch.testing.assert_close(lse, _reference_lse(q, k, causal),
                               atol=atol, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q, k, v as views of one (B, S, 3, H, D) product, as the model
    passes them."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 192, 3, 4, 64, device=cuda_device, generator=gen)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    torch.testing.assert_close(flash_attention(q, k, v),
                               _reference_attention(q, k, v), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn(4, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        rms_norm(x, torch.ones(64, device=cuda_device))
    q = torch.randn(1, 16, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)


@pytest.mark.cuda
def test_flash_kernel_bf16_with_odd_strides(cuda_device):
    """bf16 views whose strides are odd cannot be read as bf16 pairs and
    take the kernel's FMA body; it matches the plain version too."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    base = torch.randn(2, 96, 4, 65, device=cuda_device, generator=gen)
    q = base.to(torch.bfloat16)[..., :64]
    assert q.stride(2) == 65
    out = flash_attention(q, q, q)
    torch.testing.assert_close(out.float(),
                               _reference_attention(q, q, q).float(),
                               atol=3e-2, rtol=0)


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------

BWD_SHAPES = [
    (8, 512, 512, 8, 64, True),
    (8, 512, 512, 8, 64, False),
    (8, 128, 512, 8, 64, True),
    (2, 100, 157, 2, 32, True),
    (1, 2048, 2048, 8, 64, True),
    (1, 130, 130, 2, 128, False),
    (1, 64, 64, 2, 16, True),
]


def bwd_inputs(device, b, s_q, s_k, h, d, causal, dtype, g_lse=False,
               strided=False):
    """q, k, v (views of one QKV product when ``strided``), a cotangent,
    and the forward's lse with the row correction delta."""
    gen = torch.Generator(device=device).manual_seed(s_q * d + s_k + b)
    if strided:
        qkv = torch.randn(b, s_q, 3, h, d, device=device, generator=gen)
        q, k, v = (qkv.to(dtype)[:, :, i] for i in range(3))
    else:
        q, k, v = (torch.randn(b, s, h, d, device=device, generator=gen
                               ).to(dtype) for s in (s_q, s_k, s_k))
    do = torch.randn(b, s_q, h, d, device=device, generator=gen).to(dtype)
    out, lse = flash_attention_with_lse(q, k, v, causal)
    g = (torch.randn(b * h, s_q, device=device, generator=gen)
         if g_lse else None)
    return q, k, v, do, lse, _row_correction(do, out, g)


def assert_bwd_close(got, q, k, v, do, lse, delta, causal):
    """fp32: the kernels and the plain version differ only in the order of
    fp32 sums (the JAX tests' 2e-4 / 1e-3). bf16: both round at the same
    places, so each gradient is held to the plain bf16 version's own
    distance from the fp32 computation on the same inputs: max within 2x,
    mean within 1.25x."""
    want = _reference_flash_bwd(q, k, v, do, lse, delta, causal)
    if q.dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-4, rtol=1e-3)
        return
    f32 = _reference_flash_bwd(q.float(), k.float(), v.float(), do.float(),
                               lse, delta, causal)
    for g, w, y in zip(got, want, f32):
        assert g.dtype == torch.bfloat16
        err_k = (g.float() - y).abs()
        err_r = (w.float() - y).abs()
        assert float(err_k.max()) <= 2 * float(err_r.max()) + 1e-6
        assert float(err_k.mean()) <= 1.25 * float(err_r.mean()) + 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_q,s_k,h,d,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain(cuda_device, b, s_q, s_k, h, d,
                                       causal, dtype):
    ins = bwd_inputs(cuda_device, b, s_q, s_k, h, d, causal, DTYPES[dtype])
    before = dict(_build.LAUNCHES)
    dq = _kernel_flash_bwd_dq(*ins, causal)
    dk, dv = _kernel_flash_bwd_dkv(*ins, causal)
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    assert_bwd_close((dq, dk, dv), *ins, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["g_lse", "strided"])
def test_flash_bwd_kernels_with_lse_cotangent_and_views(cuda_device, dtype,
                                                        variant):
    ins = bwd_inputs(cuda_device, 2, 192, 192, 4, 64, True, DTYPES[dtype],
                     g_lse=variant == "g_lse", strided=variant == "strided")
    dq = _kernel_flash_bwd_dq(*ins, True)
    dk, dv = _kernel_flash_bwd_dkv(*ins, True)
    assert_bwd_close((dq, dk, dv), *ins, True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_q,s_k,h,d,causal", [
    (2, 256, 256, 4, 64, True), (2, 128, 256, 4, 64, True),
    (2, 100, 157, 2, 32, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_gradients_match_autograd_of_plain_attention(
        cuda_device, b, s_q, s_k, h, d, causal, dtype, with_lse):
    """The whole Function (forward kernel, delta, both backward kernels)
    against autograd through the plain attention and lse. fp32 at the JAX
    tests' 2e-4 / 1e-3; bf16 held to the plain bf16 autograd's own
    distance from fp32 autograd (max within 2x)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    base = [torch.randn(b, s, h, d, device=cuda_device, generator=gen)
            for s in (s_q, s_k, s_k)]
    g_out = torch.randn(b, s_q, h, d, device=cuda_device, generator=gen)
    g_lse = torch.randn(b * h, s_q, device=cuda_device, generator=gen)

    def grads(fn, dt):
        ts = [t.to(dt).requires_grad_() for t in base]
        out, lse = fn(*ts)
        loss = (out.float() * g_out).sum()
        if with_lse:
            loss = loss + (lse * g_lse).sum()
        return torch.autograd.grad(loss, ts)

    def kernel(q, k, v):
        if with_lse:
            return flash_attention_with_lse(q, k, v, causal)
        return flash_attention(q, k, v, causal), torch.zeros(())

    def plain(q, k, v):
        return (_reference_attention(q, k, v, causal),
                _reference_lse(q, k, causal))

    before = dict(_build.LAUNCHES)
    got = grads(kernel, DTYPES[dtype])
    for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    if dtype == "float32":
        for g, w in zip(got, grads(plain, torch.float32)):
            torch.testing.assert_close(g, w, atol=2e-4, rtol=1e-3)
        return
    f32 = grads(plain, torch.float32)
    ref = grads(plain, torch.bfloat16)
    for g, w, y in zip(got, ref, f32):
        assert g.dtype == torch.bfloat16
        assert (float((g.float() - y).abs().max())
                <= 2 * float((w.float() - y).abs().max()))
