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
    _reference_attention,
    _reference_lse,
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
