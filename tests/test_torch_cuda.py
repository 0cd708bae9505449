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
    _bwd_body,
    _fwd_body,
    _kernel_flash,
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
                                    (5, 8192), (512, 512), (1, 512)])
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


@pytest.mark.cuda
def test_kernel_launches_from_threads_are_counted_exactly(cuda_device):
    """Executor threads launch kernels at once on one card: every launch
    is counted and every result matches the plain version."""
    import threading

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    xs = [torch.randn(512, 512, device=cuda_device, generator=gen).to(
        torch.bfloat16) for _ in range(8)]
    scale = torch.rand(512, device=cuda_device, generator=gen) + 0.5
    want = [_reference_rms_norm(x, scale) for x in xs]
    before = _build.LAUNCHES["rms_norm"]
    errors = []

    def run(i):
        try:
            for _ in range(50):
                out = rms_norm(xs[i], scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), want[i].float(),
                                       atol=3.2e-2, rtol=0)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert _build.LAUNCHES["rms_norm"] == before + 8 * 50


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
# Forward kernel bodies
# ---------------------------------------------------------------------------

def fwd_inputs(device, b, s_q, s_k, h, layout="separate", seed=0):
    """bf16 q, k, v at D = 64: separate tensors, or views of one
    (B, S, 3, H, 64) product as the model passes them."""
    gen = torch.Generator(device=device).manual_seed(seed + s_q * 7 + s_k)
    if layout == "qkv_views":
        qkv = torch.randn(b, s_q, 3, h, 64, device=device, generator=gen
                          ).to(torch.bfloat16)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return tuple(torch.randn(b, s, h, 64, device=device, generator=gen
                             ).to(torch.bfloat16) for s in (s_q, s_k, s_k))


def run_fwd(q, k, v, causal, body=None):
    """(out, lse) from the forward kernel, with the launches it counted."""
    before = dict(_build.LAUNCHES)
    out, lse = _kernel_flash(q, k, v, causal, body)
    torch.cuda.synchronize()
    grew = {n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items()
            if n.startswith("flash_attention") and c != before.get(n, 0)}
    return out, lse, grew


def fwd_key_step(b, s_q, h):
    """Keys a softmax step of the wgmma body covers, as its launcher picks
    them: 128 where the grid has at most two CTAs a SM, else 64."""
    ctas = b * h * -(-s_q // 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 128 if ctas <= 2 * sms else 64


# (b, s_q, s_k, h, causal, layout, keys): the serving shape, the
# end-aligned offset (S_q < S_k), non-causal, ragged lengths both ways,
# long, and the model's QKV views (1 x 512: a request served through the
# planner), each on the key step its grid takes on the H100 (132 SMs).
# O and lse are each held at the bf16 flash tolerance.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s_q,s_k,h,causal,layout,keys", [
    (8, 512, 512, 8, True, "separate", 64),
    (8, 128, 512, 8, True, "separate", 128),
    (8, 448, 512, 8, True, "separate", 64),
    (8, 512, 512, 8, False, "separate", 64),
    (2, 100, 157, 2, False, "separate", 128),
    (2, 157, 100, 2, False, "separate", 128),
    (8, 500, 530, 8, False, "separate", 64),
    (8, 530, 500, 8, False, "separate", 64),
    (1, 2048, 2048, 8, True, "separate", 128),
    (2, 192, 192, 4, True, "qkv_views", 128),
    (8, 520, 520, 8, True, "qkv_views", 64),
    (1, 512, 512, 8, True, "qkv_views", 128),
])
def test_flash_fwd_wgmma_body_matches_plain(cuda_device, b, s_q, s_k, h,
                                            causal, layout, keys):
    q, k, v = fwd_inputs(cuda_device, b, s_q, s_k, h, layout)
    assert _fwd_body(q, k, v) == "wgmma"
    assert fwd_key_step(b, s_q, h) == keys
    out, lse, grew = run_fwd(q, k, v, causal)
    assert grew == {"flash_attention": 1, "flash_attention.wgmma": 1}
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(),
                               _reference_attention(q, k, v, causal).float(),
                               atol=3e-2, rtol=0)
    torch.testing.assert_close(lse, _reference_lse(q, k, causal),
                               atol=3e-2, rtol=0)


@pytest.mark.cuda
def test_flash_fwd_wgmma_lse_is_the_fp32_log_sum_exp(cuda_device):
    """The plain lse rounds its bf16 scores; against the fp32 scores of
    the same bf16 inputs the kernel's natural-log lse (taken as
    (m2 + log2 l) ln 2) is exact to fp32 summation order."""
    q, k, v = fwd_inputs(cuda_device, 2, 300, 300, 4)
    _, lse, _ = run_fwd(q, k, v, True)
    torch.testing.assert_close(lse, _reference_lse(q.float(), k.float(), True),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_wgmma_body_repeats_bitwise(cuda_device, causal):
    q, k, v = fwd_inputs(cuda_device, 2, 157, 300, 4)
    first = run_fwd(q, k, v, causal)
    second = run_fwd(q, k, v, causal)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,causal", [(8, 512, True), (2, 157, False)])
def test_flash_fwd_wgmma_and_mma_bodies_agree(cuda_device, b, s, causal):
    """Both bodies round p to bf16 at the same point; they differ in exp2
    against exp and in the order of sums. Each is held to the plain bf16
    path's distance from fp32 (max within 2x, mean within 1.25x), and so
    is their distance from each other."""
    q, k, v = fwd_inputs(cuda_device, b, s, s, 8)
    got = {body: run_fwd(q, k, v, causal, body) for body in ("wgmma", "mma")}
    for body, (_, _, grew) in got.items():
        assert grew == {"flash_attention": 1, f"flash_attention.{body}": 1}
    f32 = _reference_attention(q.float(), k.float(), v.float(), causal)
    noise = (_reference_attention(q, k, v, causal).float() - f32).abs()
    pairs = [(got["wgmma"][0].float(), f32), (got["mma"][0].float(), f32),
             (got["wgmma"][0].float(), got["mma"][0].float())]
    for x, y in pairs:
        err = (x - y).abs()
        assert float(err.max()) <= 2 * float(noise.max())
        assert float(err.mean()) <= 1.25 * float(noise.mean())


@pytest.mark.cuda
def test_flash_fwd_bodies_refuse_operands_they_do_not_take(cuda_device):
    """A body asked for operands it cannot take raises, whether the
    caller or the launcher refuses: no other body stands in."""
    q32 = torch.randn(1, 64, 2, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernel_flash(q32, q32, q32, True, "wgmma")
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernel_flash(q32, q32, q32, True, "mma")
    q16 = torch.randn(1, 64, 2, 32, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernel_flash(q16, q16, q16, True, "wgmma")
    # Two values past a 16-byte boundary: no tensor map can describe it
    flat = torch.randn(64 * 2 * 64 + 2, device=cuda_device).to(torch.bfloat16)
    qx = flat[2:].view(1, 64, 2, 64)
    assert _fwd_body(qx, qx, qx) == "mma"
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernel_flash(qx, qx, qx, True, "wgmma")
    o = torch.empty_like(qx)
    lse = torch.empty(2, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.kernels().flash_fwd(qx, qx, qx, o, lse, 0.125, True, 7)


@pytest.mark.cuda
def test_flash_fwd_raises_when_its_kernel_fails(cuda_device, monkeypatch):
    """A kernel that does not build fails the forward on the caller; the
    plain version never stands in on the card."""
    q, k, v = fwd_inputs(cuda_device, 1, 64, 64, 2)

    def no_build():
        raise RuntimeError("injected: kernel build failed")

    monkeypatch.setattr(_build, "kernels", no_build)
    before = _build.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="injected"):
        flash_attention(q, k, v)
    assert _build.LAUNCHES["flash_attention"] == before


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------

# (b, s_q, s_k, h, d, causal): the training shape, non-causal, cross
# length (S_q < S_k), S not a multiple of 64 (100/157, 100/100), long,
# and every head dim (wgmma takes bf16 at 64, mma bf16 at 16 and 32, fma
# float32 and D = 128)
BWD_SHAPES = [
    (8, 512, 512, 8, 64, True),
    (8, 512, 512, 8, 64, False),
    (8, 128, 512, 8, 64, True),
    (2, 100, 157, 2, 64, True),
    (2, 100, 100, 2, 64, False),
    (2, 100, 157, 2, 32, True),
    (1, 2048, 2048, 8, 64, True),
    (1, 130, 130, 2, 128, False),
    (1, 64, 64, 2, 16, True),
]


def bwd_inputs(device, b, s_q, s_k, h, d, causal, dtype, g_lse=False,
               strided=False):
    """q, k, v (views of one QKV product when ``strided``), a cotangent,
    the forward's O and lse, and the lse's cotangent (None unless
    ``g_lse``)."""
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
    return q, k, v, do, out, lse, g


def run_bwd_kernels(q, k, v, do, out, lse, g_lse, causal):
    """(dq, dk, dv, delta) from the two kernels, as the Function runs them."""
    dq, delta = _kernel_flash_bwd_dq(q, k, v, do, out, lse, g_lse, causal)
    return (dq, *_kernel_flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            delta)


def assert_bwd_close(got, q, k, v, do, out, lse, g_lse, causal):
    """fp32: the kernels and the plain version differ only in the order of
    fp32 sums (the JAX tests' 2e-4 / 1e-3). bf16: both round at the same
    places, so each gradient is held to the plain bf16 version's own
    distance from the fp32 computation on the same inputs: max within 2x,
    mean within 1.25x. The plain version takes the row correction from
    ``_row_correction``."""
    delta = _row_correction(do, out, g_lse)
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
    body = _bwd_body(*ins[:5])
    before = dict(_build.LAUNCHES)
    *grads, _ = run_bwd_kernels(*ins, causal)
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
        assert (_build.LAUNCHES[f"{name}.{body}"]
                == before.get(f"{name}.{body}", 0) + 1)
    assert_bwd_close(grads, *ins, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["g_lse", "strided"])
def test_flash_bwd_kernels_with_lse_cotangent_and_views(cuda_device, dtype,
                                                        variant):
    ins = bwd_inputs(cuda_device, 2, 192, 192, 4, 64, True, DTYPES[dtype],
                     g_lse=variant == "g_lse", strided=variant == "strided")
    if dtype == "bfloat16":
        assert _bwd_body(*ins[:5]) == "wgmma"
    *grads, _ = run_bwd_kernels(*ins, True)
    assert_bwd_close(grads, *ins, True)


# The row correction as the dQ kernel writes it against _row_correction:
# fp32 sums of D products in another order (rtol 1e-5, and atol 1e-5 for
# rows whose sum cancels to near zero)
@pytest.mark.cuda
@pytest.mark.parametrize("b,s_q,s_k,h,d,dtype", [
    (8, 512, 512, 8, 64, "bfloat16"),
    (2, 100, 157, 2, 64, "bfloat16"),
    (2, 100, 157, 2, 32, "bfloat16"),
    (1, 130, 130, 2, 128, "bfloat16"),
    (2, 100, 157, 2, 64, "float32"),
])
@pytest.mark.parametrize("with_g_lse", [False, True])
def test_flash_bwd_dq_writes_the_row_correction(cuda_device, b, s_q, s_k, h,
                                                 d, dtype, with_g_lse):
    q, k, v, do, out, lse, g = bwd_inputs(cuda_device, b, s_q, s_k, h, d,
                                          True, DTYPES[dtype], with_g_lse)
    _, delta = _kernel_flash_bwd_dq(q, k, v, do, out, lse, g, True)
    assert delta.shape == (b * h, s_q) and delta.dtype == torch.float32
    torch.testing.assert_close(delta, _row_correction(do, out, g),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_q,s_k,h,d,causal,dtype", [
    (8, 512, 512, 8, 64, True, "bfloat16"),
    (2, 100, 157, 2, 64, True, "bfloat16"),
    (2, 100, 157, 2, 32, True, "bfloat16"),
    (2, 100, 157, 2, 64, True, "float32"),
])
def test_flash_bwd_kernels_repeat_bitwise(cuda_device, b, s_q, s_k, h, d,
                                          causal, dtype):
    """Two passes and no atomics: two calls give the same bits, which the
    checkpoint-resumed training run relies on."""
    ins = bwd_inputs(cuda_device, b, s_q, s_k, h, d, causal, DTYPES[dtype],
                     g_lse=True)
    first = run_bwd_kernels(*ins, causal)
    second = run_bwd_kernels(*ins, causal)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,body", [
    (64, "bfloat16", "wgmma"), (32, "bfloat16", "mma"),
    (64, "float32", "fma"), (128, "bfloat16", "fma")])
def test_flash_bwd_counts_launches_per_body(cuda_device, d, dtype, body):
    """The training shape takes the wgmma body, fp32 and D = 128 the fma
    body and bf16 at D = 32 the mma body; each pass counts one launch
    under its own name and one under its body's."""
    ins = bwd_inputs(cuda_device, 8 if d == 64 else 2, 512, 512,
                     8 if d == 64 else 2, d, True, DTYPES[dtype])
    assert _bwd_body(*ins[:5]) == body
    before = dict(_build.LAUNCHES)
    run_bwd_kernels(*ins, True)
    grew = {n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items()
            if n.startswith("flash_bwd") and c != before.get(n, 0)}
    assert grew == {"flash_bwd_dq": 1, f"flash_bwd_dq.{body}": 1,
                    "flash_bwd_dkv": 1, f"flash_bwd_dkv.{body}": 1}


@pytest.mark.cuda
def test_flash_bwd_mma_body_keeps_pair_aligned_bf16_views(cuda_device):
    """bf16 views two values past a 16-byte boundary: TMA cannot take
    them, the mma body can, and it matches the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, s, h, d = 2, 160, 2, 64
    flat = [torch.randn(b * s * h * d + 2, device=cuda_device, generator=gen
                        ).to(torch.bfloat16)[2:].view(b, s, h, d)
            for _ in range(4)]
    q, k, v, do = flat
    out, lse = flash_attention_with_lse(q, k, v, True)
    assert _bwd_body(q, k, v, do, out) == "mma"
    *grads, _ = run_bwd_kernels(q, k, v, do, out, lse, None, True)
    assert_bwd_close(grads, q, k, v, do, out, lse, None, True)


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


# ---------------------------------------------------------------------------
# Device-plane ring permute
# ---------------------------------------------------------------------------

RING_DTYPES = [torch.int32, torch.float32, torch.bfloat16, torch.uint8]


def ring_inputs(device, n, m, dtype, misaligned, seed):
    """n shards of m elements from one generator; ``misaligned`` makes
    each a view one element past a 16-byte boundary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    off = 1 if misaligned else 0
    if dtype.is_floating_point:
        bases = [torch.randn(m + off, device=device, generator=gen).to(dtype)
                 for _ in range(n)]
    else:
        info = torch.iinfo(dtype)
        bases = [torch.randint(info.min, info.max, (m + off,), device=device,
                               generator=gen, dtype=torch.int64).to(dtype)
                 for _ in range(n)]
    return [b[off:] for b in bases]


# Bitwise: the kernel and its plain version move bytes, no arithmetic
@pytest.mark.cuda
@pytest.mark.parametrize("m", [11_338_880, 1_000_003, 1])
@pytest.mark.parametrize("dtype", RING_DTYPES, ids=str)
@pytest.mark.parametrize("misaligned", [False, True])
def test_ring_permute_kernel_matches_plain(cuda_device, m, dtype,
                                           misaligned):
    from faabric_tpu_torch.ops.ring_permute import (
        _reference_ring_permute,
        ring_permute,
    )

    n = 4
    ins = ring_inputs(cuda_device, n, m, dtype, misaligned, m + n)
    assert (ins[0].data_ptr() % 16 != 0) == misaligned
    for shift in (1, 2, 3):
        before = _build.LAUNCHES["ring_permute"]
        got = ring_permute(ins, shift)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["ring_permute"] == before + 1
        want = [torch.empty_like(t) for t in ins]
        _reference_ring_permute(ins, want, shift)
        for r in range(n):
            assert torch.equal(got[r], want[r])
            assert torch.equal(got[r], ins[(r - shift) % n])


@pytest.mark.cuda
def test_ring_permute_kernel_refuses_what_it_does_not_take(cuda_device):
    from faabric_tpu_torch.ops.ring_permute import MAX_RANKS, ring_permute

    x = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        ring_permute([x] * (MAX_RANKS + 1), 1)
    with pytest.raises(ValueError, match="contiguous"):
        ring_permute([torch.zeros(8, 2, device=cuda_device)[:, 0]] * 2, 1)
    with pytest.raises(ValueError, match="one device"):
        ring_permute([x, x.double()], 1)


def card_world(n: int, group: int):
    """A world of n rank threads whose ranks all map to the card, and its
    allgather.ring schedule."""
    from faabric_tpu_torch.batch_scheduler import SchedulingDecision
    from faabric_tpu_torch.mpi import MpiWorld
    from faabric_tpu_torch.mpi.schedule_compile import compile_schedule
    from faabric_tpu_torch.transport import PointToPointBroker

    broker = PointToPointBroker("card")
    d = SchedulingDecision(app_id=group, group_id=group)
    for r in range(n):
        d.add_message("card", r, r, r, device_id=r)
    broker.set_up_local_mappings_from_decision(d)
    world = MpiWorld(broker, group, n, group)
    return world, compile_schedule("allgather.ring", "allgather",
                                   world.topology())


def on_rank_threads(n: int, fn) -> tuple[dict, dict]:
    """``fn(rank)`` on n threads: (results, exceptions) by rank."""
    import threading

    results, errors = {}, {}

    def rank(r):
        try:
            results[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — returned to the test
            errors[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a rank thread hung"
    return results, errors


@pytest.mark.cuda
def test_world_on_one_card_runs_allgather_ring_through_the_kernel(
        cuda_device):
    """Four rank threads on cuda:0: the plane activates with every rank
    on the one card, and the allgather.ring schedule's ring phase is
    three launches of the ring kernel, with no host copies."""
    from faabric_tpu_torch.device_plane import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.mpi.types import MpiMessageType

    n, k = 4, 1 << 16
    world, sched = card_world(n, 960)
    shards = [torch.arange(k, device=cuda_device, dtype=torch.float32)
              + 1e6 * r for r in range(n)]

    def rank(r):
        assert world.activate_device_plane(r)
        env = {("in", 0): shards[r]}
        world._run_schedule(r, sched, env, None, lambda s, e: k,
                            MpiMessageType.ALLGATHER)
        return torch.cat([env[("out", q)] for q in range(n)])

    before = _build.LAUNCHES["ring_permute"]
    reset_device_copy_totals()
    results, errors = on_rank_threads(n, rank)
    assert not errors, errors
    torch.cuda.synchronize()
    plane = world.device_plane()
    assert plane.device == cuda_device and plane.disabled_reason is None
    assert _build.LAUNCHES["ring_permute"] == before + n - 1
    assert device_copy_totals()["count"] == 0
    want = torch.cat(shards)
    for r in range(n):
        assert torch.equal(results[r], want)


@pytest.mark.cuda
def test_world_on_one_card_raises_when_the_ring_kernel_fails(
        cuda_device, monkeypatch):
    """A ring kernel that does not build fails the resident allgather.ring
    on every rank: no host steps, no staging copy, the plane stays
    enabled."""
    from faabric_tpu_torch.device_plane import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.mpi.types import MpiMessageType

    n, k = 4, 1 << 10
    world, sched = card_world(n, 961)
    results, errors = on_rank_threads(n, world.activate_device_plane)
    assert not errors and all(results.values())
    shards = [torch.full((k,), r, device=cuda_device) for r in range(n)]

    def no_build():
        raise RuntimeError("injected: kernel build failed")

    monkeypatch.setattr(_build, "kernels", no_build)
    before = _build.LAUNCHES["ring_permute"]
    reset_device_copy_totals()
    _, errors = on_rank_threads(n, lambda r: world._run_schedule(
        r, sched, {("in", 0): shards[r]}, None, lambda s, e: k,
        MpiMessageType.ALLGATHER))
    assert sorted(errors) == list(range(n))
    assert all("injected" in str(e) for e in errors.values()), errors
    assert _build.LAUNCHES["ring_permute"] == before
    assert device_copy_totals()["count"] == 0
    assert world.device_plane().disabled_reason is None


# ---------------------------------------------------------------------------
# The mesh path: the differentiable ring shift, ring attention and the
# sharded train step, all ranks on one card
# ---------------------------------------------------------------------------

def card_mesh(device, n=8, **kw):
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh

    return build_mesh([device] * n, MeshConfig(**kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_shift_is_the_ring_kernel_forward_and_backward(cuda_device,
                                                            dtype):
    """``DeviceCollectives.shift`` of same-shape buffers on one card: one
    ring-permute launch forward, one backward (the inverse shift), both
    bitwise against the plain copies; strided views are made contiguous
    and launch too, and a ring longer than the kernel takes raises."""
    from faabric_tpu_torch.ops.ring_permute import MAX_RANKS
    from faabric_tpu_torch.parallel import DeviceCollectives

    coll = DeviceCollectives([cuda_device] * 4)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    xs = [torch.randn(4, 256, 4, 64, device=cuda_device, generator=gen)
          .to(DTYPES[dtype]).requires_grad_() for _ in range(4)]
    cots = [torch.randn(4, 256, 4, 64, device=cuda_device, generator=gen)
            .to(DTYPES[dtype]) for _ in range(4)]
    before = _build.LAUNCHES["ring_permute"]
    ys = coll.shift(xs, 1)
    torch.autograd.backward(ys, cots)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ring_permute"] == before + 2
    for r in range(4):
        assert torch.equal(ys[(r + 1) % 4], xs[r].detach())
        assert torch.equal(xs[r].grad, cots[(r + 1) % 4])
    views = [x.detach().transpose(1, 2) for x in xs]
    out = coll.shift(views, 3)
    assert _build.LAUNCHES["ring_permute"] == before + 3
    for r in range(4):
        assert torch.equal(out[(r + 3) % 4], views[r])
    long = DeviceCollectives([cuda_device] * (MAX_RANKS + 1))
    with pytest.raises(ValueError, match="at most"):
        long.shift([torch.zeros(8, device=cuda_device)] * (MAX_RANKS + 1))


def ring_inputs_on_mesh(device, mesh, dtype, layout, seed=0):
    """Per-rank (4, 256, 4, 64) q, k, v of a (8, 512, 8, 64) whole split
    over dp, sp and tp, as separate tensors or as views of each rank's
    QKV product (as the model passes them), and per-rank cotangents."""
    from faabric_tpu_torch.parallel import ShardSpec

    gen = torch.Generator(device=device).manual_seed(seed)
    spec = ShardSpec(mesh, ("dp", "sp", "tp", None))
    if layout == "views":
        # (B, S, H, 3, D) split as q, k, v are, then each rank's piece
        # laid out as its own (B_l, S_l, 3, H_l, D) product
        pieces = spec.shard(torch.randn(8, 512, 8, 3, 64, device=device,
                                        generator=gen))
        per_rank = [t.transpose(2, 3).contiguous().to(dtype) for t in pieces]
        q, k, v = ([t[:, :, i] for t in per_rank] for i in range(3))
    else:
        q, k, v = (spec.shard(torch.randn(8, 512, 8, 64, device=device,
                                          generator=gen).to(dtype))
                   for _ in range(3))
    g = spec.shard(torch.randn(8, 512, 8, 64, device=device, generator=gen))
    return q, k, v, g


@pytest.mark.cuda
@pytest.mark.parametrize("causal,dtype,layout", [
    (True, "bfloat16", "separate"), (True, "bfloat16", "views"),
    (False, "bfloat16", "separate"), (True, "float32", "separate")])
def test_ring_attention_kernels_match_plain_blocks(cuda_device, causal,
                                                   dtype, layout):
    """Ring attention over 8 ranks on one card (4 rings of sp = 2, blocks
    (4, 256, 4, 64)) against the same schedule with plain blocks, forward
    and q, k, v gradients: fp32 at the JAX tests' tolerances, bf16 out at
    the flash tolerance 3e-2 and gradients held to the plain bf16
    schedule's distance from the fp32 one (max 2x, mean 1.25x). Launch
    counts are the schedule's, every bf16 flash launch on ``wgmma``."""
    from faabric_tpu_torch.parallel import ring_attention
    from faabric_tpu_torch.parallel.ring_attention import (
        _flash_block,
        _plain_block,
        schedule_counts,
    )

    mesh = card_mesh(cuda_device, tp=2, sp=2)
    q, k, v, g = ring_inputs_on_mesh(cuda_device, mesh, DTYPES[dtype], layout)

    def run(block, dt=None):
        ts = [[(t if dt is None else t.to(dt)).detach().requires_grad_()
               for t in x] for x in (q, k, v)]
        out = ring_attention(*ts, mesh, causal=causal, block=block)
        torch.autograd.backward(out, [c.to(o.dtype) for c, o in zip(g, out)])
        return out, [[t.grad for t in x] for x in ts]

    _build.reset_launch_counts()
    out_k, grads_k = run(_flash_block)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = schedule_counts(mesh.size, 2, causal)
    assert launches.get("flash_attention", 0) == want["flash_attention"]
    assert launches.get("flash_bwd_dq", 0) == want["flash_attention"]
    assert launches.get("flash_bwd_dkv", 0) == want["flash_attention"]
    assert launches.get("ring_permute", 0) == 2 * want["ring_permute"]
    if dtype == "bfloat16":
        for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches.get(f"{name}.wgmma", 0) == launches[name], name
    out_p, grads_p = run(_plain_block)
    if dtype == "float32":
        for a, b in zip(out_k, out_p):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        for gk, gp in zip(grads_k, grads_p):
            for a, b in zip(gk, gp):
                torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)
        return
    out_32, grads_32 = run(_plain_block, torch.float32)
    for a, b in zip(out_k, out_p):
        assert float((a.detach().float() - b.detach().float()).abs().max()) <= 3e-2
    for gk, gp, g32 in zip(grads_k, grads_p, grads_32):
        err_k = torch.stack([(a.float() - y).abs().max()
                             for a, y in zip(gk, g32)])
        err_r = torch.stack([(b.float() - y).abs().max()
                             for b, y in zip(gp, g32)])
        mean_k = sum(float((a.float() - y).abs().mean())
                     for a, y in zip(gk, g32))
        mean_r = sum(float((b.float() - y).abs().mean())
                     for b, y in zip(gp, g32))
        assert float(err_k.max()) <= 2 * float(err_r.max()) + 1e-6
        assert mean_k <= 1.25 * mean_r + 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("n,tp,sp", [(8, 2, 2), (4, 2, 1)])
def test_sharded_train_step_on_one_card(cuda_device, n, tp, sp):
    """One train step of a head-dim-64 model sharded over n ranks on
    cuda:0: the launches the schedule implies (remat runs each forward
    twice), every one on ``wgmma``, no RMS-norm kernel (a mesh takes the
    plain norm); the fp32 loss within 1e-4 of the unsharded model's on
    the same weights, the bf16 loss within 2e-2."""
    import dataclasses

    import numpy as np

    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        data_sharding,
        loss_fn,
        make_train_step,
        shard_params,
    )
    from faabric_tpu_torch.parallel.ring_attention import schedule_counts

    cfg = ModelConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                      d_ff=512, max_seq=256)
    mesh = card_mesh(cuda_device, n, tp=tp, sp=sp)
    rng = np.random.RandomState(0)
    tok, tgt = (rng.randint(0, 512, (4, 128)).astype(np.int32)
                for _ in range(2))
    shard = data_sharding(mesh).shard
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        plain = Transformer(c, device=cuda_device)
        model = shard_params(plain, mesh, c)
        with torch.no_grad():
            want = float(loss_fn(plain, torch.as_tensor(tok, device=cuda_device),
                                 torch.as_tensor(tgt, device=cuda_device)))
            got = float(loss_fn(model, shard(tok), shard(tgt))[0])
        assert abs(got - want) <= tol, (dt, got, want)
    opt = torch.optim.AdamW(model.parameters())
    step = make_train_step(model.cfg)
    _build.reset_launch_counts()
    loss = step(model, opt, shard(tok), shard(tgt))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    per_call = (schedule_counts(n, sp) if sp > 1
                else {"flash_attention": n, "ring_permute": 0})
    layers = cfg.n_layers
    want = {"flash_attention": 2 * layers * per_call["flash_attention"],
            "flash_bwd_dq": layers * per_call["flash_attention"],
            "flash_bwd_dkv": layers * per_call["flash_attention"],
            "ring_permute": 3 * layers * per_call["ring_permute"]}
    for name, count in want.items():
        assert launches.get(name, 0) == count, (name, launches)
        if name != "ring_permute":
            assert launches.get(f"{name}.wgmma", 0) == count, name
    assert launches.get("rms_norm", 0) == 0
    assert np.isfinite(float(loss[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(2, 8), (4, 4), (8, 8)])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_flash_kernels_at_the_moe_paths_shapes(cuda_device, b, h, dtype, atol):
    """The flash forward, dQ and dK/dV at the MoE family's per-rank
    shapes ((2, 512, 8, 64) at dp 4 x ep 2, (4, 512, 4, 64) at dp 2 x tp
    2 x ep 2, and (8, 512, 8, 64) unsharded) against their plain
    versions; bf16 on ``wgmma``."""
    q, k, v, do, out, lse, _ = bwd_inputs(cuda_device, b, 512, 512, h, 64,
                                          True, DTYPES[dtype])
    want = _reference_attention(q, k, v, True)
    assert float((out.float() - want.float()).abs().max()) <= atol
    _build.reset_launch_counts()
    got = run_bwd_kernels(q, k, v, do, out, lse, None, True)
    torch.cuda.synchronize()
    assert_bwd_close(got[:3], q, k, v, do, out, lse, None, True)
    if dtype == "bfloat16":
        assert _fwd_body(q, k, v) == "wgmma"
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert _build.LAUNCHES.get(f"{name}.wgmma", 0) == 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("schedule_name", ["gpipe", "1f1b"])
def test_pipeline_step_hops_on_the_ring_kernel(cuda_device, schedule_name):
    """A pipeline step over 8 ranks on one card (dp 2, tp 2, pp 2) at a
    head-dim-64 config: every stage-to-stage hop is one ring-permute
    launch per pp group, ``hop_counts`` of them; stages run plain
    attention and norm (no flash or RMS launch); the fp32 loss within
    1e-4 of the unsharded model's on the same weights and batch."""
    import numpy as np

    from faabric_tpu_torch.models import ModelConfig, Transformer, loss_fn
    from faabric_tpu_torch.parallel import init_pp_train_state, make_pp_train_step
    from faabric_tpu_torch.models import params_from_jax, params_to_numpy
    from faabric_tpu_torch.parallel.pipeline import (
        PipelinedTransformer,
        hop_counts,
        unstack_block_params,
    )

    cfg = ModelConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                      d_ff=512, max_seq=256, compute_dtype=torch.float32)
    mesh = card_mesh(cuda_device, tp=2, pp=2)
    rng = np.random.RandomState(0)
    tok, tgt = (rng.randint(0, 512, (8, 128)).astype(np.int32)
                for _ in range(2))
    model, opt = init_pp_train_state(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, mesh)
    assert isinstance(model, PipelinedTransformer)
    plain = params_from_jax(unstack_block_params(params_to_numpy(model)), cfg,
                            device=cuda_device)
    with torch.no_grad():
        want = float(loss_fn(plain, torch.as_tensor(tok, device=cuda_device),
                             torch.as_tensor(tgt, device=cuda_device)))
    step = make_pp_train_step(cfg, n_microbatches=4,
                              schedule_name=schedule_name)
    _build.reset_launch_counts()
    loss = float(step(model, opt, tok, tgt)[0])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert abs(loss - want) <= 1e-4, (loss, want)
    assert launches.get("ring_permute", 0) == hop_counts(2, 4)[
        schedule_name] * 4, launches
    for name in ("rms_norm", "flash_attention", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        assert launches.get(name, 0) == 0, (name, launches)


@pytest.mark.cuda
def test_ring_kernel_at_the_pp_hop_shape(cuda_device):
    """One pp hop at full width: each rank's (1, 512, 512) bf16
    activation over a ring of 2, forward (+1) and back (-1), bitwise."""
    from faabric_tpu_torch.ops.ring_permute import ring_permute

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    act = [torch.randn(1, 512, 512, device=cuda_device, generator=gen)
           .to(torch.bfloat16) for _ in range(2)]
    for disp in (1, -1):
        out = ring_permute(act, disp)
        torch.cuda.synchronize()
        for r in range(2):
            assert torch.equal(out[r], act[(r - disp) % 2])


@pytest.mark.cuda
def test_moe_on_one_card_launches_its_kernels(cuda_device):
    """The MoE family at a head-dim-64 config on one card: the unsharded
    forward launches the RMS-norm kernel (ln1) and a ``wgmma`` flash
    forward once a layer; a sharded step over (dp 4, ep 2) one flash
    forward, dQ and dK/dV per rank and layer (no remat), no RMS kernel;
    the fp32 sharded loss within 1e-4 of the plain unsharded one."""
    import dataclasses

    import numpy as np

    from faabric_tpu_torch.models import (
        MoEConfig,
        MoETransformer,
        data_sharding,
        make_moe_train_step,
        moe_forward,
        moe_loss_fn,
        shard_moe_params,
    )

    cfg = MoEConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                    d_ff=512, max_seq=256)
    rng = np.random.RandomState(1)
    tok, tgt = (rng.randint(0, 512, (8, 128)).astype(np.int32)
                for _ in range(2))
    tok_t = torch.as_tensor(tok, device=cuda_device)
    model = MoETransformer(cfg, device=cuda_device)
    _build.reset_launch_counts()
    with torch.no_grad():
        logits, aux = moe_forward(model, tok_t)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("rms_norm", 0) == 2
    assert _build.LAUNCHES.get("flash_attention.wgmma", 0) == 2
    assert torch.isfinite(logits).all() and 0.9 < float(aux) < 4
    mesh = card_mesh(cuda_device, ep=2)
    shard = data_sharding(mesh).shard
    c32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    # The unsharded yardstick runs the plain attention and norm; the
    # sharded model each rank's flash kernel
    plain = MoETransformer(dataclasses.replace(
        c32, attention_impl="reference", norm_impl="reference"),
        device=cuda_device)
    with torch.no_grad():
        want = float(moe_loss_fn(plain, tok_t,
                                 torch.as_tensor(tgt, device=cuda_device)))
        got = float(moe_loss_fn(shard_moe_params(plain, mesh, c32),
                                shard(tok), shard(tgt))[0])
    assert abs(got - want) <= 1e-4, (got, want)
    sharded = shard_moe_params(model, mesh, cfg)
    opt = torch.optim.AdamW(sharded.parameters())
    _build.reset_launch_counts()
    loss = make_moe_train_step(cfg)(sharded, opt, shard(tok), shard(tgt))
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.LAUNCHES.get(f"{name}.wgmma", 0) == 2 * 8, name
    assert _build.LAUNCHES.get("rms_norm", 0) == 0
    assert np.isfinite(float(loss[0]))



# ---------------------------------------------------------------------------
# faabric's MPI as guests use it: a 4-rank guest gang on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [{"card-a": 2, "card-b": 2},
                                   {"card-host": 4}],
                         ids=["two_hosts", "one_host"])
def test_guest_gang_runs_the_mpi_suite_and_a_ddp_step_on_the_card(
        cuda_device, hosts):
    """Four torch guests on cuda:0 through rank 0's ``ctx.mpi_world()``:
    the MPI suite with CUDA-tensor payloads, then one data-parallel step
    of a small model on the flash and RMS kernels, whose ranks agree bit
    for bit. Over two hosts the gradient crosses on the host ladder; on
    one host it rides the device plane with no host copy."""
    import chip_smoke
    from faabric_tpu_torch.device_plane import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig, Transformer

    cfg = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, max_seq=256)
    corpus = torch.randint(0, 256, (1, 8, 129), generator=torch.Generator()
                           .manual_seed(0))

    def batch(step, rank, device):
        b = corpus[step, 2 * rank:2 * rank + 2].to(device)
        return b[:, :-1], b[:, 1:]

    job = {"tensors": True, "steps": 1, "lr": 0.5, "params": {},
           "batch": batch,
           "model": lambda device: Transformer(
               cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))}
    chip_smoke.register_mpi_guests(job)
    server, workers = chip_smoke.start_cluster(hosts, TorchExecutorFactory())
    try:
        client = workers[0].planner_client
        results, _ = chip_smoke.run_gang(client, "suite", 4)
        outs = chip_smoke.guest_outputs(results, "suite, CUDA tensors")
        assert sorted(o["host"] for o in outs) == sorted(
            h for h, n in hosts.items() for _ in range(n))
        before = _build.LAUNCHES["flash_bwd_dq"]
        reset_device_copy_totals()
        results, _ = chip_smoke.run_gang(client, "ddp", 4)
        torch.cuda.synchronize()
        outs = chip_smoke.guest_outputs(results, "ddp step")
    finally:
        chip_smoke.stop_cluster(server, workers)
    one_host = len(hosts) == 1
    assert all(o["plane"] is one_host for o in outs)
    assert {o["rungs"]["allreduce"] for o in outs} == (
        {"device"} if one_host else {"tree"})
    if one_host:
        assert device_copy_totals()["bytes"] == 0
    assert _build.LAUNCHES["flash_bwd_dq"] == before + 4 * cfg.n_layers
    flat = [job["params"][r] for r in range(4)]
    assert all(f.is_cuda and torch.equal(flat[0], f) for f in flat[1:])


@pytest.mark.cuda
def test_sharded_decode_on_one_card_runs_the_rms_kernel_on_every_rank(
        cuda_device):
    """A tp-sharded fp32 decode over dp 2 x tp 4 on the card: the
    unsharded tokens, and 2L + 1 RMS-kernel launches a forward a rank."""
    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        generate,
        shard_params,
    )
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh, named

    cfg = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                      d_ff=256, max_seq=64, compute_dtype=torch.float32)
    model = Transformer(cfg, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(3))
    mesh = build_mesh([cuda_device] * 8, MeshConfig(dp=2, tp=4))
    sharded = shard_params(model, mesh, cfg)
    prompt = torch.randint(0, 256, (4, 16), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(4))
    want = generate(model, prompt, 6)
    rows = named(mesh, "dp", None)
    before = _build.LAUNCHES["rms_norm"]
    got = rows.gather(generate(sharded, rows.shard(prompt), 6,
                               prefill_chunk=5))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _build.LAUNCHES["rms_norm"] - before == 8 * (4 + 5) * 5


@pytest.mark.cuda
def test_state_device_view_and_handles_on_the_card(cuda_device):
    """A KV's device view on the card: one counted H2D copy a refresh,
    the cached tensor until the image changes, set_from_device one
    counted D2H copy; a device handle pulls the same storage."""
    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.state import (
        State,
        get_device_handle_registry,
        reset_device_handles,
    )

    kv = State("card-host").get_kv("demo", "card", 4096 * 3)
    values = torch.arange(3072, dtype=torch.float32)
    kv.set(values.numpy().tobytes())
    reset_device_copy_totals()
    view = kv.get_device_array(torch.float32)
    assert view.device.type == "cuda" and torch.equal(view.cpu(), values)
    assert kv.get_device_array(torch.float32) is view
    kv.set_from_device(view * 2)
    again = kv.get_device_array(torch.float32)
    assert again is not view and torch.equal(again.cpu(), values * 2)
    assert device_copy_totals()["by_reason"] == {
        "h2d.state": {"count": 2, "bytes": 2 * 12288},
        "d2h.state": {"count": 1, "bytes": 12288}}
    reset_device_handles()
    reg = get_device_handle_registry()
    h = reg.push(1, 0, "view", again)
    assert reg.pull(h.to_dict()).data_ptr() == again.data_ptr()
    assert h.device_id == cuda_device.index
    assert torch.equal(reg.pull_host(h), values * 2)
    reset_device_handles()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32",
                                   "int64", "int16", "uint8", "bool"])
@pytest.mark.parametrize("n", [4096 * 3, 4096 * 5 + 777])
def test_device_snapshot_on_the_card_matches_the_cpu(cuda_device, dtype, n):
    """A DeviceSnapshot of a CUDA tensor compares and gathers on the card:
    its flags, diffs and counted copies equal those of the same tensor's
    snapshot on the CPU, and apply_diffs and restore give the tensor
    back."""
    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.snapshot import DeviceSnapshot

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(n)
    base = (torch.rand(n, generator=gen) > 0.5 if dt == torch.bool else
            (torch.randn(n, generator=gen) * 100).to(dt))
    cur = base.clone()
    touched = (0, n // 3, n // 3 + 1, n - 1)
    for i in touched:
        cur[i] = ~cur[i] if dt == torch.bool else cur[i] + 1
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        snap = DeviceSnapshot(base.to(dev))
        reset_device_copy_totals()
        flags = snap.dirty_pages(cur.to(dev))
        diffs = snap.diff(cur.to(dev), update_baseline=True)
        totals = device_copy_totals()["by_reason"]
        rebuilt = DeviceSnapshot(base.to(dev)).apply_diffs(base.to(dev),
                                                           diffs)
        assert rebuilt.device.type == dev.type
        assert torch.equal(rebuilt.cpu(), cur)
        assert torch.equal(snap.restore().cpu(), cur)
        assert snap.diff(cur.to(dev)) == []
        results.append((flags.tolist(),
                        [(d.offset, d.data) for d in diffs], totals))
    assert results[1] == results[0]
    flags, diffs, totals = results[1]
    assert sum(flags) == len({i * dt.itemsize // 4096 for i in touched})
    assert totals["d2h.snapshot"]["bytes"] == 2 * len(flags) + 4096 * sum(
        flags)


@pytest.mark.cuda
def test_threads_step_and_chained_scoring_on_the_card(cuda_device):
    """``chip_smoke.py``'s phase 21 at a small width on the card: a
    THREADS batch of 4 torch guests over two hosts takes a bf16 SGD step
    on the flash and RMS kernels, merged through a float SUM region
    within 1e-6 of the oracle and with bitwise loss slots; a second batch
    comes from the decision cache; a parent chains two scorings. The
    phase checks the launches: 4 train steps' kernels a batch, all flash
    forwards on ``wgmma``, and 2 scoring forwards' for the chain."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig

    cfg = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, max_seq=256)
    launches = chip_smoke.threads_phase(cuda_device, _build, cfg=cfg,
                                        seq=128)
    steps = 2 * 4  # two batches of four threads
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] \
        == steps * cfg.n_layers
    assert launches["flash_attention"] == launches["flash_attention.wgmma"] \
        == steps * 2 * cfg.n_layers + 2 * cfg.n_layers
    assert launches["rms_norm"] == steps * (4 * cfg.n_layers + 1) \
        + 2 * (2 * cfg.n_layers + 1)


@pytest.mark.cuda
def test_planes_step_on_the_card(cuda_device, monkeypatch):
    """``chip_smoke.py``'s phase 22 at a small width on the card: the
    data-parallel step of 4 torch guests over two hosts with its
    gradient on the shm rings, on the int8 leader ring, on bulk TCP and
    with broadcast steps on the delta codec, each bitwise against its
    raw or exact counterpart; every part's launches are 4 train steps'
    kernels a step, all flash forwards on ``wgmma``."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.mpi import MpiWorld

    monkeypatch.setattr(MpiWorld, "CHUNK_BYTES", 1 << 20)
    cfg = ModelConfig(vocab_size=8192, d_model=256, n_layers=2, n_heads=4,
                      d_ff=512, max_seq=256)
    launches = chip_smoke.planes_phase(cuda_device, _build, cfg=cfg,
                                       seq=128)
    steps = 4 * (1 + 1 + 1 + 2 + 2)  # 22a, 22c, 22b raw, broadcast, delta
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] \
        == steps * cfg.n_layers
    assert launches["flash_attention"] == launches["flash_attention.wgmma"] \
        == steps * 2 * cfg.n_layers
    assert launches["rms_norm"] == steps * (4 * cfg.n_layers + 1)


@pytest.mark.cuda
def test_planner_restart_on_the_card(cuda_device):
    """``chip_smoke.py``'s phase 25 at a small width on the card: a batch
    of 8 requests outlives a SIGKILLed planner child (4 held in their
    guests across the kill, their results flushed after the restart),
    then runs again with the journal on, as 8 apps through SUBMIT_BATCH
    (25c) and with the journal off. The phase checks that the crash's
    batch and 25c's launched one batch's kernels each; the four batches
    launch four times that, every flash forward on ``wgmma``."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig

    cfg = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, max_seq=256)
    n_new = 8
    launches = chip_smoke.restart_phase(cuda_device, _build, cfg=cfg,
                                        serve_len=64, n_new=n_new)
    batches, L = 4, cfg.n_layers
    assert launches["flash_attention"] == launches["flash_attention.wgmma"] \
        == batches * 8 * L
    assert launches["rms_norm"] == batches * 8 * (2 * L + 1) * (1 + n_new)


@pytest.mark.cuda
def test_processes_step_on_the_card(cuda_device, monkeypatch):
    """``chip_smoke.py``'s phase 26 at full width on the card: phase 22
    first (the in-process step on each plane), then the same step with
    its planner and its two worker hosts as processes. Each process's
    ranks' parameters after the first step are bitwise equal to phase
    22's on the same plane; the children's launches come back: 3 steps
    of 2 ranks a child, 2 children, 2 planes, every flash forward on
    ``wgmma``. Phase 27 scrapes the live cluster after each plane; phase
    28 serves 8 requests (2 layers, 32 new tokens each) across a
    SIGKILLed child, all of them run once on the surviving one."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    keep: dict = {}
    chip_smoke.planes_phase(cuda_device, _build, keep=keep)
    launches = chip_smoke.processes_phase(cuda_device, _build, keep)
    L = ModelConfig().n_layers
    steps = 2 * 4 * 3  # planes x ranks x steps
    served, serve_L, n_new = 8, 2, 32  # phase 28's requests
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == steps * L
    assert launches["flash_attention"] == launches["flash_attention.wgmma"] \
        == steps * 2 * L + served * serve_L
    assert launches["rms_norm"] == steps * (4 * L + 1) + served * (
        2 * serve_L + 1) * (1 + n_new)


def _hold_listening(ports) -> list:
    """Listening sockets on every port of ``ports``, or [] when one is
    taken."""
    import socket

    held = []
    for port in ports:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("0.0.0.0", port))
            s.listen(1)
        except OSError:
            s.close()
            for h in held:
                h.close()
            return []
        held.append(s)
    return held


@pytest.mark.cuda
def test_world_across_two_processes_on_one_card(cuda_device):
    """``tests/test_torch_distributed.py``'s two-process world on the
    card: 2 + 2 ranks on ``cuda:0`` in two processes of one device
    plane, its bytes moved through CUDA IPC windows. Every collective
    bitwise against the host ring and numpy, the fp32 allreduce against
    the single-process plane's fold, zero host↔device copies for
    resident rounds, zero bytes on the host planes, and the ring permute
    across the processes bitwise against its plain version with one
    ring-kernel launch a round in each process."""
    import chip_smoke
    from tests.test_torch_distributed import N_PROCS, world_across_processes

    _build.kernels()  # built once here; the children load it
    for _ in range(20):
        reports = world_across_processes(
            str(cuda_device), chip_smoke.random_port_base(), _hold_listening)
        if reports:
            break
    assert len(reports) == N_PROCS


def planeworker_pair(device: str, base: int) -> list[str]:
    """A planner process and two ``planeworker`` processes of
    ``tests/test_torch_procs.py`` at port offsets ``base``, + 1000 and
    + 2000, each worker joining a 2-process plane with four entries of
    ``device``: each worker's ``PLANE-`` line ("" for one that printed
    none)."""
    import os
    import subprocess
    import sys

    from tests.test_torch_distributed import CHILD_TIMEOUT_S, _read_line

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "tests", "test_torch_procs.py")
    hosts = {"cpwpl": base, "cpw1": base + 1000, "cpw2": base + 2000}
    env = {**os.environ, "PYTHONPATH": root, "FAABRIC_HOST_ALIASES": ",".join(
        f"{h}=127.0.0.1+{o}" for h, o in hosts.items())}
    env.pop("FAABRIC_LOCKCHECK", None)

    def spawn(*args):
        return subprocess.Popen(
            [sys.executable, script, *args], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=root, env=env)

    procs = [spawn("planner", str(base))]
    try:
        assert _read_line(procs[0], "READY", CHILD_TIMEOUT_S) == "READY"
        procs += [spawn("planeworker", h, "cpwpl", "1", "2", device)
                  for h in ("cpw1", "cpw2")]
        lines = [_read_line(p, "PLANE-", CHILD_TIMEOUT_S) for p in procs[1:]]
    finally:
        # The workers leave the plane together, then the planner stops
        for p in procs[1:] + procs[:1]:
            p.stdin.close()
        for p in procs[1:] + procs[:1]:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)
            p.stdout.close()
    return lines


@pytest.mark.cuda
def test_planeworkers_on_one_card(cuda_device):
    """``tests/test_torch_distributed.py``'s ``planeworker`` pair on the
    card: two processes, four entries of ``cuda:0`` each, form an
    8-device plane through a planner process, and ``DeviceCollectives``'
    addressable allreduce, allgather, reduce_scatter and broadcast run
    across them over CUDA IPC windows (which grow between the shapes),
    each process checking its own shards, and the backward of allreduce,
    allgather, a ring shift and a swap, against closed-form values; then
    the reference's two train steps over the 8 ranks (fp32, plain
    attention: the flash kernels take no head dim 8), with equal losses
    in both processes."""
    import chip_smoke

    _build.kernels()  # built once here; the children load it
    lines = planeworker_pair(str(cuda_device), chip_smoke.random_port_base())
    assert all(line.startswith("PLANE-OK") for line in lines), lines
    assert {line.split("gdev=")[1].split()[0] for line in lines} == {"8"}
    assert {line.split("ldev=")[1].split()[0] for line in lines} == {"4"}
    ranks = {line.split("ranks=")[1] for line in lines}
    assert ranks == {"[0, 1, 2, 3]", "[4, 5, 6, 7]"}, ranks
    assert len({line.split(" loss=")[1].split()[0] for line in lines}) == 1
    assert len({line.split("pp_loss=")[1].split()[0]
                for line in lines}) == 1


@pytest.mark.cuda
def test_plane_steps_phase_on_the_card(cuda_device, monkeypatch):
    """``chip_smoke.py``'s phases 30 and 31 alone: a planner process and
    two plane processes on ``cuda:0``, 4 ranks each, run 2 full-width
    steps over (dp 4, tp 2) and 2 1F1B steps over (dp 2, tp 2, pp 2)
    with every pp hop across the processes; then GPipe over (dp 2, tp 2,
    pp 2), the ring step over (dp 2, sp 2, tp 2), the MoE step over (dp
    2, tp 2, ep 2), the MoE pipeline's 1F1B step over (dp 2, pp 2, ep 2)
    and the collectives with their backward, every pair of each run's
    axis across the processes, bitwise against the script's
    single-process runs. Over both processes the flash kernels launch
    what one process launches alone, every forward on ``wgmma``, and the
    ring kernel once a hop or rotation round in each process.
    ``tests/test_torch_processes.py`` rehearses both phases on the
    CPU."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.parallel.pipeline import hop_counts
    from faabric_tpu_torch.parallel.ring_attention import schedule_counts

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _build.kernels()
    launches = chip_smoke.plane_steps_phase(cuda_device, _build)
    L = ModelConfig().n_layers
    steps, m = chip_smoke.PLANE_STEPS, chip_smoke.PLANE_MICROBATCHES
    hops = hop_counts(2, m)
    ring = schedule_counts(8, 2)
    # Phase 30: 2 processes x 4 ranks x L layers a step, remat's forward
    # twice; phase 31's ring step the same over the causal ring's blocks,
    # its MoE step (no remat) one forward a rank and layer
    p30 = 2 * 4 * L * steps
    ring_fwd = ring["flash_attention"] * L * steps
    moe_fwd = 8 * L
    assert launches["flash_attention"] == launches["flash_attention.wgmma"] \
        == 2 * p30 + 2 * ring_fwd + moe_fwd
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] \
        == p30 + ring_fwd + moe_fwd
    # One launch a process a hop or rotation round: phase 30's 1F1B hops,
    # GPipe's, the ring's rotations (forward, recomputation, backward)
    # and the MoE pipeline's 1F1B hops
    assert launches["ring_permute"] == 2 * (
        hops["1f1b"] * steps + hops["gpipe"] * steps
        + 3 * L * ring["rounds"] * steps + hops["1f1b"])
    assert "rms_norm" not in launches


@pytest.mark.cuda
def test_cross_process_plane_phase_on_the_card(cuda_device, monkeypatch):
    """``chip_smoke.py``'s phase 29 alone: a planner process and two
    worker processes that join a 2-process device plane at boot on
    ``cuda:0``, and a gang of 2 + 2 ranks across them on the plane at the
    flagship gradient's size (181,422,080 bytes a rank): int32
    collectives bitwise against the host ring and numpy, the resident
    fp32 allreduce with zero host↔device copies and bitwise equal to the
    single-process plane's fold, the ring permute bitwise against its
    plain version. The ring kernel launches once a ring round in each
    process: a checked hop and five timed ones."""
    import chip_smoke

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _build.kernels()
    launches = chip_smoke.processes_phase(
        cuda_device, _build, {"start": torch.zeros(8)}, parts=("29",))
    assert launches == {"ring_permute": 2 * 6}, launches
