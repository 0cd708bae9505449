"""Flash attention, forward and backward: CUDA kernels on the card, the
plain versions on the CPU.

Counterpart of ``faabric_tpu/ops/flash_attention.py``. Layout is the
JAX package's: q (B, S_q, H, D), k and v (B, S_k, H, D), out like q, and
the per-row log-sum-exp as (B*H, S_q) fp32 with heads folded after batch.

The forward kernel (``csrc/flash_attention.cu``) keeps the TPU kernel's
semantics: online softmax in fp32, end-aligned causal mask
(``causal_offset = S_k - S_q``) and the causal early exit. The backward
is the TPU package's two passes (``csrc/flash_attention_bwd.cu``): a dQ
kernel over q tiles and a dK/dV kernel over key tiles, both recomputing
P from the forward's lse. The row correction Δ = rowsum(dO·O) − g_lse,
which the JAX package computes outside its kernels, is computed by the
dQ kernel for its rows and handed to the dK/dV kernel; on the CPU it is
``_row_correction``, ahead of the plain versions. The forward and each
backward pass run one of three kernel bodies, which ``_fwd_body`` and
``_bwd_body`` pick from the operands' dtype, head dim and layout:
``wgmma`` (TMA-fed stages and Hopper's warpgroup products; bf16 at head
dim 64), ``mma`` (warp-level tensor-core products; other bf16) or
``fma`` (fp32 FMAs). Launches are counted per kernel and per body
(``flash_attention.wgmma``, ...); a body that cannot take its operands
raises, and nothing falls back to another body. ``flash_attention`` and
``flash_attention_with_lse`` go through one ``torch.autograd.Function``,
differentiable in both out and lse; ``flash_attention`` drops the lse,
whose missing cotangent costs nothing.

The kernels handle ragged S_q and S_k themselves with bounds masks, so
the only routing left in ``_uses_kernel`` is semantic: causal attention
with S_q > S_k goes to the plain version, whose fully masked rows get a
uniform softmax, and differentiates by autograd, as the JAX package's
fallback does. The TPU tiling rules (D < 64, block multiples of 128
lanes, the lane-broadcast lse) have no meaning here and are gone, as are
the block-size arguments: the kernels' tiles are fixed. They take
float32 and bfloat16 with head dims 16, 32, 64 and 128.
"""

from __future__ import annotations

import math

import torch

from faabric_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def _causal_mask(s_q: int, s_k: int, device) -> torch.Tensor:
    return torch.ones(s_q, s_k, dtype=torch.bool, device=device).tril(s_k - s_q)


def _scores(q, k, causal: bool) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits


def _reference_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Plain attention, fp32 softmax, probs cast to q.dtype before P.V."""
    probs = torch.softmax(_scores(q, k, causal), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _reference_lse(q, k, causal: bool) -> torch.Tensor:
    lse = torch.logsumexp(_scores(q, k, causal), dim=-1)
    b, h, s_q = lse.shape
    return lse.reshape(b * h, s_q)


def _uses_kernel(q_shape, k_shape, causal: bool) -> bool:
    # Causal with S_q > S_k leaves query rows that see no key: the plain
    # version gives them a uniform softmax rather than a 0/0 accumulator
    return not (causal and q_shape[1] > k_shape[1])


def _check_qkv(q, k, v) -> None:
    """What the kernels take: (B, S, H, D) q, k, v of one float32 or
    bfloat16 dtype on one device, a head dim they are built for, and a
    contiguous last dim (other strides are free)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash kernel takes (B, S, H, D) q, k, v")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash kernel: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError("flash kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, got {d}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash kernel: q, k, v on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel: the head dim must be contiguous")


def _tma_ok(t) -> bool:
    """TMA can describe ``t``: a 16-byte aligned base and strides of whole
    16-byte units (a dim of extent 1 is never stepped, so its stride is
    free)."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) > 0 and t.stride(i) % 8 == 0
        for i in range(3) if t.shape[i] > 1)


def _pairs_ok(t) -> bool:
    """``t``'s bf16 pairs are 4-byte aligned, as the mma bodies' C
    launchers check."""
    return t.data_ptr() % 4 == 0 and all(s % 2 == 0 for s in t.stride()[:3])


# Body codes of the C launchers
BODIES = {"fma": 0, "mma": 1, "wgmma": 2}


def _fwd_body(q, k, v) -> str:
    """The forward kernel body for these operands: "wgmma" for bfloat16
    at head dim 64 whose base pointers and strides TMA can describe; "mma"
    for other bfloat16 whose bf16 pairs are 4-byte aligned; "fma" for
    float32 and the rest."""
    if q.dtype != torch.bfloat16:
        return "fma"
    if q.shape[-1] == 64 and all(map(_tma_ok, (q, k, v))):
        return "wgmma"
    if all(map(_pairs_ok, (q, k, v))):
        return "mma"
    return "fma"


def _count_launch(name: str, body: str) -> None:
    _build.count_launch(name, f"{name}.{body}")


def _kernel_flash(q, k, v, causal: bool, body: str | None = None):
    """Launch the forward kernel: (out (B, S_q, H, D), lse (B*H, S_q)).
    ``body`` defaults to ``_fwd_body``'s pick; a body that does not take
    the operands raises."""
    _check_qkv(q, k, v)
    body = body or _fwd_body(q, k, v)
    b, s_q, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
    _build.kernels().flash_fwd(q, k, v, out, lse, 1.0 / math.sqrt(d),
                               bool(causal), BODIES[body])
    _count_launch("flash_attention", body)
    return out, lse


def _bwd_body(q, k, v, do, out=None) -> str:
    """The backward kernel body for these operands (``out``, O, only for
    the dQ pass): "wgmma" for bfloat16 at head dim 64 whose base pointers
    and strides TMA can describe; "mma" for other bfloat16 at head dims up
    to 64 whose bf16 pairs are 4-byte aligned; "fma" for float32, head dim
    128 and the rest."""
    if q.dtype != torch.bfloat16 or q.shape[-1] > 64:
        return "fma"
    operands = [t for t in (q, k, v, do, out) if t is not None]
    if q.shape[-1] == 64 and all(map(_tma_ok, operands)):
        return "wgmma"
    if all(map(_pairs_ok, (q, k, v, do))):
        return "mma"
    return "fma"


def _check_stat(name: str, t, q) -> None:
    b, s_q, h, _ = q.shape
    if (t.shape != (b * h, s_q) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"flash backward: {name} must be contiguous "
                         f"float32 ({b * h}, {s_q})")


def _check_bwd_inputs(q, k, v, do, lse) -> None:
    _check_qkv(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("flash backward: dO must be like q")
    if do.stride(-1) != 1:
        raise ValueError("flash backward: dO's head dim must be contiguous")
    _check_stat("lse", lse, q)


def _kernel_flash_bwd_dq(q, k, v, do, out, lse, g_lse, causal: bool):
    """Launch the dQ kernel, which also computes the row correction:
    (dq (B, S_q, H, D) like q, delta (B*H, S_q) fp32). ``g_lse``, the
    lse's cotangent, may be None."""
    _check_bwd_inputs(q, k, v, do, lse)
    if (out.shape != q.shape or out.dtype != q.dtype
            or out.device != q.device or out.stride(-1) != 1):
        raise ValueError("flash backward: O must be like q with a "
                         "contiguous head dim")
    if g_lse is not None:
        _check_stat("g_lse", g_lse, q)
    body = _bwd_body(q, k, v, do, out)
    b, s_q, h, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
    _build.kernels().flash_bwd_dq(q, k, v, do, out, lse, g_lse, delta, dq,
                                  1.0 / math.sqrt(q.shape[-1]), bool(causal),
                                  BODIES[body])
    _count_launch("flash_bwd_dq", body)
    return dq, delta


def _kernel_flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    """Launch the dK/dV kernel with the dQ kernel's row correction:
    (dk, dv) (B, S_k, H, D) like k and v."""
    _check_bwd_inputs(q, k, v, do, lse)
    _check_stat("delta", delta, q)
    body = _bwd_body(q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _build.kernels().flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv,
                                   1.0 / math.sqrt(q.shape[-1]), bool(causal),
                                   BODIES[body])
    _count_launch("flash_bwd_dkv", body)
    return dk, dv


def _reference_p_ds(q, k, v, do, lse, delta, causal: bool):
    """P and dS in fp32 as the backward kernels recompute them: scores of
    the fp32 products under the forward's mask, P = exp(s - lse) (0 where
    masked), dP = dO.V^T with dO in V's dtype, dS = P (dP - delta) scale."""
    b, s_q, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    f = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(s_q, k.shape[1], q.device), NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, s_q, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(v.dtype).to(f), v.to(f))
    return p, p * (dp - delta.reshape(b, h, s_q, 1)) * scale


def _reference_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    """The dQ kernel's function: dq = dS.K with dS rounded to K's dtype,
    summed in fp32, rounded once to q's dtype."""
    _, ds = _reference_p_ds(q, k, v, do, lse, delta, causal)
    f = torch.float32
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(f),
                        k.to(f)).to(q.dtype)


def _reference_bwd_dq_with_delta(q, k, v, do, out, lse, g_lse,
                                 causal: bool):
    """The dQ kernel's function, row correction included: (dq, delta)."""
    delta = _row_correction(do, out, g_lse)
    return _reference_bwd_dq(q, k, v, do, lse, delta, causal), delta


def _reference_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    """The dK/dV kernel's function: dv = P^T.dO with P rounded to dO's
    dtype, dk = dS^T.Q with dS rounded to Q's dtype, fp32 sums."""
    p, ds = _reference_p_ds(q, k, v, do, lse, delta, causal)
    f = torch.float32
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(f), do.to(f))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(f), q.to(f))
    return dk.to(k.dtype), dv.to(v.dtype)


def _reference_flash_bwd(q, k, v, do, lse, delta, causal: bool):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv)
    from the forward's lse and the row correction delta, with the
    kernels' mask and rounding points."""
    return (_reference_bwd_dq(q, k, v, do, lse, delta, causal),
            *_reference_bwd_dkv(q, k, v, do, lse, delta, causal))


def _forward(q, k, v, causal: bool):
    """(out, lse): the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal), _reference_lse(q, k, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _kernel_flash(q, k, v, causal)


def _row_correction(do, out, g_lse=None) -> torch.Tensor:
    """delta = rowsum(dO * O) - g_lse, contiguous (B*H, S_q) fp32: the
    softmax Jacobian's row term, with the lse cotangent folded in (since
    d lse / d s = P)."""
    b, s_q, h, _ = out.shape
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, s_q)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def _backward(q, k, v, out, lse, g_out, g_lse, causal: bool):
    """(dq, dk, dv) for the cotangents of out and lse (either may be
    None). On CUDA the dQ kernel computes the row correction and the
    dK/dV kernel reads it; on the CPU, ``_row_correction`` and then the
    kernels' plain version compute the same function step by step."""
    do = torch.zeros_like(out) if g_out is None else g_out.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if q.device.type == "cpu":
        delta = _row_correction(do, out, g_lse)
        return _reference_flash_bwd(q, k, v, do, lse, delta, causal)
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    dq, delta = _kernel_flash_bwd_dq(q, k, v, do, out, lse, g_lse, causal)
    return (dq, *_kernel_flash_bwd_dkv(q, k, v, do, lse, delta, causal))


class _FlashAttention(torch.autograd.Function):
    """(out, lse), differentiable in both."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        # An unused output's cotangent stays None and costs nothing
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        return (*_backward(*ctx.saved_tensors, g_out, g_lse, ctx.causal), None)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Attention, (B, S, H, D) -> (B, S, H, D)."""
    if not _uses_kernel(q.shape, k.shape, causal):
        return _reference_attention(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal)[0]


def flash_attention_with_lse(q, k, v, causal: bool = True):
    """(out (B, S_q, H, D), lse (B*H, S_q) fp32), differentiable in both."""
    if not _uses_kernel(q.shape, k.shape, causal):
        return _reference_attention(q, k, v, causal), _reference_lse(q, k, causal)
    return _FlashAttention.apply(q, k, v, causal)


def merge_attention_blocks(outs, lses):
    """Combine partial attentions over disjoint key blocks (each an
    (out, lse) pair from flash_attention_with_lse) into the attention over
    their union: the flash-decoding merge."""
    lse_total = lses[0]
    for l in lses[1:]:
        lse_total = torch.logaddexp(lse_total, l)
    b_h, s_q = lse_total.shape
    out = None
    for o, l in zip(outs, lses):
        b = o.shape[0]
        w = torch.exp(l - lse_total).reshape(b, b_h // b, s_q)
        term = o.float() * w.transpose(1, 2)[..., None]
        out = term if out is None else out + term
    return out.to(outs[0].dtype), lse_total
