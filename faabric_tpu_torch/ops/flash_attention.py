"""Flash attention forward: a CUDA kernel on the card, the plain version
on the CPU.

Counterpart of ``faabric_tpu/ops/flash_attention.py``. Layout is the
JAX package's: q (B, S_q, H, D), k and v (B, S_k, H, D), out like q, and
the per-row log-sum-exp as (B*H, S_q) fp32 with heads folded after batch.

The kernel (``csrc/flash_attention.cu``) keeps the TPU kernel's
semantics: online softmax in fp32, end-aligned causal mask
(``causal_offset = S_k - S_q``) and the causal early exit. It handles
ragged S_q and S_k itself with bounds masks, so the only routing left in
``_uses_kernel`` is semantic: causal attention with S_q > S_k goes to the
plain version, whose fully masked rows get a uniform softmax. The TPU
tiling rules (D < 64, block multiples of 128 lanes, the lane-broadcast
lse) have no meaning here and are gone, as are the block-size arguments:
the kernel's tiles are fixed. It takes float32 and bfloat16 with head
dims 16, 32, 64 and 128.

Only the forward is ported. On the kernel path a gradient raises
NotImplementedError; it is never taken through the plain version
quietly. The plain path (the semantic fallback) differentiates by
autograd, as the JAX package's fallback does.
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


def _kernel_flash(q, k, v, causal: bool):
    """Launch the forward kernel: (out (B, S_q, H, D), lse (B*H, S_q))."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash kernel takes (B, S, H, D) q, k, v")
    b, s_q, h, d = q.shape
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
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
    _build.kernels().flash_fwd(q, k, v, out, lse, 1.0 / math.sqrt(d),
                               bool(causal))
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


def _flash_forward(q, k, v, causal: bool):
    """(out, lse) on the kernel path; (plain out, None) on the semantic
    fallback."""
    if not _uses_kernel(q.shape, k.shape, causal):
        return _reference_attention(q, k, v, causal), None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash backward kernels: next slice")
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal), _reference_lse(q, k, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _kernel_flash(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Attention, (B, S, H, D) -> (B, S, H, D)."""
    return _flash_forward(q, k, v, causal)[0]


def flash_attention_with_lse(q, k, v, causal: bool = True):
    """(out (B, S_q, H, D), lse (B*H, S_q) fp32)."""
    out, lse = _flash_forward(q, k, v, causal)
    if lse is None:
        lse = _reference_lse(q, k, causal)
    return out, lse


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
