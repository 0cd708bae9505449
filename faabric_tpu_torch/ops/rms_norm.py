"""Fused RMS norm: a CUDA kernel on the card, its plain version on the CPU.

Counterpart of ``faabric_tpu/ops/rms_norm.py``. The kernel
(``csrc/rms_norm.cu``) reads each row once, reduces the sum of squares
in fp32 and writes ``x * rsqrt(mean(x^2) + eps) * scale`` computed in
fp32 and rounded once to ``x.dtype``. The backward recomputes through
``_rms_formula``, the formula ``_rms_bwd`` differentiates in the JAX
package (its ``_reference_rms_norm``: fp32 statistics, products in
``x.dtype``), which has no backward kernel either.
"""

from __future__ import annotations

import math

import torch

from faabric_tpu_torch.ops import _build

MAX_D = 8192


def _reference_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 statistics and
    products, one rounding to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _rms_formula(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """The function the backward differentiates: the JAX package's
    ``_reference_rms_norm``, which is also the model's plain norm
    (``models/transformer.py::_rms_norm``): fp32 statistics, products in
    ``x.dtype``."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale.to(x.dtype)


def _kernel_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                     eps: float) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"rms_norm kernel takes 0 < D <= {MAX_D}, got {d}")
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"scale must be ({d},) on {x.device}")
    if not x.is_contiguous():
        raise ValueError("rms_norm kernel takes a contiguous x")
    rows = math.prod(x.shape[:-1])
    flat = x.view(rows, d)
    out = torch.empty_like(flat)
    _build.kernels().rms_norm_fwd(flat, scale.float().contiguous(), out, eps)
    _build.count_launch("rms_norm")
    return out.view(x.shape)


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return _reference_rms_norm(x, scale, eps)
        if x.device.type != "cuda":
            raise ValueError(f"rms_norm: unsupported device {x.device}")
        return _kernel_rms_norm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_()
            s_ = scale.detach().requires_grad_()
            out = _rms_formula(x_, s_, ctx.eps)
            gx, gs = torch.autograd.grad(out, (x_, s_), g)
        return gx, gs, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) -> same shape and dtype as x."""
    return _RmsNorm.apply(x, scale, eps)
