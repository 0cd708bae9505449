"""Flagship model: decoder-only transformer, in PyTorch.

Counterpart of ``faabric_tpu/models/transformer.py`` with the same
parameter layout, so JAX parameters load one to one
(``models/convert.py``): ``embed`` (V, D); per block ``ln1``, ``wqkv``
(D, 3, H, E), ``wo`` (H, E, D), ``ln2``, ``w1`` (D, F), ``w2`` (F, D);
then ``ln_f`` and ``lm_head`` (D, V). Parameters stay float32 and are
cast to the bfloat16 compute dtype at each use (mixed precision, as in
the JAX package).

``attention_impl`` picks plain attention ("reference") or the flash
kernels ("flash"); ``norm_impl`` the model's own RMS norm ("reference")
or the fused kernel ("fused"). "auto" resolves to the kernels on CUDA
and to the plain versions on the CPU. ``remat`` wraps each block in
``torch.utils.checkpoint`` when gradients are taken, as ``jax.checkpoint``
does in the JAX package: a block keeps only its input, and its forward
(flash kernel included) runs again in the backward pass.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from faabric_tpu_torch.util.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    rope_theta: float = 10000.0
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    attention_impl: str = "auto"
    norm_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def resolve_impls(cfg: ModelConfig, device: torch.device) -> ModelConfig:
    """Resolve "auto" kernel choices for the device: the kernels on CUDA,
    the plain versions on the CPU."""
    on_cuda = torch.device(device).type == "cuda"
    att, norm = cfg.attention_impl, cfg.norm_impl
    if att == "auto":
        att = "flash" if on_cuda else "reference"
    if norm == "auto":
        norm = "fused" if on_cuda else "reference"
    if att not in ("reference", "flash"):
        raise ValueError(f"attention_impl {att!r}: use auto, reference or flash")
    if norm not in ("reference", "fused"):
        raise ValueError(f"norm_impl {norm!r}: use auto, reference or fused")
    if (att, norm) != (cfg.attention_impl, cfg.norm_impl):
        cfg = dataclasses.replace(cfg, attention_impl=att, norm_impl=norm)
    return cfg


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d, h, e, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.ln1 = nn.Parameter(torch.ones(d, **kw))
        self.wqkv = nn.Parameter(torch.empty(d, 3, h, e, **kw))
        self.wo = nn.Parameter(torch.empty(h, e, d, **kw))
        self.ln2 = nn.Parameter(torch.ones(d, **kw))
        self.w1 = nn.Parameter(torch.empty(d, f, **kw))
        self.w2 = nn.Parameter(torch.empty(f, d, **kw))


class Transformer(nn.Module):
    """The model's parameters and config; ``model(tokens)`` runs
    :func:`forward`. Weights are drawn as the JAX ``init_params`` draws
    them (standard normal over sqrt(fan_in), norms at one), from
    ``generator``; a torch generator gives other numbers than a JAX key."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model, **kw))
        self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size,
                                                **kw))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        def dense(p: torch.Tensor, fan_in: int) -> None:
            p.normal_(generator=gen).div_(math.sqrt(fan_in))

        d = self.cfg.d_model
        for blk in self.blocks:
            dense(blk.wqkv, d)
            dense(blk.wo, d)
            dense(blk.w1, d)
            dense(blk.w2, self.cfg.d_ff)
        dense(self.embed, d)
        dense(self.lm_head, d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The model's plain norm: fp32 statistics, products in x.dtype (the
    formula the fused kernel's backward differentiates)."""
    from faabric_tpu_torch.ops.rms_norm import _rms_formula

    return _rms_formula(x, scale, 1e-6)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved rotary embeddings over the head dim: x (B, S, H, D),
    pairs (x[..., 0::2], x[..., 1::2]), angles and products in fp32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[:, :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _attention(q, k, v) -> torch.Tensor:
    """Causal attention, (B, S, H, D); fp32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_impl == "fused":
        from faabric_tpu_torch.ops.rms_norm import rms_norm

        return rms_norm(x, scale)
    return _rms_norm(x, scale)


def _qkv(h: torch.Tensor, blk: Block, cfg: ModelConfig):
    """h (B, S, D) -> q, k, v (B, S, H, E) views of one product."""
    b, s, _ = h.shape
    w = blk.wqkv.to(cfg.compute_dtype).reshape(cfg.d_model, -1)
    qkv = (h @ w).view(b, s, 3, cfg.n_heads, cfg.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _out_proj(attn: torch.Tensor, blk: Block, cfg: ModelConfig) -> torch.Tensor:
    b, s = attn.shape[:2]
    wo = blk.wo.to(cfg.compute_dtype).reshape(-1, cfg.d_model)
    return attn.reshape(b, s, -1) @ wo


def _mlp(x: torch.Tensor, blk: Block, cfg: ModelConfig) -> torch.Tensor:
    h = _norm(x, blk.ln2, cfg)
    ff = F.gelu(h @ blk.w1.to(cfg.compute_dtype), approximate="tanh")
    return x + ff @ blk.w2.to(cfg.compute_dtype)


def attention_sublayer(x: torch.Tensor, blk: Block, positions: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm attention + residual (honours attention_impl/norm_impl)."""
    h = _norm(x, blk.ln1, cfg)
    q, k, v = _qkv(h, blk, cfg)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if cfg.attention_impl == "flash":
        from faabric_tpu_torch.ops.flash_attention import flash_attention

        attn = flash_attention(q, k, v, True)
    else:
        attn = _attention(q, k, v)
    return x + _out_proj(attn, blk, cfg)


def _block(x: torch.Tensor, blk: Block, positions: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    return _mlp(attention_sublayer(x, blk, positions, cfg), blk, cfg)


def _embed(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig):
    return F.embedding(tokens, model.embed).to(cfg.compute_dtype)


def _logits(model: Transformer, x: torch.Tensor, cfg: ModelConfig):
    x = _norm(x, model.ln_f, cfg)
    return (x @ model.lm_head.to(cfg.compute_dtype)).float()


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    cfg = resolve_impls(model.cfg, model.device)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed(model, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.blocks:
        if remat:
            # The blocks draw no random numbers: no RNG state to replay
            x = checkpoint(_block, x, blk, positions, cfg,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(x, blk, positions, cfg)
    return _logits(model, x, cfg)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def loss_fn(model: Transformer, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    return token_nll(forward(model, tokens), targets).mean()
