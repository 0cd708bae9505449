"""Autoregressive decoding with a KV cache.

Counterpart of ``faabric_tpu/models/generate.py``. The cache is
allocated once at ``max_seq`` and written in place (the JAX package
updates it functionally); attention masks by position. Prefill may run
in chunks to bound its score memory. The decode loop is a Python loop
under ``torch.inference_mode()``, one forward per token.
"""

from __future__ import annotations

import math

import torch

from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    Transformer,
    _embed,
    _logits,
    _mlp,
    _norm,
    _out_proj,
    _qkv,
    _rope,
    resolve_impls,
)


def init_kv_cache(cfg: ModelConfig, batch: int, device) -> list[dict]:
    shape = (batch, cfg.max_seq, cfg.n_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _cached_attention(q, cache_k, cache_v, length: int) -> torch.Tensor:
    """q (B, S_q, H, D) against the cache's first ``length`` positions
    (q's last position is length-1). Keys at or past ``length`` are
    masked in the JAX package; they add exact zeros to the softmax, so
    they are not read here."""
    cache_k, cache_v = cache_k[:, :length], cache_v[:, :length]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, cache_k).float() * scale
    s_q = q.shape[1]
    q_pos = (length - s_q) + torch.arange(s_q, device=q.device)
    k_pos = torch.arange(length, device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, cache_v)


def _block_with_cache(x, blk, cache: dict, start: int, length: int,
                      cfg: ModelConfig) -> torch.Tensor:
    """One block over tokens at positions [start, start + S); writes their
    keys and values into ``cache`` and attends over [0, length)."""
    b, s, _ = x.shape
    h = _norm(x, blk.ln1, cfg)
    q, k, v = _qkv(h, blk, cfg)
    positions = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    cache["k"][:, start:start + s] = k
    cache["v"][:, start:start + s] = v
    attn = _cached_attention(q, cache["k"], cache["v"], length)
    return _mlp(x + _out_proj(attn, blk, cfg), blk, cfg)


def forward_with_cache(model: Transformer, tokens: torch.Tensor,
                       cache: list[dict], start: int) -> torch.Tensor:
    """tokens (B, S) entering at position ``start`` -> logits (B, S, V);
    ``cache`` is updated in place. length = start + S."""
    cfg = resolve_impls(model.cfg, model.device)
    s = tokens.shape[1]
    if start + s > cfg.max_seq:
        raise ValueError(f"positions up to {start + s} exceed max_seq "
                         f"{cfg.max_seq}")
    x = _embed(model, tokens, cfg)
    for blk, layer_cache in zip(model.blocks, cache):
        x = _block_with_cache(x, blk, layer_cache, start, start + s, cfg)
    return _logits(model, x, cfg)


def _filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Temperature, then top-k, then top-p masking of (B, V) logits:
    masked entries become -inf."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep the smallest prefix with cumulative mass >= top_p (the
        # first token always survives)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return logits


def _pick_token(logits: torch.Tensor, generator: torch.Generator | None,
                greedy: bool, temperature: float, top_k: int,
                top_p: float) -> torch.Tensor:
    """One sampling step over (B, V) logits -> (B,) int32."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def generate(model: Transformer, prompt: torch.Tensor, n_tokens: int,
             generator: torch.Generator | None = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             prefill_chunk: int = 0) -> torch.Tensor:
    """Decode: prompt (B, S_p) int -> (B, n_tokens) int32. Greedy at
    temperature 0; otherwise samples with ``generator`` after
    temperature, top-k and top-p. ``prefill_chunk`` runs a long prompt
    through prefill in chunks of that many tokens."""
    cfg = model.cfg
    greedy = temperature == 0.0
    b, s_p = prompt.shape
    if s_p + n_tokens - 1 > cfg.max_seq:
        raise ValueError(f"prompt {s_p} + {n_tokens} new tokens exceed "
                         f"max_seq {cfg.max_seq}")
    with torch.inference_mode():
        cache = init_kv_cache(cfg, b, model.device)
        chunk = prefill_chunk if 0 < prefill_chunk < s_p else s_p
        for pos in range(0, s_p, chunk):
            logits = forward_with_cache(model, prompt[:, pos:pos + chunk],
                                        cache, pos)
        tok = _pick_token(logits[:, -1], generator, greedy, temperature,
                          top_k, top_p)
        out = [tok]
        for pos in range(s_p, s_p + n_tokens - 1):
            logits = forward_with_cache(model, tok[:, None], cache, pos)
            tok = _pick_token(logits[:, -1], generator, greedy, temperature,
                              top_k, top_p)
            out.append(tok)
        return torch.stack(out, dim=1)
