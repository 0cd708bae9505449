"""Autoregressive decoding with a KV cache.

Counterpart of ``faabric_tpu/models/generate.py``. The cache is
allocated once at ``max_seq`` and written in place (the JAX package
updates it functionally); attention masks by position. Prefill may run
in chunks to bound its score memory. The decode loop is a Python loop
under ``torch.inference_mode()``, one forward per token.

A :class:`ShardedTransformer` decodes tensor-parallel, as the reference
does with ``mesh=``: the prompt and the result are per-rank lists
(B/dp rows each), each rank keeps its own KV cache of (B/dp, max_seq,
H/tp, D), the reference's ``P("dp", None, "tp", None)``, and the
activation collectives run through the mesh's ``DeviceCollectives`` as
the sharded forward's do (the embedding, attention output and w2
allreduced over tp, the logits gathered over tp). Each rank runs the
fused RMS norm where the unsharded decode does (the reference resolves
its kernels without the mesh here). A dp group draws each token once
and hands it to all of its ranks; sampling takes one generator per dp
group. Ranks along sp (and ep) hold replicas of their dp group's rows.
"""

from __future__ import annotations

import math

import torch

from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    ShardedTransformer,
    Transformer,
    _check_family,
    _embed,
    _logits,
    _mlp,
    _norm,
    _out_proj,
    _qkv,
    _rope,
    _sharded_embed,
    _sharded_ffn_sublayer,
    _sharded_logits,
    resolve_impls,
)


def init_kv_cache(cfg: ModelConfig, batch: int, device,
                  n_heads: int | None = None) -> list[dict]:
    """Per layer, zeroed K and V of (batch, max_seq, heads, head_dim);
    ``n_heads`` is a tp shard's head count (all heads by default)."""
    shape = (batch, cfg.max_seq, n_heads or cfg.n_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_layers)]


def init_sharded_kv_cache(model: ShardedTransformer,
                          batch: int) -> list[list[dict]]:
    """Each rank's own cache for a global batch ``batch``: (batch/dp,
    max_seq, H/tp, D) on the rank's device, per layer."""
    mesh, cfg = _check_decode_mesh(model), model.cfg
    if batch % mesh.shape["dp"] or cfg.n_heads % mesh.shape["tp"]:
        raise ValueError(f"batch {batch} and {cfg.n_heads} heads do not "
                         f"split over dp {mesh.shape['dp']} and tp "
                         f"{mesh.shape['tp']}")
    return [init_kv_cache(cfg, batch // mesh.shape["dp"], dev,
                          cfg.n_heads // mesh.shape["tp"])
            for dev in mesh.rank_devices]


SERVING_XPROC = ("sharded serving (decode, perplexity) over a mesh whose "
                 "ranks live in several processes is not ported yet "
                 "(ROADMAP.md Queue 1 step 13)")


def _check_decode_mesh(model: ShardedTransformer):
    _check_family(model)
    mesh = model.mesh
    if mesh.shape["pp"] > 1:
        raise ValueError("decode over a pipeline mesh (pp > 1) is not "
                         "supported; lay the model over dp and tp")
    if mesh.multiprocess:
        raise NotImplementedError(SERVING_XPROC)
    return mesh


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


def _cached_attn(x, blk, cache: dict, start: int, length: int,
                 cfg: ModelConfig) -> torch.Tensor:
    """The attention sublayer's output projection (before the residual)
    for tokens at positions [start, start + S): writes their keys and
    values into ``cache`` and attends over [0, length). On a tp shard
    ``blk`` and ``cache`` hold the rank's heads, and the result is the
    row-parallel wo's partial sum."""
    b, s, _ = x.shape
    q, k, v = _qkv(_norm(x, blk.ln1, cfg), blk, cfg)
    positions = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    q = _rope(q, positions, cfg.rope_theta)
    cache["k"][:, start:start + s] = _rope(k, positions, cfg.rope_theta)
    cache["v"][:, start:start + s] = v
    attn = _cached_attention(q, cache["k"], cache["v"], length)
    return _out_proj(attn, blk, cfg)


def _block_with_cache(x, blk, cache: dict, start: int, length: int,
                      cfg: ModelConfig) -> torch.Tensor:
    return _mlp(x + _cached_attn(x, blk, cache, start, length, cfg), blk, cfg)


def _sharded_block_with_cache(xs, blks, caches, start: int, length: int,
                              cfg: ModelConfig, mesh) -> list:
    """One block on every rank's shards (heads over tp), each rank
    writing its own cache; wo's partial sums are completed by an
    allreduce over tp, then the sharded forward's FFN sublayer."""
    outs = mesh.over("tp", [_cached_attn(x, blk, cache, start, length, cfg)
                            for x, blk, cache in zip(xs, blks, caches)],
                     "allreduce")
    xs = [x + o for x, o in zip(xs, outs)]
    return _sharded_ffn_sublayer(xs, blks, cfg, mesh)


def _sharded_forward_with_cache(model: ShardedTransformer, tokens,
                                cache: list[list[dict]], start: int) -> list:
    mesh = _check_decode_mesh(model)
    if len(tokens) != mesh.size or len(cache) != mesh.size:
        raise ValueError(f"{len(tokens)} token shards and {len(cache)} "
                         f"caches for {mesh.size} ranks")
    cfg = resolve_impls(model.cfg, mesh.device)
    s = tokens[0].shape[1]
    if start + s > cfg.max_seq:
        raise ValueError(f"positions up to {start + s} exceed max_seq "
                         f"{cfg.max_seq}")
    shards = model.shards()
    xs = _sharded_embed(shards, tokens, cfg, mesh)
    for i in range(cfg.n_layers):
        xs = _sharded_block_with_cache(
            xs, [sh.blocks[i] for sh in shards], [c[i] for c in cache],
            start, start + s, cfg, mesh)
    return _sharded_logits(shards, xs, cfg, mesh)


def forward_with_cache(model: Transformer, tokens, cache, start: int):
    """tokens (B, S) entering at position ``start`` -> logits (B, S, V);
    ``cache`` is updated in place. length = start + S. A
    :class:`ShardedTransformer` takes per-rank token lists (B/dp, S) and
    per-rank caches (:func:`init_sharded_kv_cache`) and gives per-rank
    logits (B/dp, S, V), replicated over tp."""
    if isinstance(model, ShardedTransformer):
        return _sharded_forward_with_cache(model, tokens, cache, start)
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


def _decode(forward_fn, prompts: list, n_tokens: int, pick,
            prefill_chunk: int) -> list:
    """Prefill then decode over per-part prompts of one width:
    ``forward_fn(tokens, start)`` gives per-part logits and ``pick(last
    logits)`` per-part next tokens (B, ) int32."""
    s_p = prompts[0].shape[1]
    chunk = prefill_chunk if 0 < prefill_chunk < s_p else s_p
    for pos in range(0, s_p, chunk):
        logits = forward_fn([p[:, pos:pos + chunk] for p in prompts], pos)
    toks = pick([lg[:, -1] for lg in logits])
    out = [toks]
    for pos in range(s_p, s_p + n_tokens - 1):
        logits = forward_fn([t[:, None] for t in toks], pos)
        toks = pick([lg[:, -1] for lg in logits])
        out.append(toks)
    return [torch.stack([o[r] for o in out], dim=1)
            for r in range(len(prompts))]


def _dp_generators(generator, dp: int) -> list:
    """One generator per dp group: a sequence of ``dp`` generators, or a
    single one when dp is 1."""
    if generator is None or isinstance(generator, torch.Generator):
        if dp != 1 and generator is not None:
            raise ValueError(f"sampling over dp {dp} takes a sequence of "
                             f"{dp} generators, one per dp group")
        return [generator] * dp
    gens = list(generator)
    if len(gens) != dp:
        raise ValueError(f"{len(gens)} generators for dp {dp}")
    return gens


def generate(model: Transformer, prompt, n_tokens: int,
             generator=None, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, prefill_chunk: int = 0):
    """Decode: prompt (B, S_p) int -> (B, n_tokens) int32. Greedy at
    temperature 0; otherwise samples with ``generator`` after
    temperature, top-k and top-p. ``prefill_chunk`` runs a long prompt
    through prefill in chunks of that many tokens.

    A :class:`ShardedTransformer` takes the prompt as per-rank lists
    (``named(mesh, "dp", None).shard(prompt)``) and gives per-rank
    (B/dp, n_tokens) results; ``generator`` is then a sequence of one
    generator per dp group (a single one at dp 1)."""
    cfg = model.cfg
    greedy = temperature == 0.0
    sharded = isinstance(model, ShardedTransformer)
    s_p = (prompt[0] if sharded else prompt).shape[1]
    if s_p + n_tokens - 1 > cfg.max_seq:
        raise ValueError(f"prompt {s_p} + {n_tokens} new tokens exceed "
                         f"max_seq {cfg.max_seq}")

    def draw(logits, gen):
        return _pick_token(logits, gen, greedy, temperature, top_k, top_p)

    with torch.inference_mode():
        if not sharded:
            cache = init_kv_cache(cfg, prompt.shape[0], model.device)
            return _decode(
                lambda toks, pos: [forward_with_cache(model, toks[0], cache,
                                                      pos)],
                [prompt], n_tokens, lambda lgs: [draw(lgs[0], generator)],
                prefill_chunk)[0]

        mesh = _check_decode_mesh(model)
        prompts = list(prompt)
        cache = init_sharded_kv_cache(model,
                                      prompts[0].shape[0] * mesh.shape["dp"])
        groups = mesh.groups(("tp", "sp", "pp", "ep"))  # one per dp index
        gens = _dp_generators(generator, len(groups))

        def pick(last_logits):
            # Every rank of a dp group holds the same gathered logits:
            # draw once from its first rank, hand the token to the rest
            toks = [None] * mesh.size
            for group, gen in zip(groups, gens):
                tok = draw(last_logits[group[0]], gen)
                for r in group:
                    toks[r] = tok.to(mesh.rank_devices[r])
            return toks

        return _decode(
            lambda toks, pos: forward_with_cache(model, toks, cache, pos),
            prompts, n_tokens, pick, prefill_chunk)
