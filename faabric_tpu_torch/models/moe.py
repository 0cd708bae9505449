"""Mixture-of-Experts transformer, in PyTorch: the second model family,
with expert parallelism over the ``ep`` mesh axis.

Counterpart of ``faabric_tpu/models/moe.py``, with the same parameter
layout (per block ``router`` (D, E), ``w1`` (E, D, F), ``w2`` (E, F, D)
beside the attention weights). Top-k routing with fixed expert capacity
in the einsum-dispatch formulation: a one-hot dispatch tensor scatters
tokens into per-expert buffers, the experts run as one batched product
pair, and the combine einsum gathers their outputs weighted by the
router's gates (renormalised over the selected experts for k > 1).
Capacity is allocated slot-major, so every token's first choice outranks
any token's second. Tokens past an expert's capacity drop: only their
residual passes. Routing and the expert products run in fp32, as the
reference computes them outside any Pallas kernel; attention and its
norm follow ``resolve_impls`` (unsharded on the card: the flash forward
and the fused RMS norm for ``ln1``; ``ln2`` and ``ln_f`` take the plain
norm, as in the reference).

Over a mesh (:class:`ShardedMoETransformer`, ``moe_param_shardings``)
the expert FFN is one ep-local function, :func:`_ep_moe_ffn`, which the
pipeline's MoE stages share (``parallel/pipeline.py``): every rank
computes the same routing, runs only its own experts' slab (each
expert's hidden split over tp), and two allreduces reassemble the
output, over tp after w2 and over ep after the combine. The reference's
single-mesh layer gets there through sharding constraints and XLA's
all_to_alls; the function computed is the same. Over a mesh whose ranks
live in several processes of a device plane each process runs its own
ranks, and the allreduces (tp, ep and the aux's over the mesh) cross
the boundary where their groups do (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    ShardedTransformer,
    _check_sharded,
    _first,
    _local,
    _param_shapes,
    _param_tree,
    _rms_norm,
    _sharded_attention_sublayer,
    _sharded_embed,
    _sharded_logits,
    _sharded_positions,
    _token_parts,
    attention_sublayer,
    resolve_impls,
    token_nll,
)
from faabric_tpu_torch.util.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig(ModelConfig):
    n_experts: int = 4
    capacity_factor: float = 1.25
    # Experts per token: 1 = switch routing (gate = the raw top
    # probability), > 1 = GShard-style, gates renormalised over the
    # selected experts
    router_top_k: int = 1
    # Weight of the switch load-balancing loss
    aux_loss_weight: float = 0.01


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEConfig, device: torch.device):
        super().__init__()
        d, h, e, f, n = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                         cfg.n_experts)
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.ln1 = nn.Parameter(torch.ones(d, **kw))
        self.wqkv = nn.Parameter(torch.empty(d, 3, h, e, **kw))
        self.wo = nn.Parameter(torch.empty(h, e, d, **kw))
        self.ln2 = nn.Parameter(torch.ones(d, **kw))
        self.router = nn.Parameter(torch.empty(d, n, **kw))
        self.w1 = nn.Parameter(torch.empty(n, d, f, **kw))
        self.w2 = nn.Parameter(torch.empty(n, f, d, **kw))


class MoETransformer(nn.Module):
    """The MoE model's parameters and config; ``model(tokens)`` runs
    :func:`moe_forward`. Weights are drawn as ``init_moe_params`` draws
    them (standard normal over sqrt(fan_in), norms at one), from
    ``generator``."""

    def __init__(self, cfg: MoEConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw))
        self.blocks = nn.ModuleList(MoEBlock(cfg, device)
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
            dense(blk.router, d)
            dense(blk.w1, d)
            dense(blk.w2, self.cfg.d_ff)
        dense(self.embed, d)
        dense(self.lm_head, d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens):
        return moe_forward(self, tokens)


def moe_param_shardings(mesh, cfg: MoEConfig) -> dict:
    """The JAX package's specs: the embedding over tp, heads over tp,
    the router replicated, experts over ep with each expert's hidden
    over tp."""
    from faabric_tpu_torch.parallel.mesh import named

    block = {"ln1": named(mesh), "wqkv": named(mesh, None, None, "tp", None),
             "wo": named(mesh, "tp", None, None), "ln2": named(mesh),
             "router": named(mesh), "w1": named(mesh, "ep", None, "tp"),
             "w2": named(mesh, "ep", "tp", None)}
    return {"embed": named(mesh, "tp", None),
            "blocks": [dict(block) for _ in range(cfg.n_layers)],
            "ln_f": named(mesh), "lm_head": named(mesh, None, "tp")}


def _moe_param_shapes(cfg: MoEConfig) -> dict:
    """Every weight's whole shape: the dense family's, each block with
    the router and the experts."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = _param_shapes(cfg)
    for block in shapes["blocks"]:
        block.update(router=(d, n), w1=(n, d, f), w2=(n, f, d))
    return shapes


class ShardedMoETransformer(ShardedTransformer):
    """A MoETransformer's weights laid over a mesh (``ranks[r]`` holds
    rank r's shards, :func:`moe_param_shardings`); ``model(tokens)`` runs
    :func:`moe_forward` on per-rank token lists. Over a mesh whose ranks
    live in several processes each process holds and runs its own
    ranks (``None`` for the others')."""

    @staticmethod
    def _shardings(mesh, cfg: MoEConfig) -> dict:
        return moe_param_shardings(mesh, cfg)

    @staticmethod
    def _shapes(cfg: MoEConfig) -> dict:
        return _moe_param_shapes(cfg)

    def forward(self, tokens):
        return moe_forward(self, tokens)


def shard_moe_params(params, mesh, cfg: MoEConfig) -> ShardedMoETransformer:
    """A MoETransformer (or the JAX package's pytree of arrays) laid over
    the mesh."""
    if isinstance(params, nn.Module):
        params = _param_tree(params)
    return ShardedMoETransformer(cfg, mesh, params)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _capacity(cfg: MoEConfig, seq: int) -> int:
    return max(1, int(math.ceil(
        seq * cfg.router_top_k * cfg.capacity_factor / cfg.n_experts)))


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch_combine(x: torch.Tensor, router: torch.Tensor,
                         cfg: MoEConfig):
    """Routing and slot-major capacity allocation, shared by the
    unsharded layer, the sharded one and the pipeline's MoE stages:
    x (B, S, D) -> (dispatch (B, S, E, C), combine (B, S, E, C), aux).
    All in fp32, as the reference: the same inputs give the same
    routing wherever it runs."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.router_top_k
    c = _capacity(cfg, s)

    probs = torch.softmax(x.float() @ router.float(), dim=-1)   # (B, S, E)
    topk_probs, topk_idx = _top_k(probs, k)                     # (B, S, K)
    gates = (topk_probs if k == 1
             else topk_probs / topk_probs.sum(-1, keepdim=True))

    # Switch load-balancing aux over FIRST choices: E · Σ_e f_e · p_e
    density = F.one_hot(topk_idx[..., 0], e).float().mean(1)
    aux = (density * probs.mean(1)).sum(-1).mean() * e

    # Slot-major: flatten (K, S) so every first choice outranks any
    # second, count positions in each expert's buffer with an fp32
    # cumsum, drop past capacity (``jax.nn.one_hot`` gives a zero row for
    # a position >= C; ``F.one_hot`` would raise, so clamp and mask)
    oh = F.one_hot(topk_idx, e).float()                         # (B, S, K, E)
    oh_flat = oh.transpose(1, 2).reshape(b, k * s, e)
    pos_flat = ((torch.cumsum(oh_flat, dim=1) - 1.0) * oh_flat).sum(-1)
    keep = (pos_flat < c).float()
    pos_hot = F.one_hot(pos_flat.long().clamp(0, c - 1), c).float()
    disp = ((oh_flat * keep[..., None])[..., None]
            * pos_hot[:, :, None, :]).reshape(b, k, s, e, c)
    dispatch = disp.sum(1)
    combine = (disp * gates.transpose(1, 2)[..., None, None]).sum(1)
    return dispatch, combine, aux


def _experts(h32, dispatch, w1, w2):
    """The expert FFN in fp32 on the experts of ``w1``/``w2`` (and their
    slice of ``dispatch``): tokens into per-expert buffers (E, B, C, D),
    then the batched product pair."""
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, h32)
    mid = F.gelu(torch.einsum("ebcd,edf->ebcf", expert_in, w1.float()),
                 approximate="tanh")
    return torch.einsum("ebcf,efd->ebcd", mid, w2.float())


def _moe_layer(x: torch.Tensor, blk, cfg: MoEConfig):
    """x (B, S, D) -> (out, aux): every expert on one device."""
    dispatch, combine, aux = moe_dispatch_combine(x, blk.router, cfg)
    out_e = _experts(x.float(), dispatch, blk.w1, blk.w2)
    out = torch.einsum("bsec,ebcd->bsd", combine, out_e)
    return out.to(x.dtype), aux


def _ep_moe_ffn(hs, blks, cfg: MoEConfig, mesh):
    """The switch-MoE FFN on each rank's (tp, ep) shards: the routing is
    computed alike on every rank, each rank runs only its experts' slab
    (hidden split over tp), and allreduces over tp (after w2) and over ep
    (after the combine) reassemble the output. At sp > 1 each rank routes
    the whole sequence, gathered over sp, and keeps its own rows.
    Returns (outputs, each rank's aux over its rows)."""
    sp = mesh.shape["sp"]
    if sp > 1:
        hs = mesh.over("sp", hs, "allgather", dim=1)

    def route(h, b, r):
        dispatch, combine, aux = moe_dispatch_combine(h, b.router, cfg)
        e_loc = b.w1.shape[0]
        lo = mesh.index(r, "ep") * e_loc
        return (_experts(h.float(), dispatch[:, :, lo:lo + e_loc], b.w1,
                         b.w2), combine[:, :, lo:lo + e_loc], aux)

    parts = _local(route, hs, blks, range(mesh.size))
    outs = mesh.over("tp", _local(lambda p: p[0], parts), "allreduce")
    outs = _local(lambda p, o: torch.einsum("bsec,ebcd->bsd", p[1], o),
                  parts, outs)
    outs = mesh.over("ep", outs, "allreduce")
    outs = _local(lambda o, h: o.to(h.dtype), outs, hs)
    if sp > 1:
        s_l = _first(outs).shape[1] // sp
        outs = _local(lambda o, r: o.narrow(1, mesh.index(r, "sp") * s_l,
                                            s_l), outs, range(mesh.size))
    return outs, _local(lambda p: p[2], parts)


def _sharded_moe_block(xs, blks, positions, cfg: MoEConfig, mesh):
    """A MoE block on each rank's shards: the shared attention sublayer,
    then the ep-local expert FFN. Returns (outputs, auxs)."""
    xs = _sharded_attention_sublayer(xs, blks, positions, cfg, mesh)
    ffs, auxs = _ep_moe_ffn(_local(lambda x, b: _rms_norm(x, b.ln2), xs,
                                   blks), blks, cfg, mesh)
    return _local(lambda x, f: x + f, xs, ffs), auxs


# ---------------------------------------------------------------------------
# Forward, loss, train step
# ---------------------------------------------------------------------------

def moe_forward(model, tokens):
    """tokens (B, S) -> (logits (B, S, V) fp32, aux scalar), the aux the
    mean over layers. No remat, as the reference. A sharded model takes
    per-rank token lists (B/dp, S/sp) and gives per-rank logits and
    per-rank copies of the global aux."""
    if isinstance(model, ShardedTransformer):
        return _sharded_moe_forward(model, tokens)
    cfg = resolve_impls(model.cfg, model.device)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = F.embedding(tokens, model.embed).to(cfg.compute_dtype)
    aux_total = torch.zeros((), device=x.device)
    for blk in model.blocks:
        x = attention_sublayer(x, blk, positions, cfg)
        out, aux = _moe_layer(_rms_norm(x, blk.ln2), blk, cfg)
        aux_total = aux_total + aux
        x = x + out
    x = _rms_norm(x, model.ln_f)
    logits = (x @ model.lm_head.to(cfg.compute_dtype)).float()
    return logits, aux_total / max(1, cfg.n_layers)


def _sharded_moe_parts(model: ShardedTransformer, tokens):
    """Per-rank logits and each rank's aux over its own rows."""
    mesh = _check_sharded(model, tokens)
    cfg = resolve_impls(model.cfg, mesh.device, mesh)
    shards = model.shards()
    positions = _sharded_positions(tokens, mesh)
    xs = _sharded_embed(shards, tokens, cfg, mesh)
    aux_total = None
    for i in range(cfg.n_layers):
        xs, auxs = _sharded_moe_block(
            xs, _local(lambda sh: sh.blocks[i], shards), positions, cfg,
            mesh)
        aux_total = auxs if aux_total is None else _local(
            lambda a, b: a + b, aux_total, auxs)
    aux_total = _local(lambda a: a / max(1, cfg.n_layers), aux_total)
    return _sharded_logits(shards, xs, cfg, mesh), aux_total


def _global_aux(auxs, mesh) -> list:
    """Each rank's aux over its rows -> per-rank copies of the mean over
    the dp shards (equal shards; every rank of a dp shard holds the same
    value, so the sum over all ranks over the mesh size is that mean)."""
    return mesh.over(mesh.axis_names, _local(lambda a: a / mesh.size, auxs),
                     "allreduce")


def _sharded_moe_forward(model: ShardedTransformer, tokens):
    logits, auxs = _sharded_moe_parts(model, tokens)
    return logits, _global_aux(auxs, model.mesh)


def moe_loss_fn(model, tokens, targets):
    """Mean token NLL plus ``aux_loss_weight`` x aux. Over a mesh: per
    rank, the global value as a differentiable replicated copy."""
    cfg = model.cfg
    if not isinstance(model, ShardedTransformer):
        logits, aux = moe_forward(model, tokens)
        return token_nll(logits, targets).mean() + cfg.aux_loss_weight * aux
    mesh = model.mesh
    logits, auxs = _sharded_moe_parts(model, tokens)
    parts = _local(lambda p, a: p + cfg.aux_loss_weight * a / mesh.size,
                   _token_parts(logits, targets, mesh), auxs)
    return mesh.over(mesh.axis_names, parts, "allreduce")


def make_moe_train_step(cfg: MoEConfig, optimizer=None):
    """``step(model, opt, tokens, targets) -> loss``: one AdamW update of
    a :class:`MoETransformer`, or of a sharded one on per-rank lists (the
    loss then a per-rank list), as ``models.train.make_train_step``."""
    from faabric_tpu_torch.models.train import _build_step, make_optimizer

    return _build_step(cfg, optimizer or make_optimizer(), 1, moe_loss_fn)


def init_moe_train_state(generator: torch.Generator | None = None,
                         cfg: MoEConfig = MoEConfig(), device=None,
                         optimizer=None, mesh=None):
    """(model, opt) as ``models.train.init_train_state``, for the MoE
    family: weights from ``generator``, over ``mesh`` if given."""
    from faabric_tpu_torch.models.train import make_optimizer

    optimizer = optimizer or make_optimizer()
    if mesh is not None and device is None:
        device = mesh.device
    model = MoETransformer(cfg, device=device, generator=generator)
    if mesh is not None:
        model = shard_moe_params(model, mesh, cfg)
    return model, optimizer.init(model)
