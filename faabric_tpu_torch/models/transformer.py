"""Flagship model: decoder-only transformer, in PyTorch.

Counterpart of ``faabric_tpu/models/transformer.py`` with the same
parameter layout, so JAX parameters load one to one
(``models/convert.py``): ``embed`` (V, D); per block ``ln1``, ``wqkv``
(D, 3, H, E), ``wo`` (H, E, D), ``ln2``, ``w1`` (D, F), ``w2`` (F, D);
then ``ln_f`` and ``lm_head`` (D, V). Parameters stay float32 and are
cast to the bfloat16 compute dtype at each use (mixed precision, as in
the JAX package).

``attention_impl`` picks plain attention ("reference"), the flash
kernels ("flash") or, over a sequence-split mesh, ring attention
("ring"); ``norm_impl`` the model's own RMS norm ("reference") or the
fused kernel ("fused"). "auto" resolves to the kernels on CUDA and to
the plain versions on the CPU. ``remat`` wraps each block in
``torch.utils.checkpoint`` when gradients are taken, as ``jax.checkpoint``
does in the JAX package: a block keeps only its input, and its forward
(flash kernel included) runs again in the backward pass.

Over a mesh (``parallel/mesh.py``) the model is a
:class:`ShardedTransformer`: per rank, that rank's shards of every
weight (``param_shardings``, the reference's specs), and ``forward`` /
``loss_fn`` take per-rank token lists, the batch split over dp and the
sequence over sp. Each rank runs the block on its own shards, and
every exchange between ranks is a collective of
``parallel/collectives.py``: the vocab-parallel embedding and the
row-parallel attention output and w2 end in an allreduce over tp, the
sequence-split attention rotates (ring) or gathers (plain) K and V over
sp, and the logits are gathered over tp on the vocab dim. This is what
XLA inserts for the JAX package's sharding annotations.

Over a mesh whose ranks live in several processes of a device plane
(``parallel/mesh.py``), each process holds and runs only its own ranks'
shards: every per-rank list holds ``None`` for the other processes'
ranks, and the collectives that cross the boundary go through
``device_plane/xproc.py``. With ``remat`` a checkpointed block reruns
its collectives in the backward, so there the recomputation runs whole
(no early stop): every process recomputes the same blocks through the
same rounds in the same order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from faabric_tpu_torch.util.device import resolve_device

_BLOCK_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


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


def resolve_impls(cfg: ModelConfig, device: torch.device,
                  mesh=None) -> ModelConfig:
    """Resolve "auto" kernel choices for the device: the kernels on CUDA,
    the plain versions on the CPU. Under a mesh, flash attention over a
    split sequence (sp > 1) becomes ring attention, and the fused norm
    the plain one, as in the JAX package. "ring" with no mesh is the
    plain attention."""
    on_cuda = torch.device(device).type == "cuda"
    att, norm = cfg.attention_impl, cfg.norm_impl
    if att == "auto":
        att = "flash" if on_cuda else "reference"
    if norm == "auto":
        norm = "fused" if on_cuda else "reference"
    if att not in ("reference", "flash", "ring"):
        raise ValueError(
            f"attention_impl {att!r}: use auto, reference, flash or ring")
    if norm not in ("reference", "fused"):
        raise ValueError(f"norm_impl {norm!r}: use auto, reference or fused")
    if mesh is not None:
        if att == "flash" and mesh.shape["sp"] > 1:
            att = "ring"
        if norm == "fused":
            norm = "reference"
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


def _attention(q, k, v, q_offset: int = 0) -> torch.Tensor:
    """Causal attention, (B, S, H, D); fp32 softmax. Query row i sits at
    position ``q_offset + i`` of the keys' sequence."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device).tril(q_offset)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_impl == "fused":
        from faabric_tpu_torch.ops.rms_norm import rms_norm

        return rms_norm(x, scale)
    return _rms_norm(x, scale)


def _qkv(h: torch.Tensor, blk: Block, cfg: ModelConfig):
    """h (B, S, D) -> q, k, v (B, S, H, E) views of one product (H the
    heads of ``blk``'s wqkv, a shard's under a mesh)."""
    b, s, _ = h.shape
    w = blk.wqkv.to(cfg.compute_dtype).reshape(cfg.d_model, -1)
    qkv = (h @ w).view(b, s, 3, -1, cfg.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _out_proj(attn: torch.Tensor, blk: Block, cfg: ModelConfig) -> torch.Tensor:
    b, s = attn.shape[:2]
    wo = blk.wo.to(cfg.compute_dtype).reshape(-1, cfg.d_model)
    return attn.reshape(b, s, -1) @ wo


def _ffn(h: torch.Tensor, blk: Block, cfg: ModelConfig) -> torch.Tensor:
    ff = F.gelu(h @ blk.w1.to(cfg.compute_dtype), approximate="tanh")
    return ff @ blk.w2.to(cfg.compute_dtype)


def _mlp(x: torch.Tensor, blk: Block, cfg: ModelConfig) -> torch.Tensor:
    return x + _ffn(_norm(x, blk.ln2, cfg), blk, cfg)


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


def _check_family(model) -> None:
    """The dense entry points refuse another family's model (its config
    a subclass of ModelConfig): its own module runs it."""
    if type(model.cfg) is not ModelConfig:
        raise TypeError(f"a {type(model.cfg).__name__} model runs through "
                        "its own module's forward and loss, not the dense "
                        "ones")


def forward(model: Transformer, tokens):
    """tokens (B, S) int -> logits (B, S, V) float32. A
    :class:`ShardedTransformer` takes per-rank token lists (B/dp, S/sp)
    and gives per-rank logits (B/dp, S/sp, V), replicated over tp."""
    _check_family(model)
    if isinstance(model, ShardedTransformer):
        return _sharded_forward(model, tokens)
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


def loss_fn(model: Transformer, tokens, targets):
    """The mean token NLL. Over a mesh: per rank, the global mean as a
    differentiable replicated value (a backward from any one rank's
    copy gives every rank's shards their gradients)."""
    _check_family(model)
    if isinstance(model, ShardedTransformer):
        return _sharded_loss(model, tokens, targets)
    return token_nll(forward(model, tokens), targets).mean()


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------

def _param_shapes(cfg: ModelConfig) -> dict:
    """Every weight's whole shape, in the JAX package's pytree layout."""
    d, h, e, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    block = {"ln1": (d,), "wqkv": (d, 3, h, e), "wo": (h, e, d),
             "ln2": (d,), "w1": (d, f), "w2": (f, d)}
    return {"embed": (cfg.vocab_size, d),
            "blocks": [dict(block) for _ in range(cfg.n_layers)],
            "ln_f": (d,), "lm_head": (d, cfg.vocab_size)}


def param_shardings(mesh, cfg: ModelConfig) -> dict:
    """Shard specs per weight, the JAX package's: heads and hidden over
    tp, the embedding's and lm_head's vocab over tp, norms replicated."""
    from faabric_tpu_torch.parallel.mesh import named

    block = {"ln1": named(mesh), "wqkv": named(mesh, None, None, "tp", None),
             "wo": named(mesh, "tp", None, None), "ln2": named(mesh),
             "w1": named(mesh, None, "tp"), "w2": named(mesh, "tp", None)}
    return {"embed": named(mesh, "tp", None),
            "blocks": [dict(block) for _ in range(cfg.n_layers)],
            "ln_f": named(mesh), "lm_head": named(mesh, None, "tp")}


def _present(blk) -> list[str]:
    """The block weights ``blk`` (a dict or a module) holds, in the JAX
    package's pytree order (names sorted), whatever order built it."""
    if isinstance(blk, dict):
        return sorted(blk)
    return sorted(n for n, _ in blk.named_parameters(recurse=False))


def _leaves(tree: dict) -> list[tuple[str, object]]:
    """(name, leaf) of a parameter pytree, named as ``named_parameters``
    names a Transformer's (``blocks.0.wqkv``); a pipeline's stacked tree
    (``parallel/pipeline.py``) names its slabs ``stacked.wqkv``."""
    out = [("embed", tree["embed"])]
    if "stacked" in tree:
        out += [(f"stacked.{k}", tree["stacked"][k])
                for k in _present(tree["stacked"])]
    else:
        for i, blk in enumerate(tree["blocks"]):
            out += [(f"blocks.{i}.{k}", blk[k]) for k in _present(blk)]
    return out + [("ln_f", tree["ln_f"]), ("lm_head", tree["lm_head"])]


def _tree(flat: dict) -> dict:
    """The inverse of :func:`_leaves`: named leaves back as the pytree."""
    tree = {"embed": flat["embed"], "ln_f": flat["ln_f"],
            "lm_head": flat["lm_head"]}
    blocks: dict[int, dict] = {}
    for name, leaf in flat.items():
        part = name.split(".")
        if part[0] == "stacked":
            tree.setdefault("stacked", {})[part[1]] = leaf
        elif part[0] == "blocks":
            blocks.setdefault(int(part[1]), {})[part[2]] = leaf
    if "stacked" not in tree:
        tree["blocks"] = [blocks[i] for i in range(len(blocks))]
    return tree


def _param_tree(model: nn.Module) -> dict:
    """A Transformer's (or a MoETransformer's) parameters as the pytree."""
    return {"embed": model.embed,
            "blocks": [{k: getattr(blk, k) for k in _present(blk)}
                       for blk in model.blocks],
            "ln_f": model.ln_f, "lm_head": model.lm_head}


class _RankShards(nn.Module):
    """One rank's parameter shards, named as the leaves of the model's
    pytree (``blocks.0.wqkv``, or a pipeline stage's ``stacked.wqkv``)."""

    def __init__(self, leaves: dict[str, torch.Tensor]):
        super().__init__()
        n_layers = len({n.split(".")[1] for n in leaves
                        if n.startswith("blocks.")})
        if n_layers:
            self.blocks = nn.ModuleList(nn.Module() for _ in range(n_layers))
        if any(n.startswith("stacked.") for n in leaves):
            self.stacked = nn.Module()
        for name, leaf in leaves.items():
            path, _, key = name.rpartition(".")
            setattr(self.get_submodule(path), key, nn.Parameter(leaf))


class _Elsewhere(nn.Module):
    """The place of a rank whose shards another process holds."""


def _local(fn, *per_rank) -> list:
    """``fn`` over the ranks of per-rank lists that this process holds
    (their first list's entry not ``None``), ``None`` elsewhere."""
    return [None if args[0] is None else fn(*args) for args in zip(*per_rank)]


def _first(per_rank):
    """The first entry of a per-rank list that this process holds."""
    return next(x for x in per_rank if x is not None)


class ShardedTransformer(nn.Module):
    """A Transformer's weights laid over a mesh: ``ranks[r]`` holds rank
    r's shard of every weight (``param_shardings``), a leaf of its own on
    the rank's device, so that a rank's program differentiates into its
    own copies. Across processes only this process's ranks hold shards
    (``shards()`` is ``None`` for the others). ``params`` is the whole
    pytree (numpy arrays or tensors) in the JAX package's layout; it is
    only sliced. Subclasses lay the weights out otherwise through
    :meth:`_layout`, :meth:`_shardings` and :meth:`_shapes` (the MoE
    family's experts, ``models/moe.py``; the pipeline's stacked slabs,
    ``parallel/pipeline.py``)."""

    def __init__(self, cfg: ModelConfig, mesh, params: dict):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        params = self._layout(params, cfg)
        self.specs = dict(_leaves(self._shardings(mesh, cfg)))
        shapes = dict(_leaves(self._shapes(cfg)))
        given = dict(_leaves(params))
        if set(given) != set(shapes):
            raise ValueError(f"weights {sorted(set(given) ^ set(shapes))} do "
                             f"not fit the config's")
        per_rank: list[dict] = [{} for _ in range(mesh.size)]
        for name, arr in given.items():
            if tuple(arr.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                                 f"fit {shapes[name]}")
            if isinstance(arr, torch.Tensor):
                arr = arr.detach()
            pieces = self.specs[name].shard(arr, cfg.param_dtype)
            for leaves, piece in zip(per_rank, pieces):
                leaves[name] = piece
        local = set(mesh.local_ranks)
        self.ranks = nn.ModuleList(
            _RankShards(leaves) if r in local else _Elsewhere()
            for r, leaves in enumerate(per_rank))

    @staticmethod
    def _layout(params: dict, cfg: ModelConfig) -> dict:
        if len(params["blocks"]) != cfg.n_layers:
            raise ValueError(f"{len(params['blocks'])} blocks for "
                             f"{cfg.n_layers} layers")
        return params

    @staticmethod
    def _shardings(mesh, cfg: ModelConfig) -> dict:
        return param_shardings(mesh, cfg)

    @staticmethod
    def _shapes(cfg: ModelConfig) -> dict:
        return _param_shapes(cfg)

    def forward(self, tokens):
        return forward(self, tokens)

    def shards(self) -> list:
        """Every rank's shards, ``None`` for other processes' ranks."""
        return [None if isinstance(sh, _Elsewhere) else sh
                for sh in self.ranks]

    def copies(self, name: str) -> list:
        """Every rank's shard of weight ``name`` (``blocks.0.wqkv``),
        ``None`` for other processes' ranks."""
        return _local(lambda sh: sh.get_parameter(name), self.shards())

    def _unique(self) -> list[tuple[str, int]]:
        """(weight, rank) of one copy of each distinct shard, in the
        order of :meth:`unique_parameters`: the first rank of each
        replica group, whichever process holds it."""
        return [(name, g[0]) for name, spec in self.specs.items()
                for g in spec.replica_groups()]

    def unique_parameters(self) -> list[nn.Parameter]:
        """One copy of each distinct shard: the whole model's weights
        once each (for norms over the model, as gradient clipping takes).
        Across processes, the copies whose first holder is this
        process's: each shard counted once over the plane."""
        local = set(self.mesh.local_ranks)
        return [self.copies(name)[r] for name, r in self._unique()
                if r in local]

    def grad_norm(self) -> torch.Tensor:
        """The 2-norm of the gradients of :meth:`unique_parameters`, as
        ``torch.nn.utils.get_total_norm`` gives it over them in one
        process. Across processes each process takes its copies' norms
        (``torch._foreach_norm``, as that function does), each rank puts
        them at their places in the model's order with zeros elsewhere,
        and one allreduce over the plane brings every norm into that
        order exactly (a sum with zeros), so the total is the same
        function of the same norms."""
        mesh = self.mesh
        if not mesh.multiprocess:
            return torch.nn.utils.get_total_norm(
                [p.grad for p in self.unique_parameters()])
        unique = self._unique()
        mine = [(i, r, self.copies(name)[r].grad)
                for i, (name, r) in enumerate(unique)
                if r in mesh.local_ranks]
        # A process may hold no first holder at all
        norms = (torch._foreach_norm([g for _, _, g in mine], 2.0)
                 if mine else [])
        vecs = [None if d is None else torch.zeros(
            len(unique), dtype=self.cfg.param_dtype, device=d)
                for d in mesh.rank_devices]
        for (i, r, _), nrm in zip(mine, norms):
            vecs[r][i] = nrm
        total = mesh.over(mesh.axis_names, vecs, "allreduce")
        return torch.linalg.vector_norm(_first(total), 2.0)

    def gathered(self) -> dict:
        """The whole weights as the JAX package's pytree of tensors on
        this process's first rank's device, each assembled from its
        shards (across processes, in every process)."""
        return _tree({name: spec.gather(self.copies(name))
                      for name, spec in self.specs.items()})

    @torch.no_grad()
    def load_tree(self, params: dict) -> None:
        """Copy a whole pytree (this layout's, as :meth:`gathered` gives
        it) into every local rank's shards."""
        for name, arr in _leaves(self._layout(params, self.cfg)):
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.require(arr, requirements=["C"]))
            for p, piece in zip(self.copies(name),
                                self.specs[name].shard(arr.detach())):
                if p is not None:
                    p.copy_(piece)

    @torch.no_grad()
    def allreduce_grads(self) -> None:
        """Sum each shard's gradient over the ranks holding that shard
        (the gradient allreduce XLA inserts over dp): one flat allreduce
        per replica group structure, through the mesh's collectives
        (across processes, one exchange round each). A copy its rank's
        program never used (a pipeline stage's embedding off the first
        stage) counts as zero and then holds the sum."""
        by_axes: dict[tuple, list[str]] = {}
        for name, spec in self.specs.items():
            by_axes.setdefault(spec.replica_axes(), []).append(name)
        for p in self.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for axes, names in by_axes.items():
            grads = _local(lambda sh: [sh.get_parameter(n).grad
                                       for n in names], self.shards())
            flats = _local(lambda gs: torch.cat([g.reshape(-1) for g in gs]),
                           grads)
            summed = self.mesh.over(axes, flats, "allreduce")
            for gs, flat in zip(grads, summed):
                if gs is None:
                    continue
                torch._foreach_copy_(gs, [piece.view_as(g) for piece, g in zip(
                    flat.split([g.numel() for g in gs]), gs)])


def shard_params(params, mesh, cfg: ModelConfig) -> ShardedTransformer:
    """A Transformer (or the JAX package's pytree of arrays) laid over
    the mesh."""
    if isinstance(params, nn.Module):
        params = _param_tree(params)
    return ShardedTransformer(cfg, mesh, params)


def _check_sharded(model: ShardedTransformer, tokens):
    if len(tokens) != model.mesh.size:
        raise ValueError(f"{len(tokens)} token shards for "
                         f"{model.mesh.size} ranks")
    return model.mesh


def _sharded_embed(shards, tokens, cfg: ModelConfig, mesh) -> list:
    """Vocab-parallel lookup: each rank looks its tokens up in its own
    vocab range (zeros elsewhere), then an allreduce over tp."""
    def look_up(sh, tok, r):
        v_l = sh.embed.shape[0]
        ids = tok.long() - mesh.index(r, "tp") * v_l
        inside = (ids >= 0) & (ids < v_l)
        x = F.embedding(ids.clamp(0, v_l - 1), sh.embed) * inside[..., None]
        return x.to(cfg.compute_dtype)

    xs = _local(look_up, shards, tokens, range(mesh.size))
    return mesh.over("tp", xs, "allreduce")


def _sharded_attention(qs, ks, vs, cfg: ModelConfig, mesh) -> list:
    if cfg.attention_impl == "ring":
        from faabric_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(qs, ks, vs, mesh, axis="sp", batch_axis="dp",
                              head_axis="tp")
    if cfg.attention_impl == "flash":
        # Only at sp = 1 (resolve_impls routes a split sequence to the
        # ring): batch and heads are independent, so each rank attends
        # its own (B/dp, S, H/tp, D) slab
        from faabric_tpu_torch.ops.flash_attention import flash_attention

        return _local(lambda q, k, v: flash_attention(q, k, v, True),
                      qs, ks, vs)
    if mesh.shape["sp"] == 1:
        return _local(_attention, qs, ks, vs)
    # A split sequence: each rank's queries see the whole sequence's
    # keys, gathered over sp, under the mask at their global rows
    ks = mesh.over("sp", ks, "allgather", dim=1)
    vs = mesh.over("sp", vs, "allgather", dim=1)
    return _local(lambda q, k, v, r: _attention(
        q, k, v, mesh.index(r, "sp") * q.shape[1]), qs, ks, vs,
                  range(mesh.size))


def _sharded_attention_sublayer(xs, blks, positions, cfg: ModelConfig,
                                mesh) -> list:
    """Pre-norm attention and residual on each rank's shards (shared by
    the dense and MoE families, sharded or in a pipeline stage): heads
    over tp, the row-parallel wo's partial sums completed by an
    allreduce over tp."""
    qkvs = _local(lambda x, b: _qkv(_norm(x, b.ln1, cfg), b, cfg), xs, blks)
    qs = _local(lambda qkv, p: _rope(qkv[0], p, cfg.rope_theta),
                qkvs, positions)
    ks = _local(lambda qkv, p: _rope(qkv[1], p, cfg.rope_theta),
                qkvs, positions)
    attn = _sharded_attention(qs, ks, _local(lambda qkv: qkv[2], qkvs), cfg,
                              mesh)
    outs = mesh.over("tp", _local(lambda a, b: _out_proj(a, b, cfg),
                                  attn, blks),
                     "allreduce")
    return _local(lambda x, o: x + o, xs, outs)


def _sharded_ffn_sublayer(xs, blks, cfg: ModelConfig, mesh) -> list:
    """Pre-norm FFN and residual on each rank's shards: the row-parallel
    w2's partial sums over the rank's hidden units are completed by an
    allreduce over tp."""
    ffs = mesh.over("tp", _local(lambda x, b: _ffn(_norm(x, b.ln2, cfg), b,
                                                   cfg), xs, blks),
                    "allreduce")
    return _local(lambda x, f: x + f, xs, ffs)


def _sharded_block(xs, blks, positions, cfg: ModelConfig, mesh) -> list:
    xs = _sharded_attention_sublayer(xs, blks, positions, cfg, mesh)
    return _sharded_ffn_sublayer(xs, blks, cfg, mesh)


def _sharded_positions(tokens, mesh) -> list:
    """RoPE at global positions: a rank's sequence block starts at its
    sp index x S/sp."""
    def at(tok, r):
        b, s_l = tok.shape[-2:]
        start = mesh.index(r, "sp") * s_l
        return torch.arange(start, start + s_l,
                            device=tok.device)[None].expand(b, s_l)

    return _local(at, tokens, range(len(tokens)))


def _sharded_logits(shards, xs, cfg: ModelConfig, mesh) -> list:
    logits = _local(lambda x, sh: (_norm(x, sh.ln_f, cfg) @ sh.lm_head.to(
        cfg.compute_dtype)).float(), xs, shards)
    # Gathered over tp on the vocab dim: the JAX package constrains the
    # logits to ("dp", "sp", None)
    return mesh.over("tp", logits, "allgather", dim=-1)


def checkpointed(fn, *args, mesh):
    """``fn(*args)`` under ``torch.utils.checkpoint``; over a mesh that
    spans processes, its recomputation runs whole (no early stop), so
    that every process reruns the same collectives."""
    with set_checkpoint_early_stop(not mesh.multiprocess):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)


def _sharded_forward(model: ShardedTransformer, tokens) -> list:
    mesh = _check_sharded(model, tokens)
    cfg = resolve_impls(model.cfg, mesh.device, mesh)
    shards = model.shards()
    positions = _sharded_positions(tokens, mesh)
    xs = _sharded_embed(shards, tokens, cfg, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        blks = _local(lambda sh: sh.blocks[i], shards)
        if remat:
            # The blocks draw no random numbers: no RNG state to replay
            xs = checkpointed(_sharded_block, xs, blks, positions, cfg, mesh,
                              mesh=mesh)
        else:
            xs = _sharded_block(xs, blks, positions, cfg, mesh)
    return _sharded_logits(shards, xs, cfg, mesh)


def _token_parts(logits, targets, mesh) -> list:
    """Each rank's share of the mean token NLL over the mesh. Each
    token's NLL is computed by every rank of its (dp, sp) cell;
    weighting each copy by 1/replicas counts every token once."""
    b_l, s_l = _first(targets).shape
    n_tokens = b_l * mesh.shape["dp"] * s_l * mesh.shape["sp"]
    replicas = mesh.size // (mesh.shape["dp"] * mesh.shape["sp"])
    return _local(lambda lg, tgt: token_nll(lg, tgt).sum()
                  / (n_tokens * replicas), logits, targets)


def _sharded_loss(model: ShardedTransformer, tokens, targets):
    mesh = model.mesh
    parts = _token_parts(_sharded_forward(model, tokens), targets, mesh)
    return mesh.over(mesh.axis_names, parts, "allreduce")
