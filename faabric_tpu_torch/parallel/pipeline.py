"""Pipeline parallelism over the ``pp`` mesh axis: GPipe and 1F1B.

Counterpart of ``faabric_tpu/parallel/pipeline.py``. The JAX package runs
the pipeline as one SPMD program: a ``lax.scan`` over ticks under
``shard_map``, branch-free because collectives under a device-varying
``lax.cond`` deadlock. The port is one process driving every rank, so
the schedule is a Python loop over ticks that runs only the stages with
work at that tick:

- Block weights stack into leading-``n_layers`` slabs (``stacked``),
  split over pp: each stage's ranks hold ``n_layers / pp`` layers, each
  split over tp (experts over ep) as in ``models/transformer.py``. Every
  rank keeps its own copies of ``embed``, ``ln_f`` and ``lm_head``,
  which the reference replicates over pp.
- GPipe: at tick t stage s runs microbatch ``t − s``; stage 0 embeds;
  the last stage's head adds its NLL; after every tick but the last one
  whole-ring shift over pp (``DeviceCollectives.shift``, on one card the
  ring-permute kernel, one launch per pp group) moves each stage's
  output to the next. The backward is autograd through the tick loop: a
  shift's backward is the inverse shift.
- 1F1B: each tick runs one forward unit (``mf = t − s``) and one backward
  unit (``mb = t − 2(S−1) + s``) per stage. A stage keeps a ring of
  ``ring_slots(S)`` saved inputs and recomputes its slab from one under
  ``torch.enable_grad()``, with the cotangent hopped in from stage s+1
  (the last stage seeds it from its own head in the same tick). After
  every tick but the last, one whole-ring shift moves activations
  forward and one moves input cotangents back.

So a step of either schedule launches a fixed number of ring hops:
``2 (n_ticks − 1)`` (GPipe: forward and backward) or
``2 (n_ticks_1f1b − 1)`` (1F1B) per pp group (``hop_counts``).

Inside a stage the block is the sharded model's own, run on the stage's
sub-mesh (its ranks, pp = 1): Megatron tp with an allreduce after wo and
w2; at sp > 1 K/V gathered over sp under the causal mask at the global
row offset. Attention and norm stay plain, as the reference's stage
body, whatever ``attention_impl`` says. MoE configs take MoE blocks, the
expert FFN the ep-local one of ``models/moe.py``, without the aux loss
(the reference's ``aux_loss_weight = 0`` semantics under pp).

Each rank's share of the loss is its last-stage NLL over the global
token count and the tp x ep ranks that compute the same tokens, so the
sum over ranks is the mean; every collective's backward is its exact
adjoint, so summing each weight's gradient over the ranks holding it
(``allreduce_grads``) gives the gradient of that mean. Both schedules
leave their gradients in the model's ``.grad``, so the optimizer step is
the same for both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from faabric_tpu_torch.models.moe import (
    MoEConfig,
    MoETransformer,
    _moe_param_shapes,
    _sharded_moe_block,
)
from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    ShardedTransformer,
    Transformer,
    _param_shapes,
    _param_tree,
    _rms_norm,
    _sharded_block,
    _sharded_positions,
    token_nll,
)
from faabric_tpu_torch.parallel.mesh import Mesh, named

# ---------------------------------------------------------------------------
# Schedule math
# ---------------------------------------------------------------------------


def n_ticks(n_stages: int, n_microbatches: int) -> int:
    """GPipe ticks to drain the pipeline."""
    return n_microbatches + n_stages - 1


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Fraction of stage-ticks idle in the fill/drain bubble."""
    total = n_stages * n_ticks(n_stages, n_microbatches)
    return (total - n_stages * n_microbatches) / total


def schedule(n_stages: int, n_microbatches: int) -> list[list[int | None]]:
    """``schedule(S, M)[t][s]``: the microbatch stage s works on at tick t
    (None: a bubble)."""
    return [[t - s if 0 <= t - s < n_microbatches else None
             for s in range(n_stages)]
            for t in range(n_ticks(n_stages, n_microbatches))]


def n_ticks_1f1b(n_stages: int, n_microbatches: int) -> int:
    """Ticks of the 1F1B schedule (a tick: one forward and one backward
    unit per stage)."""
    return n_microbatches + 2 * (n_stages - 1)


def ring_slots(n_stages: int) -> int:
    """Saved inputs a 1F1B stage holds: in-flight microbatches are bounded
    by the schedule depth 2(S−1)+1, not by M."""
    return 2 * (n_stages - 1) + 1


def hop_counts(n_stages: int, n_microbatches: int) -> dict[str, int]:
    """Whole-ring shifts over pp a step makes, per pp group: one after
    every tick but the last, forward and back."""
    return {"gpipe": 2 * (n_ticks(n_stages, n_microbatches) - 1),
            "1f1b": 2 * (n_ticks_1f1b(n_stages, n_microbatches) - 1),
            "loss": n_ticks(n_stages, n_microbatches) - 1}


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def stack_block_params(params: dict) -> dict:
    """A model pytree (blocks as a list of dicts) -> the pipeline's, each
    block weight stacked on a leading (n_layers,) axis. Leaves may be
    numpy arrays or tensors."""
    blocks = params["blocks"]

    def stack(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack([x.detach() for x in xs])
        return np.stack([np.asarray(x) for x in xs])

    return {"embed": params["embed"],
            "stacked": {k: stack([blk[k] for blk in blocks])
                        for k in blocks[0]},
            "ln_f": params["ln_f"], "lm_head": params["lm_head"]}


def unstack_block_params(pp_params: dict) -> dict:
    """Inverse of :func:`stack_block_params` (checkpoint interop)."""
    stacked = pp_params["stacked"]
    n_layers = next(iter(stacked.values())).shape[0]
    return {"embed": pp_params["embed"],
            "blocks": [{k: stacked[k][i] for k in stacked}
                       for i in range(n_layers)],
            "ln_f": pp_params["ln_f"], "lm_head": pp_params["lm_head"]}


def pp_param_shardings(mesh: Mesh, cfg: ModelConfig) -> dict:
    """Layer axis over pp; heads and hidden over tp; embed, ln_f and
    lm_head replicated. A MoE config adds the expert axis: the router
    replicated, expert slabs over ep with each expert's hidden over tp."""
    stacked = {"ln1": named(mesh, "pp", None),
               "wqkv": named(mesh, "pp", None, None, "tp", None),
               "wo": named(mesh, "pp", "tp", None, None),
               "ln2": named(mesh, "pp", None)}
    if isinstance(cfg, MoEConfig):
        stacked.update(router=named(mesh, "pp", None, None),
                       w1=named(mesh, "pp", "ep", None, "tp"),
                       w2=named(mesh, "pp", "ep", "tp", None))
    else:
        stacked.update(w1=named(mesh, "pp", None, "tp"),
                       w2=named(mesh, "pp", "tp", None))
    return {"embed": named(mesh), "stacked": stacked, "ln_f": named(mesh),
            "lm_head": named(mesh)}


def pp_data_sharding(mesh: Mesh):
    """(M, B, S) microbatched tokens: batch over dp, sequence over sp,
    the microbatch axis whole on every rank
    (``pp_data_sharding(mesh).shard(microbatch(tokens, M))``)."""
    return named(mesh, None, "dp", "sp")


def microbatch(tokens, n_microbatches: int):
    """(B, S) -> (M, B/M, S): microbatch m holds rows [m·B/M, (m+1)·B/M)."""
    b, s = tokens.shape
    if b % n_microbatches:
        raise ValueError(
            f"batch {b} not divisible by n_microbatches={n_microbatches}")
    return tokens.reshape(n_microbatches, b // n_microbatches, s)


def _validate_pp_mesh(cfg: ModelConfig, mesh: Mesh) -> int:
    n_stages = mesh.shape["pp"]
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={n_stages}")
    if mesh.shape["sp"] > 1 and isinstance(cfg, MoEConfig):
        raise ValueError(
            "MoE pipeline stages don't compose with sp (per-shard "
            "capacity would diverge from the global routing)")
    ep = mesh.shape["ep"]
    if ep > 1:
        n_experts = getattr(cfg, "n_experts", 0)
        if not n_experts:
            raise ValueError("ep>1 needs a MoE config (n_experts)")
        if n_experts % ep:
            raise ValueError(
                f"n_experts={n_experts} not divisible by ep={ep}")
    return n_stages


# ---------------------------------------------------------------------------
# The pipelined model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Stage:
    """One pipeline stage: its ranks (ascending, so rank i of ``mesh`` is
    ``ranks[i]`` of the whole mesh, at the same dp/tp/sp/ep coordinates)
    and the sub-mesh of them that its in-stage collectives run over."""

    ranks: list[int]
    mesh: Mesh


class _Layer:
    """Layer i of a rank's stacked slabs, read as a block's attributes
    (each a view of the slab, so gradients land in the slab)."""

    def __init__(self, stacked, i: int):
        self._stacked, self._i = stacked, i

    def __getattr__(self, key):
        return getattr(self._stacked, key)[self._i]


class PipelinedTransformer(ShardedTransformer):
    """A Transformer's (or a MoETransformer's) weights laid over a mesh
    with a pp axis: ``ranks[r]`` holds its stage's slab of stacked block
    weights (``stacked.wqkv`` ...) split over tp (and ep), and its own
    copies of ``embed``, ``ln_f`` and ``lm_head``. ``params`` is the JAX
    package's pytree, in the model's layout (``blocks``) or the
    pipeline's (``stacked``)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, params: dict):
        n_stages = _validate_pp_mesh(cfg, mesh)
        super().__init__(cfg, mesh, params)
        self.layers_per_stage = cfg.n_layers // n_stages
        sizes = {**mesh.shape, "pp": 1}
        self.stages = []
        for s in range(n_stages):
            ranks = [r for r in range(mesh.size) if mesh.index(r, "pp") == s]
            self.stages.append(_Stage(ranks, Mesh(
                [mesh.rank_devices[r] for r in ranks], sizes)))
        # The reference's stage body ignores attention_impl/norm_impl
        self.stage_cfg = dataclasses.replace(cfg, attention_impl="reference",
                                             norm_impl="reference")

    @staticmethod
    def _layout(params: dict, cfg: ModelConfig) -> dict:
        if "stacked" in params:
            return params
        if len(params["blocks"]) != cfg.n_layers:
            raise ValueError(f"{len(params['blocks'])} blocks for "
                             f"{cfg.n_layers} layers")
        return stack_block_params(params)

    @staticmethod
    def _shardings(mesh, cfg: ModelConfig) -> dict:
        return pp_param_shardings(mesh, cfg)

    @staticmethod
    def _shapes(cfg: ModelConfig) -> dict:
        shapes = (_moe_param_shapes(cfg) if isinstance(cfg, MoEConfig)
                  else _param_shapes(cfg))
        block = shapes.pop("blocks")[0]
        return {**shapes, "stacked": {k: (cfg.n_layers, *v)
                                      for k, v in block.items()}}

    def forward(self, tokens):
        raise TypeError("a PipelinedTransformer runs through "
                        "parallel.pipeline.make_pp_loss or make_pp_train_step")

    # -- the in-stage program --------------------------------------------
    def _embed(self, stage: _Stage, tokens: list) -> list:
        cfg = self.stage_cfg
        return [F.embedding(tok, self.ranks[r].embed).to(cfg.compute_dtype)
                for r, tok in zip(stage.ranks, tokens)]

    def _run_stage(self, stage: _Stage, xs: list, positions: list) -> list:
        """The stage's slab of layers on its ranks' activations."""
        cfg = self.stage_cfg
        block = (_pp_moe_block if isinstance(cfg, MoEConfig)
                 else _sharded_block)
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(self.layers_per_stage):
            blks = [_Layer(self.ranks[r].stacked, i) for r in stage.ranks]
            if remat:
                # The blocks draw no random numbers: no RNG state to replay
                xs = checkpoint(block, xs, blks, positions, cfg, stage.mesh,
                                use_reentrant=False, preserve_rng_state=False)
            else:
                xs = block(xs, blks, positions, cfg, stage.mesh)
        return xs

    def _head(self, r: int, y, targets, weight: float):
        """Rank r's share of the loss from one microbatch's stage output:
        the head's NLL summed, times ``weight``."""
        sh, cfg = self.ranks[r], self.stage_cfg
        logits = (_rms_norm(y, sh.ln_f) @ sh.lm_head.to(cfg.compute_dtype)
                  ).float()
        return token_nll(logits, targets).sum() * weight


def _pp_moe_block(xs, blks, positions, cfg, mesh) -> list:
    """A MoE block on a stage's (tp, ep) shards; the aux is not computed
    on the pipeline path."""
    return _sharded_moe_block(xs, blks, positions, cfg, mesh)[0]


def _hop(mesh: Mesh, xs: list, disp: int) -> list:
    """One whole-ring shift over pp: rank r's tensor lands on the rank of
    the same coordinates at stage (s + disp) % pp."""
    return mesh.over("pp", xs, lambda coll, t: coll.shift(t, disp))


class _Run:
    """What both schedules need of one call: the per-rank microbatched
    tokens and targets, global positions, the loss weight."""

    def __init__(self, model: PipelinedTransformer, tokens, targets):
        mesh = model.mesh
        if len(tokens) != mesh.size or len(targets) != mesh.size:
            raise ValueError(f"{len(tokens)} token shards for {mesh.size} "
                             "ranks")
        if tokens[0].dim() != 3:
            raise ValueError("a pipeline takes per-rank (M, B/(M dp), S/sp) "
                             "shards (pp_data_sharding of microbatch)")
        self.mesh, self.tokens, self.targets = mesh, tokens, targets
        self.n_stages = mesh.shape["pp"]
        self.m, b_l, s_l = tokens[0].shape
        self.positions = _sharded_positions(tokens, mesh)
        # Each token's NLL is computed by the tp x ep ranks of its cell
        # on the last stage
        self.weight = 1.0 / (self.m * b_l * mesh.shape["dp"] * s_l
                             * mesh.shape["sp"] * mesh.shape["tp"]
                             * mesh.shape["ep"])
        cfg = model.stage_cfg
        self.zeros = [torch.zeros(b_l, s_l, cfg.d_model,
                                  dtype=cfg.compute_dtype, device=d)
                      for d in mesh.rank_devices]

    def at(self, stage: _Stage, values: list) -> list:
        return [values[r] for r in stage.ranks]

    def tokens_of(self, stage: _Stage, m: int) -> list:
        return [self.tokens[r][m] for r in stage.ranks]

    def hop(self, values: dict, disp: int) -> list:
        """A whole-ring shift of the ranks' ``values`` (zeros where a
        rank has none this tick)."""
        return _hop(self.mesh, [values.get(r, z) for r, z in
                                enumerate(self.zeros)], disp)

    def total(self, parts: dict) -> list:
        """Per-rank copies of the loss from the last stage's shares."""
        mesh = self.mesh
        xs = [parts.get(r, torch.zeros((), device=d))
              for r, d in enumerate(mesh.rank_devices)]
        return mesh.over(mesh.axis_names, xs,
                         lambda coll, t: coll.allreduce(t))


def _check_model(model, cfg: ModelConfig, mesh: Mesh) -> None:
    if not isinstance(model, PipelinedTransformer):
        raise TypeError(f"a pipeline schedule takes a PipelinedTransformer, "
                        f"got {type(model).__name__}")
    if model.cfg != cfg or model.mesh.shape != mesh.shape:
        raise ValueError(f"schedule built for {cfg} over {mesh.shape}, model "
                         f"has {model.cfg} over {model.mesh.shape}")


def _gpipe_loss(model: PipelinedTransformer, tokens, targets) -> list:
    run = _Run(model, tokens, targets)
    last = run.n_stages - 1
    ticks = n_ticks(run.n_stages, run.m)
    parts: dict[int, torch.Tensor] = {}
    hopped = None
    for t in range(ticks):
        outs: dict[int, torch.Tensor] = {}
        for s, stage in enumerate(model.stages):
            m = t - s
            if not 0 <= m < run.m:
                continue
            xs = (model._embed(stage, run.tokens_of(stage, m)) if s == 0
                  else run.at(stage, hopped))
            ys = model._run_stage(stage, xs, run.at(stage, run.positions))
            for r, y in zip(stage.ranks, ys):
                if s == last:
                    p = model._head(r, y, run.targets[r][m], run.weight)
                    parts[r] = p if r not in parts else parts[r] + p
                else:
                    outs[r] = y
        if t < ticks - 1:
            hopped = run.hop(outs, 1)
    return run.total(parts)


def _gpipe_value_and_grad(model: PipelinedTransformer, tokens, targets):
    model.zero_grad(set_to_none=True)
    loss = _gpipe_loss(model, tokens, targets)
    # Every rank holds the loss; one copy's backward reaches every rank
    loss[0].backward()
    model.allreduce_grads()
    return [x.detach() for x in loss]


def _1f1b_value_and_grad(model: PipelinedTransformer, tokens, targets):
    model.zero_grad(set_to_none=True)
    run = _Run(model, tokens, targets)
    n_stages, last = run.n_stages, run.n_stages - 1
    ticks = n_ticks_1f1b(n_stages, run.m)
    slots = ring_slots(n_stages)
    saved: dict[int, list] = {r: [None] * slots for r in range(run.mesh.size)}
    parts: dict[int, torch.Tensor] = {}
    x_hop = dy_hop = None

    def leaves(xs):
        return [x.detach().requires_grad_() for x in xs]

    for t in range(ticks):
        outs: dict[int, torch.Tensor] = {}
        dxs: dict[int, torch.Tensor] = {}
        for s, stage in enumerate(model.stages):
            pos = run.at(stage, run.positions)
            # -- forward unit: microbatch t − s ------------------------
            mf = t - s
            if 0 <= mf < run.m and s < last:
                with torch.no_grad():
                    xs = (model._embed(stage, run.tokens_of(stage, mf))
                          if s == 0 else run.at(stage, x_hop))
                    ys = model._run_stage(stage, xs, pos)
                for r, x, y in zip(stage.ranks, xs, ys):
                    outs[r] = y
                    if s > 0:
                        saved[r][mf % slots] = x
            # -- backward unit: microbatch t − 2(S−1) + s --------------
            # (the last stage's is its forward unit's, seeded by its head)
            mb = t - 2 * last + s
            if not 0 <= mb < run.m:
                continue
            xs = None if s == 0 else leaves(
                run.at(stage, x_hop) if s == last
                else [saved[r][mb % slots] for r in stage.ranks])
            with torch.enable_grad():
                ys = model._run_stage(
                    stage, model._embed(stage, run.tokens_of(stage, mb))
                    if s == 0 else xs, pos)
                if s == last:
                    heads = [model._head(r, y, run.targets[r][mb], run.weight)
                             for r, y in zip(stage.ranks, ys)]
            if s == last:
                torch.autograd.backward(heads)
                for r, h in zip(stage.ranks, heads):
                    h = h.detach()
                    parts[r] = h if r not in parts else parts[r] + h
            else:
                torch.autograd.backward(ys, run.at(stage, dy_hop))
            if s > 0:
                for r, x in zip(stage.ranks, xs):
                    dxs[r] = x.grad
                    saved[r][mb % slots] = None
        if t < ticks - 1:
            x_hop = run.hop(outs, 1)
            dy_hop = run.hop(dxs, -1)
    loss = run.total(parts)
    model.allreduce_grads()
    return loss


def make_pp_loss(cfg: ModelConfig, mesh: Mesh):
    """``loss(model, tokens_mb, targets_mb)`` of a
    :class:`PipelinedTransformer` under the GPipe schedule:
    ``tokens_mb`` per-rank (M, B/(M dp), S/sp) shards
    (``pp_data_sharding``); per-rank copies of the mean NLL,
    differentiable."""
    _validate_pp_mesh(cfg, mesh)

    def loss(model, tokens_mb, targets_mb):
        _check_model(model, cfg, mesh)
        return _gpipe_loss(model, tokens_mb, targets_mb)

    return loss


def make_pp_1f1b_value_and_grad(cfg: ModelConfig, mesh: Mesh):
    """``fn(model, tokens_mb, targets_mb) -> loss``: the 1F1B schedule,
    leaving the gradients (summed over each weight's holders) in the
    model's ``.grad``, as GPipe's backward and ``allreduce_grads`` do;
    activation memory bounded by the schedule depth, not by M."""
    _validate_pp_mesh(cfg, mesh)

    def fn(model, tokens_mb, targets_mb):
        _check_model(model, cfg, mesh)
        return _1f1b_value_and_grad(model, tokens_mb, targets_mb)

    return fn


def _as_microbatches(mesh: Mesh, batch, n_microbatches: int) -> list:
    """Per-rank microbatched shards as given, or a whole (B, S) batch
    microbatched and placed by ``pp_data_sharding``."""
    if isinstance(batch, (list, tuple)):
        if batch[0].dim() != 3 or batch[0].shape[0] != n_microbatches:
            raise ValueError(f"shards of shape {tuple(batch[0].shape)}: the "
                             f"step takes ({n_microbatches}, B/(M dp), S/sp)")
        return list(batch)
    return pp_data_sharding(mesh).shard(microbatch(batch, n_microbatches))


def make_pp_train_step(cfg: ModelConfig, optimizer=None,
                       n_microbatches: int = 4, schedule_name: str = "gpipe"):
    """``step(model, opt, tokens, targets) -> loss``: one AdamW update of
    a :class:`PipelinedTransformer` in place (the optimizer of
    ``models.train``: clip norm over one copy of each weight). ``tokens``
    and ``targets`` are a whole (B, S) batch, microbatched here, or
    per-rank (M, B/(M dp), S/sp) shards; the loss is a per-rank list.
    ``schedule_name``: ``"gpipe"`` (autograd through the tick loop,
    activations O(M + S) per stage, remat inside stages) or ``"1f1b"``
    (hand-scheduled, a ring of O(S) saved stage inputs)."""
    from faabric_tpu_torch.models.train import _update, make_optimizer

    spec = optimizer or make_optimizer()
    if schedule_name == "1f1b":
        value_and_grad = _1f1b_value_and_grad
    elif schedule_name == "gpipe":
        value_and_grad = _gpipe_value_and_grad
    else:
        raise ValueError(f"Unknown pipeline schedule {schedule_name!r}")

    def step(model, opt, tokens, targets):
        _check_model(model, cfg, model.mesh)
        tok, tgt = (_as_microbatches(model.mesh, a, n_microbatches)
                    for a in (tokens, targets))
        loss = value_and_grad(model, tok, tgt)
        _update(model, opt, spec, model.unique_parameters())
        return loss

    return step


def init_pp_train_state(generator: torch.Generator | None, cfg: ModelConfig,
                        mesh: Mesh, optimizer=None):
    """(model, opt): weights drawn from ``generator`` exactly as
    ``models.init_train_state`` (or the MoE family's) draws them, on rank
    0's device, then laid over the pp mesh, and its AdamW."""
    from faabric_tpu_torch.models.train import make_optimizer

    optimizer = optimizer or make_optimizer()
    device = mesh.rank_devices[0]
    family = MoETransformer if isinstance(cfg, MoEConfig) else Transformer
    whole = family(cfg, device=device, generator=generator)
    model = PipelinedTransformer(cfg, mesh, _param_tree(whole))
    return model, optimizer.init(model)
