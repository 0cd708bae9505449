"""Training step for the flagship transformer, in PyTorch.

Counterpart of ``faabric_tpu/models/train.py``. The step updates the
model and its ``torch.optim.AdamW`` in place and returns the loss as a
device tensor: nothing in it waits for the card. The optimizer follows
optax's ``adamw`` (decoupled decay on every parameter), its
learning-rate schedules and ``clip_by_global_norm``, so that the same
parameters and batches give the JAX package's updates.

Over a mesh the model is a ``ShardedTransformer`` and the batch per-rank
lists (``data_sharding``). One backward through the ranks' programs
gives each rank's copies their gradients; ``allreduce_grads`` sums each
shard's over the ranks that hold it (the dp allreduce XLA inserts), and
the same AdamW then updates every rank's copies alike. The loss comes
back as a per-rank list of the replicated global loss.

Over a mesh whose ranks live in several processes of a device plane the
same step runs in every process, each over its own ranks (``None`` in
the per-rank lists for the others'). Each process backpropagates its
own loss copies with cotangent 1 at global rank 0 and 0 elsewhere: the
loss allreduce's backward, across the processes, then gives every
rank's share exactly 1, as in one process (a 1 in every process would
scale the gradients by the process count). The clip norm counts each
shard once over the plane (``ShardedTransformer.grad_norm``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    ShardedTransformer,
    Transformer,
    loss_fn,
    shard_params,
)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` returns; :meth:`init` makes the torch
    optimizer over a model's parameters."""

    lr: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: int | None = None
    clip_norm: float | None = None

    def schedule(self, count: int) -> float:
        """The learning rate of update ``count`` (0 for the first), with
        the formulas of optax's schedules."""
        if self.total_steps:
            # warmup_cosine_decay_schedule(0, lr, warmup, total), end 0
            warmup = max(1, self.warmup_steps)
            decay = max(self.total_steps, self.warmup_steps + 1) - warmup
            if count < warmup:
                return _linear(count, self.lr, warmup)
            t = min(count - warmup, decay)
            return self.lr * (0.5 * (1 + math.cos(math.pi * t / decay)))
        if self.warmup_steps:
            # Warm up, then hold at the peak
            if count < self.warmup_steps:
                return _linear(count, self.lr, self.warmup_steps)
            return self.lr
        return self.lr

    def init(self, model: torch.nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(model.parameters(), lr=self.schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)


def _linear(count: int, peak: float, steps: int) -> float:
    """optax.linear_schedule(0, peak, steps) at ``count``."""
    frac = 1 - min(max(count, 0), steps) / steps
    return (0.0 - peak) * frac + peak


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 0, total_steps: int | None = None,
                   clip_norm: float | None = None) -> OptimizerSpec:
    """AdamW with an optional warmup-cosine schedule (``total_steps``), a
    warmup that then holds (``warmup_steps`` alone), and global-norm
    gradient clipping."""
    return OptimizerSpec(lr, weight_decay, warmup_steps, total_steps,
                         clip_norm)


def _update(model: torch.nn.Module, opt: torch.optim.Optimizer,
            spec: OptimizerSpec) -> None:
    """Clip the gradients as optax.clip_by_global_norm does (g·max/‖g‖
    when ‖g‖ >= max), then one AdamW update at the schedule's rate. A
    sharded model's norm is over one copy of each shard
    (``grad_norm``). The update count lives in the optimizer's param
    groups, so it is saved and restored with the optimizer's
    state_dict."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if spec.clip_norm is not None:
        norm = (model.grad_norm() if isinstance(model, ShardedTransformer)
                else torch.nn.utils.get_total_norm(grads))
        scale = torch.where(norm < spec.clip_norm, torch.ones_like(norm),
                            spec.clip_norm / norm)
        by_device: dict[torch.device, list] = {}
        for g in grads:
            by_device.setdefault(g.device, []).append(g)
        for dev, gs in by_device.items():
            torch._foreach_mul_(gs, scale.to(dev))
    for group in opt.param_groups:
        count = group.setdefault("count", 0)
        group["lr"] = spec.schedule(count)
        group["count"] = count + 1
    opt.step()


def backward_copies(copies: list) -> None:
    """Backpropagate a sharded model's per-rank loss copies (``None``
    for other processes' ranks): cotangent 1 at global rank 0 and 0 at
    every other rank this process holds. In one process this is rank
    0's copy's backward; across processes every process runs it over its
    own copies, and the loss allreduce's backward sums the cotangents to
    exactly 1 on every rank."""
    roots = [(c, torch.ones_like(c) if r == 0 else torch.zeros_like(c))
             for r, c in enumerate(copies) if c is not None]
    torch.autograd.backward([c for c, _ in roots], [g for _, g in roots])


def _microbatches(batch, accum_steps: int) -> list:
    """``accum_steps`` equal microbatches of a batch: of the tensor, or of
    every rank's shard (each microbatch then stays split over dp)."""
    first = (batch if isinstance(batch, torch.Tensor)
             else next(t for t in batch if t is not None))
    if first.shape[0] % accum_steps:
        raise ValueError(f"batch {first.shape[0]} "
                         f"{'' if first is batch else 'per rank '}"
                         f"not divisible by accum_steps={accum_steps}")
    if first is batch:
        return list(batch.chunk(accum_steps))
    return [list(mb) for mb in zip(*(
        [None] * accum_steps if t is None else t.chunk(accum_steps)
        for t in batch))]


def _build_step(cfg: ModelConfig, optimizer: OptimizerSpec,
                accum_steps: int, loss=loss_fn):
    """The step shared by :func:`make_train_step`, :func:`make_multi_step`
    and the MoE family's ``make_moe_train_step`` (its ``loss``)."""

    def step(model: Transformer, opt: torch.optim.Optimizer, tokens, targets):
        if model.cfg != cfg:
            raise ValueError(f"step built for {cfg}, model has {model.cfg}")
        sharded = isinstance(model, ShardedTransformer)
        model.zero_grad(set_to_none=True)
        total = None
        for tok, tgt in zip(_microbatches(tokens, accum_steps),
                            _microbatches(targets, accum_steps)):
            mb_loss = loss(model, tok, tgt)
            copies = mb_loss if sharded else [mb_loss]
            # Over a mesh every rank holds the loss; rank 0's copy's
            # backward reaches every rank's shards
            backward_copies(copies)
            copies = [None if x is None else x.detach() for x in copies]
            total = copies if total is None else [
                None if a is None else a + b for a, b in zip(total, copies)]
        if accum_steps > 1:
            # Means over equal microbatches equal the full-batch gradient
            total = [None if x is None else x / accum_steps for x in total]
            torch._foreach_div_([p.grad for p in model.parameters()
                                 if p.grad is not None], accum_steps)
        if sharded:
            model.allreduce_grads()
        _update(model, opt, optimizer)
        return total if sharded else total[0]

    return step


def make_train_step(cfg: ModelConfig, optimizer: OptimizerSpec | None = None,
                    accum_steps: int = 1):
    """``step(model, opt, tokens, targets) -> loss``: one update of the
    model and its optimizer in place; the loss stays on the device.
    ``accum_steps > 1`` splits the batch into that many equal
    microbatches and accumulates their gradients before the one update
    (big effective batches without their activation memory). For a
    ``ShardedTransformer`` the batch is per-rank lists, and the loss a
    per-rank list."""
    return _build_step(cfg, optimizer or make_optimizer(), accum_steps)


def make_multi_step(cfg: ModelConfig, optimizer: OptimizerSpec | None = None,
                    accum_steps: int = 1):
    """``run(model, opt, tokens, targets, n) -> last loss``: ``n`` whole
    train steps with no host sync between them. ``tokens`` and
    ``targets`` (each rank's, for a ``ShardedTransformer``) carry a leading step axis of
    length ``n`` (a fresh batch per step), or the plain batch shape to
    reuse one batch every step."""
    step = _build_step(cfg, optimizer or make_optimizer(), accum_steps)

    def run(model: Transformer, opt: torch.optim.Optimizer, tokens, targets,
            n: int):
        sharded = isinstance(model, ShardedTransformer)
        first = (next(t for t in tokens if t is not None) if sharded
                 else tokens)
        per_step = first.dim() == 3
        if per_step and first.shape[0] != n:
            raise ValueError(
                f"tokens carry {first.shape[0]} per-step batches, n={n}")
        loss = None
        for i in range(n):
            if not per_step:
                tok, tgt = tokens, targets
            elif sharded:
                tok, tgt = ([None if t is None else t[i] for t in ts]
                            for ts in (tokens, targets))
            else:
                tok, tgt = tokens[i], targets[i]
            loss = step(model, opt, tok, tgt)
        return loss

    return run


def init_train_state(generator: torch.Generator | None = None,
                     cfg: ModelConfig = ModelConfig(), device=None,
                     optimizer: OptimizerSpec | None = None, mesh=None):
    """(model, opt): a :class:`Transformer` with weights drawn from
    ``generator`` on ``device`` (``cuda`` by default) and its AdamW. With
    ``mesh``, the same weights (drawn on ``device``, by default this
    process's first rank's) laid over the mesh as a
    ``ShardedTransformer``: across processes every process draws the
    whole weights alike and keeps its own ranks' shards."""
    optimizer = optimizer or make_optimizer()
    if mesh is not None and device is None:
        device = mesh.device
    model = Transformer(cfg, device=device, generator=generator)
    if mesh is not None:
        model = shard_params(model, mesh, cfg)
    return model, optimizer.init(model)


def data_sharding(mesh):
    """The per-rank split of a (B, S) batch: B over dp, S over sp
    (``data_sharding(mesh).shard(tokens)`` places it, ``None`` for other
    processes' ranks)."""
    from faabric_tpu_torch.parallel.mesh import named

    return named(mesh, "dp", "sp")
