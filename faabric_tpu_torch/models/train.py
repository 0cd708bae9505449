"""Training step for the flagship transformer, in PyTorch.

Counterpart of ``faabric_tpu/models/train.py`` on one device (the sharded
step comes with the port's collectives). The step updates the model and
its ``torch.optim.AdamW`` in place and returns the loss as a device
tensor: nothing in it waits for the card. The optimizer follows optax's
``adamw`` (decoupled decay on every parameter), its learning-rate
schedules and ``clip_by_global_norm``, so that the same parameters and
batches give the JAX package's updates.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from faabric_tpu_torch.models.transformer import ModelConfig, Transformer, loss_fn


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
    when ‖g‖ >= max), then one AdamW update at the schedule's rate. The
    update count lives in the optimizer's param groups, so it is saved
    and restored with the optimizer's state_dict."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if spec.clip_norm is not None:
        norm = torch.nn.utils.get_total_norm(grads)
        scale = torch.where(norm < spec.clip_norm, torch.ones_like(norm),
                            spec.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
    for group in opt.param_groups:
        count = group.setdefault("count", 0)
        group["lr"] = spec.schedule(count)
        group["count"] = count + 1
    opt.step()


def _build_step(cfg: ModelConfig, optimizer: OptimizerSpec,
                accum_steps: int):
    """The step shared by :func:`make_train_step` and
    :func:`make_multi_step`."""

    def step(model: Transformer, opt: torch.optim.Optimizer,
             tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError(f"step built for {cfg}, model has {model.cfg}")
        model.zero_grad(set_to_none=True)
        if accum_steps > 1:
            b = tokens.shape[0]
            if b % accum_steps:
                raise ValueError(
                    f"batch {b} not divisible by accum_steps={accum_steps}")
            loss = torch.zeros((), device=tokens.device)
            for tok, tgt in zip(tokens.chunk(accum_steps),
                                targets.chunk(accum_steps)):
                mb_loss = loss_fn(model, tok, tgt)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            # Means over equal microbatches equal the full-batch gradient
            loss = loss / accum_steps
            torch._foreach_div_([p.grad for p in model.parameters()
                                 if p.grad is not None], accum_steps)
        else:
            loss = loss_fn(model, tokens, targets)
            loss.backward()
            loss = loss.detach()
        _update(model, opt, optimizer)
        return loss

    return step


def make_train_step(cfg: ModelConfig, optimizer: OptimizerSpec | None = None,
                    accum_steps: int = 1):
    """``step(model, opt, tokens, targets) -> loss``: one update of the
    model and its optimizer in place; the loss stays on the device.
    ``accum_steps > 1`` splits the batch into that many equal
    microbatches and accumulates their gradients before the one update
    (big effective batches without their activation memory)."""
    return _build_step(cfg, optimizer or make_optimizer(), accum_steps)


def make_multi_step(cfg: ModelConfig, optimizer: OptimizerSpec | None = None,
                    accum_steps: int = 1):
    """``run(model, opt, tokens, targets, n) -> last loss``: ``n`` whole
    train steps with no host sync between them. ``tokens`` and
    ``targets`` carry a leading step axis of length ``n`` (a fresh batch
    per step), or the plain batch shape to reuse one batch every step."""
    step = _build_step(cfg, optimizer or make_optimizer(), accum_steps)

    def run(model: Transformer, opt: torch.optim.Optimizer,
            tokens: torch.Tensor, targets: torch.Tensor, n: int):
        per_step = tokens.dim() == 3
        if per_step and tokens.shape[0] != n:
            raise ValueError(
                f"tokens carry {tokens.shape[0]} per-step batches, n={n}")
        loss = None
        for i in range(n):
            tok, tgt = (tokens[i], targets[i]) if per_step else (tokens, targets)
            loss = step(model, opt, tok, tgt)
        return loss

    return run


def init_train_state(generator: torch.Generator | None = None,
                     cfg: ModelConfig = ModelConfig(), device=None,
                     optimizer: OptimizerSpec | None = None):
    """(model, opt): a :class:`Transformer` with weights drawn from
    ``generator`` on ``device`` (``cuda`` by default) and its AdamW."""
    optimizer = optimizer or make_optimizer()
    model = Transformer(cfg, device=device, generator=generator)
    return model, optimizer.init(model)
