"""Evaluation: token-level NLL and perplexity over a batch stream.

Counterpart of ``faabric_tpu/models/evaluate.py``. A
:class:`ShardedTransformer` runs the sharded forward, as the reference's
``mesh=`` form does.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Optional

import torch

from faabric_tpu_torch.models.transformer import (
    ShardedTransformer,
    Transformer,
    forward,
    token_nll,
)


def _sharded_nll_sum(model: ShardedTransformer, tokens, targets):
    """The batch's NLL sum and token count over the mesh. ``tokens`` and
    ``targets`` are per-rank lists (a ``DataLoader`` with the mesh gives
    them) or whole (B, S) arrays, split here over dp and sp. Each token
    is counted once: on the rank at tp, pp and ep index 0 of its cell."""
    from faabric_tpu_torch.models.train import data_sharding

    mesh = model.mesh
    if not isinstance(tokens, (list, tuple)):
        spec = data_sharding(mesh)
        tokens = spec.shard(torch.as_tensor(tokens))
        targets = spec.shard(torch.as_tensor(targets))
    logits = forward(model, tokens)
    total, n = 0.0, 0
    for r, (lg, tgt) in enumerate(zip(logits, targets)):
        c = mesh.coords(r)
        if c["tp"] == c["pp"] == c["ep"] == 0:
            nll = token_nll(lg, tgt.to(lg.device))
            total = total + nll.sum().double().to(mesh.rank_devices[0])
            n += nll.numel()
    return total, n


@torch.no_grad()
def evaluate_perplexity(model: Transformer, batches: Iterable,
                        max_batches: Optional[int] = None) -> dict:
    """Mean token NLL and perplexity over (tokens, targets) batches (for
    example a :class:`faabric_tpu_torch.data.DataLoader`). The sums stay
    on the device until the end."""
    if max_batches is not None:
        batches = itertools.islice(iter(batches), max_batches)
    sharded = isinstance(model, ShardedTransformer)
    device = model.mesh.rank_devices[0] if sharded else model.device
    total = torch.zeros((), dtype=torch.float64, device=device)
    n_tokens = 0
    for tokens, targets in batches:
        if sharded:
            nll_sum, count = _sharded_nll_sum(model, tokens, targets)
            total += nll_sum
            n_tokens += count
            continue
        tokens = torch.as_tensor(tokens, device=model.device)
        targets = torch.as_tensor(targets, device=model.device)
        nll = token_nll(forward(model, tokens), targets)
        total += nll.sum().double()
        n_tokens += nll.numel()
    if n_tokens == 0:
        raise ValueError("evaluate_perplexity got no batches")
    mean_nll = float(total) / n_tokens
    return {"nll": mean_nll, "perplexity": math.exp(mean_nll),
            "tokens": n_tokens}
