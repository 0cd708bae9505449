"""Evaluation: token-level NLL and perplexity over a batch stream.

Counterpart of ``faabric_tpu/models/evaluate.py``.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Optional

import torch

from faabric_tpu_torch.models.transformer import Transformer, forward, token_nll


@torch.no_grad()
def evaluate_perplexity(model: Transformer, batches: Iterable,
                        max_batches: Optional[int] = None) -> dict:
    """Mean token NLL and perplexity over (tokens, targets) batches (for
    example a :class:`faabric_tpu_torch.data.DataLoader`). The sums stay
    on the device until the end."""
    if max_batches is not None:
        batches = itertools.islice(iter(batches), max_batches)
    total = torch.zeros((), dtype=torch.float64, device=model.device)
    n_tokens = 0
    for tokens, targets in batches:
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
