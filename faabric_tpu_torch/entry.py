"""Entry point: one forward pass of the flagship transformer on one card.

Counterpart of ``__graft_entry__.py::entry``: the same config and the
same ``RandomState(0)`` tokens. The weights come from a torch generator
seeded with 0, so they are not the JAX package's numbers; load those
with ``models.convert.params_from_jax`` to compare the two.
"""

from __future__ import annotations

import numpy as np
import torch

from faabric_tpu_torch.models import ModelConfig, Transformer, forward
from faabric_tpu_torch.util.device import resolve_device

ENTRY_CONFIG = ModelConfig(vocab_size=2048, d_model=256, n_layers=2,
                           n_heads=8, d_ff=1024, max_seq=256)


def entry(device=None):
    """(fn, example_args): ``fn(model, tokens)`` -> logits (2, 128, 2048)."""
    device = resolve_device(device)
    cfg = ENTRY_CONFIG
    gen = torch.Generator(device=device).manual_seed(0)
    model = Transformer(cfg, device=device, generator=gen)
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 128)),
        dtype=torch.int32, device=device)

    def fn(model, tokens):
        with torch.inference_mode():
            return forward(model, tokens)

    return fn, (model, tokens)
