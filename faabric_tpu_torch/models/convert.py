"""Load the JAX package's parameter pytree into a :class:`Transformer`.

The pytree arrives as numpy arrays (for example
``jax.tree.map(np.asarray, init_params(key, cfg))``), so this module
needs no JAX. The layouts are the same, and each array is copied bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from faabric_tpu_torch.models.transformer import ModelConfig, Transformer

_BLOCK_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device=None) -> Transformer:
    model = Transformer(cfg, device=device)
    if len(np_params["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(np_params['blocks'])} blocks for "
                         f"{cfg.n_layers} layers")

    def load(p: torch.nn.Parameter, arr) -> None:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape {arr.shape} does not fit {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))

    with torch.no_grad():
        for name in ("embed", "ln_f", "lm_head"):
            load(getattr(model, name), np_params[name])
        for blk, src in zip(model.blocks, np_params["blocks"]):
            for name in _BLOCK_KEYS:
                load(getattr(blk, name), src[name])
    return model
