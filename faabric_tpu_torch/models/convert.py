"""Move parameters between the JAX package's pytree and a
:class:`Transformer` or, over a mesh, a :class:`ShardedTransformer`.

The pytree travels as numpy arrays (for example
``jax.tree.map(np.asarray, init_params(key, cfg))``), so this module
needs no JAX. The layouts are the same, and each array is copied bit
for bit: over a mesh into every rank's shards, and back from them.
"""

from __future__ import annotations

import numpy as np
import torch

from faabric_tpu_torch.models.transformer import (
    _BLOCK_KEYS,
    ModelConfig,
    ShardedTransformer,
    Transformer,
    _param_tree,
)


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None,
                    mesh=None) -> Transformer | ShardedTransformer:
    """A model holding the pytree's weights: on ``device``, or with
    ``mesh`` as each rank's shards on the rank devices."""
    if mesh is not None:
        return ShardedTransformer(cfg, mesh, np_params)
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


def params_to_numpy(model: Transformer | ShardedTransformer) -> dict:
    """The model's parameters as the JAX package's pytree of float32 numpy
    arrays (a sharded model's gathered from its shards): the inverse of
    :func:`params_from_jax`."""
    def arr(p: torch.Tensor) -> np.ndarray:
        return p.detach().to("cpu", torch.float32).numpy().copy()

    tree = (model.gathered() if isinstance(model, ShardedTransformer)
            else _param_tree(model))
    return {"embed": arr(tree["embed"]),
            "blocks": [{k: arr(b[k]) for k in _BLOCK_KEYS}
                       for b in tree["blocks"]],
            "ln_f": arr(tree["ln_f"]), "lm_head": arr(tree["lm_head"])}
