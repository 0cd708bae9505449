"""Move parameters between the JAX package's pytree and the port's
models: a :class:`Transformer` or ``MoETransformer``, over a mesh a
:class:`ShardedTransformer`, and over a mesh with a pp axis a
``PipelinedTransformer``.

The pytree travels as numpy arrays (for example
``jax.tree.map(np.asarray, init_params(key, cfg))``), so this module
needs no JAX. It may be in the model's layout (``blocks``, a list of
per-layer dicts; a MoE config's carry the router and the experts) or the
pipeline's (``stacked``, each block weight stacked over layers, as
``parallel/pipeline.py::stack_block_params`` gives it); either loads into
any model of the config. Each array is copied bit for bit: over a mesh
into every rank's shards, and back from them.
"""

from __future__ import annotations

import numpy as np
import torch

from faabric_tpu_torch.models.moe import (
    MoEConfig,
    MoETransformer,
    ShardedMoETransformer,
)
from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    ShardedTransformer,
    Transformer,
    _leaves,
    _param_tree,
)


def _unstacked(params: dict) -> dict:
    if "stacked" not in params:
        return params
    from faabric_tpu_torch.parallel.pipeline import unstack_block_params

    return unstack_block_params(params)


@torch.no_grad()
def load_params(model: torch.nn.Module, params: dict) -> None:
    """Copy a whole pytree (either layout) into ``model``'s weights in
    place, whatever its layout and sharding."""
    if isinstance(model, ShardedTransformer):
        model.load_tree(params)
        return
    params = _unstacked(params)
    if len(params["blocks"]) != model.cfg.n_layers:
        raise ValueError(f"{len(params['blocks'])} blocks for "
                         f"{model.cfg.n_layers} layers")
    want = dict(_leaves(_param_tree(model)))
    given = dict(_leaves(params))
    if set(given) != set(want):
        raise ValueError(f"weights {sorted(set(given) ^ set(want))} do not "
                         "fit the model's")
    for name, p in want.items():
        arr = given[name]
        arr = (arr.detach().to("cpu") if isinstance(arr, torch.Tensor)
               else torch.from_numpy(np.array(arr, dtype=np.float32)))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(arr.shape)} does not fit "
                             f"{tuple(p.shape)}")
        p.copy_(arr)


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None,
                    mesh=None) -> torch.nn.Module:
    """A model holding the pytree's weights: on ``device``, or with
    ``mesh`` as each rank's shards on the rank devices (a
    ``PipelinedTransformer`` where the mesh has a pp axis or the tree is
    stacked). A :class:`MoEConfig` gives the MoE family's models."""
    if mesh is not None:
        if mesh.shape["pp"] > 1 or "stacked" in np_params:
            from faabric_tpu_torch.parallel.pipeline import PipelinedTransformer

            return PipelinedTransformer(cfg, mesh, np_params)
        if isinstance(cfg, MoEConfig):
            return ShardedMoETransformer(cfg, mesh, np_params)
        return ShardedTransformer(cfg, mesh, np_params)
    if isinstance(cfg, MoEConfig):
        model = MoETransformer(cfg, device=device)
    else:
        model = Transformer(cfg, device=device)
    load_params(model, np_params)
    return model


def params_to_numpy(model: torch.nn.Module) -> dict:
    """The model's parameters as the JAX package's pytree of float32 numpy
    arrays, in the model's own layout (a sharded model's gathered from
    its shards; a pipelined model's stacked): the inverse of
    :func:`params_from_jax`."""
    tree = (model.gathered() if isinstance(model, ShardedTransformer)
            else _param_tree(model))
    return _as_numpy(tree)


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy().copy()
