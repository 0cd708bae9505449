"""Training-state checkpoint and resume.

Counterpart of ``faabric_tpu/models/checkpoint.py``: the model's weights,
the optimizer's ``state_dict`` and the step, in one ``torch.save`` file.
The weights are kept in one format whatever the model's layout: the
whole pytree in the JAX package's model layout (``blocks``), gathered
from a sharded model's shards and unstacked from a pipelined model's
slabs, so a checkpoint of any layout restores into any other of the same
config (the reference's pipeline checkpoint goes through
``unstack_block_params`` likewise). The optimizer's state holds one entry
per parameter tensor, so it restores only into the layout it was saved
from; pass ``opt=None`` to restore the weights alone. It includes the
update count that drives the learning-rate schedule, so a resumed run
continues the same schedule.
"""

from __future__ import annotations

import os

import torch


def _whole(model: torch.nn.Module) -> dict:
    from faabric_tpu_torch.models.convert import _unstacked
    from faabric_tpu_torch.models.transformer import (
        ShardedTransformer,
        _param_tree,
    )

    tree = (_unstacked(model.gathered())
            if isinstance(model, ShardedTransformer) else _param_tree(model))
    return {"embed": tree["embed"].detach(),
            "blocks": [{k: v.detach() for k, v in blk.items()}
                       for blk in tree["blocks"]],
            "ln_f": tree["ln_f"].detach(), "lm_head": tree["lm_head"].detach()}


def save_train_state(path: str, model: torch.nn.Module,
                     opt: torch.optim.Optimizer | None, step: int = 0) -> None:
    """Write the model's weights, the optimizer (if any) and ``step`` to
    ``path``. The file appears whole or not at all; a failed save
    raises."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp"
    with torch.no_grad():
        params = _whole(model)
    try:
        torch.save({"params": params,
                    "opt": None if opt is None else opt.state_dict(),
                    "step": int(step)}, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def restore_train_state(path: str, model: torch.nn.Module,
                        opt: torch.optim.Optimizer | None = None) -> int:
    """Load a checkpoint's weights into ``model`` (any layout of the
    config) and, with ``opt``, its optimizer state, in place; return its
    step."""
    from faabric_tpu_torch.models.convert import load_params

    state = torch.load(os.path.abspath(path), weights_only=True,
                       map_location="cpu")
    if "params" not in state:
        raise ValueError(
            f"{path} is of the older format (the model's state_dict under "
            "'model', for the layout it was saved from): load it with "
            "model.load_state_dict(torch.load(path)['model'])")
    load_params(model, state["params"])
    if opt is not None:
        if state["opt"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        opt.load_state_dict(state["opt"])
    return int(state["step"])
