"""Training-state checkpoint and resume.

Counterpart of ``faabric_tpu/models/checkpoint.py``: the model's and the
optimizer's ``state_dict``s and the step, in one ``torch.save`` file. The
optimizer's state includes the update count that drives the learning-rate
schedule, so a resumed run continues the same schedule.
"""

from __future__ import annotations

import os

import torch


def save_train_state(path: str, model: torch.nn.Module,
                     opt: torch.optim.Optimizer, step: int = 0) -> None:
    """Write the model, the optimizer and ``step`` to ``path``. The file
    appears whole or not at all; a failed save raises."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp"
    try:
        torch.save({"model": model.state_dict(), "opt": opt.state_dict(),
                    "step": int(step)}, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def restore_train_state(path: str, model: torch.nn.Module,
                        opt: torch.optim.Optimizer) -> int:
    """Load a checkpoint into ``model`` and ``opt`` in place (tensors land
    on the model's device) and return its step."""
    state = torch.load(os.path.abspath(path), weights_only=True,
                       map_location=next(model.parameters()).device)
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["opt"])
    return int(state["step"])
