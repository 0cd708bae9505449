"""Device selection for the PyTorch port.

The port runs on the card. The CPU is used only when a caller names it
(``device="cpu"``), as the CPU tests do: a missing GPU is an error, never
a silent switch to the plain code paths.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda:0``. A CUDA device without a usable GPU raises."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "faabric_tpu_torch needs a CUDA GPU: torch.cuda.is_available() "
                "is False. Pass device='cpu' to run the plain PyTorch paths.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
