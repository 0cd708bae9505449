"""faabric_tpu_torch: the PyTorch/CUDA port of faabric_tpu's device half.

It imports ``torch`` and nothing of JAX or of ``faabric_tpu``. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
without a card and without that request they raise. Hand-written CUDA
kernels for Hopper live in ``ops/csrc/`` and are built at first use.
"""

from faabric_tpu_torch.util.device import resolve_device

__all__ = ["resolve_device"]
