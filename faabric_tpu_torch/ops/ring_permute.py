"""Ring permute: a CUDA kernel on the card, its plain version on the CPU.

Counterpart of the Pallas kernel in ``faabric_tpu/device_plane/
pallas_ring.py`` (``_pallas_permute_call``): one ring hop in which rank
r's flat shard lands in rank ``(r + shift) % n``'s output, bitwise. The
TPU kernel runs once per chip as a remote DMA; on the card the ranks of
one process share the device, so ``csrc/ring_permute.cu`` moves all n
shards in one launch, with the n source and n destination pointers
passed by value in the kernel's parameters (at most ``MAX_RANKS``).
"""

from __future__ import annotations

import torch

from faabric_tpu_torch.ops import _build

MAX_RANKS = 64


def _reference_ring_permute(ins, outs, shift: int) -> None:
    """The kernel's function in plain PyTorch: one ``copy_`` per rank."""
    n = len(ins)
    for r in range(n):
        outs[(r + shift) % n].copy_(ins[r])


def _check(ins, outs) -> None:
    if not ins or len(outs) != len(ins):
        raise ValueError("ring_permute takes as many outputs as inputs, "
                         "at least one")
    first = ins[0]
    for t in (*ins, *outs):
        if (t.device != first.device or t.dtype != first.dtype
                or t.numel() != first.numel()):
            raise ValueError("ring_permute takes tensors of one device, "
                             "dtype and size")
        if not t.is_contiguous():
            raise ValueError("ring_permute takes contiguous tensors")


def ring_permute(ins, shift: int, outs=None) -> list[torch.Tensor]:
    """``outs[(r + shift) % n] = ins[r]`` for the n tensors of ``ins``.

    ``outs`` (allocated like ``ins`` when None) is returned. CUDA tensors
    go through the kernel in one launch; CPU tensors through the plain
    version. No output may alias an input.
    """
    ins = list(ins)
    outs = [torch.empty_like(t) for t in ins] if outs is None else list(outs)
    _check(ins, outs)
    n = len(ins)
    shift = int(shift) % n
    dev = ins[0].device
    if dev.type == "cpu":
        _reference_ring_permute(ins, outs, shift)
        return outs
    if dev.type != "cuda":
        raise ValueError(f"ring_permute: unsupported device {dev}")
    if n > MAX_RANKS:
        raise ValueError(f"ring_permute kernel takes at most {MAX_RANKS} "
                         f"ranks, got {n}")
    _build.kernels().ring_permute(ins, outs, shift)
    _build.count_launch("ring_permute")
    return outs
