"""Ring attention: attention over a sequence sharded on a mesh axis.

Counterpart of ``faabric_tpu/parallel/ring_attention.py``. Q, K and V
shard along the sequence over ``axis`` (``sp``); each rank keeps its Q
block, and the K/V blocks rotate around each ring of ranks along that
axis through the differentiable ``DeviceCollectives.shift``, which on
the card is one ring-permute kernel launch per ring and tensor (its
backward, the inverse shift, likewise). At each step a rank folds the
block it holds into its running (out, lse) with the flash-decoding
merge (``ops/flash_attention.py::merge_attention_blocks``), by the
block's global index: its own block through the causal flash kernel,
a past block through the non-causal one, and a future block not at all
(no launch; the reference merges a neutral element there, which leaves
the running pair unchanged bit for bit). The ring runs n − 1
fold-then-rotate steps and a last fold with no rotation. So in a causal
ring of n ranks, rank i folds i + 1 blocks, n(n + 1)/2 flash calls a
ring, and K and V rotate n − 1 times each.

Blocks are per-rank lists as everywhere on the mesh: element r is rank
r's (B_l, S_l, H_l, D) block. ``batch_axis`` and ``head_axis`` name the
axes B and H split over, as in the reference; attention never
communicates over them, so they change nothing here.

Over a mesh whose rings cross the processes of a device plane
(``parallel/mesh.py``) each process folds only its own ranks' blocks,
and each rotation of K or V is one exchange round over every ring (on
the card one ring-permute launch a process, into the peer's IPC
window); the shift's backward is the inverse-permute round, and the
flash kernels' backward stays on each rank.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _flash_block(q, k, v, causal: bool):
    from faabric_tpu_torch.ops.flash_attention import flash_attention_with_lse

    return flash_attention_with_lse(q, k, v, causal)


def _plain_block(q, k, v, causal: bool):
    """The flash kernels' plain version for one block pair: what a test
    holds the ring's kernels against, in the same schedule."""
    from faabric_tpu_torch.ops.flash_attention import (
        _reference_attention,
        _reference_lse,
    )

    return _reference_attention(q, k, v, causal), _reference_lse(q, k, causal)


def schedule_counts(n_ranks: int, sp: int, causal: bool = True) -> dict:
    """Kernel launches of one ``ring_attention`` call over ``n_ranks``
    ranks in rings of ``sp``: flash forwards (n(n + 1)/2 a causal ring,
    n² otherwise) and ring-permute launches (K and V, n − 1 rotations a
    ring). Its backward adds one dQ and one dK/dV launch per flash call
    and one ring-permute launch per rotation. Where the rings cross
    processes, each rotation of K or V is one exchange ``rounds`` over
    every ring, in which each process makes one ring-permute launch (its
    flash launches those of its own ranks). An axis of size 1 runs the
    plain attention: no launch."""
    if sp == 1:
        return {"flash_attention": 0, "ring_permute": 0, "rounds": 0}
    rings = n_ranks // sp
    return {"flash_attention": rings * (sp * (sp + 1) // 2 if causal
                                        else sp * sp),
            "ring_permute": rings * 2 * (sp - 1),
            "rounds": 2 * (sp - 1)}


class _Keep(torch.autograd.Function):
    """``acc`` unchanged, with a K/V block as inputs that take no
    gradient: a skipped block's rotation stays in the rank's backward
    graph. Across processes a rotation's backward is an exchange round
    that every process must make, also one whose ranks all skip the
    block (in a causal ring, the ranks at ring position 0)."""

    @staticmethod
    def forward(ctx, acc, k, v):
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _ring(mesh, axis: str, qs, ks, vs, causal: bool, block=_flash_block):
    """The ring schedule over every ring along ``axis`` at once, on this
    process's ranks' blocks (per-rank lists, ``None`` for other
    processes' ranks): ``block(q, k, v, causal) -> (out, lse)`` attends
    one block pair; each rotation of K and of V is one ``Mesh.over``
    shift over every ring (across processes, one exchange round)."""
    from faabric_tpu_torch.ops.flash_attention import merge_attention_blocks

    n = mesh.shape[axis]
    accs: dict = {}
    lses: dict = {}
    for r in mesh.local_ranks:
        b, s_l, h, d = qs[r].shape
        accs[r] = torch.zeros((b, s_l, h, d), dtype=torch.float32,
                              device=qs[r].device)
        lses[r] = torch.full((b * h, s_l), NEG_INF, dtype=torch.float32,
                             device=qs[r].device)
    for step in range(n):
        for r in mesh.local_ranks:
            j = mesh.index(r, axis)
            kv = (j - step) % n
            if causal and kv > j:
                # A future block: fully masked, no launch; the block stays
                # in the rank's graph, so that every process runs the
                # backward of every rotation
                if step > 0:
                    accs[r] = _Keep.apply(accs[r], ks[r], vs[r])
                continue
            out, lse = block(qs[r], ks[r], vs[r], causal and kv == j)
            accs[r], lses[r] = merge_attention_blocks([accs[r], out],
                                                      [lses[r], lse])
        if step < n - 1:
            ks = mesh.over(axis, ks, "shift", disp=1)
            vs = mesh.over(axis, vs, "shift", disp=1)
    # Causal rows always see their diagonal block: no fully masked row
    return [None if q is None else accs[r].to(q.dtype)
            for r, q in enumerate(qs)]


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   batch_axis: str | None = None,
                   head_axis: str | None = None, block=_flash_block):
    """Per-rank q, k, v blocks (B_l, S_l, H_l, D), the sequence split over
    ``axis`` → per-rank outputs of the same shape (``None`` for other
    processes' ranks). Within a ring, rank i holds Q block i and, at
    step s, K/V block (i − s) mod n; masking uses the blocks' global
    positions. At an axis of size 1 each rank runs the plain attention
    on its blocks. ``block`` attends one pair of blocks (the flash
    kernels; a test may give their plain versions)."""
    if mesh.shape[axis] == 1:
        from faabric_tpu_torch.ops.flash_attention import _reference_attention

        return [None if qr is None else _reference_attention(qr, kr, vr,
                                                             causal)
                for qr, kr, vr in zip(q, k, v)]
    return _ring(mesh, axis, list(q), list(k), list(v), causal, block)


def shard_sequence(x, mesh, axis: str = "sp") -> list[torch.Tensor]:
    """Place (B, S, ...) as per-rank pieces with S split over ``axis``
    (replicated over the other axes)."""
    from faabric_tpu_torch.parallel.mesh import ShardSpec

    return ShardSpec(mesh, (None, axis)).shard(x)
