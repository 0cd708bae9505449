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
    and one ring-permute launch per rotation. An axis of size 1 runs the
    plain attention: no launch."""
    if sp == 1:
        return {"flash_attention": 0, "ring_permute": 0}
    rings = n_ranks // sp
    return {"flash_attention": rings * (sp * (sp + 1) // 2 if causal
                                        else sp * sp),
            "ring_permute": rings * 2 * (sp - 1)}


def _ring(coll, qs, ks, vs, causal: bool, block=_flash_block):
    """One ring's schedule over its ranks' blocks (in ring order):
    ``block(q, k, v, causal) -> (out, lse)`` attends one block pair."""
    from faabric_tpu_torch.ops.flash_attention import merge_attention_blocks

    n = coll.n
    accs, lses = [], []
    for q in qs:
        b, s_l, h, d = q.shape
        accs.append(torch.zeros((b, s_l, h, d), dtype=torch.float32,
                                device=q.device))
        lses.append(torch.full((b * h, s_l), NEG_INF, dtype=torch.float32,
                               device=q.device))
    for step in range(n):
        for j in range(n):
            kv = (j - step) % n
            if causal and kv > j:
                continue  # a future block: fully masked
            out, lse = block(qs[j], ks[j], vs[j], causal and kv == j)
            accs[j], lses[j] = merge_attention_blocks([accs[j], out],
                                                      [lses[j], lse])
        if step < n - 1:
            ks = coll.shift(ks, 1)
            vs = coll.shift(vs, 1)
    # Causal rows always see their diagonal block: no fully masked row
    return [acc.to(q.dtype) for acc, q in zip(accs, qs)]


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   batch_axis: str | None = None,
                   head_axis: str | None = None, block=_flash_block):
    """Per-rank q, k, v blocks (B_l, S_l, H_l, D), the sequence split over
    ``axis`` → per-rank outputs of the same shape. Within a ring, rank i
    holds Q block i and, at step s, K/V block (i − s) mod n; masking uses
    the blocks' global positions. At an axis of size 1 each rank runs the
    plain attention on its blocks. ``block`` attends one pair of blocks
    (the flash kernels; a test may give their plain versions)."""
    if mesh.shape[axis] == 1:
        from faabric_tpu_torch.ops.flash_attention import _reference_attention

        return [_reference_attention(qr, kr, vr, causal)
                for qr, kr, vr in zip(q, k, v)]
    out: list = [None] * mesh.size
    for ranks, coll in mesh.collectives(axis):
        ys = _ring(coll, [q[r] for r in ranks], [k[r] for r in ranks],
                   [v[r] for r in ranks], causal, block)
        for r, y in zip(ranks, ys):
            out[r] = y
    return out


def shard_sequence(x, mesh, axis: str = "sp") -> list[torch.Tensor]:
    """Place (B, S, ...) as per-rank pieces with S split over ``axis``
    (replicated over the other axes)."""
    from faabric_tpu_torch.parallel.mesh import ShardSpec

    return ShardSpec(mesh, (None, axis)).shard(x)
