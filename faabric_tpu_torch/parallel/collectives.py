"""Device collectives over an ordered list of rank devices.

Counterpart of ``faabric_tpu/parallel/collectives.py``. The JAX package
holds the ranks' buffers as one stacked ``(n_ranks, *buf)`` array
sharded over a mesh and compiles each collective as a ``shard_map``. The
port is one process driving the rank devices (which may all be one
card), so the stacked array becomes a list of per-rank tensors, element
r on ``devices[r]``, and each collective moves data between them with
copies and folds. The convention is otherwise the reference's:

- ``allreduce``: every rank gets the reduction of all ranks' buffers.
- ``allgather``: rank buffers (k, *buf) → (n*k, *buf) on every rank.
- ``reduce_scatter``: rank buffers (n*k, ...) → (k, ...), rank r the
  r-th segment of the sum.
- ``alltoall``: rank buffers (n, *buf); row i of rank j → row j of rank i.
- ``broadcast``: the root's buffer on every rank.
- ``scan``: rank r gets the inclusive prefix reduction of ranks 0..r.
- ``permute``: buffers move along (src, dst) pairs; ranks no pair
  reaches get zeros.

Every output is a tensor of its own, on its rank's device, even where
the ranks share a device. Folds run in rank order. In one process
allreduce SUM, allgather and permute (with ``send_recv`` and ``shift``)
are ``torch.autograd.Function``s whose backward is again a collective:
allreduce's is an allreduce, allgather's each rank's slice summed over
the group, a permutation's the inverse permutation. A permute that
rotates the whole ring by a fixed distance over ranks of one device
goes through ``ops/ring_permute.py``: on CUDA one launch of the
ring-permute kernel, forward and backward (it raises past its
``MAX_RANKS``), on the CPU its plain version. Only permutes of other
patterns, or over ranks on several devices, copy buffer by buffer.

Over the device plane's global devices (``parallel/distributed.py``)
other processes' ranks are ``None`` in every per-rank list. There every
collective runs through ``device_plane/xproc.py`` in one exchange round
a call (:func:`cross_process`, shared with ``Mesh.over``;
``allreduce_loop`` in one round a hop): every process gets every rank's
deposit and computes its own ranks' results from them in rank order
with the single-process code, so the results are bitwise the
single-process ones. A permutation is one permute round, which moves
only the shards that land somewhere (on the card one launch of the ring
kernel a process, into local outputs and the peers' IPC windows).
Across processes every form is a ``torch.autograd.Function`` whose
backward is one more round over every process's cotangents. allreduce
SUM, allgather, reduce_scatter and permute take their adjoint form:
allreduce's an allreduce, allgather's a reduce_scatter,
reduce_scatter's an allgather, a permutation's the inverse permutation.
The others (broadcast, alltoall, scan, allreduce of another op) gather
every rank's cotangent and rerun the single-process form's own autograd
over every rank's inputs, which their forward round delivered and kept:
each process keeps its own ranks' input gradients, bitwise the
single-process ones by construction.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from faabric_tpu_torch.mpi.types import MpiOp

_FOLDS = {MpiOp.SUM: torch.add, MpiOp.MAX: torch.maximum,
          MpiOp.MIN: torch.minimum, MpiOp.PROD: torch.mul}
_HALF = (torch.float16, torch.bfloat16)


def _op_fold(op: MpiOp):
    fold = _FOLDS.get(op)
    if fold is None:
        raise NotImplementedError(f"Device reduction op {op}")
    return fold


def _fold(parts: Sequence[torch.Tensor], op: MpiOp) -> torch.Tensor:
    """Reduce same-device tensors in order into a new tensor. As the JAX
    package's reductions on the CPU: PROD of a 16-bit float and SUM of
    bfloat16 fold in float32 and round once (``jnp.prod``; XLA's psum),
    the rest fold in the buffers' dtype; LAND and LOR give 0 or 1 in the
    buffers' dtype. Under autograd the folds run out of place (the same
    values), so that the fold is differentiable."""
    if op in (MpiOp.LAND, MpiOp.LOR):
        acc = parts[0].ne(0)
        for t in parts[1:]:
            acc = acc & t.ne(0) if op == MpiOp.LAND else acc | t.ne(0)
        return acc.to(parts[0].dtype)
    fold = _op_fold(op)
    in_place = not (torch.is_grad_enabled()
                    and any(t.requires_grad for t in parts))

    def into(acc, t):
        return fold(acc, t, out=acc) if in_place else fold(acc, t)

    dtype = parts[0].dtype
    if ((op == MpiOp.PROD and dtype in _HALF)
            or (op == MpiOp.SUM and dtype == torch.bfloat16)):
        acc = parts[0].float()
        for t in parts[1:]:
            acc = into(acc, t)
        return acc.to(dtype)
    if len(parts) == 1:
        return parts[0].clone()
    acc = fold(parts[0], parts[1])
    for t in parts[2:]:
        acc = into(acc, t)
    return acc


def _ring_shift(pairs, n: int) -> int | None:
    """The distance d when ``pairs`` rotate the whole ring, r → (r + d) % n
    for every r; None otherwise."""
    if len(pairs) != n or n < 2:
        return None
    d = (pairs[0][1] - pairs[0][0]) % n
    dst = {s: t for s, t in pairs}
    if sorted(dst) != list(range(n)):
        return None
    return d if all(dst[r] == (r + d) % n for r in range(n)) else None


# The cross-process forms whose backward is one round of another form
# (the adjoint); the others' backward replays their single-process
# autograd (``_Plan.replay``)
_ADJOINT = {"allreduce": "allreduce", "allgather": "reduce_scatter",
            "reduce_scatter": "allgather", "permute": "permute"}
_SCAN_OPS = (MpiOp.SUM, MpiOp.PROD, MpiOp.MAX, MpiOp.MIN)


def _adjoint(kind: str, kw: dict) -> str | None:
    """The form of ``kind``'s backward round where it has an adjoint
    form (allreduce only for SUM), else None."""
    if kind == "allreduce" and kw["op"] != MpiOp.SUM:
        return None
    return _ADJOINT.get(kind)


def _check_pairs(pairs, n: int) -> tuple:
    pairs = tuple((int(s), int(t)) for s, t in pairs)
    srcs, dsts = [s for s, _ in pairs], [t for _, t in pairs]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= r < n for r in srcs + dsts)):
        raise ValueError(f"permute pairs {pairs} must name each of {n} "
                         "ranks at most once as a source and once as a "
                         "destination")
    return pairs


def _allreduce_loop(allreduce, xs, n: int, op, size: int) -> list:
    """``n`` chained ``allreduce(ys)`` over groups of ``size`` ranks,
    then SUM's one rescale (``DeviceCollectives.allreduce_loop``);
    ``None`` entries (other processes' ranks) stay ``None``."""
    op = MpiOp(op)
    if op not in (MpiOp.SUM, MpiOp.MAX, MpiOp.MIN):
        raise NotImplementedError(f"allreduce_loop op {op}")
    ys = list(xs)
    for _ in range(n):
        ys = allreduce(ys)
    growth = size ** (n - 1)
    if op != MpiOp.SUM or growth == 1:
        return ys

    def rescale(y):
        if y.is_floating_point():
            # The reciprocal in the buffer's dtype, as the reference
            return y * torch.tensor(1.0 / growth, dtype=y.dtype,
                                    device=y.device)
        # Exact: the interim value is growth·sum
        return torch.div(y, growth, rounding_mode="floor")

    return [None if y is None else rescale(y) for y in ys]


def _exchanger(processes, device):
    """The process's exchanger over ranks in ``processes`` (one per
    layout of ranks over processes, whatever mesh or group asks)."""
    from faabric_tpu_torch.device_plane.xproc import named_exchanger

    return named_exchanger("coll/" + ",".join(map(str, processes)),
                           processes, device)


def _group_outputs(kind: str, kw: dict, g: list, parts: list,
                   mine: list) -> dict:
    """The outputs of ``kind`` over group ``g`` for its ranks ``mine``
    (rank → tensor), from every rank's input ``parts``, folded in rank
    order as the single-process forms fold; every output a tensor of
    its own."""
    first = parts[g[0]]
    if kind == "reduce_scatter":
        dim = kw["dim"]
        size = first.shape[dim]
        if size % len(g):
            raise ValueError(f"reduce_scatter: dim {dim} of size {size} "
                             f"does not split over {len(g)} ranks")
        k = size // len(g)
        return {r: _fold([parts[q].narrow(dim, g.index(r) * k, k)
                          for q in g], MpiOp.SUM) for r in mine}
    if kind == "alltoall":
        if first.shape[0] != len(g):
            raise ValueError(f"alltoall takes ({len(g)}, ...) buffers")
        return {r: torch.stack([parts[q][g.index(r)] for q in g])
                for r in mine}
    if kind == "scan":
        # Prefix by prefix in the buffers' dtype, up to the last of mine
        fold, out, acc = _op_fold(kw["op"]), {}, None
        for q in g[:max(g.index(r) for r in mine) + 1]:
            acc = parts[q].clone() if acc is None else fold(acc, parts[q])
            if q in mine:
                out[q] = acc
        return out
    if kind == "allreduce":
        one = _fold([parts[q] for q in g], kw["op"])
    elif kind == "allgather":
        one = torch.cat([parts[q] for q in g], kw["dim"])
    else:
        one = parts[g[kw["root"]]].clone()
    # The first local rank takes the result, the others a copy
    return {r: one if i == 0 else one.clone() for i, r in enumerate(mine)}


class _Plan:
    """One cross-process call: the exchanger over every rank (rank r in
    process ``processes[r]``), the groups of ranks the collective runs
    over (each in its own rank order) and this process's ranks."""

    def __init__(self, processes, groups, local_ranks, device) -> None:
        self.local_ranks = local_ranks
        # Only the groups that hold a rank of this process are computed
        self.groups = [list(g) for g in groups if set(local_ranks) & set(g)]
        self.exchanger = _exchanger(processes, device)

    def _flat(self, kind: str, xs) -> dict:
        first = xs[0]
        if any(x.shape != first.shape or x.dtype != first.dtype
               or x.device != first.device for x in xs):
            raise ValueError(f"{kind} across processes takes buffers of one "
                             "shape, dtype and device")
        return {r: x.contiguous().reshape(-1)
                for r, x in zip(self.local_ranks, xs)}

    def run(self, kind: str, kw: dict, xs, keep: bool = False):
        """The local ranks' outputs (in their order) of ``kind`` over the
        local ranks' tensors ``xs`` (in the same order). With ``keep``,
        (outputs, copies of the other processes' inputs to this
        process's groups by rank) for :meth:`replay`, which takes the
        local inputs besides."""
        shape = xs[0].shape
        flat = self._flat(kind, xs)
        if kind == "permute":
            dest = {g[s]: g[t] for g in self.groups for s, t in kw["pairs"]}
            got = self.exchanger.permute(flat, dest)
            return [got[r].view(shape) for r in self.local_ranks]
        out, kept = {}, {}
        with self.exchanger.gather(flat) as every:
            parts = [t.view(shape) for t in every]
            for g in self.groups:
                out.update(_group_outputs(kind, kw, g, parts,
                                          [r for r in g if r in flat]))
                if keep:
                    kept.update((q, parts[q].clone()) for q in g
                                if q not in flat)
        outs = [out[r] for r in self.local_ranks]
        return (outs, kept) if keep else outs

    def replay(self, kind: str, kw: dict, kept: dict, xs, grads) -> list:
        """The local ranks' input gradients of ``kind`` (``None`` where
        an input takes none): one gather round of every rank's
        cotangent, then in each of this process's groups the
        single-process form's own autograd over every rank's input (the
        local ``xs``, the others' ``kept``), backpropagated with every
        rank's cotangent."""
        shape = grads[0].shape
        kept = {**kept, **dict(zip(self.local_ranks, xs))}
        out = {}
        with self.exchanger.gather(self._flat(kind, grads)) as every:
            for g in self.groups:
                leaves = [kept[q].detach().requires_grad_() for q in g]
                coll = DeviceCollectives([leaves[0].device] * len(g))
                with torch.enable_grad():
                    ys = getattr(coll, kind)(leaves, **kw)
                torch.autograd.backward(ys, [every[q].view(shape)
                                             for q in g])
                out.update((q, leaf.grad) for q, leaf in zip(g, leaves)
                           if q in self.local_ranks)
        return [out[r] for r in self.local_ranks]


def gather_every(processes, xs) -> list:
    """Every rank's tensor of the per-rank list ``xs`` (one shape and
    dtype; ``None`` for other processes' ranks), in one gather round:
    the local ones as given, the others' as copies."""
    from faabric_tpu_torch.parallel.distributed import process_index

    me = process_index()
    local = {r: x for r, x in enumerate(xs) if processes[r] == me}
    first = next(iter(local.values()))
    with _exchanger(processes, first.device).gather(
            {r: x.contiguous().reshape(-1)
             for r, x in local.items()}) as every:
        return [local[r] if r in local else t.view(first.shape).clone()
                for r, t in enumerate(every)]


class _CrossProcess(torch.autograd.Function):
    """A cross-process collective as one autograd node: its backward is
    one more round over every process's cotangents (of the adjoint form,
    or the gather that :meth:`_Plan.replay` folds), so every process
    meets its rounds in the same order."""

    @staticmethod
    def forward(ctx, plan, kind, kw, *xs):
        ctx.plan, ctx.kind, ctx.kw = plan, kind, kw
        if _adjoint(kind, kw) is not None:
            return tuple(plan.run(kind, kw, xs))
        outs, ctx.kept = plan.run(kind, kw, xs, keep=True)
        # The local inputs go through autograd's version check: one
        # changed in place before the backward raises there
        ctx.save_for_backward(*xs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        kw = dict(ctx.kw)
        adjoint = _adjoint(ctx.kind, kw)
        if adjoint is None:
            dxs = ctx.plan.replay(ctx.kind, kw, ctx.kept, ctx.saved_tensors,
                                  grads)
            del ctx.kept
        else:
            if ctx.kind == "permute":
                kw["pairs"] = tuple((t, s) for s, t in kw["pairs"])
            dxs = ctx.plan.run(adjoint, kw, grads)
        return (None, None, None, *dxs)


def _cross_form(kind: str, kw: dict, n: int) -> tuple[str, dict]:
    """``kind`` with the keyword arguments of its ``DeviceCollectives``
    method over groups of ``n`` ranks → (form, keyword arguments) of a
    cross-process round: ``send_recv`` and ``shift`` become permutes."""
    if kind == "allreduce":
        return kind, {"op": MpiOp(kw.get("op", MpiOp.SUM))}
    if kind == "allgather":
        return kind, {"dim": kw.get("dim", 0)}
    if kind == "reduce_scatter":
        if MpiOp(kw.get("op", MpiOp.SUM)) != MpiOp.SUM:
            raise NotImplementedError("Device reduce_scatter supports SUM")
        return kind, {"dim": kw.get("dim", 0)}
    if kind == "broadcast":
        return kind, {"root": kw.get("root", 0)}
    if kind == "alltoall":
        return kind, {}
    if kind == "scan":
        op = MpiOp(kw.get("op", MpiOp.SUM))
        if op not in _SCAN_OPS:
            raise NotImplementedError(f"Device scan op {op}")
        return kind, {"op": op}
    if kind == "send_recv":
        return "permute", {"pairs": ((kw["src"], kw["dst"]),)}
    if kind == "shift":
        disp = kw.get("disp", 1)
        return "permute", {"pairs": tuple((i, (i + disp) % n)
                                          for i in range(n))}
    if kind == "permute":
        return kind, {"pairs": kw["pairs"]}
    raise ValueError(f"unknown collective {kind!r}")


def cross_process(processes, groups, xs, kind: str, **kw) -> list:
    """``kind`` with the keyword arguments of its ``DeviceCollectives``
    method (allreduce, allreduce_loop, allgather, reduce_scatter,
    alltoall, broadcast, scan, permute, send_recv or shift; group
    positions for the last three) over every group of ``groups`` at
    once, in one exchange round (``allreduce_loop`` one a hop), whose
    ranks live in the processes ``processes[r]``: per-rank outputs with
    ``None`` for other processes' ranks. Differentiable: a buffer that
    needs a gradient makes the call one autograd node
    (:class:`_CrossProcess`)."""
    from faabric_tpu_torch.parallel.distributed import process_index

    if kind == "allreduce_loop":
        return _allreduce_loop(
            lambda ys: cross_process(processes, groups, ys, "allreduce",
                                     op=kw.get("op", MpiOp.SUM)),
            xs, kw["n"], kw.get("op", MpiOp.SUM), len(groups[0]))
    me = process_index()
    local = [r for r, p in enumerate(processes) if p == me]
    for r, x in enumerate(xs):
        if (x is None) == (r in local):
            want = "a tensor" if r in local else "None"
            raise ValueError(f"rank {r} lives in process {processes[r]}: "
                             f"its entry is {want} in process {me}")
    kind, kw = _cross_form(kind, kw, len(groups[0]))
    if not local:
        return [None] * len(xs)
    ins = [xs[r] for r in local]
    if kind == "permute":
        kw["pairs"] = _check_pairs(kw["pairs"], len(groups[0]))
    plan = _Plan(processes, groups, local, ins[0].device)
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        outs = _CrossProcess.apply(plan, kind, kw, *ins)
    else:
        outs = plan.run(kind, kw, ins)
    got: list = [None] * len(xs)
    for r, y in zip(local, outs):
        got[r] = y
    return got


class DeviceCollectives:
    """Collectives bound to an ordered list of devices (rank i ↔ device
    i, devices may repeat). Entries of the plane's global device table
    (``distributed.PlaneDevice``) place each rank in its process."""

    def __init__(self, devices: Sequence) -> None:
        from faabric_tpu_torch.parallel.distributed import (
            PlaneDevice,
            process_index,
        )

        devices = list(devices)
        self.processes = [d.process_index if isinstance(d, PlaneDevice)
                          else 0 for d in devices]
        self.devices = [torch.device(d.device if isinstance(d, PlaneDevice)
                                     else d) for d in devices]
        self.n = len(self.devices)
        if self.n == 0:
            raise ValueError("DeviceCollectives needs at least one device")
        self.process_index = (process_index() if any(
            isinstance(d, PlaneDevice) for d in devices) else 0)
        self.local_ranks = [r for r, p in enumerate(self.processes)
                            if p == self.process_index]
        # Ranks in other processes: per-rank lists hold None for them
        self.multiprocess = len(self.local_ranks) != self.n

    # ------------------------------------------------------------------
    def shard_stacked(self, per_rank: Sequence) -> list[torch.Tensor]:
        """One host buffer per rank → a tensor of its own on each rank's
        device (the single-controller form: this process holds every
        rank's buffer)."""
        if len(per_rank) != self.n:
            raise ValueError(f"{len(per_rank)} buffers for {self.n} ranks")
        return [torch.as_tensor(np.asarray(b)).to(d, copy=True)
                for b, d in zip(per_rank, self.devices)]

    def shard_stacked_addressable(self, local_per_rank, buf_shape: tuple,
                                  dtype) -> list:
        """Multi-process form of :meth:`shard_stacked`: each process
        supplies buffers only for its own ranks (``local_per_rank``: rank
        → buffer), which land on their devices; other processes' ranks
        are ``None``. Raises ``KeyError`` for a local rank with no
        buffer."""
        out: list = [None] * self.n
        for r in self.local_ranks:
            if r not in local_per_rank:
                raise KeyError(
                    f"process {self.process_index} owns rank {r} (device "
                    f"{self.devices[r]}) but no buffer was supplied for it")
            buf = np.asarray(local_per_rank[r], dtype).reshape(buf_shape)
            out[r] = torch.as_tensor(buf).to(self.devices[r], copy=True)
        return out

    def addressable_shard(self, xs, rank: int) -> torch.Tensor:
        """This process's buffer of ``rank`` in the per-rank list ``xs``;
        raises ``KeyError`` for a rank of another process."""
        if rank not in self.local_ranks:
            raise KeyError(f"rank {rank}'s shard lives in process "
                           f"{self.processes[rank]}, not in process "
                           f"{self.process_index}")
        return xs[rank]

    def to_per_rank(self, xs: Sequence[torch.Tensor]) -> list[np.ndarray]:
        """Per-rank tensors back as host buffers (None for other
        processes' ranks)."""
        return [None if x is None else x.detach().cpu().numpy()
                for x in self._check(xs)]

    def _check(self, xs) -> list[torch.Tensor]:
        xs = list(xs)
        if len(xs) != self.n:
            raise ValueError(f"{len(xs)} buffers for {self.n} ranks")
        for r, (x, d) in enumerate(zip(xs, self.devices)):
            if r not in self.local_ranks:
                if x is not None:
                    raise ValueError(f"rank {r} lives in process "
                                     f"{self.processes[r]}: its entry is "
                                     f"None here")
                continue
            if x.device != d:
                raise ValueError(f"rank {r}'s buffer is on {x.device}, its "
                                 f"device is {d}")
        return xs

    def _per_device(self, make) -> list[torch.Tensor]:
        """``make(device)`` once per distinct device; the first rank of a
        device takes the result, later ranks a copy."""
        made: dict[torch.device, torch.Tensor] = {}
        out = []
        for d in self.devices:
            if d in made:
                out.append(made[d].clone())
            else:
                made[d] = make(d)
                out.append(made[d])
        return out

    def _xproc(self, kind: str, xs, **kw) -> list:
        """A collective over ranks of several processes, in one exchange
        round (:func:`cross_process`); local ranks on one device."""
        devices = sorted({str(self.devices[r]) for r in self.local_ranks})
        if len(devices) > 1:
            raise NotImplementedError(
                f"{kind}: local ranks on several devices ({devices}) wait "
                f"for ROADMAP.md Queue 1 step 9")
        return cross_process(self.processes, [list(range(self.n))], xs,
                             kind, **kw)

    # ------------------------------------------------------------------
    # Collectives
    # ------------------------------------------------------------------
    def _allreduce(self, xs, op: MpiOp) -> list[torch.Tensor]:
        return self._per_device(
            lambda d: _fold([x.to(d) for x in xs], op))

    def allreduce(self, xs, op: MpiOp = MpiOp.SUM) -> list[torch.Tensor]:
        """SUM, MAX, MIN, PROD, LAND, LOR; SUM is differentiable (its
        backward is the allreduce of the cotangents), MAX, MIN and PROD
        through their folds; across processes every op but LAND and LOR
        is."""
        xs = self._check(xs)
        op = MpiOp(op)
        if self.multiprocess:
            return self._xproc("allreduce", xs, op=op)
        if op == MpiOp.SUM:
            return list(_AllReduceSum.apply(self, *xs))
        return self._allreduce(xs, op)

    def allreduce_loop(self, xs, n: int,
                       op: MpiOp = MpiOp.SUM) -> list[torch.Tensor]:
        """``n`` chained allreduces, returning exactly what a single
        :meth:`allreduce` would: the benchmarking form (across processes
        one round a hop). For SUM the value grows ×ranks per extra hop,
        and one rescale by ranks^(n−1) after the loop restores the plain
        sum. The rescale (a full elementwise pass) exists only for n ≥ 2,
        so a two-point timing slope cancels it only if both trip counts
        are ≥ 2. Interim SUM values must stay within the dtype's range
        for the chosen n (MAX/MIN are idempotent)."""
        def hop(ys):
            if self.multiprocess:
                return self._xproc("allreduce", ys, op=op)
            return self._allreduce(ys, MpiOp(op))

        return _allreduce_loop(hop, self._check(xs), n, op, self.n)

    def _allgather(self, xs, dim: int) -> list[torch.Tensor]:
        return self._per_device(
            lambda d: torch.cat([x.to(d) for x in xs], dim))

    def allgather(self, xs, dim: int = 0) -> list[torch.Tensor]:
        """Rank buffers of one shape, concatenated in rank order along
        ``dim`` on every rank; differentiable (across processes too)."""
        xs = self._check(xs)
        if self.multiprocess:
            return self._xproc("allgather", xs, dim=dim)
        if any(x.shape != xs[0].shape for x in xs):
            raise ValueError("allgather takes buffers of one shape")
        return list(_AllGather.apply(self, dim, *xs))

    def _reduce_scatter(self, xs, dim: int) -> list[torch.Tensor]:
        size = xs[0].shape[dim]
        if size % self.n:
            raise ValueError(f"reduce_scatter: dim {dim} of size {size} "
                             f"does not split over {self.n} ranks")
        k = size // self.n
        return [_fold([x.narrow(dim, r * k, k).to(d) for x in xs], MpiOp.SUM)
                for r, d in enumerate(self.devices)]

    def reduce_scatter(self, xs, op: MpiOp = MpiOp.SUM,
                       dim: int = 0) -> list[torch.Tensor]:
        """Rank buffers (n*k, ...) → (k, ...): rank r gets segment r of
        the sum (SUM only, as the reference)."""
        if MpiOp(op) != MpiOp.SUM:
            raise NotImplementedError("Device reduce_scatter supports SUM")
        if self.multiprocess:
            return self._xproc("reduce_scatter", self._check(xs), dim=dim)
        return self._reduce_scatter(self._check(xs), dim)

    def alltoall(self, xs) -> list[torch.Tensor]:
        """Rank buffers (n, *buf): row i of rank j lands as row j of
        rank i (across processes, one round)."""
        xs = self._check(xs)
        if any(x is not None and x.shape[0] != self.n for x in xs):
            raise ValueError(f"alltoall takes ({self.n}, ...) buffers")
        if self.multiprocess:
            return self._xproc("alltoall", xs)
        return [torch.stack([x[r].to(d) for x in xs])
                for r, d in enumerate(self.devices)]

    def broadcast(self, xs, root: int = 0) -> list[torch.Tensor]:
        """The root rank's buffer, as a tensor of its own on every rank;
        differentiable (the root's gradient sums every rank's
        cotangent), across processes too."""
        xs = self._check(xs)
        if self.multiprocess:
            return self._xproc("broadcast", xs, root=root)
        return [xs[root].to(d, copy=True) for d in self.devices]

    def scan(self, xs, op: MpiOp = MpiOp.SUM) -> list[torch.Tensor]:
        """Inclusive prefix reduction across ranks (MPI_Scan; across
        processes, one round)."""
        op = MpiOp(op)
        if op not in _SCAN_OPS:
            raise NotImplementedError(f"Device scan op {op}")
        xs = self._check(xs)
        if self.multiprocess:
            return self._xproc("scan", xs, op=op)
        # Prefix by prefix in the buffers' dtype, as jnp.cumsum/cumprod
        fold = _op_fold(op)
        out, acc = [], None
        for x, d in zip(xs, self.devices):
            acc = x.to(d, copy=True) if acc is None else fold(acc.to(d),
                                                              x.to(d))
            out.append(acc)
        return out

    # ------------------------------------------------------------------
    # Point-to-point between rank devices
    # ------------------------------------------------------------------
    def _permute(self, xs, pairs) -> list[torch.Tensor]:
        shift = _ring_shift(pairs, self.n)
        if shift is not None and len(set(self.devices)) == 1:
            from faabric_tpu_torch.ops.ring_permute import ring_permute

            # The one place that makes shards contiguous: a no-op for
            # buffers an earlier hop wrote, one copy for strided views
            return ring_permute([x.contiguous() for x in xs], shift)
        out = [None] * self.n
        for src, dst in pairs:
            out[dst] = xs[src].to(self.devices[dst], copy=True)
        return [torch.zeros_like(x) if o is None else o
                for x, o in zip(xs, out)]

    def permute(self, xs, pairs: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
        """Move rank buffers along (src, dst) pairs (each rank sends at
        most once and receives at most once); ranks that no pair reaches
        get zeros. Differentiable: the backward moves the cotangents
        along the reversed pairs. Across processes one permute round
        moves the shards."""
        xs = self._check(xs)
        pairs = _check_pairs(pairs, self.n)
        if self.multiprocess:
            return self._xproc("permute", xs, pairs=pairs)
        if any(x.shape != xs[0].shape or x.dtype != xs[0].dtype for x in xs):
            raise ValueError("permute takes buffers of one shape and dtype")
        return list(_Permute.apply(self, pairs, *xs))

    def send_recv(self, xs, src: int, dst: int) -> list[torch.Tensor]:
        """Rank ``src``'s buffer lands on rank ``dst`` (others zero)."""
        return self.permute(xs, [(src, dst)])

    def shift(self, xs, disp: int = 1) -> list[torch.Tensor]:
        """Ring rotation by ``disp``: rank r's buffer lands on rank
        (r + disp) % n."""
        return self.permute(xs, [(i, (i + disp) % self.n)
                                 for i in range(self.n)])


# ---------------------------------------------------------------------------
# The differentiable forms
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coll, *xs):
        ctx.coll = coll
        return tuple(coll._allreduce(xs, MpiOp.SUM))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.coll._allreduce(grads, MpiOp.SUM))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coll, dim, *xs):
        ctx.coll, ctx.dim = coll, dim
        return tuple(coll._allgather(xs, dim))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.coll._reduce_scatter(grads, ctx.dim))


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coll, pairs, *xs):
        ctx.coll, ctx.pairs = coll, pairs
        return tuple(coll._permute(xs, pairs))

    @staticmethod
    def backward(ctx, *grads):
        back = tuple((t, s) for s, t in ctx.pairs)
        return (None, None, *ctx.coll._permute(grads, back))


def local_devices_for_ids(device_ids: Sequence[int],
                          device_type: str = "cuda") -> list[torch.device]:
    """Planner-assigned device ids → ``torch.device``s of this host, the
    ids wrapped modulo the local device count.

    A deliberate divergence from the JAX package, which raises when two
    ids wrap onto one chip (a ``jax.sharding.Mesh`` needs distinct
    devices): here ranks may share a device. faabric's ranks are threads
    of one process and the card's machine has one H100, so n ranks alias
    ``cuda:0``, and on the CPU every rank is the one ``cpu`` device.
    ``device_type="cuda"`` raises without a card."""
    from faabric_tpu_torch.util.device import resolve_device

    if device_type == "cpu":
        return [torch.device("cpu") for _ in device_ids]
    resolve_device(device_type)
    count = torch.cuda.device_count()
    return [torch.device("cuda", int(i) % count) for i in device_ids]
