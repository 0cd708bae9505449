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
other processes' ranks are ``None`` in every per-rank list; there
allreduce, allgather, reduce_scatter and broadcast run through
``device_plane/xproc.py``, forward only (a buffer that needs a gradient
raises), and the rest raise.
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
    buffers' dtype."""
    if op in (MpiOp.LAND, MpiOp.LOR):
        acc = parts[0].ne(0)
        for t in parts[1:]:
            acc = acc & t.ne(0) if op == MpiOp.LAND else acc | t.ne(0)
        return acc.to(parts[0].dtype)
    fold = _op_fold(op)
    dtype = parts[0].dtype
    if ((op == MpiOp.PROD and dtype in _HALF)
            or (op == MpiOp.SUM and dtype == torch.bfloat16)):
        acc = parts[0].float()
        for t in parts[1:]:
            fold(acc, t, out=acc)
        return acc.to(dtype)
    if len(parts) == 1:
        return parts[0].clone()
    acc = fold(parts[0], parts[1])
    for t in parts[2:]:
        fold(acc, t, out=acc)
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


_XPROC_QUEUED = ("across processes only allreduce, allgather, "
                 "reduce_scatter and broadcast run so far; the rest waits "
                 "for the sharded train step across processes (ROADMAP.md "
                 "Queue 1 step 8)")
_XPROC_NO_GRAD = ("across processes the collectives have no backward yet: "
                  "it waits for the sharded train step across processes "
                  "(ROADMAP.md Queue 1 step 8); run them on buffers that "
                  "need no gradient, or under torch.no_grad()")


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

    def _single_process(self, name: str) -> None:
        if self.multiprocess:
            raise NotImplementedError(f"{name}: {_XPROC_QUEUED}")

    def _xproc(self, kind: str, xs, op: MpiOp = MpiOp.SUM, dim: int = 0,
               root: int = 0) -> list:
        """A collective over ranks of several processes: every process
        gets every rank's buffer (``device_plane/xproc.py``), then the
        local ranks' results are computed as in one process. Forward
        only: a local buffer that needs a gradient raises, since the
        peers' deposits reach the fold without one and a backward would
        miss the other processes' cotangents."""
        from faabric_tpu_torch.device_plane.xproc import named_exchanger

        local = {r: xs[r] for r in self.local_ranks}
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in local.values()):
            raise NotImplementedError(f"{kind}: {_XPROC_NO_GRAD}")
        first = local[self.local_ranks[0]]
        if any(x.shape != first.shape or x.dtype != first.dtype
               for x in local.values()):
            raise ValueError(f"{kind} takes buffers of one shape and dtype")
        devices = sorted({str(self.devices[r]) for r in self.local_ranks})
        if len(devices) > 1:
            raise NotImplementedError(
                f"{kind}: local ranks on several devices ({devices}) wait "
                f"for ROADMAP.md Queue 1 step 9")
        ex = named_exchanger(
            "coll/" + ",".join(map(str, self.processes)), self.processes,
            first.device)
        flat = {r: x.contiguous().reshape(-1) for r, x in local.items()}
        out: list = [None] * self.n
        with ex.gather(flat) as every:
            parts = [t.view(first.shape) for t in every]
            if kind == "reduce_scatter":
                size = first.shape[dim]
                if size % self.n:
                    raise ValueError(f"reduce_scatter: dim {dim} of size "
                                     f"{size} does not split over {self.n} "
                                     f"ranks")
                k = size // self.n
                for r in self.local_ranks:
                    out[r] = _fold([p.narrow(dim, r * k, k) for p in parts],
                                   MpiOp.SUM)
                return out
            if kind == "allreduce":
                one = _fold(parts, op)
            elif kind == "allgather":
                one = torch.cat(parts, dim)
            else:
                one = parts[root].clone()
            # The first local rank takes the result, the others a copy
            for i, r in enumerate(self.local_ranks):
                out[r] = one if i == 0 else one.clone()
        return out

    # ------------------------------------------------------------------
    # Collectives
    # ------------------------------------------------------------------
    def _allreduce(self, xs, op: MpiOp) -> list[torch.Tensor]:
        return self._per_device(
            lambda d: _fold([x.to(d) for x in xs], op))

    def allreduce(self, xs, op: MpiOp = MpiOp.SUM) -> list[torch.Tensor]:
        """SUM, MAX, MIN, PROD, LAND, LOR; in one process SUM is
        differentiable (its backward is the allreduce of the cotangents).
        Across processes it is forward only (see :meth:`_xproc`)."""
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
        :meth:`allreduce` would: the benchmarking form. For SUM the value
        grows ×ranks per extra hop, and one rescale by ranks^(n−1) after
        the loop restores the plain sum. The rescale (a full elementwise
        pass) exists only for n ≥ 2, so a two-point timing slope cancels
        it only if both trip counts are ≥ 2. Interim SUM values must stay
        within the dtype's range for the chosen n (MAX/MIN are
        idempotent)."""
        op = MpiOp(op)
        if op not in (MpiOp.SUM, MpiOp.MAX, MpiOp.MIN):
            raise NotImplementedError(f"allreduce_loop op {op}")
        self._single_process("allreduce_loop")
        ys = self._check(xs)
        for _ in range(n):
            ys = self._allreduce(ys, op)
        growth = self.n ** (n - 1)
        if op == MpiOp.SUM and growth > 1:
            if ys[0].is_floating_point():
                # The reciprocal in the buffer's dtype, as the reference
                ys = [y * torch.tensor(1.0 / growth, dtype=y.dtype,
                                       device=y.device) for y in ys]
            else:
                # Exact: the interim value is growth·sum
                ys = [torch.div(y, growth, rounding_mode="floor") for y in ys]
        return ys

    def _allgather(self, xs, dim: int) -> list[torch.Tensor]:
        return self._per_device(
            lambda d: torch.cat([x.to(d) for x in xs], dim))

    def allgather(self, xs, dim: int = 0) -> list[torch.Tensor]:
        """Rank buffers of one shape, concatenated in rank order along
        ``dim`` on every rank; differentiable in one process, forward
        only across processes."""
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
        rank i."""
        self._single_process("alltoall")
        xs = self._check(xs)
        if any(x.shape[0] != self.n for x in xs):
            raise ValueError(f"alltoall takes ({self.n}, ...) buffers")
        return [torch.stack([x[r].to(d) for x in xs])
                for r, d in enumerate(self.devices)]

    def broadcast(self, xs, root: int = 0) -> list[torch.Tensor]:
        """The root rank's buffer, as a tensor of its own on every rank."""
        xs = self._check(xs)
        if self.multiprocess:
            return self._xproc("broadcast", xs, root=root)
        return [xs[root].to(d, copy=True) for d in self.devices]

    def scan(self, xs, op: MpiOp = MpiOp.SUM) -> list[torch.Tensor]:
        """Inclusive prefix reduction across ranks (MPI_Scan)."""
        op = MpiOp(op)
        if op not in (MpiOp.SUM, MpiOp.PROD, MpiOp.MAX, MpiOp.MIN):
            raise NotImplementedError(f"Device scan op {op}")
        self._single_process("scan")
        xs = self._check(xs)
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
        along the reversed pairs."""
        self._single_process("permute")
        xs = self._check(xs)
        pairs = tuple((int(s), int(t)) for s, t in pairs)
        srcs, dsts = [s for s, _ in pairs], [t for _, t in pairs]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or not all(0 <= r < self.n for r in srcs + dsts)):
            raise ValueError(f"permute pairs {pairs} must name each of "
                             f"{self.n} ranks at most once as a source "
                             "and once as a destination")
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
