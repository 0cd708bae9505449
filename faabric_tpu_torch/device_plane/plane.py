"""The device collective plane: collectives over one world's device.

Counterpart of ``faabric_tpu/device_plane/plane.py`` (``DevicePlane``
:164-589): the rung above the MPI world's whole host ladder. When a
world's ranks all resolved onto the plane's device (registry.py),
allreduce, allgather, reduce_scatter and ring_permute run on that
device instead of through the host queues.

Execution model: rank threads of one process rendezvous per
collective. Each deposits its buffer; the LAST arriver executes the
round for every local rank on its own thread's current stream and hands
each rank its result. The reference builds a jitted XLA program per
(kind, op, shape, dtype); PyTorch runs eagerly, so there is no
executable cache: allreduce and reduce_scatter fold the deposits in
rank order with torch ops, allgather concatenates them, and
ring_permute is ONE launch of the ring-permute kernel for all local
ranks (ring.py). ``summary()`` reports rounds per kind and the ring
launches in place of the reference's cached executables.

Device-resident payloads: a deposit that is a tensor on its rank's
registered device is used in place, and when every local deposit is
resident the round moves **zero** host↔device bytes; each rank gets a
tensor on that device. Host (numpy) rounds place each deposit on the
device (one counted ``h2d.input``) and read each rank's result back
(one counted ``d2h.readback``). A mixed-residency round stages its
resident deposits to the host (one counted ``d2h.staging`` each) and
runs the host shape. Every crossing is stamped in copies.py.

Torch tensors are mutable where ``jax.Array``s are not, so every rank
gets its own output tensor and no result aliases a caller's input: MPI
lets the caller reuse its buffer after the call. Buffer donation has no
counterpart here and is dropped.

Streams: a depositing rank records an event on its current stream,
which the executor's stream waits on before it reads the deposits; the
executor records an event after the round, which each rank's current
stream waits on before the rank returns, and each result is marked as
used on that stream for the caching allocator.

Failure contract: eligibility is a pure function of (activation
verdict, shape, dtype, op) — residency does not enter it — so every
rank picks the same rung. A backend error in a host or mixed-residency
round disables the plane and raises :class:`DevicePlaneFallback`, which
MpiWorld catches to re-run the collective on the host ladder (the
reference's contract). A backend error in a round whose deposits are
all resident (a kernel that does not build or launch on the card)
reaches every rank's caller as it is and leaves the plane enabled:
re-running the round on the host ladder would quietly stage device
tensors through the host.
"""

from __future__ import annotations

import collections
import functools
import logging
import os
import threading

import numpy as np
import torch

from faabric_tpu_torch.device_plane.copies import (
    D2H,
    H2D,
    count_copy,
    device_copy_totals,
)
from faabric_tpu_torch.device_plane.registry import DevicePlaneFallback
from faabric_tpu_torch.device_plane.ring import permute_body
from faabric_tpu_torch.mpi.types import MpiOp, UserOp
from faabric_tpu_torch.telemetry import get_metrics

logger = logging.getLogger(__name__)

# A rank thread waiting for its rendezvous peers (sibling threads of
# one process, which a loaded machine can still park for seconds)
DEVICE_PLANE_TIMEOUT_S = float(
    os.environ.get("FAABRIC_DEVICE_PLANE_TIMEOUT", "120"))

_ALLREDUCE_OPS = (MpiOp.SUM, MpiOp.MAX, MpiOp.MIN, MpiOp.PROD)
_FOLDS = {MpiOp.SUM: torch.add, MpiOp.MAX: torch.maximum,
          MpiOp.MIN: torch.minimum, MpiOp.PROD: torch.mul}
KINDS = ("allreduce", "allgather", "reduce_scatter", "ring_permute")

_metrics = get_metrics()
_COLLECTIVES = {
    kind: _metrics.counter(
        "faabric_device_plane_collectives_total",
        "Collectives executed on the device plane (per rank)", op=kind)
    for kind in KINDS}
_FALLBACKS = _metrics.counter(
    "faabric_device_plane_fallbacks_total",
    "Device plane disables (collectives re-routed to the host ladder)")


def is_device_payload(data) -> bool:
    """Whether ``data`` is a tensor (the port's device payload type)."""
    return isinstance(data, torch.Tensor)


@functools.cache
def _numpy_dtype_of(dtype: torch.dtype) -> np.dtype | None:
    """The numpy counterpart of a torch dtype; None for bfloat16 and the
    other types numpy lacks."""
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        return None


def payload_dtype(data) -> np.dtype | None:
    """``data``'s element type as numpy names it (None without one)."""
    if isinstance(data, torch.Tensor):
        return _numpy_dtype_of(data.dtype)
    try:
        return np.dtype(data.dtype)
    except (AttributeError, TypeError):
        return None


def to_host(data) -> np.ndarray:
    """A payload as a numpy array. A tensor crosses to the host as one
    counted ``d2h.staging`` copy; numpy passes through."""
    if not isinstance(data, torch.Tensor):
        return np.asarray(data)
    if payload_dtype(data) is None:
        raise TypeError(f"{data.dtype} tensors have no numpy dtype: the "
                        f"host ladder cannot carry them")
    count_copy(D2H, data.numel() * data.element_size(), "staging")
    return data.detach().cpu().numpy()


class _Round:
    """One rendezvous: the local rank threads of one collective call.
    Fields are written before ready.set() and read after."""

    __slots__ = ("deposits", "results", "done", "error", "ready")

    def __init__(self) -> None:
        # rank → (key, buf, resident, event of the depositor's stream)
        self.deposits: dict[int, tuple] = {}
        self.results: dict[int, object] | None = None
        self.done: torch.cuda.Event | None = None
        self.error: BaseException | None = None
        self.ready = threading.Event()


class DevicePlane:
    """Collectives bound to one world's resolved device."""

    def __init__(self, world_id: int, devices, local_ranks,
                 topology_gen: int) -> None:
        self.world_id = world_id
        self.devices = list(devices)          # rank i ↔ devices[i]
        self.device = self.devices[0]
        self.n = len(self.devices)
        self.local_ranks = tuple(sorted(local_ranks))
        self.n_local = len(self.local_ranks)
        self.topology_gen = topology_gen

        # Rendezvous state, the disable verdict and the round counts
        # mutate under _lock from the N rank threads
        self._lock = threading.Lock()
        self._rounds: dict[int, _Round] = {}
        self._rank_seq: dict[int, int] = {}
        self._disabled: str | None = None
        self._executed: collections.Counter = collections.Counter()

    # ------------------------------------------------------------------
    # Eligibility / residency / fallback ladder
    # ------------------------------------------------------------------
    def eligible(self, kind: str, arr, op=None) -> bool:
        """Pure function of (activation verdict, shape, dtype, op): every
        rank derives the same rung. Only ``arr``'s size and dtype are
        read, never its bytes."""
        with self._lock:
            if self._disabled is not None:
                return False
        size = (arr.numel() if isinstance(arr, torch.Tensor)
                else int(getattr(arr, "size", 0)))
        dtype = payload_dtype(arr)
        # Integer and IEEE float element types; bool, complex, structured
        # pairs and bfloat16 (numpy kind "V" in the reference) are not.
        # 64-bit types ride the plane: torch keeps them, where JAX
        # without x64 would narrow them to 32 bits.
        if size == 0 or dtype is None or dtype.kind not in "iuf":
            return False
        if isinstance(op, UserOp):
            return False
        if kind == "allreduce":
            return op in _ALLREDUCE_OPS
        if kind == "reduce_scatter":
            return op == MpiOp.SUM and size % self.n == 0
        if kind in ("allgather", "ring_permute"):
            return op is None
        return False

    def resident(self, rank: int, arr) -> bool:
        """True when ``arr`` is a tensor on ``rank``'s registered device.
        Residency is an execution property, never an eligibility one."""
        return (is_device_payload(arr) and 0 <= rank < self.n
                and arr.device == self.devices[rank])

    def disable(self, reason: str) -> None:
        """One-way: after a backend error in a host round or a rendezvous
        breakdown the plane routes everything to the host ladder
        (re-activation means a fresh handshake)."""
        with self._lock:
            if self._disabled is not None:
                return
            self._disabled = reason
        _FALLBACKS.inc()
        logger.warning("Device plane (world %s) disabled: %s",
                       self.world_id, reason)

    @property
    def disabled_reason(self) -> str | None:
        with self._lock:
            return self._disabled

    # ------------------------------------------------------------------
    # Collectives (per-rank buffers in and out; result residency
    # follows input)
    # ------------------------------------------------------------------
    def allreduce(self, rank: int, data, op: MpiOp = MpiOp.SUM):
        out = self._collective("allreduce", rank, data, op)
        return out.reshape(data.shape)

    def allgather(self, rank: int, data):
        return self._collective("allgather", rank, data, None)

    def reduce_scatter(self, rank: int, data, op: MpiOp = MpiOp.SUM):
        return self._collective("reduce_scatter", rank, data, op)

    def ring_permute(self, rank: int, data, shift: int = 1):
        """Every rank's payload lands on rank ``(rank + shift) % n`` in
        one launch of the ring kernel for all local ranks. Returns the
        payload of rank ``(rank - shift) % n``."""
        shift = int(shift) % self.n
        if shift == 0:
            return data
        out = self._collective("ring_permute", rank, data, shift)
        return out.reshape(data.shape)

    # ------------------------------------------------------------------
    def _collective(self, kind: str, rank: int, data, op):
        resident = self.resident(rank, data)
        event = None
        if resident:
            flat = data.reshape(-1).contiguous()
            if flat.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(flat.device))
        else:
            flat = np.ascontiguousarray(to_host(data).reshape(-1))
        if kind == "ring_permute":
            op_code = int(op)  # the shift rides the op slot of the key
        else:
            op_code = int(op) if op is not None else -1
        key = (kind, op_code, int(flat.shape[0]), payload_dtype(flat).name)
        with self._lock:
            if self._disabled is not None:
                raise DevicePlaneFallback(self._disabled)
            if rank not in self.local_ranks:
                raise DevicePlaneFallback(
                    f"rank {rank} is not local to this plane")
            # Collectives are globally ordered per world, so each rank's
            # Nth device collective belongs to rendezvous N
            seq = self._rank_seq.get(rank, 0)
            self._rank_seq[rank] = seq + 1
            rnd = self._rounds.get(seq)
            if rnd is None:
                rnd = self._rounds[seq] = _Round()
            rnd.deposits[rank] = (key, flat, resident, event)
            last = len(rnd.deposits) == self.n_local

        if last:
            try:
                rnd.results, rnd.done = self._execute(kind, key,
                                                      rnd.deposits)
            except BaseException as e:  # noqa: BLE001 — delivered to
                # every waiting peer below. A host round's backend error
                # also disables the plane so later collectives skip the
                # rung; a resident round's reaches the callers as it is
                resident_round = all(d[2] for d in rnd.deposits.values())
                if not (isinstance(e, DevicePlaneFallback) or resident_round):
                    self.disable(f"backend error: {e!r}")
                    e = DevicePlaneFallback(
                        f"device collective failed: {e!r}")
                rnd.error = e
            with self._lock:
                self._rounds.pop(seq, None)
            rnd.ready.set()
        else:
            while not rnd.ready.wait(DEVICE_PLANE_TIMEOUT_S):
                with self._lock:
                    gathered = len(rnd.deposits) == self.n_local
                if gathered:
                    # Every local rank deposited: the executor is running
                    # and WILL deliver, so keep waiting like a blocked
                    # host collective
                    continue
                with self._lock:
                    self._rounds.pop(seq, None)
                self.disable(
                    f"rendezvous timeout: round {seq} gathered "
                    f"{len(rnd.deposits)}/{self.n_local} local ranks")
                raise DevicePlaneFallback("device-plane rendezvous timeout")

        if rnd.error is not None:
            raise rnd.error
        _COLLECTIVES[kind].inc()
        out = rnd.results[rank]
        if rnd.done is not None:
            stream = torch.cuda.current_stream(out.device)
            stream.wait_event(rnd.done)
            out.record_stream(stream)
        return out

    # ------------------------------------------------------------------
    def _execute(self, kind: str, key: tuple, deposits: dict[int, tuple]):
        """Executor body (one thread per round): the deposits in rank
        order onto the device, the round, each rank's result out.
        Returns (results by rank, the event after the round or None)."""
        for r, (k, *_rest) in deposits.items():
            if k != key:
                raise RuntimeError(  # protocol desync — NOT a fallback
                    f"device-plane rendezvous mismatch: rank {r} "
                    f"deposited {k}, executor saw {key}")
        _kind, op_code, _m, _dtype = key
        all_resident = all(res for (_k, _b, res, _e) in deposits.values())
        ranks = sorted(deposits)
        on_card = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if on_card else None

        ins = []
        for r in ranks:
            _k, buf, res, event = deposits[r]
            if event is not None:
                stream.wait_event(event)
            if not all_resident:
                if res:
                    # Mixed-residency round: the resident deposit takes
                    # the explicit staging copy and rides the host shape
                    buf = to_host(buf)
                count_copy(H2D, buf.nbytes, "input")
                buf = torch.from_numpy(
                    np.require(buf, requirements="W")).to(self.device)
            ins.append(buf)

        outs = self._compute(kind, op_code, ins)
        with self._lock:
            self._executed[kind] += 1
        done = None
        if on_card:
            done = torch.cuda.Event()
            done.record(stream)
        if all_resident:
            return dict(zip(ranks, outs)), done
        results = {}
        for r, out in zip(ranks, outs):
            count_copy(D2H, out.numel() * out.element_size(), "readback")
            results[r] = out.cpu().numpy()
        return results, None

    def _compute(self, kind: str, op_code: int, ins: list) -> list:
        """The round itself over the flat deposits in rank order: one
        freshly allocated output per rank, none aliasing an input."""
        n = len(ins)
        if kind == "ring_permute":
            return permute_body(ins, op_code)
        if kind == "allgather":
            out = torch.cat(ins)
            return [out] + [out.clone() for _ in range(n - 1)]
        op = MpiOp(op_code)
        fold = _FOLDS[op]

        def reduce(parts):
            if op == MpiOp.PROD and parts[0].dtype == torch.float16:
                # As the JAX plane's jnp.prod: float16 multiplies in
                # float32 and rounds once
                acc = parts[0].float()
                for t in parts[1:]:
                    acc.mul_(t)
                return acc.to(torch.float16)
            if len(parts) == 1:
                return parts[0].clone()
            acc = fold(parts[0], parts[1])
            for t in parts[2:]:
                fold(acc, t, out=acc)
            return acc

        if kind == "allreduce":
            acc = reduce(ins)
            return [acc] + [acc.clone() for _ in range(n - 1)]
        if kind == "reduce_scatter":
            k = ins[0].shape[0] // n
            return [reduce([t[r * k:(r + 1) * k] for t in ins])
                    for r in range(n)]
        raise RuntimeError(f"unknown device collective {kind}")

    def summary(self) -> dict:
        """Observability snapshot (tests, smoke runs)."""
        with self._lock:
            rounds = dict(self._executed)
        return {
            "world_id": self.world_id,
            "size": self.n,
            "local_ranks": list(self.local_ranks),
            "device": str(self.device),
            "topology_gen": self.topology_gen,
            "disabled": self.disabled_reason,
            "rounds": rounds,
            # ring rounds on the card are kernel launches; on the CPU
            # they run the plain version
            "ring_launches": (rounds.get("ring_permute", 0)
                              if self.device.type == "cuda" else 0),
            # process-wide, not per plane
            "process_device_copies": device_copy_totals(),
        }
