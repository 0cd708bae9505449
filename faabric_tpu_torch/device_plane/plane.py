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

Across processes (a world whose ranks live in several processes of a
joined device plane, ``parallel/distributed.py``): the last local
arriver of each process runs the round for its local ranks through
``xproc.py``, which gives every process every rank's deposit (gloo on
the CPU; CUDA IPC windows on one card), and folds them in rank order
with the same code, so the results are bitwise the single-process
plane's. A ring round is one launch of the ring kernel per process,
writing into local outputs and peers' windows. The exchange runs on a
gloo group of the plane's own per world plane, made at its first round.

Telemetry, as the reference's: the first round of a key (kind, op,
size, dtype, residency) is its ``compile``: an ``mpi.phase``/``compile``
span over the load of the round's kernels (the nvcc build, on the card,
the first time in the process), counted in
``faabric_device_plane_compiles_total``. Every round is one
``mpi.phase``/``execute`` span. On the card its time is a CUDA event
pair around the round on the executor's stream, and the span ends only
after the end event has completed (a host wait inside the span), so the
``execute`` phase in the collective profiler and the ``("mesh",
"device")`` rate in the perf store are the card's time, not the
launch's; with metrics off there is no wait. Each rank's contribution
is recorded in the comm matrix as a ``device`` cell toward its ring
neighbour.

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
import time
import weakref

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
from faabric_tpu_torch.telemetry import (
    get_collective_profiler,
    get_comm_matrix,
    get_metrics,
    get_perf_store,
    metrics_enabled,
    span,
)

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
_COMPILES = _metrics.counter(
    "faabric_device_plane_compiles_total",
    "Device-plane executable cache misses (compilations)")
_FALLBACKS = _metrics.counter(
    "faabric_device_plane_fallbacks_total",
    "Device plane disables (collectives re-routed to the host ladder)")
# Compile and execute phases go to the collective profiler, and each
# round's payload to the perf store's device-plane profile
_PROFILER = get_collective_profiler()
_PERF = get_perf_store()

# This process's live planes, whose summaries the telemetry RPC and the
# planner's ``GET /topology`` list. Weak: a destroyed world's plane must
# not be kept alive by the scrape surface
_PLANES: "weakref.WeakSet[DevicePlane]" = weakref.WeakSet()
_PLANES_LOCK = threading.Lock()


def device_planes_summary() -> list[dict]:
    """The summaries of this process's live planes, by world id."""
    with _PLANES_LOCK:
        planes = list(_PLANES)
    out = []
    for p in planes:
        try:
            out.append(p.summary())
        except Exception:  # noqa: BLE001 — a scrape must not raise
            pass
    out.sort(key=lambda s: s.get("world_id", 0))
    return out


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

    # Concurrency contract (analysis/concheck.py): rendezvous state, the
    # disable verdict, the round counts and the compiled-key set mutate
    # under _lock from N rank threads. The reference's executable cache
    # and its leaf _cache_lock (_cache, _cache_hits, _cache_compiles,
    # _compile_ms) have no counterpart: a round here launches a
    # hand-written kernel, so there is no executable to hold, and
    # _compiled only records which keys ran once.
    GUARDS = {
        "_rounds": "_lock",
        "_rank_seq": "_lock",
        "_disabled": "_lock",
        "_executed": "_lock",
        "_compiled": "_lock",
    }

    def __init__(self, world_id: int, devices, local_ranks,
                 topology_gen: int, processes=None,
                 exchange_name: str | None = None) -> None:
        self.world_id = world_id
        self.devices = list(devices)          # rank i ↔ devices[i]
        self.n = len(self.devices)
        self.local_ranks = tuple(sorted(local_ranks))
        self.n_local = len(self.local_ranks)
        # This process's device (a remote rank's entry names its own)
        self.device = self.devices[self.local_ranks[0]]
        self.topology_gen = topology_gen
        # rank → its plane process index; the exchange between them (a
        # gloo group and, on the card, IPC windows) is made at the first
        # round, under exchange_name, which every process of the world
        # must give it alike and no other activation may reuse
        self.processes = (list(processes) if processes is not None
                          else [0] * self.n)
        self.process_count = len(set(self.processes))
        self.process_index = (self.processes[self.local_ranks[0]]
                              if self.n else 0)
        self._xproc = None
        if self.process_count > 1:
            from faabric_tpu_torch.device_plane import xproc

            if not exchange_name:
                raise ValueError("a plane across processes needs an "
                                 "exchange_name")
            self._xproc = xproc.Exchanger(exchange_name, self.processes,
                                          self.device)

        # Rendezvous state, the disable verdict and the round counts
        # mutate under _lock from the N rank threads
        self._lock = threading.Lock()
        self._rounds: dict[int, _Round] = {}
        self._rank_seq: dict[int, int] = {}
        self._disabled: str | None = None
        self._executed: collections.Counter = collections.Counter()
        # Keys (kind, op, size, dtype, all-resident) whose first round
        # ran: a new one is a compile
        self._compiled: set[tuple] = set()
        with _PLANES_LOCK:
            _PLANES.add(self)

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
        # This rank's contribution entered the device plane (attributed
        # to its ring neighbour; the host planes saw none of it)
        get_comm_matrix().record(rank, (rank + 1) % self.n, "device",
                                 int(flat.nbytes))
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
        _kind, op_code, m, dtype = key
        all_resident = all(res for (_k, _b, res, _e) in deposits.values())
        ranks = sorted(deposits)
        executor_rank = ranks[0]
        on_card = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if on_card else None
        attrs = dict(world=self.world_id, kind=kind, elems=m, dtype=dtype,
                     resident=all_resident)

        exe_key = key + (all_resident,)
        with self._lock:
            first = exe_key not in self._compiled
            self._compiled.add(exe_key)
        if first:
            # Rounds are sequential per plane, so one executor compiles
            # at a time
            _COMPILES.inc()
            t0 = time.monotonic()
            with span("mpi.phase", "compile", phase="compile", **attrs):
                if on_card:
                    from faabric_tpu_torch.ops import _build

                    _build.kernels()
            elapsed = time.monotonic() - t0
            _PROFILER.record_phase(self.world_id, kind, executor_rank,
                                   "compile", elapsed)

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

        timed = metrics_enabled()
        t0 = time.monotonic()
        with span("mpi.phase", "execute", phase="execute", **attrs):
            if on_card and timed:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record(stream)
                outs = self._round(kind, op_code, ranks, ins)
                end.record(stream)
                # The span and the rate end when the card has finished
                end.synchronize()
                elapsed = start.elapsed_time(end) / 1e3
            else:
                outs = self._round(kind, op_code, ranks, ins)
                elapsed = time.monotonic() - t0
        _PROFILER.record_phase(self.world_id, kind, executor_rank,
                               "execute", elapsed)
        # The whole round's payload moved in this one execute: a rate of
        # the device, not of a link
        _PERF.observe("mesh", "device",
                      sum(int(d[1].nbytes) for d in deposits.values()),
                      elapsed)
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

    def _round(self, kind: str, op_code: int, ranks: list, ins: list) -> list:
        """The round's outputs for the local ``ranks`` (whose flat
        deposits ``ins`` are): in this process alone, or through the
        exchange with the world's other processes."""
        if self._xproc is None:
            return self._compute(kind, op_code, ins)
        local = dict(zip(ranks, ins))
        if kind == "ring_permute":
            outs = self._xproc.ring(local, op_code)
            return [outs[r] for r in ranks]
        with self._xproc.gather(local) as every:
            return self._compute(kind, op_code, every, want=ranks)

    def _compute(self, kind: str, op_code: int, ins: list,
                 want=None) -> list:
        """The round itself over every rank's flat deposit, in rank
        order: one freshly allocated output for each rank of ``want``
        (all by default), none aliasing an input."""
        n = len(ins)
        want = list(range(n)) if want is None else list(want)
        if kind == "ring_permute":
            outs = permute_body(ins, op_code)
            return [outs[r] for r in want]
        if kind == "allgather":
            out = torch.cat(ins)
            return [out] + [out.clone() for _ in want[1:]]
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
            return [acc] + [acc.clone() for _ in want[1:]]
        if kind == "reduce_scatter":
            k = ins[0].shape[0] // n
            return [reduce([t[r * k:(r + 1) * k] for t in ins])
                    for r in want]
        raise RuntimeError(f"unknown device collective {kind}")

    def close(self) -> None:
        """Release the cross-process exchange (its windows and
        mappings), without waiting on a peer. A plane of one process has
        nothing to release."""
        if self._xproc is not None:
            self._xproc.close()

    def summary(self) -> dict:
        """Observability snapshot (tests, smoke runs)."""
        with self._lock:
            rounds = dict(self._executed)
            compiles = len(self._compiled)
        return {
            "world_id": self.world_id,
            "size": self.n,
            "local_ranks": list(self.local_ranks),
            "device": str(self.device),
            "topology_gen": self.topology_gen,
            "process_index": self.process_index,
            "process_count": self.process_count,
            "disabled": self.disabled_reason,
            "rounds": rounds,
            "compiles": compiles,
            # ring rounds on the card are kernel launches; on the CPU
            # they run the plain version
            "ring_launches": (rounds.get("ring_permute", 0)
                              if self.device.type == "cuda" else 0),
            # process-wide, not per plane
            "process_device_copies": device_copy_totals(),
            # across processes on the card: the ring kernel's own ms in
            # this process's latest ring rounds
            "ring_kernel_ms": (self._xproc.ring_kernel_ms()
                               if self._xproc is not None else []),
        }
