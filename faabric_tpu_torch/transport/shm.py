"""Shared-memory rings: the same-machine bulk data plane.

Counterpart of ``faabric_tpu/transport/shm.py``. When a bulk sender and
its receiver live on one machine (worker processes of one host, or host
aliases of one machine), a payload crosses as one copy into a /dev/shm
ring and one out, with no socket. The ring is native
(``util/csrc/shm_ring.cpp``): a lock-free SPSC byte queue whose head and
tail are C++ atomics in the shared mapping, with futex waits on both
sides.

The ring file is ``faabric-ring-<tag>-<pid>-<n>`` under /dev/shm, a
192-byte header and then the data, as the reference lays it out: a ring
made by one package opens in the other. Rendezvous rides the bulk TCP
connection (``transport/bulk.py``): the client creates the ring,
announces its name in a sentinel frame, and the server attaches and
drains it. Both planes stamp the same sequence numbers, and the
receiving broker merges them.

Frames and bytes are counted both ways; a push that found no space
records its blocking wait in ``faabric_shm_ring_push_wait_seconds``
(consumer backpressure), and one that gave up counts as a stall.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
import time

import numpy as np

from faabric_tpu_torch.telemetry import get_metrics
from faabric_tpu_torch.util.native import get_shmring_lib

_metrics = get_metrics()
_RING_TX_FRAMES = _metrics.counter(
    "faabric_shm_ring_tx_frames_total", "Frames pushed into shm rings")
_RING_TX_BYTES = _metrics.counter(
    "faabric_shm_ring_tx_bytes_total", "Payload bytes pushed into shm rings")
_RING_RX_FRAMES = _metrics.counter(
    "faabric_shm_ring_rx_frames_total", "Frames popped from shm rings")
_RING_RX_BYTES = _metrics.counter(
    "faabric_shm_ring_rx_bytes_total", "Payload bytes popped from shm rings")
_RING_PUSH_WAIT = _metrics.histogram(
    "faabric_shm_ring_push_wait_seconds",
    "Blocking wait for ring space when the fast-path push found none "
    "(consumer backpressure)")
_RING_PUSH_STALLS = _metrics.counter(
    "faabric_shm_ring_push_stalls_total",
    "Ring pushes abandoned on timeout (sender fell back to TCP)")

SHM_DIR = "/dev/shm"
HDR_BYTES = 192
DEFAULT_RING_BYTES = 32 * (1 << 20)

_counter_lock = threading.Lock()
_counter = 0


def shm_available() -> bool:
    """Whether rings can be used; ``SHM_BULK=0`` turns them off (read on
    every call)."""
    return (os.environ.get("SHM_BULK", "1") != "0"
            and os.path.isdir(SHM_DIR)
            and os.access(SHM_DIR, os.W_OK)
            and get_shmring_lib() is not None)


def gc_stale_rings() -> int:
    """Unlink rings whose creator process is gone (a killed worker
    leaves its files; the name carries the creator's pid so survivors
    can sweep them). Returns the count removed."""
    removed = 0
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return 0
    for n in names:
        if not n.startswith("faabric-ring-"):
            continue
        parts = n.rsplit("-", 2)
        try:
            pid = int(parts[-2])
        except (ValueError, IndexError):
            continue
        if not os.path.exists(f"/proc/{pid}"):
            try:
                os.unlink(os.path.join(SHM_DIR, n))
                removed += 1
            except OSError:
                pass
    return removed


def _next_name(tag: str) -> str:
    global _counter
    with _counter_lock:
        _counter += 1
        n = _counter
    safe = "".join(c if c.isalnum() else "-" for c in tag)[:48]
    return f"faabric-ring-{safe}-{os.getpid()}-{n}"


class ShmRing:
    """One direction of a same-machine channel: the creating side
    produces, the attaching side consumes (exactly one of each; the bulk
    plane uses one ring a connection)."""

    def __init__(self, name: str, mm: mmap.mmap, capacity: int,
                 created: bool) -> None:
        self.name = name
        self._mm = mm
        self.capacity = capacity
        self._created = created
        self._lib = get_shmring_lib()
        buf = (ctypes.c_char * (HDR_BYTES + capacity)).from_buffer(mm)
        self._base = ctypes.addressof(buf)
        self._buf = buf  # keeps the mapping pinned

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, tag: str, capacity: int = DEFAULT_RING_BYTES
               ) -> "ShmRing":
        if capacity & (capacity - 1):
            raise ValueError(f"ring capacity {capacity} not a power of two")
        lib = get_shmring_lib()
        if lib is None:
            raise RuntimeError("native shm ring unavailable")
        # A taken name (the reference's rings in this same process
        # count from 1 too, or a dead process's file under a recycled
        # pid) moves on to the next number
        for _ in range(64):
            name = _next_name(tag)
            path = os.path.join(SHM_DIR, name)
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
                break
            except FileExistsError:
                continue
        else:
            raise FileExistsError(f"no free ring name for {tag}")
        try:
            os.ftruncate(fd, HDR_BYTES + capacity)
            mm = mmap.mmap(fd, HDR_BYTES + capacity)
        finally:
            os.close(fd)
        ring = cls(name, mm, capacity, created=True)
        if lib.ring_init(ring._base, capacity) != 0:
            ring.close()
            raise RuntimeError("ring_init failed")
        # Touch every page now, so the first big frame's copy does not
        # pay the page faults (page 0 holds the fresh header: skip it)
        np.frombuffer(mm, np.uint8)[mmap.PAGESIZE::mmap.PAGESIZE] = 0
        return ring

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        lib = get_shmring_lib()
        if lib is None:
            raise RuntimeError("native shm ring unavailable")
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad ring name {name!r}")
        path = os.path.join(SHM_DIR, name)
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        probe = (ctypes.c_char * size).from_buffer(mm)
        cap = lib.ring_check(ctypes.addressof(probe))
        del probe
        if cap < 0 or HDR_BYTES + cap != size:
            mm.close()
            raise ValueError(f"{path} is not a valid ring")
        return cls(name, mm, int(cap), created=False)

    # ------------------------------------------------------------------
    def _gather_args(self, bufs):
        """ctypes (segs, lens) for one gathered frame, built once a push
        even when the blocking path retries."""
        arrs = [b if isinstance(b, np.ndarray) and b.dtype == np.uint8
                and b.ndim == 1 else np.frombuffer(b, np.uint8)
                for b in bufs]
        n = len(arrs)
        segs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
        lens = (ctypes.c_uint64 * n)(*[a.nbytes for a in arrs])
        return arrs, segs, lens, n

    def _try_pushv(self, segs, lens, n) -> bool:
        rc = self._lib.ring_try_pushv(self._base, segs, lens, n)
        if rc == -2:
            raise ValueError("frame larger than ring capacity")
        return rc == 0

    def try_push(self, bufs) -> bool:
        """One frame gathered from bytes-like segments; False when the
        ring lacks space. Raises ValueError for a frame that can never
        fit."""
        _arrs, segs, lens, n = self._gather_args(bufs)
        return self._try_pushv(segs, lens, n)

    def push(self, bufs, timeout: float = 10.0,
             nbytes: int | None = None) -> bool:
        """Blocking push; False on timeout (the consumer stalled: the
        caller falls back to TCP). Waits on the ring's shared futex,
        woken by the consumer's pops. ``nbytes`` is the gathered size
        when the caller knows it."""
        arrs, segs, lens, n = self._gather_args(bufs)
        if self._try_pushv(segs, lens, n):
            _RING_TX_FRAMES.inc()
            _RING_TX_BYTES.inc(sum(lens) if nbytes is None else nbytes)
            return True
        need = (sum(lens) if nbytes is None else nbytes) + 8
        t0 = time.monotonic()
        deadline = t0 + timeout
        while True:
            self._lib.ring_wait_space(self._base, need, 20_000)
            if self._try_pushv(segs, lens, n):
                _RING_PUSH_WAIT.observe(time.monotonic() - t0)
                _RING_TX_FRAMES.inc()
                _RING_TX_BYTES.inc(need - 8)
                return True
            if time.monotonic() >= deadline:
                _RING_PUSH_WAIT.observe(time.monotonic() - t0)
                _RING_PUSH_STALLS.inc()
                return False

    def pop_batch(self, out: np.ndarray, lens, max_frames: int) -> int:
        """Pop up to ``max_frames`` frames into ``out`` (the caller's
        reused uint8 scratch), each payload's length into ``lens`` (a
        ctypes uint64 array). One native call and one futex wake a
        batch. Returns the frame count; 0 means empty, or the next frame
        alone exceeds ``out`` (the caller then takes ``try_pop``)."""
        n = int(self._lib.ring_pop_batch(
            self._base, out.ctypes.data, out.nbytes, lens, max_frames))
        if n:
            _RING_RX_FRAMES.inc(n)
            _RING_RX_BYTES.inc(int(sum(lens[i] for i in range(n))))
        return n

    def wait_data(self, timeout_us: int = 20_000) -> bool:
        """Block until a frame is likely there; True when data is
        visible. Wakes may be spurious: loop on ``try_pop``."""
        return self._lib.ring_wait_data(self._base, timeout_us) == 0

    def try_pop(self) -> np.ndarray | None:
        """The next frame as a uint8 array the caller owns, or None when
        the ring is empty."""
        n = self._lib.ring_peek(self._base)
        if n < 0:
            return None
        out = np.empty(n, np.uint8)
        self._lib.ring_pop(self._base, out.ctypes.data, n)
        _RING_RX_FRAMES.inc()
        _RING_RX_BYTES.inc(n)
        return out

    def peek(self) -> int:
        """The next frame's payload length, or -1 when empty."""
        return int(self._lib.ring_peek(self._base))

    def free_space(self) -> int:
        return int(self._lib.ring_free_space(self._base))

    # ------------------------------------------------------------------
    def close(self, unlink: bool | None = None) -> None:
        """Drop the mapping; ``unlink`` defaults to whether this side
        created the file (either side may force it: the name is used
        once)."""
        if self._mm is not None:
            # ctypes buffers pin the mmap: drop them first
            self._buf = None
            try:
                self._mm.close()
            except BufferError:
                pass  # a stale export keeps the map; the unlink still runs
            self._mm = None
        if unlink is None:
            unlink = self._created
        if unlink:
            try:
                os.unlink(os.path.join(SHM_DIR, self.name))
            except OSError:
                pass
