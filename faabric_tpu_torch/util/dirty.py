"""Dirty-page tracking over host images.

Counterpart of ``faabric_tpu/util/dirty.py`` (reference
include/faabric/util/dirty.h:24-52, src/util/dirty.cpp). Executor images
are host numpy buffers; a tensor on the card is tracked on the card by
``snapshot/device_snapshot.py`` instead. The modes:

- ``compare``: a baseline copy and a vectorised page compare (numpy);
- ``native``: the same baseline, memcmp per page in C++
  (``util/native.py``);
- ``hash``: a 64-bit universal hash a 4 KiB page as the baseline (8
  bytes a page), computed blockwise;
- ``none``: every page dirty;
- ``segv``, ``uffd``: write-protection faults, recorded by a SIGSEGV
  handler or a userfaultfd event thread (``util/csrc/``);
- ``softpte``: the kernel's soft-dirty page-table bits.

The fault and soft-dirty modes change the whole process (a signal
handler, a userfaultfd, ``/proc/self/clear_refs``): use them only in a
process that owns its signal handling. ``make_dirty_tracker`` falls
back down softpte -> segv -> native where one is missing.

Global and thread-local start/stop, page flags out: thread-local
tracking lets each executor thread report only its own writes.
"""

from __future__ import annotations

import threading

from typing import Optional

import numpy as np

from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

PAGE_SIZE = 4096


def n_pages(size: int) -> int:
    return (size + PAGE_SIZE - 1) // PAGE_SIZE


def _as_array(mem) -> np.ndarray:
    return np.frombuffer(mem, dtype=np.uint8)


def page_flags(old: np.ndarray, new: np.ndarray,
               page_size: int = PAGE_SIZE) -> np.ndarray:
    """Dirty flags per page of ``new`` vs ``old``: one native memcmp pass
    when the C++ helper is available (numpy reshape-compare otherwise),
    partial trailing page included, pages past ``old`` (growth) dirty by
    definition. Shared by the dirty trackers and the delta codec."""
    from faabric_tpu_torch.util.native import get_pagediff_lib

    n = new.size
    n_pages_total = (n + page_size - 1) // page_size
    flags = np.zeros(n_pages_total, dtype=bool)
    common = min(old.size, n)
    common_pages = (common + page_size - 1) // page_size

    lib = get_pagediff_lib()
    if common and lib is not None:
        raw = np.zeros(common_pages, dtype=np.uint8)
        old_c = np.ascontiguousarray(old[:common])
        new_c = np.ascontiguousarray(new[:common])
        lib.diff_pages(old_c.ctypes.data, new_c.ctypes.data, common,
                       page_size, raw.ctypes.data)
        flags[:common_pages] = raw.astype(bool)
    elif common:
        whole = common // page_size
        if whole:
            flags[:whole] = (
                new[:whole * page_size].reshape(-1, page_size)
                != old[:whole * page_size].reshape(-1, page_size)
            ).any(axis=1)
        if whole * page_size < common:
            flags[whole] = not np.array_equal(
                new[whole * page_size:common], old[whole * page_size:common])
    if n > old.size:
        flags[old.size // page_size:] = True
    return flags


def hint_page_indices(region_hints, total_pages: int) -> np.ndarray:
    """Page indices covered by (offset, length) byte extents, clipped to
    the image."""
    mask = np.zeros(total_pages, dtype=bool)
    for off, length in region_hints:
        if length <= 0:
            continue
        first = off // PAGE_SIZE
        last = (off + length - 1) // PAGE_SIZE
        mask[max(0, first):min(total_pages, last + 1)] = True
    return np.where(mask)[0]


class DirtyTracker:
    """``region_hints`` (list of (offset, length) byte extents) is an
    opt-in contract that the tracked task only writes inside those
    extents — trackers then baseline/compare just the hinted pages, so
    bracketing cost scales with the declared write set instead of the
    whole image (the comparison-tracking answer to the reference's
    fault-driven precision, dirty.cpp:306-412). Writes outside the hints
    are NOT detected in hint mode."""

    mode = "base"

    def start_tracking(self, mem, region_hints=None) -> None:
        raise NotImplementedError

    def stop_tracking(self, mem) -> None:
        pass

    def get_dirty_pages(self, mem) -> np.ndarray:
        """Bool flags per page since start_tracking."""
        raise NotImplementedError

    def start_thread_local_tracking(self, mem, region_hints=None) -> None:
        pass

    def stop_thread_local_tracking(self, mem) -> None:
        pass

    def get_thread_local_dirty_pages(self, mem) -> np.ndarray:
        return self.get_dirty_pages(mem)


def _paged_view(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(len(idx), PAGE_SIZE) copy of the selected pages, zero-padding the
    image's trailing partial page."""
    pages = n_pages(arr.size)
    out = np.zeros((idx.size, PAGE_SIZE), dtype=np.uint8)
    whole = idx[idx < arr.size // PAGE_SIZE]
    if whole.size:
        grid = arr[:(arr.size // PAGE_SIZE) * PAGE_SIZE].reshape(
            -1, PAGE_SIZE)
        out[:whole.size] = grid[whole]
    if idx.size > whole.size:  # trailing partial page selected
        lo = (pages - 1) * PAGE_SIZE
        out[-1, :arr.size - lo] = arr[lo:]
    return out


class CompareTracker(DirtyTracker):
    """Baseline copy + vectorised compare; with region hints only the
    hinted pages are copied and compared."""

    mode = "compare"

    def __init__(self) -> None:
        self._baseline: Optional[np.ndarray] = None
        self._hint_idx: Optional[np.ndarray] = None
        self._tls = threading.local()

    def _snapshot(self, mem, region_hints):
        arr = _as_array(mem)
        if region_hints is None:
            return arr.copy(), None
        idx = hint_page_indices(region_hints, n_pages(arr.size))
        return _paged_view(arr, idx), idx

    def start_tracking(self, mem, region_hints=None) -> None:
        self._baseline, self._hint_idx = self._snapshot(mem, region_hints)

    def _diff(self, baseline: np.ndarray, mem,
              hint_idx: Optional[np.ndarray] = None) -> np.ndarray:
        cur = _as_array(mem)
        size = cur.size
        flags = np.zeros(n_pages(size), dtype=bool)
        if hint_idx is not None:
            live = hint_idx[hint_idx < flags.size]
            rows = _paged_view(cur, live)
            flags[live] = (rows != baseline[:live.size]).any(axis=1)
            return flags
        # Memory may have grown since the baseline was taken: pages beyond
        # the baseline are dirty by definition
        cmp_size = min(size, baseline.size)
        cmp_pages = cmp_size // PAGE_SIZE
        if cmp_pages:
            flags[:cmp_pages] = (
                cur[:cmp_pages * PAGE_SIZE].reshape(-1, PAGE_SIZE)
                != baseline[:cmp_pages * PAGE_SIZE].reshape(-1, PAGE_SIZE)
            ).any(axis=1)
        # Trailing partial page plus anything beyond the baseline
        if cmp_pages * PAGE_SIZE < cmp_size:
            flags[cmp_pages] = not np.array_equal(
                cur[cmp_pages * PAGE_SIZE:cmp_size],
                baseline[cmp_pages * PAGE_SIZE:cmp_size])
        if size > baseline.size:
            flags[baseline.size // PAGE_SIZE:] = True
        return flags

    def get_dirty_pages(self, mem) -> np.ndarray:
        if self._baseline is None:
            return np.zeros(0, dtype=bool)
        return self._diff(self._baseline, mem, self._hint_idx)

    def start_thread_local_tracking(self, mem, region_hints=None) -> None:
        self._tls.baseline, self._tls.hint_idx = self._snapshot(
            mem, region_hints)

    def get_thread_local_dirty_pages(self, mem) -> np.ndarray:
        baseline = getattr(self._tls, "baseline", None)
        if baseline is None:
            return np.zeros(0, dtype=bool)
        return self._diff(baseline, mem,
                          getattr(self._tls, "hint_idx", None))


class NativeCompareTracker(CompareTracker):
    """Baseline copy + C++ memcmp per page; falls back to numpy."""

    mode = "native"

    def _diff(self, baseline: np.ndarray, mem,
              hint_idx: Optional[np.ndarray] = None) -> np.ndarray:
        if hint_idx is not None:
            # Hinted diffs are already O(hinted pages) in numpy
            return super()._diff(baseline, mem, hint_idx)
        return page_flags(baseline, _as_array(mem))


# Random per-word-position multipliers for the vectorised page hash: a
# page's hash is the dot product of its 512 uint64 WORDS with this vector
# mod 2^64 (multiply-shift universal family). Hashing words instead of
# bytes reads the page as-is — no 8× astype widening — which makes the
# bracket about 8× cheaper.
_HASH_RNG = np.random.RandomState(0x5EED)
_WORDS_PER_PAGE = PAGE_SIZE // 8
_HASH_MULT = _HASH_RNG.randint(1, 2**63 - 1, _WORDS_PER_PAGE,
                               dtype=np.uint64) | np.uint64(1)
_HASH_BLOCK_PAGES = 8192  # bound the intermediate product buffer


class HashTracker(DirtyTracker):
    """Per-page 64-bit baseline hash — 8 bytes per 4 KiB page instead of
    a full copy. Hashing is a vectorised blockwise dot product (no per-page Python
    loop): this brackets every executor task, so it must not dwarf the
    guest work."""

    mode = "hash"

    def __init__(self) -> None:
        self._hashes: Optional[np.ndarray] = None
        self._hint_idx: Optional[np.ndarray] = None
        self._tls = threading.local()

    @staticmethod
    def _page_hashes(mem, hint_idx: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        arr = _as_array(mem)
        if hint_idx is not None:
            grid = _paged_view(arr, hint_idx).view(np.uint64)
            with np.errstate(over="ignore"):
                return (grid * _HASH_MULT).sum(axis=1)
        pages = n_pages(arr.size)
        pad = pages * PAGE_SIZE - arr.size
        if pad:
            arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        grid = arr.view(np.uint64).reshape(pages, _WORDS_PER_PAGE)
        out = np.empty(pages, dtype=np.uint64)
        with np.errstate(over="ignore"):
            for lo in range(0, pages, _HASH_BLOCK_PAGES):
                hi = min(pages, lo + _HASH_BLOCK_PAGES)
                out[lo:hi] = (grid[lo:hi] * _HASH_MULT).sum(axis=1)
        return out

    @staticmethod
    def _compare(old: Optional[np.ndarray], mem,
                 hint_idx: Optional[np.ndarray] = None) -> np.ndarray:
        if old is None:
            return np.zeros(0, dtype=bool)
        if hint_idx is not None:
            flags = np.zeros(n_pages(_as_array(mem).size), dtype=bool)
            live = hint_idx[hint_idx < flags.size]
            cur = HashTracker._page_hashes(mem, live)
            flags[live] = cur != old[:live.size]
            return flags
        cur = HashTracker._page_hashes(mem)
        flags = np.ones(cur.size, dtype=bool)  # pages beyond baseline dirty
        m = min(cur.size, old.size)
        flags[:m] = cur[:m] != old[:m]
        return flags

    def start_tracking(self, mem, region_hints=None) -> None:
        self._hint_idx = (None if region_hints is None else
                          hint_page_indices(region_hints,
                                            n_pages(_as_array(mem).size)))
        self._hashes = self._page_hashes(mem, self._hint_idx)

    def get_dirty_pages(self, mem) -> np.ndarray:
        return self._compare(self._hashes, mem, self._hint_idx)

    def start_thread_local_tracking(self, mem, region_hints=None) -> None:
        self._tls.hint_idx = (None if region_hints is None else
                              hint_page_indices(
                                  region_hints,
                                  n_pages(_as_array(mem).size)))
        self._tls.hashes = self._page_hashes(mem, self._tls.hint_idx)

    def get_thread_local_dirty_pages(self, mem) -> np.ndarray:
        return self._compare(getattr(self._tls, "hashes", None), mem,
                             getattr(self._tls, "hint_idx", None))


class NoneTracker(DirtyTracker):
    """Everything dirty (reference dirty.h:194-225)."""

    mode = "none"

    def __init__(self) -> None:
        self._size = 0

    def start_tracking(self, mem, region_hints=None) -> None:
        self._size = _as_array(mem).size

    def get_dirty_pages(self, mem) -> np.ndarray:
        return np.ones(n_pages(_as_array(mem).size), dtype=bool)


def _os_to_image_flags(os_flags: np.ndarray, page_off: int,
                       n_img: int) -> np.ndarray:
    """Map per-OS-page dirty flags to IMAGE pages when the buffer start
    is not page-aligned (malloc'd numpy buffers rarely are): image page
    j overlaps OS pages j and j+1, so it is dirty if either is."""
    if page_off == 0:
        return os_flags[:n_img].astype(bool)
    padded = np.zeros(n_img + 1, dtype=bool)
    padded[:min(os_flags.size, n_img + 1)] = \
        os_flags[:n_img + 1].astype(bool)
    return padded[:n_img] | padded[1:n_img + 1]


class SegvTracker(DirtyTracker):
    """Write-protection fault tracking — the reference's headline
    precision mode (src/util/dirty.cpp segfault tracker): the image is
    mprotect'd read-only at start; the first write to each page faults
    into a C++ SIGSEGV handler (util/csrc/segv_tracker.cpp) that records
    the page and restores write access. O(dirty) — no baseline copy, no
    per-bracket memory scan; a 128 MiB image with 3 dirty pages costs 3
    faults, not a 128 MiB compare.

    Kernel-interface caveat (same as the reference's): writes into the
    protected range from the KERNEL side (recv_into, read() into the
    buffer) return EFAULT instead of faulting — guest code writing
    through userspace (numpy ops, memoryviews) is the supported shape.

    Thread-local tracking reports every page dirtied since tracking
    began (page-fault attribution is per-process, not per-thread); the
    THREADS merge path ORs per-thread sets, so over-reporting is
    content-correct and merge-safe.

    ``region_hints`` narrow the protected range to the hinted pages —
    fewer protected pages, but writes outside the hints are undetected
    (the same contract as the comparison trackers)."""

    mode = "segv"

    def _get_lib(self):
        from faabric_tpu_torch.util.native import get_segv_lib

        return get_segv_lib()

    def __init__(self) -> None:
        lib = self._get_lib()
        if lib is None:
            raise RuntimeError(f"{self.mode} dirty tracking unavailable "
                               "(kernel or native build)")
        self._start_fn = getattr(lib, f"{self.mode}_start")
        self._stop_fn = getattr(lib, f"{self.mode}_stop")
        self._region_ids: list[int] = []
        self._os_flags: Optional[np.ndarray] = None
        self._addr = 0
        self._size = 0
        self._page_off = 0

    def start_tracking(self, mem, region_hints=None) -> None:
        arr = _as_array(mem)
        self._addr = arr.ctypes.data
        self._size = arr.size
        start_al = self._addr & ~(PAGE_SIZE - 1)
        self._page_off = self._addr - start_al
        end_al = -(-(self._addr + self._size) // PAGE_SIZE) * PAGE_SIZE
        n_os = (end_al - start_al) // PAGE_SIZE
        self._os_flags = np.zeros(n_os, dtype=np.uint8)
        self._region_ids = []
        if region_hints is not None:
            # Protect only runs of OS pages covering the hinted extents
            img_idx = hint_page_indices(region_hints, n_pages(self._size))
            os_mask = np.zeros(n_os, dtype=bool)
            for j in img_idx:
                os_mask[j] = True
                if self._page_off and j + 1 < n_os:
                    os_mask[j + 1] = True
            runs = _mask_runs(os_mask)
        else:
            runs = [(0, n_os)]
        for lo, count in runs:
            rid = self._start_fn(
                start_al + lo * PAGE_SIZE, count,
                self._os_flags.ctypes.data + lo)
            if rid < 0:
                for r in self._region_ids:
                    self._stop_fn(r)
                self._region_ids = []
                raise RuntimeError(f"{self.mode} start failed ({rid}) — "
                                   "unprotectable mapping?")
            self._region_ids.append(rid)

    def stop_tracking(self, mem) -> None:
        for rid in self._region_ids:
            self._stop_fn(rid)
        self._region_ids = []

    def get_dirty_pages(self, mem) -> np.ndarray:
        arr = _as_array(mem)
        if self._os_flags is None:
            return np.zeros(0, dtype=bool)
        if arr.ctypes.data != self._addr:
            # Buffer reallocated (growth copies into a new allocation):
            # every page of the new buffer is dirty by definition
            return np.ones(n_pages(arr.size), dtype=bool)
        n_img = n_pages(self._size)
        flags = _os_to_image_flags(self._os_flags, self._page_off, n_img)
        if arr.size > self._size:  # in-place growth: new pages dirty
            out = np.ones(n_pages(arr.size), dtype=bool)
            out[:n_img] = flags
            return out
        return flags

    # Per-thread attribution is impossible with process-wide faults;
    # report the full dirty set (merge-safe, see class docstring)
    def start_thread_local_tracking(self, mem, region_hints=None) -> None:
        pass

    def stop_thread_local_tracking(self, mem) -> None:
        pass

    def get_thread_local_dirty_pages(self, mem) -> np.ndarray:
        return self.get_dirty_pages(mem)

    def __del__(self):  # noqa: D105 — protections must not outlive us
        try:
            self.stop_tracking(None)
        except Exception:  # noqa: BLE001
            pass


class UffdTracker(SegvTracker):
    """userfaultfd write-protect tracking — the reference's
    uffd-thread-wp mode (src/util/dirty.cpp uffd impls,
    include/faabric/util/dirty.h:124-192): same O(dirty) fault-per-page
    cost model as SIGSEGV tracking, but faults are ordinary events
    consumed by ONE native thread (util/csrc/uffd_tracker.cpp) instead of a
    process-wide signal handler — no async-signal-safety constraints and
    no interaction with other SIGSEGV users (faulthandler, the CUDA runtime).
    Kernel-side writes into the range (read(2)/recv into the buffer)
    fault-and-resolve normally instead of failing EFAULT, which the
    segv mode cannot offer. Needs kernel >= 5.7 uffd-wp; unavailable
    kernels fall down the ladder (uffd -> segv -> native)."""

    mode = "uffd"

    def _get_lib(self):
        from faabric_tpu_torch.util.native import get_uffd_lib

        return get_uffd_lib()


def _mask_runs(mask: np.ndarray) -> list:
    """Consecutive True runs of a bool mask as (start, count) pairs."""
    idx = np.where(mask)[0]
    if idx.size == 0:
        return []
    splits = np.where(np.diff(idx) > 1)[0] + 1
    return [(int(g[0]), int(g.size))
            for g in np.split(idx, splits)]


# ---------------------------------------------------------------------------
# Soft-dirty PTEs (reference src/util/dirty.cpp softpte tracker)
# ---------------------------------------------------------------------------

_SOFTPTE_LOCK = threading.Lock()
_SOFTPTE_SESSIONS: list = []  # live _SoftPTESession objects
_softpte_probe: Optional[bool] = None


def _pagemap_softdirty(addr: int, size: int) -> np.ndarray:
    """Soft-dirty bit (pagemap bit 55) per OS page over [addr, addr+size)."""
    first = addr >> 12
    n = ((addr + size - 1) >> 12) - first + 1
    with open("/proc/self/pagemap", "rb") as f:
        f.seek(first * 8)
        data = f.read(n * 8)
    words = np.frombuffer(data, dtype=np.uint64)
    return ((words >> np.uint64(55)) & np.uint64(1)).astype(bool)


def softpte_available() -> bool:
    """One-time probe: CONFIG_MEM_SOFT_DIRTY kernels set pagemap bit 55
    on the first write after a clear_refs(4). Containers and custom
    kernels often ship without it — then the probe write succeeds but
    the bit never appears, and softpte mode must fall back."""
    global _softpte_probe
    with _SOFTPTE_LOCK:
        if _softpte_probe is not None:
            return _softpte_probe
        try:
            probe = np.ones(PAGE_SIZE * 4, np.uint8)  # faulted-in pages
            with open("/proc/self/clear_refs", "w") as f:
                f.write("4")
            probe[PAGE_SIZE * 2] = 7
            bits = _pagemap_softdirty(probe.ctypes.data, probe.size)
            _softpte_probe = bool(bits.any())
        except OSError:
            _softpte_probe = False
        if not _softpte_probe:
            # Debug, not info: make_dirty_tracker already warns once per
            # (mode, fallback) when the ladder actually falls back —
            # surfacing the probe result here too printed the same
            # fallback twice back-to-back in every worker log
            logger.debug("Soft-dirty PTEs not functional on this kernel; "
                         "DIRTY_TRACKING_MODE=softpte falls back to segv/"
                         "native")
        return _softpte_probe


class _SoftPTESession:
    """One tracked image. clear_refs resets soft-dirty bits for the
    WHOLE process, so starting any session first folds the current bits
    of every other live session into its accumulator — sessions never
    lose writes to each other's clears."""

    def __init__(self, addr: int, size: int) -> None:
        self.addr = addr
        self.size = size
        n_os = ((addr + size - 1) >> 12) - (addr >> 12) + 1
        self.accum = np.zeros(n_os, dtype=bool)

    def fold_current(self) -> None:
        self.accum |= _pagemap_softdirty(self.addr, self.size)

    def dirty_os_pages(self) -> np.ndarray:
        return self.accum | _pagemap_softdirty(self.addr, self.size)


class SoftPTETracker(DirtyTracker):
    """Kernel soft-dirty PTE tracking (reference dirty.cpp softpte
    tracker): clear_refs(4) write-protects every PTE; the kernel sets
    pagemap bit 55 on the first write to each page. O(dirty) faults at
    write time + an 8-bytes-per-page pagemap read at query time — no
    baseline copy, no image scan. Requires CONFIG_MEM_SOFT_DIRTY
    (``softpte_available()``); ``make_dirty_tracker`` falls back to the
    segv tracker (or native compare) where the kernel lacks it.

    Like the segv tracker, fault attribution is process-wide, so
    thread-local queries report the full dirty set (merge-safe)."""

    mode = "softpte"

    def __init__(self) -> None:
        if not softpte_available():
            raise RuntimeError("soft-dirty PTEs not available")
        self._sess: Optional[_SoftPTESession] = None
        self._page_off = 0

    def start_tracking(self, mem, region_hints=None) -> None:
        arr = _as_array(mem)
        sess = _SoftPTESession(arr.ctypes.data, arr.size)
        self._page_off = arr.ctypes.data & (PAGE_SIZE - 1)
        with _SOFTPTE_LOCK:
            # Everyone else banks their bits before we clear them
            for other in _SOFTPTE_SESSIONS:
                other.fold_current()
            with open("/proc/self/clear_refs", "w") as f:
                f.write("4")
            if self._sess in _SOFTPTE_SESSIONS:
                _SOFTPTE_SESSIONS.remove(self._sess)
            _SOFTPTE_SESSIONS.append(sess)
        self._sess = sess

    def stop_tracking(self, mem) -> None:
        with _SOFTPTE_LOCK:
            if self._sess in _SOFTPTE_SESSIONS:
                _SOFTPTE_SESSIONS.remove(self._sess)
        self._sess = None

    def get_dirty_pages(self, mem) -> np.ndarray:
        arr = _as_array(mem)
        if self._sess is None:
            return np.zeros(0, dtype=bool)
        if arr.ctypes.data != self._sess.addr:
            return np.ones(n_pages(arr.size), dtype=bool)
        with _SOFTPTE_LOCK:
            os_flags = self._sess.dirty_os_pages()
        n_img = n_pages(self._sess.size)
        flags = _os_to_image_flags(os_flags, self._page_off, n_img)
        if arr.size > self._sess.size:
            out = np.ones(n_pages(arr.size), dtype=bool)
            out[:n_img] = flags
            return out
        return flags

    def start_thread_local_tracking(self, mem, region_hints=None) -> None:
        pass

    def stop_thread_local_tracking(self, mem) -> None:
        pass

    def get_thread_local_dirty_pages(self, mem) -> np.ndarray:
        return self.get_dirty_pages(mem)

    def __del__(self):  # noqa: D105
        try:
            self.stop_tracking(None)
        except Exception:  # noqa: BLE001
            pass


_TRACKERS = {
    "compare": CompareTracker,
    "native": NativeCompareTracker,
    "hash": HashTracker,
    "none": NoneTracker,
    "segv": SegvTracker,
    "softpte": SoftPTETracker,
    "uffd": UffdTracker,
}

_FALLBACK_WARNED: set = set()


def make_dirty_tracker(mode: str | None = None) -> DirtyTracker:
    mode = mode or get_system_config().dirty_tracking_mode
    cls = _TRACKERS.get(mode)
    if cls is None:
        raise ValueError(f"Unknown dirty tracking mode: {mode}")
    # Kernel-assisted modes degrade gracefully: softpte → segv → native.
    # This ladder is an intentional robustness addition — the reference
    # (dirty.cpp getDirtyTracker) throws on an unavailable mode instead.
    # dict.fromkeys dedupes so mode='segv' doesn't construct SegvTracker
    # twice before falling back.
    for fallback in dict.fromkeys((cls, SegvTracker, NativeCompareTracker)):
        try:
            return fallback()
        except RuntimeError as e:
            key = (mode, fallback.mode)
            if key not in _FALLBACK_WARNED:
                _FALLBACK_WARNED.add(key)
                logger.warning("Dirty mode %s unavailable (%s); "
                               "falling back", fallback.mode, e)
    return NativeCompareTracker()
