"""Snapshots of a tensor on its device: dirty pages and diffs found there.

Counterpart of ``faabric_tpu/snapshot/device_snapshot.py``. There is no
mprotect on device memory, so fault-driven tracking (reference
src/util/dirty.cpp) cannot exist for it. Instead a baseline copy stays
on the device beside the live tensor, and the page compare runs there:

- ``dirty_pages(current)``: one compare and reduction on the device
  giving an (n_pages,) bool vector; only those n/4096 bytes cross to
  the host.
- ``diff(current)``: gathers exactly the dirty pages on the device (one
  ``index_select`` along the page axis) and copies just them to the
  host, as the same :class:`SnapshotDiff` objects the host snapshot
  stack ships over RPC (``snapshot/remote.py``) and merges
  (``SnapshotData.queue_diffs``).

The reference does this in XLA, not in a Pallas kernel: the compare is
an elementwise pass and a reduction bound by memory bandwidth, and the
gain is architectural (the image never goes to the host). The port does
it in plain torch on the tensor's own device, CUDA or CPU.

Compares and gathers run on a **same-width integer view** of the tensor
(free: no copy), never on a byte image and never on the values: word
equality is byte equality, where comparing floats would not be (NaN !=
NaN, -0.0 == 0.0). The views are signed (int16, int32, int64), since
torch's unsigned 16- to 64-bit dtypes lack ``ne`` and ``index_select``
on some backends; a signed view keeps the bit patterns all the same.
bool is viewed as uint8. Diffs are the little-endian byte ranges of the
tensor, with offsets equal to the host ``SnapshotData`` layout's, so a
device diff queues onto a host snapshot.

Every device-to-host copy of this module is counted in
``device_plane/copies.py`` (reason ``snapshot``): the flag vector, the
gathered pages, the baseline a host snapshot is made from, and the
tensor ``apply_diffs`` patches (with its copy back). Each diff is a
``device_diff`` event of the state ledger, as the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from faabric_tpu_torch.device_plane.copies import D2H, H2D, count_copy
from faabric_tpu_torch.snapshot.snapshot import SnapshotData, SnapshotDiff
from faabric_tpu_torch.telemetry.statestats import get_state_stats

DEVICE_PAGE_SIZE = 4096

_WORD_FOR_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}


def _word_dtype(dtype: torch.dtype) -> torch.dtype:
    """The integer dtype a tensor is compared as: the signed one of its
    width (uint8 for one byte). Complex dtypes are refused, as the
    reference refuses them."""
    if dtype.is_complex:
        raise ValueError(
            f"DeviceSnapshot does not support complex dtype {dtype}; "
            "view the tensor as its real-pair components first")
    return _WORD_FOR_SIZE[dtype.itemsize]


def _as_word_image(t: torch.Tensor) -> torch.Tensor:
    """The tensor flattened to its integer words: a view where the
    tensor is contiguous (bit patterns, so bytes, are kept)."""
    flat = t.detach().reshape(-1)
    return flat.view(_word_dtype(flat.dtype))


def _bucket(n: int) -> int:
    """``n`` rounded up to a power of two. The reference pads its gather
    to these sizes to bound XLA recompiles; torch's gather needs no
    padding, so only the tests call this."""
    b = 1
    while b < n:
        b <<= 1
    return b


class DeviceSnapshot:
    """Baseline and diff for one tensor, on the tensor's device.

    The baseline stays on the device beside the live tensor (twice the
    memory of the tracked tensor: the price of tracking without
    faults)."""

    def __init__(self, tensor: torch.Tensor,
                 page_size: int = DEVICE_PAGE_SIZE) -> None:
        self.page_size = page_size
        self.shape = tuple(tensor.shape)
        self.dtype = tensor.dtype
        self.device = tensor.device
        self._baseline_w = _as_word_image(tensor).clone()
        self._word = self._baseline_w.dtype
        if page_size % self._word.itemsize:
            raise ValueError(
                f"page_size {page_size} not a multiple of item size "
                f"{self._word.itemsize}")
        self.page_words = page_size // self._word.itemsize
        self.n_words = self._baseline_w.numel()
        self.n_bytes = self.n_words * self._word.itemsize
        self.n_pages = -(-self.n_words // self.page_words)

    # ------------------------------------------------------------------
    def _flags_on_device(self, w: torch.Tensor) -> torch.Tensor:
        """(n_pages,) bool on the device. Whole pages compare as one
        (pages, page_words) grid; a partial last page compares alone,
        so the image is never padded."""
        whole = self.n_words // self.page_words
        cut = whole * self.page_words
        flags = (w[:cut].view(whole, self.page_words)
                 != self._baseline_w[:cut].view(whole, self.page_words)
                 ).any(dim=1)
        if cut < self.n_words:
            tail = (w[cut:] != self._baseline_w[cut:]).any().reshape(1)
            flags = torch.cat([flags, tail])
        return flags

    def _flags_w(self, w: torch.Tensor) -> np.ndarray:
        flags = self._flags_on_device(w).cpu().numpy()
        # The point of diffing on the device, made countable: the only
        # device-to-host traffic of a compare is this flag vector
        count_copy(D2H, int(flags.nbytes), "snapshot")
        return flags

    def _gather(self, w: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """(len(idx), page_words) words of the selected pages, on the
        device; a partial last page is zero-padded to a whole one."""
        whole = self.n_words // self.page_words
        cut = whole * self.page_words
        n_whole = int(np.searchsorted(idx, whole))
        rows = w[:cut].view(whole, self.page_words).index_select(
            0, torch.from_numpy(idx[:n_whole]).to(w.device))
        if n_whole == idx.size:
            return rows
        last = torch.zeros(1, self.page_words, dtype=w.dtype,
                           device=w.device)
        last[0, :self.n_words - cut] = w[cut:]
        return torch.cat([rows, last])

    def dirty_pages(self, tensor: torch.Tensor) -> np.ndarray:
        """(n_pages,) bool host vector; the only device-to-host copy is
        the flag vector itself."""
        self._check(tensor)
        return self._flags_w(_as_word_image(tensor))

    def diff(self, tensor: torch.Tensor, update_baseline: bool = False
             ) -> list[SnapshotDiff]:
        """Byte-exact diffs of ``tensor`` against the baseline; the
        dirty pages are gathered on the device and copied in one batch.
        Adjacent dirty pages coalesce into one diff."""
        self._check(tensor)
        stats = get_state_stats()
        t0 = time.perf_counter() if stats.enabled else 0.0
        # One word image serves the compare, the gather and the
        # baseline refresh
        w = _as_word_image(tensor)
        idx = np.flatnonzero(self._flags_w(w))
        if idx.size == 0:
            if stats.enabled:
                stats.snapshot_event("device_diff",
                                     seconds=time.perf_counter() - t0)
            return []
        rows = self._gather(w, idx)
        pages = rows.cpu().numpy()
        count_copy(D2H, int(pages.nbytes), "snapshot")
        # (pages, page_words) words -> (pages, page_size) bytes
        pages = pages.view(np.uint8).reshape(idx.size, -1)
        # Runs of consecutive dirty pages, found at once: one diff each
        starts = np.flatnonzero(np.diff(idx, prepend=-2) != 1)
        diffs: list[SnapshotDiff] = []
        for lo, hi in zip(starts, np.append(starts[1:], idx.size)):
            offset = int(idx[lo]) * self.page_size
            # Clip the last page's padding back to the true size
            end = min((int(idx[hi - 1]) + 1) * self.page_size, self.n_bytes)
            diffs.append(SnapshotDiff(
                offset, pages[lo:hi].reshape(-1)[:end - offset].tobytes()))
        if update_baseline:
            # Only the dirty pages differ: write just them back
            self._scatter(rows, idx)
        if stats.enabled:
            stats.snapshot_event(
                "device_diff", nbytes=sum(len(d.data) for d in diffs),
                pages=int(idx.size), regions=len(diffs),
                seconds=time.perf_counter() - t0)
        return diffs

    def _scatter(self, rows: torch.Tensor, idx: np.ndarray) -> None:
        """The inverse of ``_gather``: ``rows`` written into the baseline
        at pages ``idx``, in place on the device."""
        whole = self.n_words // self.page_words
        cut = whole * self.page_words
        n_whole = int(np.searchsorted(idx, whole))
        if n_whole:
            self._baseline_w[:cut].view(whole, self.page_words).index_copy_(
                0, torch.from_numpy(idx[:n_whole]).to(rows.device),
                rows[:n_whole])
        if n_whole < idx.size:
            self._baseline_w[cut:] = rows[-1, :self.n_words - cut]

    @property
    def baseline_bytes(self) -> np.ndarray:
        """Host uint8 copy of the baseline image (host bridging, tests)."""
        return self._baseline_w.to("cpu", copy=True).numpy().view(
            np.uint8).reshape(-1)

    def update_baseline(self, tensor: torch.Tensor) -> None:
        self._check(tensor)
        self._baseline_w = _as_word_image(tensor).clone()

    def restore(self) -> torch.Tensor:
        """The baseline as a tensor of the original shape and dtype, on
        the device (a copy: writing to it leaves the baseline as is)."""
        return self._baseline_w.clone().view(self.dtype).reshape(self.shape)

    # ------------------------------------------------------------------
    # Bridges to the host snapshot stack (freeze and thaw, RPC pushes)
    # ------------------------------------------------------------------
    def to_host_snapshot(self) -> SnapshotData:
        """The baseline as a host SnapshotData; device diffs queue onto
        it at the same byte offsets."""
        host = self._baseline_w.cpu().numpy()
        count_copy(D2H, int(host.nbytes), "snapshot")
        return SnapshotData(host)

    def apply_diffs(self, tensor: torch.Tensor,
                    diffs: list[SnapshotDiff]) -> torch.Tensor:
        """Byte-exact diffs applied to a tensor, as a new tensor on its
        device (the restore direction: thaw a frozen device state, then
        replay its diffs)."""
        self._check(tensor)
        host = _as_word_image(tensor).to("cpu", copy=True).numpy()
        count_copy(D2H, int(host.nbytes), "snapshot")
        u8 = host.view(np.uint8)
        for d in diffs:
            u8[d.offset:d.offset + len(d.data)] = np.frombuffer(
                d.data, np.uint8)
        count_copy(H2D, int(u8.nbytes), "snapshot")
        out = torch.from_numpy(host).to(tensor.device)
        return out.view(self.dtype).reshape(self.shape)

    def _check(self, tensor: torch.Tensor) -> None:
        if tuple(tensor.shape) != self.shape or tensor.dtype != self.dtype:
            raise ValueError(
                f"snapshot tracks {self.shape}/{self.dtype}, "
                f"got {tuple(tensor.shape)}/{tensor.dtype}")
        if tensor.device != self.device:
            raise ValueError(
                f"snapshot tracks a tensor on {self.device}, got one on "
                f"{tensor.device}")
