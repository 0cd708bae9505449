"""Input pipeline: token datasets and a prefetching loader.

Counterpart of ``faabric_tpu/data/loader.py``: a memmap-backed token
store, deterministic shuffled windows (the same permutation as the JAX
loader for the same seed and epoch), and a background thread that
assembles the next batches while the current step runs. On CUDA a batch
goes through pinned memory with a non-blocking copy: the thread does
not wait for the copy, which the card runs on the default stream, in
order with the step's kernels. With a ``mesh`` a batch is staged as
per-rank shards, B over dp and S over sp (``models.data_sharding``).

Usage::

    ds = TokenDataset.from_file("corpus.bin", seq_len=2048)  # or from array
    loader = DataLoader(ds, batch_size=32, seed=0)
    for tokens, targets in loader:          # int32 tensors on the device
        loss = step(model, opt, tokens, targets)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from faabric_tpu_torch.util.device import resolve_device


class TokenDataset:
    """Contiguous token ids carved into (seq_len + 1) windows: a window
    yields (inputs = w[:-1], targets = w[1:])."""

    def __init__(self, tokens: np.ndarray, seq_len: int) -> None:
        if tokens.ndim != 1:
            raise ValueError("TokenDataset wants a flat token id array")
        self.tokens = tokens
        self.seq_len = int(seq_len)
        self.n_windows = (tokens.size - 1) // self.seq_len
        if self.n_windows <= 0:
            raise ValueError(
                f"{tokens.size} tokens cannot fill a {seq_len}-token window")

    @classmethod
    def from_file(cls, path: str, seq_len: int,
                  dtype=np.int32) -> "TokenDataset":
        """Zero-copy memmap over a flat binary token file: corpora far
        larger than RAM stream through the page cache."""
        return cls(np.memmap(path, dtype=dtype, mode="r"), seq_len)

    def window(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        lo = idx * self.seq_len
        w = np.asarray(self.tokens[lo:lo + self.seq_len + 1])
        return w[:-1], w[1:]

    def __len__(self) -> int:
        return self.n_windows


class DataLoader:
    """Batches of shuffled windows, staged on the device ahead of use.

    Deterministic per (seed, epoch), with the JAX loader's permutation.
    ``device`` defaults to ``cuda``; with ``mesh`` the batches are
    per-rank lists on the mesh's rank devices.
    """

    def __init__(self, dataset: TokenDataset, batch_size: int, device=None,
                 seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, mesh=None) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, int(prefetch))
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"{len(dataset)} windows < batch_size {batch_size}")
        if mesh is not None:
            dp = mesh.shape["dp"]
            if batch_size % dp:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by dp={dp}")
            if not drop_last:
                raise ValueError(
                    "drop_last=False cannot shard a partial final batch "
                    "over the mesh; use drop_last=True")
        self._epoch = 0

    # -- assembly -------------------------------------------------------
    def _batch_indices(self, epoch: int):
        rng = np.random.RandomState((self.seed * 1_000_003 + epoch)
                                    & 0x7FFFFFFF)
        order = rng.permutation(len(self.dataset))
        stop = (len(order) - len(order) % self.batch_size
                if self.drop_last else len(order))
        for lo in range(0, stop, self.batch_size):
            yield order[lo:lo + self.batch_size]

    def _assemble(self, idxs: np.ndarray):
        xs = np.empty((len(idxs), self.dataset.seq_len), np.int32)
        ys = np.empty_like(xs)
        for i, w in enumerate(idxs):
            xs[i], ys[i] = self.dataset.window(int(w))
        if self.mesh is not None:
            from faabric_tpu_torch.models.train import data_sharding

            spec = data_sharding(self.mesh)
            on_cuda = any(d is not None and d.type == "cuda"
                          for d in self.mesh.rank_devices)
            return tuple(spec.shard(torch.from_numpy(a).pin_memory()
                                    if on_cuda else a) for a in (xs, ys))
        if self.device.type == "cpu":
            return torch.from_numpy(xs), torch.from_numpy(ys)
        return tuple(torch.from_numpy(a).pin_memory().to(self.device,
                                                         non_blocking=True)
                     for a in (xs, ys))

    # -- iteration ------------------------------------------------------
    def __iter__(self) -> Iterator:
        """One epoch, prefetched: a daemon worker assembles and stages the
        next batches while the caller consumes the current one."""
        epoch, self._epoch = self._epoch, self._epoch + 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            # Bounded put that gives up when the consumer abandoned the
            # epoch (break or exception): the thread would otherwise park
            # in q.put forever, holding staged batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idxs in self._batch_indices(epoch):
                    if stop.is_set() or not put(self._assemble(idxs)):
                        return
            except Exception as e:  # noqa: BLE001 — surfaced to consumer
                put(e)
            finally:
                put(end)

        t = threading.Thread(target=producer, name="data/prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)
