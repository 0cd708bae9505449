"""The port's snapshot stack against the JAX package's, on the same inputs.

Counterparts of every case of ``tests/unit/test_snapshot.py`` (dirty
trackers, merge diffs, the registry, the delta codec) and of
``tests/unit/test_device_snapshot.py``, and of ``snapshot_of`` in
``tests/unit/test_device_resident.py``. Each scenario runs once on each
package (``REF``, ``PORT``) with the same bytes and keeps the reference
test's own assertions; the two runs' observations (flags, diffs'
offsets, bytes, types and operations, merged images, delta bytes) must
then be equal. Device snapshots run on JAX's CPU device and on CPU
tensors. The snapshot RPC crosses the wire both ways (a port client
against a reference server and the reverse), its frames are byte for
byte the reference's, and ``chip_smoke.py``'s phase 20 runs on a
two-host port runtime at a small width.

The fault-driven trackers (``segv``, ``uffd``) and soft-dirty pages
(``softpte``) change the whole process that loads them (a SIGSEGV
handler, a userfaultfd, ``/proc/self/clear_refs``), so their cases of
both packages run in one subprocess of this module (``--tracker-cases``),
started once for the module; each case reads its result.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PAGE = 4096
KERNEL_MODES = ("segv", "softpte", "uffd")


# ---------------------------------------------------------------------------
# Tracker cases: run by the subprocess only (numpy and util/ of each
# package; no JAX, no torch)
# ---------------------------------------------------------------------------

def _aligned_zeros(n: int) -> np.ndarray:
    """Zeros starting on a page, so a write maps to exactly one page and
    both packages' flags can be held equal."""
    buf = np.zeros(n + PAGE, np.uint8)
    off = (-buf.ctypes.data) % PAGE
    return buf[off:off + n]


def _tracker_or_fallback(dirty, mode):
    tracker = dirty.make_dirty_tracker(mode)
    return tracker, (None if tracker.mode == mode else
                     {"fallback": tracker.mode})


def _detects_all_writes(dirty, mode):
    mem = _aligned_zeros(PAGE * 64 + 100)
    tracker, fallback = _tracker_or_fallback(dirty, mode)
    if fallback:
        return fallback
    tracker.start_tracking(mem)
    mem[10] = 1
    mem[PAGE * 20 + 5] = 2
    mem[PAGE * 64 + 50] = 3
    flags = tracker.get_dirty_pages(mem)
    tracker.stop_tracking(mem)
    assert flags.size == 65
    dirty_set = {int(i) for i in np.where(flags)[0]}
    assert {0, 20, 64} <= dirty_set
    assert dirty_set <= {0, 1, 19, 20, 21, 63, 64}
    mem[PAGE * 40] = 9  # after stop: untracked, no fault
    return {"dirty": sorted(dirty_set)}


def _sparse_cost(dirty, mode):
    mem = _aligned_zeros(64 << 20)
    tracker, fallback = _tracker_or_fallback(dirty, mode)
    if fallback:
        return fallback
    t0 = time.perf_counter()
    tracker.start_tracking(mem)
    for p in (7, 4000, 12000):
        mem[PAGE * p + 1] = 5
    flags = tracker.get_dirty_pages(mem)
    bracket_s = time.perf_counter() - t0
    tracker.stop_tracking(mem)
    assert int(flags.sum()) <= 6
    for p in (7, 4000, 12000):
        assert flags[p] or flags[p - 1] or flags[p + 1]
    assert bracket_s < 0.25, f"bracket took {bracket_s * 1000:.0f}ms"
    return {"dirty": [int(i) for i in np.where(flags)[0]]}


def _reallocation_all_dirty(dirty, mode):
    mem = _aligned_zeros(PAGE * 2)
    tracker, fallback = _tracker_or_fallback(dirty, mode)
    if fallback:
        return fallback
    tracker.start_tracking(mem)
    grown = np.concatenate([mem, np.zeros(PAGE * 2, np.uint8)])
    grown[PAGE] = 7
    flags = tracker.get_dirty_pages(grown)
    tracker.stop_tracking(mem)
    assert flags.size == 4 and flags.all()
    return {"size": int(flags.size), "all": bool(flags.all())}


def _segv_region_hints(dirty, _mode):
    mem = _aligned_zeros(PAGE * 64)
    tracker, fallback = _tracker_or_fallback(dirty, "segv")
    if fallback:
        return fallback
    tracker.start_tracking(mem, region_hints=[(PAGE * 2, PAGE),
                                              (PAGE * 10, 100)])
    mem[PAGE * 2 + 5] = 1
    mem[PAGE * 10 + 50] = 2
    mem[PAGE * 30] = 3  # outside the hints: unprotected, untracked
    flags = tracker.get_dirty_pages(mem)
    tracker.stop_tracking(mem)
    dirty_set = {int(i) for i in np.where(flags)[0]}
    assert {2, 10} <= dirty_set and 30 not in dirty_set
    assert dirty_set <= {1, 2, 3, 9, 10, 11}
    return {"dirty": sorted(dirty_set)}


def _segv_concurrent_writes(dirty, _mode):
    mem = _aligned_zeros(8 << 20)
    tracker, fallback = _tracker_or_fallback(dirty, "segv")
    if fallback:
        return fallback
    tracker.start_tracking(mem)
    pages = {t: list(range(t * 100, t * 100 + 20)) for t in range(8)}

    def writer(ps):
        for p in ps:
            mem[PAGE * p + 3] = 7

    threads = [threading.Thread(target=writer, args=(ps,))
               for ps in pages.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    flags = tracker.get_dirty_pages(mem)
    tracker.stop_tracking(mem)
    for ps in pages.values():
        for p in ps:
            assert flags[p] or flags[p - 1] or flags[p + 1], p
    return {"dirty": [int(i) for i in np.where(flags)[0]]}


def _softpte_falls_back(dirty, _mode):
    tracker = dirty.make_dirty_tracker("softpte")
    if dirty.softpte_available():
        assert tracker.mode == "softpte"
    else:
        assert tracker.mode in ("segv", "native")
    mem = _aligned_zeros(PAGE * 4)
    tracker.start_tracking(mem)
    mem[PAGE * 2] = 1
    flags = tracker.get_dirty_pages(mem)
    tracker.stop_tracking(mem)
    assert flags[2] or flags[1] or flags[3]
    return {"mode": tracker.mode,
            "dirty": [int(i) for i in np.where(flags)[0]]}


TRACKER_CASES = {
    **{f"detects_all_writes[{m}]": (_detects_all_writes, m)
       for m in KERNEL_MODES},
    **{f"sparse_cost[{m}]": (_sparse_cost, m) for m in KERNEL_MODES},
    **{f"reallocation_all_dirty[{m}]": (_reallocation_all_dirty, m)
       for m in KERNEL_MODES},
    "segv_region_hints": (_segv_region_hints, "segv"),
    "segv_concurrent_writes": (_segv_concurrent_writes, "segv"),
    "softpte_falls_back": (_softpte_falls_back, "softpte"),
}


def _run_tracker_cases() -> dict:
    import faabric_tpu.util.dirty as ref_dirty
    import faabric_tpu_torch.util.dirty as port_dirty

    results = {}
    for name, (fn, mode) in TRACKER_CASES.items():
        results[name] = {}
        for label, mod in (("ref", ref_dirty), ("port", port_dirty)):
            try:
                results[name][label] = {"ok": True, "obs": fn(mod, mode)}
            except Exception as e:  # noqa: BLE001 — reported per case
                results[name][label] = {"ok": False,
                                        "error": f"{type(e).__name__}: {e}"}
    return results


if __name__ == "__main__" and "--tracker-cases" in sys.argv:
    print("TRACKER_RESULTS " + json.dumps(_run_tracker_cases()), flush=True)
    sys.exit(0)


# ---------------------------------------------------------------------------
# The test process from here on
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import socket  # noqa: E402
import struct  # noqa: E402
import subprocess  # noqa: E402
import types  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

pytest.importorskip("jax")


def _build_reference_native_once() -> None:
    """Build the JAX package's native helpers before its
    ``tests/unit/test_snapshot.py`` is collected. That module picks its
    tracker cases by loading ``libsegvtracker.so`` and
    ``libuffdtracker.so`` while it is collected, and its loader compiles
    straight into ``native/build/``: in a fresh checkout every xdist
    worker compiles at once, one can load a library another is still
    writing, and it then collects other cases than its peers (xdist
    refuses the run). This module is collected first in every worker;
    here the workers build one at a time under a file lock, in a
    subprocess (the trackers install process-wide state), and the later
    ones find the libraries built."""
    import fcntl

    lock_dir = ROOT / "native" / "build"
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / ".collect.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        subprocess.run(
            [sys.executable, "-c",
             "from faabric_tpu.util import native as n\n"
             "n.get_shmring_lib(); n.get_pagediff_lib()\n"
             "n.get_segv_lib(); n.get_uffd_lib()\n"],
            cwd=ROOT, capture_output=True, timeout=600)


_build_reference_native_once()

import faabric_tpu.device_plane.copies as ref_copies  # noqa: E402
import faabric_tpu.snapshot as ref_snapshot  # noqa: E402
import faabric_tpu.snapshot.device_snapshot as ref_devsnap  # noqa: E402
import faabric_tpu.snapshot.remote as ref_remote  # noqa: E402
import faabric_tpu.state as ref_state  # noqa: E402
import faabric_tpu.transport.common as ref_common  # noqa: E402
import faabric_tpu.util.config as ref_config  # noqa: E402
import faabric_tpu.util.delta as ref_delta  # noqa: E402
import faabric_tpu.util.dirty as ref_dirty  # noqa: E402
import faabric_tpu.util.testing as ref_testing  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import faabric_tpu_torch.device_plane.copies as port_copies  # noqa: E402
import faabric_tpu_torch.snapshot as port_snapshot  # noqa: E402
import faabric_tpu_torch.snapshot.device_snapshot as port_devsnap  # noqa: E402
import faabric_tpu_torch.snapshot.remote as port_remote  # noqa: E402
import faabric_tpu_torch.state as port_state  # noqa: E402
import faabric_tpu_torch.transport.common as port_common  # noqa: E402
import faabric_tpu_torch.util.config as port_config  # noqa: E402
import faabric_tpu_torch.util.delta as port_delta  # noqa: E402
import faabric_tpu_torch.util.dirty as port_dirty  # noqa: E402
import faabric_tpu_torch.util.testing as port_testing  # noqa: E402
from faabric_tpu_torch.transport.message import (  # noqa: E402
    HEADER_FMT,
    HEADER_LEN,
    TransportMessage,
    send_frame,
)


@dataclasses.dataclass
class Pkg:
    """One package's snapshot names, so one scenario runs on either."""
    name: str
    snapshot: types.ModuleType
    remote: types.ModuleType
    dirty: types.ModuleType
    delta: types.ModuleType
    common: types.ModuleType
    config: types.ModuleType
    testing: types.ModuleType

    def __repr__(self) -> str:
        return self.name


REF = Pkg("faabric_tpu", ref_snapshot, ref_remote, ref_dirty, ref_delta,
          ref_common, ref_config, ref_testing)
PORT = Pkg("faabric_tpu_torch", port_snapshot, port_remote, port_dirty,
           port_delta, port_common, port_config, port_testing)


def both(scenario, *args):
    """Run ``scenario(pk, *args)`` on the reference, then on the port;
    their observations must be equal. Returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want, (got, want)
    return got


@pytest.fixture(autouse=True)
def _isolate():
    yield
    for pk in (REF, PORT):
        pk.testing.set_mock_mode(False)
        pk.remote.clear_mock_snapshot_requests()
        pk.common.clear_host_aliases()
        pk.config.get_system_config().reset()
    port_state.reset_device_handles()


def diff_obs(diffs) -> list:
    return [(d.offset, bytes(d.data), int(d.data_type), int(d.operation))
            for d in diffs]


def dirty_idx(flags) -> list:
    return [int(i) for i in np.where(flags)[0]]


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

def _config(pk, env):
    defaults = pk.config.SystemConfig()
    conf = pk.config.SystemConfig()
    old = {k: os.environ.get(k) for k in env}
    try:
        os.environ.update(env)
        conf.reset()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fields = ("dirty_tracking_mode", "snapshot_server_threads")
    return ([getattr(defaults, f) for f in fields],
            [getattr(conf, f) for f in fields])


@pytest.mark.parametrize("env", [
    {},
    {"DIRTY_TRACKING_MODE": "segv", "SNAPSHOT_SERVER_THREADS": "5"},
    {"DIRTY_TRACKING_MODE": "uffd", "SNAPSHOT_SERVER_THREADS": "many"},
])
def test_snapshot_config_knobs(env):
    defaults, read = both(_config, env)
    # The dataclass default is "hash", the environment's "native"
    assert defaults == ["hash", 2]
    if not env:
        assert read == ["native", 2]


# ---------------------------------------------------------------------------
# Dirty tracking in this process (compare, native, hash, none)
# ---------------------------------------------------------------------------

def _tracker_modes(pk, mode):
    mem = np.zeros(PAGE * 4 + 100, dtype=np.uint8)
    tracker = pk.dirty.make_dirty_tracker(mode)
    tracker.start_tracking(mem)
    mem[10] = 1
    mem[PAGE * 2 + 5] = 2
    mem[PAGE * 4 + 50] = 3
    flags = tracker.get_dirty_pages(mem)
    assert flags.size == 5
    return tracker.mode, flags.tolist()


@pytest.mark.parametrize("mode", ["compare", "native", "hash", "none"])
def test_dirty_tracker_modes(mode):
    got_mode, flags = both(_tracker_modes, mode)
    assert got_mode == mode
    if mode == "none":
        assert all(flags)
    else:
        assert dirty_idx(np.array(flags)) == [0, 2, 4]


def _thread_local(pk, mode):
    mem = np.zeros(PAGE * 2, dtype=np.uint8)
    tracker = pk.dirty.make_dirty_tracker(mode)
    tracker.start_tracking(mem)
    mem[0] = 1
    tracker.start_thread_local_tracking(mem)
    mem[PAGE] = 2
    return (dirty_idx(tracker.get_thread_local_dirty_pages(mem)),
            dirty_idx(tracker.get_dirty_pages(mem)))


@pytest.mark.parametrize("mode", ["compare", "native", "hash"])
def test_thread_local_tracking_isolated(mode):
    assert both(_thread_local, mode) == ([1], [0, 1])


def _growth(pk, mode):
    mem = np.zeros(PAGE * 2, dtype=np.uint8)
    tracker = pk.dirty.make_dirty_tracker(mode)
    tracker.start_tracking(mem)
    grown = np.concatenate([mem, np.zeros(PAGE * 2 + 10, np.uint8)])
    grown[PAGE] = 7
    flags = tracker.get_dirty_pages(grown)
    return int(flags.size), dirty_idx(flags)


@pytest.mark.parametrize("mode", ["compare", "native", "hash"])
def test_dirty_tracking_memory_growth(mode):
    assert both(_growth, mode) == (5, [1, 2, 3, 4])


def _hints(pk, mode):
    mem = np.zeros(PAGE * 64, np.uint8)
    tracker = pk.dirty.make_dirty_tracker(mode)
    hints = [(PAGE * 2, PAGE), (PAGE * 10, 100)]
    tracker.start_tracking(mem, region_hints=hints)
    mem[PAGE * 2 + 5] = 1
    mem[PAGE * 10 + 50] = 2
    mem[PAGE * 30] = 3
    flags = tracker.get_dirty_pages(mem)
    tracker.start_thread_local_tracking(mem, region_hints=hints)
    mem[PAGE * 10] = 9
    local = tracker.get_thread_local_dirty_pages(mem)
    return int(flags.size), dirty_idx(flags), dirty_idx(local)


@pytest.mark.parametrize("mode", ["compare", "native", "hash"])
def test_region_hints_track_only_hinted_pages(mode):
    assert both(_hints, mode) == (64, [2, 10], [10])


def _hint_trailing(pk, mode):
    mem = np.zeros(PAGE * 3 + 100, np.uint8)
    tracker = pk.dirty.make_dirty_tracker(mode)
    tracker.start_tracking(mem, region_hints=[(PAGE * 3, 100)])
    mem[PAGE * 3 + 10] = 1
    return dirty_idx(tracker.get_dirty_pages(mem))


@pytest.mark.parametrize("mode", ["compare", "hash"])
def test_region_hints_partial_trailing_page(mode):
    assert both(_hint_trailing, mode) == [3]


def _page_flags_and_hints(pk):
    rng = np.random.RandomState(3)
    old = rng.randint(0, 255, PAGE * 9 + 17, dtype=np.uint8)
    new = np.concatenate([old, np.ones(PAGE + 3, np.uint8)])
    new[[5, PAGE * 4, PAGE * 9 + 16]] ^= 1
    return (pk.dirty.page_flags(old, new).tolist(),
            pk.dirty.page_flags(old, new, 1024).tolist(),
            pk.dirty.hint_page_indices(
                [(0, 0), (PAGE - 1, 2), (PAGE * 7, PAGE * 5)], 9).tolist(),
            pk.dirty.n_pages(PAGE * 9 + 17))


def test_page_flags_and_hint_pages():
    flags, fine, hints, pages = both(_page_flags_and_hints)
    assert dirty_idx(np.array(flags)) == [0, 4, 9, 10]
    assert hints == [0, 1, 7, 8] and pages == 10 and len(fine) == 41


# ---------------------------------------------------------------------------
# Snapshot diffs and merge regions
# ---------------------------------------------------------------------------

def make_mem(size=PAGE * 4):
    return np.zeros(size, dtype=np.uint8)


def all_dirty(mem):
    return np.ones((mem.size + PAGE - 1) // PAGE, dtype=bool)


def _bytewise(pk):
    mem = make_mem()
    snap = pk.snapshot.SnapshotData(mem.tobytes())
    mem[100:110] = 42
    mem[PAGE + 500] = 7
    diffs = snap.diff_with_dirty_regions(mem, all_dirty(mem))
    assert all(d.operation == pk.snapshot.SnapshotMergeOperation.BYTEWISE
               for d in diffs)
    covered = [(d.offset, d.offset + len(d.data)) for d in diffs]
    assert any(lo <= 100 and hi >= 110 for lo, hi in covered)
    assert any(lo <= PAGE + 500 < hi for lo, hi in covered)
    assert sum(len(d.data) for d in diffs) <= 3 * 128
    for d in diffs:
        snap.apply_diff(d)
    np.testing.assert_array_equal(snap.data, mem)
    return diff_obs(diffs), snap.to_bytes()


def test_bytewise_diff_chunks():
    both(_bytewise)


def _bytewise_numpy_path(pk, monkeypatch):
    """The chunked compare without the native range scanner."""
    monkeypatch.setattr(
        f"{pk.name}.util.native.get_pagediff_lib", lambda: None)
    rng = np.random.RandomState(4)
    base = rng.randint(0, 255, PAGE * 3 + 50, dtype=np.uint8)
    snap = pk.snapshot.SnapshotData(base)
    mem = base.copy()
    mem[[0, 127, 128, 700, 701, PAGE * 3 + 49]] ^= 0xFF
    diffs = snap.diff_with_dirty_regions(mem, all_dirty(mem))
    return diff_obs(diffs)


def test_bytewise_diffs_without_the_native_scanner(monkeypatch):
    with_native = both(lambda pk: diff_obs(
        pk.snapshot.SnapshotData(np.zeros(8, np.uint8))
        .diff_with_dirty_regions(np.ones(8, np.uint8), np.ones(1, bool))))
    assert with_native == [(0, bytes([1] * 8), 0, 0)]
    got = both(_bytewise_numpy_path, monkeypatch)
    assert [o for o, *_ in got] == [0, 640, PAGE * 3]


def _scattered_sum(pk):
    """A FLOAT SUM region over 64 pages, every third page dirty, and
    bytewise gaps around it: the region's delta is one diff."""
    rng = np.random.RandomState(9)
    base = rng.rand(PAGE * 64 // 4 + 300).astype(np.float32).view(np.uint8)
    snap = pk.snapshot.SnapshotData(base)
    snap.add_merge_region(PAGE, PAGE * 60,
                          pk.snapshot.SnapshotDataType.FLOAT,
                          pk.snapshot.SnapshotMergeOperation.SUM)
    snap.fill_gaps_with_bytewise_regions()
    mem = base.copy()
    flags = np.zeros(-(-mem.size // PAGE), bool)
    flags[::3] = True
    for p in np.flatnonzero(flags):
        mem[p * PAGE:p * PAGE + 4].view(np.float32)[0] += 1.5
    return diff_obs(snap.diff_with_dirty_regions(mem, flags))


def test_sum_region_diffs_once_over_scattered_pages(monkeypatch):
    """Dirty pages scattered over a SUM region give the reference's diffs,
    with the region's delta computed once, not once a dirty range."""
    calls = []
    real = port_snapshot.SnapshotData._arith_diff
    monkeypatch.setattr(port_snapshot.SnapshotData, "_arith_diff",
                        lambda self, cur, region: calls.append(1)
                        or real(self, cur, region))
    got = both(_scattered_sum)
    assert calls == [1]
    assert sum(op == int(REF.snapshot.SnapshotMergeOperation.SUM)
               for *_, op in got) == 1
    assert len(got) > 2


ARITH_CASES = [
    ("INT", np.int32, "SUM", 10, 25, 25),
    ("INT", np.int32, "SUBTRACT", 100, 70, 70),
    ("DOUBLE", np.float64, "PRODUCT", 4.0, 8.0, 8.0),
    ("LONG", np.int64, "MAX", 50, 90, 90),
    ("LONG", np.int64, "MIN", 50, 20, 20),
]


def _arith(pk, dtype, np_dtype, op, a, b, expected):
    mem = make_mem()
    width = np.dtype(np_dtype).itemsize
    mem[:width].view(np_dtype)[0] = a
    snap = pk.snapshot.SnapshotData(mem.tobytes())
    snap.add_merge_region(0, width, pk.snapshot.SnapshotDataType[dtype],
                          pk.snapshot.SnapshotMergeOperation[op])
    mem[:width].view(np_dtype)[0] = b
    diffs = snap.diff_with_dirty_regions(mem, all_dirty(mem))
    assert len(diffs) == 1
    snap.apply_diff(diffs[0])
    assert snap.data[:width].view(np_dtype)[0] == expected
    return diff_obs(diffs), snap.to_bytes()


@pytest.mark.parametrize("dtype,np_dtype,op,a,b,expected", ARITH_CASES)
def test_arithmetic_merge_ops(dtype, np_dtype, op, a, b, expected):
    both(_arith, dtype, np_dtype, op, a, b, expected)


def _sum_concurrent(pk):
    base = make_mem()
    base[:4].view(np.int32)[0] = 1000
    snap = pk.snapshot.SnapshotData(base.tobytes())
    snap.add_merge_region(0, 4, pk.snapshot.SnapshotDataType.INT,
                          pk.snapshot.SnapshotMergeOperation.SUM)
    mem_a = base.copy()
    mem_a[:4].view(np.int32)[0] = 1010
    mem_b = base.copy()
    mem_b[:4].view(np.int32)[0] = 1007
    diffs_a = snap.diff_with_dirty_regions(mem_a, all_dirty(mem_a))
    diffs_b = snap.diff_with_dirty_regions(mem_b, all_dirty(mem_b))
    snap.queue_diffs(diffs_a)
    snap.queue_diffs(diffs_b)
    queued = snap.queued_diff_count()
    assert snap.write_queued_diffs() == 2
    return (queued, diff_obs(diffs_a + diffs_b),
            int(snap.data[:4].view(np.int32)[0]))


def test_sum_region_merges_concurrent_writers():
    assert both(_sum_concurrent)[::2] == (2, 1017)


def _ignore_xor(pk):
    op = pk.snapshot.SnapshotMergeOperation
    mem = make_mem()
    snap = pk.snapshot.SnapshotData(mem.tobytes())
    snap.add_merge_region(0, 64, operation=op.IGNORE)
    snap.add_merge_region(64, 64, operation=op.XOR)
    mem[0:4] = 9
    mem[64:68] = 5
    diffs = snap.diff_with_dirty_regions(mem, all_dirty(mem))
    xor_diffs = [d for d in diffs if d.operation == op.XOR]
    assert len(xor_diffs) == 1
    assert not any(d.offset < 64 for d in diffs)
    snap.apply_diff(xor_diffs[0])
    np.testing.assert_array_equal(snap.data[64:68],
                                  np.full(4, 5, dtype=np.uint8))
    return diff_obs(diffs), snap.to_bytes()


def test_ignore_and_xor_regions():
    both(_ignore_xor)


def _fill_gaps(pk):
    snap = pk.snapshot.SnapshotData(1024)
    snap.add_merge_region(100, 48, pk.snapshot.SnapshotDataType.INT,
                          pk.snapshot.SnapshotMergeOperation.SUM)
    with pytest.raises(ValueError):
        snap.add_merge_region(0, 3, pk.snapshot.SnapshotDataType.INT,
                              pk.snapshot.SnapshotMergeOperation.SUM)
    snap.fill_gaps_with_bytewise_regions()
    regions = snap.get_merge_regions()
    covered = sorted((r.offset, r.end) for r in regions)
    assert covered[0][0] == 0 and covered[-1][1] == 1024
    for (_a, b), (c, _d) in zip(covered, covered[1:]):
        assert b >= c
    return [r.to_dict() for r in regions]


def test_fill_gaps_with_bytewise_regions():
    assert len(both(_fill_gaps)) == 3


def _map_to_memory(pk):
    content = np.random.RandomState(0).randint(0, 255, PAGE,
                                               dtype=np.uint8)
    snap = pk.snapshot.SnapshotData(content.tobytes())
    target = np.full(PAGE * 2, 0xFF, dtype=np.uint8)
    snap.map_to_memory(target)
    np.testing.assert_array_equal(target[:PAGE], content)
    assert (target[PAGE:] == 0).all()
    with pytest.raises(ValueError):
        snap.map_to_memory(np.zeros(PAGE - 1, np.uint8))
    return target.tobytes()


def test_map_to_memory_restore():
    both(_map_to_memory)


def _resize_and_growth(pk):
    snap = pk.snapshot.SnapshotData(np.arange(100, dtype=np.uint8),
                                    max_size=300)
    snap.resize(200)
    grown = snap.to_bytes()
    snap.resize(50)
    with pytest.raises(ValueError):
        snap.resize(301)
    # An extension diff past the bound grows the image anyway
    snap.apply_diff(pk.snapshot.SnapshotDiff(400, b"\x07" * 8))
    # Memory grown past the snapshot: the dirty extension is a raw diff
    mem = np.zeros(PAGE * 2, np.uint8)
    mem[PAGE + 3] = 1
    small = pk.snapshot.SnapshotData(PAGE)
    diffs = small.diff_with_dirty_regions(mem, all_dirty(mem))
    return grown, snap.to_bytes(), snap.max_size, diff_obs(diffs)


def test_resize_and_extension_diffs():
    grown, image, max_size, diffs = both(_resize_and_growth)
    assert len(grown) == 200 and len(image) == 408 and max_size == 408
    assert diffs == [(PAGE, mem_tail(), 0, 0)]


def mem_tail() -> bytes:
    tail = np.zeros(PAGE, np.uint8)
    tail[3] = 1
    return tail.tobytes()


def _registry(pk):
    reg = pk.snapshot.SnapshotRegistry()
    snap = pk.snapshot.SnapshotData(64)
    reg.register_snapshot("k", snap)
    assert reg.snapshot_exists("k")
    assert reg.get_snapshot("k") is snap
    assert reg.get_snapshot_count() == 1
    resident = reg.resident_bytes()
    reg.delete_snapshot("k")
    with pytest.raises(KeyError):
        reg.get_snapshot("k")
    with pytest.raises(ValueError):
        reg.register_snapshot("", snap)
    return resident, reg.try_get_snapshot("k"), reg.get_snapshot_count()


def test_registry():
    assert both(_registry) == (64, None, 0)


# ---------------------------------------------------------------------------
# Delta encoding: the port's bytes are the reference's
# ---------------------------------------------------------------------------

def _delta_roundtrip(pk, spec):
    rng = np.random.RandomState(1)
    old = rng.randint(0, 255, 3 * PAGE + 77, dtype=np.uint8)
    new = old.copy()
    new[100:200] = 1
    new[PAGE * 2:PAGE * 2 + 50] = 2
    settings = pk.delta.DeltaSettings.parse(spec)
    delta = pk.delta.serialize_delta(settings, old.tobytes(), new.tobytes())
    out = pk.delta.apply_delta(delta, old.tobytes())
    assert bytes(out) == new.tobytes()
    assert len(delta) < new.size
    reuse = np.empty(new.size, np.uint8)
    assert bytes(pk.delta.apply_delta(delta, old.tobytes(), out=reuse)) \
        == new.tobytes()
    inplace = old.copy()
    assert bytes(pk.delta.apply_delta(delta, inplace, out=inplace)) \
        == new.tobytes()
    return delta, dataclasses.astuple(settings)


@pytest.mark.parametrize("spec", ["pages=4096", "pages=4096;xor",
                                  "pages=4096;xor;zlib=6",
                                  "pages=1024;zlib=1"])
def test_delta_roundtrip(spec):
    both(_delta_roundtrip, spec)


def _delta_grows(pk):
    old = np.zeros(PAGE, dtype=np.uint8)
    new = np.ones(PAGE * 2, dtype=np.uint8)
    settings = pk.delta.DeltaSettings.parse("pages=4096;zlib=1")
    delta = pk.delta.serialize_delta(settings, old.tobytes(), new.tobytes())
    assert bytes(pk.delta.apply_delta(delta, old.tobytes())) \
        == new.tobytes()
    shrink = pk.delta.serialize_delta(settings, new, old)
    assert bytes(pk.delta.apply_delta(shrink, new)) == old.tobytes()
    return delta, shrink


def test_delta_grows_and_shrinks():
    both(_delta_grows)


def _delta_parts_and_probes(pk, spec):
    rng = np.random.RandomState(2)
    old = rng.randint(0, 255, 40 * PAGE + 9, dtype=np.uint8)
    new = old.copy()
    new[rng.randint(0, new.size, 300)] ^= 0x5A  # >64 KiB of commands
    parts = [new[:100], new[100:9 * PAGE], new[9 * PAGE:]]
    grown_parts = parts + [np.full(3 * PAGE, 9, np.uint8)]
    settings = pk.delta.DeltaSettings.parse(spec)
    whole = pk.delta.serialize_delta(settings, old, new)
    split = pk.delta.serialize_delta_parts(settings, old, parts)
    grown = pk.delta.serialize_delta_parts(settings, old, grown_parts)
    assert bytes(pk.delta.apply_delta(split, old)) == new.tobytes()
    assert bytes(pk.delta.apply_delta(grown, old)) \
        == np.concatenate(grown_parts).tobytes()
    sparse = old.copy()
    sparse[[0, PAGE * 30]] ^= 1
    return (whole, split, grown,
            pk.delta.sampled_overlap(old, sparse),
            pk.delta.sampled_overlap(old.tobytes(), new.tobytes(), samples=5),
            pk.delta.sampled_overlap(old, new[:-1]),
            pk.delta.sampled_overlap_parts(old, parts),
            pk.delta.sampled_overlap_parts(old, grown_parts),
            pk.delta.delta_is_xor_only(whole),
            pk.delta.delta_is_xor_only(grown),
            pk.delta.delta_is_xor_only(b"\x01"))


@pytest.mark.parametrize("spec", ["pages=4096;xor;zlib=1", "pages=4096;zlib=9",
                                  "pages=512;xor"])
def test_delta_parts_overlap_probes_and_xor_only(spec):
    obs = both(_delta_parts_and_probes, spec)
    assert obs[-1] is False and obs[-2] is False
    assert obs[-3] == ("xor" in spec)


# ---------------------------------------------------------------------------
# Kernel-assisted trackers: one subprocess runs every case of both
# packages (see the module docstring)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracker_results():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH", "")]))}
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), "--tracker-cases"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("TRACKER_RESULTS ")]
    assert proc.returncode == 0 and lines, (proc.returncode, proc.stdout,
                                            proc.stderr[-4000:])
    return json.loads(lines[-1].removeprefix("TRACKER_RESULTS "))


@pytest.mark.parametrize("case", list(TRACKER_CASES))
def test_kernel_tracker_cases(tracker_results, case):
    """The reference's fault-driven and soft-dirty cases, each package in
    the subprocess on page-aligned images: both keep the reference test's
    assertions and report the same pages; where a mode is missing from
    this kernel, both fall back to the same one."""
    res = tracker_results[case]
    assert res["ref"]["ok"], res["ref"]
    assert res["port"]["ok"], res["port"]
    assert res["port"]["obs"] == res["ref"]["obs"]


def test_tracker_modes_never_load_in_the_test_process():
    """Nothing of this module loaded a SIGSEGV handler or a userfaultfd
    of the port here: those libraries stay in the subprocess."""
    import faabric_tpu_torch.util.native as port_native

    assert not {"segv_tracker", "uffd_tracker"} & set(port_native._cache)
    assert "make_dirty_tracker" in vars(port_dirty)


# ---------------------------------------------------------------------------
# Device snapshots: JAX arrays on JAX's CPU device, CPU tensors
# ---------------------------------------------------------------------------

def _jx(a):
    return jax.device_put(a, jax.local_devices()[0])


def test_clean_array_has_no_dirty_pages():
    host = np.arange(4096 * 3, dtype=np.float32)
    ref = ref_devsnap.DeviceSnapshot(_jx(host))
    port = port_devsnap.DeviceSnapshot(torch.from_numpy(host.copy()))
    assert not ref.dirty_pages(_jx(host)).any()
    assert not port.dirty_pages(torch.from_numpy(host.copy())).any()
    assert ref.diff(_jx(host)) == port.diff(torch.from_numpy(host)) == []
    assert (port.n_pages, port.page_words) == (ref.n_pages, ref.page_words)


def test_single_write_flags_single_page():
    """Also the counted copies: the flag vector, then the one gathered
    page (a count whose bucket is itself, so the reference gathers no
    padding)."""
    n = port_snapshot.DEVICE_PAGE_SIZE
    assert n == ref_snapshot.DEVICE_PAGE_SIZE == PAGE
    ref = ref_devsnap.DeviceSnapshot(jnp.zeros(n * 4, dtype=jnp.uint8))
    port = port_devsnap.DeviceSnapshot(torch.zeros(n * 4, dtype=torch.uint8))
    cur = np.zeros(n * 4, np.uint8)
    cur[n * 2 + 17] = 9
    copies = []
    for copies_mod, snap, arr in (
            (ref_copies, ref, jnp.asarray(cur)),
            (port_copies, port, torch.from_numpy(cur.copy()))):
        copies_mod.reset_device_copy_totals()
        flags = snap.dirty_pages(arr)
        diffs = snap.diff(arr)
        copies.append((flags.tolist(), diff_obs(diffs),
                       copies_mod.device_copy_totals()))
    assert copies[1] == copies[0]
    flags, diffs, totals = copies[1]
    assert flags == [False, False, True, False]
    assert diffs == [(n * 2, bytes(17) + b"\x09" + bytes(n - 18), 0, 0)]
    assert totals["by_reason"] == {"d2h.snapshot": {"count": 3,
                                                    "bytes": 4 + 4 + n}}


def _jax_and_torch_diffs(host, writes, dtype_j, dtype_t, update=False):
    """The same writes ((index, value) on the flat array) on a JAX array
    and a tensor; returns both snapshots, both current values and both
    diff lists."""
    ja, ta = jnp.asarray(host, dtype_j), torch.from_numpy(host).to(dtype_t)
    ref, port = ref_devsnap.DeviceSnapshot(ja), port_devsnap.DeviceSnapshot(ta)
    jc, tc = ja, ta.clone()
    for idx, val in writes:
        jc = jc.at[idx].set(jnp.asarray(val, dtype_j))
        tc[idx] = val
    return (ref, port, jc, tc, ref.diff(jc, update_baseline=update),
            port.diff(tc, update_baseline=update))


def test_adjacent_dirty_pages_coalesce():
    n = PAGE
    ref, port, _, _, rd, pd = _jax_and_torch_diffs(
        np.zeros(n * 6, np.uint8), [(n, 1), (n * 2, 2), (n * 4, 4)],
        jnp.uint8, torch.uint8)
    assert diff_obs(pd) == diff_obs(rd)
    assert [d.offset for d in pd] == [n, n * 4]
    assert [len(d.data) for d in pd] == [2 * n, n]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_typed_arrays_diff_byte_exact(dtype):
    host = np.random.RandomState(0).randn(1000, 33).astype(np.float32)
    ref, port, jc, tc, rd, pd = _jax_and_torch_diffs(
        host, [((500, 7), 123), ((999, 32), -1)], getattr(jnp, dtype),
        getattr(torch, dtype))
    assert pd and diff_obs(pd) == diff_obs(rd)
    np.testing.assert_array_equal(port.baseline_bytes, ref.baseline_bytes)
    img = port.baseline_bytes.copy()
    for d in pd:
        img[d.offset:d.offset + len(d.data)] = np.frombuffer(d.data, np.uint8)
    expect = np.asarray(
        jax.lax.bitcast_convert_type(jc.reshape(-1), jnp.uint8)).reshape(-1)
    np.testing.assert_array_equal(img, expect)
    np.testing.assert_array_equal(
        img, tc.reshape(-1).view(torch.uint8).numpy())


def test_unaligned_size_final_page_clipped():
    n = PAGE + 100
    ref, port, _, _, rd, pd = _jax_and_torch_diffs(
        np.zeros(n, np.uint8), [(n - 1, 7)], jnp.uint8, torch.uint8)
    assert diff_obs(pd) == diff_obs(rd)
    assert len(pd) == 1 and pd[0].offset == PAGE
    assert len(pd[0].data) == 100 and pd[0].data[-1] == 7


def test_device_diffs_queue_onto_host_snapshot():
    host = np.repeat(np.arange(PAGE, dtype=np.uint8), 3)
    ref, port, jc, tc, rd, pd = _jax_and_torch_diffs(
        host, [(5000, 255)], jnp.uint8, torch.uint8)
    images = []
    for pk, snap, diffs in ((REF, ref, rd), (PORT, port, pd)):
        host_snap = pk.snapshot.SnapshotData(snap.baseline_bytes)
        host_snap.queue_diffs(diffs)
        host_snap.write_queued_diffs()
        images.append(host_snap.to_bytes())
    assert images[0] == images[1] == tc.numpy().tobytes()
    np.testing.assert_array_equal(np.frombuffer(images[0], np.uint8),
                                  np.asarray(jc))


def test_apply_diffs_restore_roundtrip():
    host = np.random.RandomState(1).randn(512, 64).astype(np.float32)
    ja, ta = jnp.asarray(host), torch.from_numpy(host.copy())
    ref, port = ref_devsnap.DeviceSnapshot(ja), port_devsnap.DeviceSnapshot(ta)
    jc = ja.at[100, 3].add(5.0).at[400, 60].set(0.0)
    tc = ta.clone()
    tc[100, 3] += 5.0
    tc[400, 60] = 0.0
    rd, pd = ref.diff(jc), port.diff(tc)
    assert diff_obs(pd) == diff_obs(rd)
    port_copies.reset_device_copy_totals()
    rebuilt = port.apply_diffs(port.restore(), pd)
    assert port_copies.device_copy_totals()["by_reason"] == {
        "d2h.snapshot": {"count": 1, "bytes": host.nbytes},
        "h2d.snapshot": {"count": 1, "bytes": host.nbytes}}
    want = np.asarray(ref.apply_diffs(ref.restore(), rd))
    assert rebuilt.dtype == torch.float32 and rebuilt.shape == (512, 64)
    np.testing.assert_array_equal(rebuilt.numpy(), want)
    np.testing.assert_array_equal(rebuilt.numpy(), np.asarray(jc))


def test_update_baseline_resets_dirty_state():
    ref, port, jc, tc, rd, pd = _jax_and_torch_diffs(
        np.zeros(PAGE * 2, np.uint8), [(0, 1)], jnp.uint8, torch.uint8,
        update=True)
    assert pd and diff_obs(pd) == diff_obs(rd)
    assert port.diff(tc) == ref.diff(jc) == []
    restored = port.restore()
    assert int(restored[0]) == int(np.asarray(ref.restore())[0]) == 1
    restored[1] = 5  # a copy: the baseline stays
    assert port.diff(tc) == []
    port.update_baseline(torch.ones(PAGE * 2, dtype=torch.uint8))
    ref.update_baseline(jnp.ones(PAGE * 2, dtype=jnp.uint8))
    assert port.dirty_pages(tc).tolist() == ref.dirty_pages(jc).tolist() \
        == [True, True]


@pytest.mark.parametrize("n", [PAGE * 3, PAGE * 3 + 100, 100])
def test_diff_update_baseline_refreshes_dirty_pages(n):
    # Writes in the first page and the last (partial where n is not a
    # whole number of pages); the refreshed baseline is the current image
    ref, port, jc, tc, rd, pd = _jax_and_torch_diffs(
        np.arange(n, dtype=np.uint8), [(1, 200), (n - 1, 7)], jnp.uint8,
        torch.uint8, update=True)
    assert pd and diff_obs(pd) == diff_obs(rd)
    np.testing.assert_array_equal(port.baseline_bytes, ref.baseline_bytes)
    np.testing.assert_array_equal(port.baseline_bytes, tc.numpy())
    assert port.diff(tc) == ref.diff(jc) == []
    tc[n // 2] += 1
    jc = jc.at[n // 2].add(1)
    assert diff_obs(port.diff(tc)) == diff_obs(ref.diff(jc))


def test_shape_dtype_mismatch_rejected():
    ref = ref_devsnap.DeviceSnapshot(jnp.zeros(100, jnp.float32))
    port = port_devsnap.DeviceSnapshot(torch.zeros(100))
    for snap, bad in ((ref, jnp.zeros(101, jnp.float32)),
                      (ref, jnp.zeros(100, jnp.int32)),
                      (port, torch.zeros(101)),
                      (port, torch.zeros(100, dtype=torch.int32))):
        with pytest.raises(ValueError, match="tracks"):
            snap.dirty_pages(bad)


def test_many_dirty_counts_reuse_bucketed_gathers():
    sizes = (1, 2, 3, 5, 9, 64)
    assert [port_devsnap._bucket(n) for n in sizes] \
        == [ref_devsnap._bucket(n) for n in sizes] == [1, 2, 4, 8, 16, 64]
    for k in (1, 3, 5):
        writes = [(PAGE * 2 * p, p + 1) for p in range(k)]
        *_, rd, pd = _jax_and_torch_diffs(np.zeros(PAGE * 16, np.uint8),
                                          writes, jnp.uint8, torch.uint8)
        assert len(pd) == k and diff_obs(pd) == diff_obs(rd)


def test_complex_dtype_rejected_with_guidance():
    with pytest.raises(ValueError, match="complex"):
        ref_devsnap.DeviceSnapshot(jnp.zeros(8, jnp.complex64))
    with pytest.raises(ValueError, match="complex"):
        port_devsnap.DeviceSnapshot(torch.zeros(8, dtype=torch.complex64))


@pytest.mark.parametrize("dtype", ["bool", "float16", "int16", "uint8",
                                   "int8"])
def test_word_images_of_other_dtypes(dtype):
    """bool (as uint8), 16- and 8-bit words: flags, diffs and the
    baseline bytes as the reference's; restore gives the dtype back."""
    rng = np.random.RandomState(5)
    if dtype == "bool":
        host = rng.rand(3000) > 0.5
    elif dtype == "float16":
        host = rng.randn(3000).astype(np.float16)
    else:
        info = np.iinfo(dtype)
        host = rng.randint(info.min, info.max, 3000).astype(dtype)
    ja, ta = jnp.asarray(host), torch.from_numpy(host.copy())
    ref, port = ref_devsnap.DeviceSnapshot(ja), port_devsnap.DeviceSnapshot(ta)
    new = host.copy()
    for i in (3, 2999):
        new[i] = ~new[i] if dtype == "bool" else new[i] + 1
    jc, tc = jnp.asarray(new), torch.from_numpy(new.copy())
    assert port.dirty_pages(tc).tolist() == ref.dirty_pages(jc).tolist()
    assert diff_obs(port.diff(tc)) == diff_obs(ref.diff(jc))
    np.testing.assert_array_equal(port.baseline_bytes, ref.baseline_bytes)
    restored = port.restore()
    assert restored.dtype == ta.dtype and torch.equal(restored, ta)


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_64_bit_words(dtype):
    """64-bit tensors (which JAX without x64 narrows, so no parity run):
    the diffs are the pages of the new bytes that differ from the old."""
    old = (np.random.RandomState(7).randn(1500) * 1e6).astype(dtype)
    new = old.copy()
    new[[0, 1100]] += 1
    snap = port_devsnap.DeviceSnapshot(torch.from_numpy(old.copy()))
    assert snap.page_words == PAGE // 8
    diffs = snap.diff(torch.from_numpy(new))
    raw = new.view(np.uint8)
    assert diff_obs(diffs) == [(0, raw[:PAGE].tobytes(), 0, 0),
                               (PAGE * 2, raw[PAGE * 2:].tobytes(), 0, 0)]


def test_device_handle_snapshot_bridge():
    """``snapshot_of`` (tests/unit/test_device_resident.py): diffs of a
    handle's live tensor, found where the tensor lies; only the flags and
    the dirty pages cross to the host, counted."""
    def scenario(pk, to_device):
        pk.reset_device_handles()
        reg = pk.get_device_handle_registry()
        base = np.zeros(4096, dtype=np.float32)
        h = reg.push(5, 0, "snap", to_device(base.copy()))
        snap = reg.snapshot_of(h)
        changed = base.copy()
        changed[0] = 1.5
        diffs = snap.diff(to_device(changed))
        restored = np.asarray(snap.restore()).copy().view(np.uint8)
        for d in diffs:
            restored[d.offset:d.offset + len(d.data)] = \
                np.frombuffer(d.data, np.uint8)
        np.testing.assert_array_equal(restored.view(np.float32), changed)
        pk.reset_device_handles()
        return diff_obs(diffs)

    want = scenario(ref_state, _jx)
    got = scenario(port_state, torch.from_numpy)
    assert got == want and len(got) == 1 and got[0][0] == 0


# ---------------------------------------------------------------------------
# The snapshot RPC across the wire, both ways
# ---------------------------------------------------------------------------

def _new_server(pk, registry, base, scheduler=None):
    server = pk.remote.SnapshotServer(registry, scheduler=scheduler,
                                      port_offset=base)
    server.start()
    return server


def _snapshot_for(pk):
    image = np.random.RandomState(6).randint(0, 255, PAGE * 3 + 11,
                                             dtype=np.uint8)
    snap = pk.snapshot.SnapshotData(image, max_size=PAGE * 8)
    snap.add_merge_region(16, 8, pk.snapshot.SnapshotDataType.LONG,
                          pk.snapshot.SnapshotMergeOperation.SUM)
    snap.add_merge_region(200, 300)
    return snap


def _diffs_for(pk):
    op, ty = pk.snapshot.SnapshotMergeOperation, pk.snapshot.SnapshotDataType
    return [pk.snapshot.SnapshotDiff(0, b"\x01" * 10),
            pk.snapshot.SnapshotDiff(16, np.int64(5).tobytes(), ty.LONG,
                                     op.SUM),
            pk.snapshot.SnapshotDiff(PAGE * 3 + 4, b"\xff" * 7)]


def _wait_for(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.mark.parametrize("client_pk,server_pk", [(PORT, REF), (REF, PORT)],
                         ids=["port_client-ref_server",
                              "ref_client-port_server"])
def test_snapshot_rpc_across_packages(client_pk, server_pk):
    """Push (image and merge regions), update (queued diffs, then
    written), thread result (its diffs queued on the snapshot, its return
    value delivered to the server's scheduler, which wakes
    ``await_thread_result``; a result for an unknown key drops its diffs
    and still wakes the waiter) and delete."""
    import importlib

    from tests.conftest import next_port_base

    base = next_port_base()
    registry = server_pk.snapshot.SnapshotRegistry()
    scheduler = importlib.import_module(
        f"{server_pk.name}.scheduler.scheduler").Scheduler("snaphost", None)
    server = _new_server(server_pk, registry, base, scheduler)
    client_pk.common.register_host_alias("snaphost", "127.0.0.1", base)
    client = client_pk.remote.SnapshotClient("snaphost")
    try:
        sent = _snapshot_for(client_pk)
        client.push_snapshot("app/key", sent)
        got = registry.get_snapshot("app/key")
        assert got.to_bytes() == sent.to_bytes()
        assert got.max_size == sent.max_size == PAGE * 8
        assert [r.to_dict() for r in got.get_merge_regions()] \
            == [r.to_dict() for r in sent.get_merge_regions()]
        assert type(got) is server_pk.snapshot.SnapshotData

        client.push_snapshot_update("app/key", _diffs_for(client_pk))
        assert got.queued_diff_count() == 3
        want = _snapshot_for(server_pk)
        for d in _diffs_for(server_pk):
            want.apply_diff(d)
        assert got.write_queued_diffs() == 3
        assert got.to_bytes() == want.to_bytes()

        with pytest.raises(TimeoutError):
            scheduler.await_thread_result(10, timeout=0.05)
        woke = []
        waiter = threading.Thread(target=lambda: woke.append(
            scheduler.await_thread_result(10, timeout=10.0)))
        waiter.start()
        client.push_thread_result(9, 10, 7, "app/key",
                                  _diffs_for(client_pk)[:1])
        waiter.join(timeout=10.0)
        assert woke == [7]
        assert got.queued_diff_count() == 1
        client.push_thread_result(9, 11, 0, "app/other",
                                  _diffs_for(client_pk)[:1])
        assert scheduler.await_thread_result(11, timeout=10.0) == 0
        assert got.queued_diff_count() == 1
        assert got.write_queued_diffs() == 1

        client.delete_snapshot("app/key")
        _wait_for(lambda: not registry.snapshot_exists("app/key"),
                  "delete_snapshot never reached the server")
        with pytest.raises(Exception, match="No snapshot"):
            client.push_snapshot_update("app/key", [])
    finally:
        client.close()
        server.stop()


class FrameRecorder:
    """Listens on a snapshot server's two ports, keeps every frame's
    bytes and answers sync frames with an empty success."""

    def __init__(self, offset: int) -> None:
        self.frames: dict[str, list[bytes]] = {"async": [], "sync": []}
        self._lock = threading.Lock()
        self._listeners = []
        self._conns: list[socket.socket] = []
        for plane, port in (("async", port_common.SNAPSHOT_ASYNC_PORT),
                            ("sync", port_common.SNAPSHOT_SYNC_PORT)):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port + offset))
            s.listen(4)
            self._listeners.append(s)
            threading.Thread(target=self._accept, args=(s, plane),
                             daemon=True).start()

    def _accept(self, listener, plane):
        while True:
            try:
                conn, _ = listener.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn, plane),
                             daemon=True).start()

    @staticmethod
    def _exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def _serve(self, conn, plane):
        try:
            while True:
                head = self._exact(conn, HEADER_LEN)
                _, code, _, _, json_len, bin_len = struct.unpack(HEADER_FMT,
                                                                 head)
                body = self._exact(conn, json_len + bin_len)
                with self._lock:
                    self.frames[plane].append(head + body)
                if plane == "sync":
                    send_frame(conn, TransportMessage(code=code))
        except (ConnectionError, OSError):
            return

    def take(self, n_sync: int, n_async: int) -> dict:
        _wait_for(lambda: len(self.frames["sync"]) >= n_sync
                  and len(self.frames["async"]) >= n_async,
                  f"frames: {[len(v) for v in self.frames.values()]}")
        with self._lock:
            out = {k: list(v) for k, v in self.frames.items()}
            for v in self.frames.values():
                v.clear()
        return out

    def close(self):
        for s in self._listeners + self._conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()


def test_snapshot_rpc_frames_are_the_references():
    """A port client's frames for push, update, thread result and delete
    are byte for byte a reference client's."""
    from tests.conftest import next_port_base

    base = next_port_base()
    recorder = FrameRecorder(base)
    frames = {}
    try:
        for pk in (REF, PORT):
            pk.common.register_host_alias("rec", "127.0.0.1", base)
            client = pk.remote.SnapshotClient("rec")
            try:
                client.push_snapshot("app/key", _snapshot_for(pk))
                client.push_snapshot_update("app/key", _diffs_for(pk))
                client.push_thread_result(3, 4, 5, "app/key",
                                          _diffs_for(pk)[1:])
                client.delete_snapshot("app/key")
                frames[pk.name] = recorder.take(3, 1)
            finally:
                client.close()
    finally:
        recorder.close()
    assert frames[PORT.name] == frames[REF.name]
    push = frames[PORT.name]["sync"][0]
    assert push[2] == 1 and push.endswith(_snapshot_for(PORT).to_bytes())


def _mock_calls(pk):
    pk.testing.set_mock_mode(True)
    pk.remote.clear_mock_snapshot_requests()
    client = pk.remote.SnapshotClient("mockhost")
    snap = _snapshot_for(pk)
    client.push_snapshot("k", snap)
    client.push_snapshot_update("k", _diffs_for(pk))
    client.push_thread_result(1, 2, 3, "k", _diffs_for(pk)[:2])
    client.delete_snapshot("k")
    pushes = [(h, k, s.to_bytes()) for h, k, s in pk.remote.get_snapshot_pushes()]
    diff_pushes = [(h, k, diff_obs(ds))
                   for h, k, ds in pk.remote.get_snapshot_diff_pushes()]
    results = pk.remote.get_mock_thread_results()
    pk.remote.clear_mock_snapshot_requests()
    pk.testing.set_mock_mode(False)
    return pushes, diff_pushes, results


def test_mock_recordings_including_thread_results():
    pushes, diff_pushes, results = both(_mock_calls)
    assert len(pushes) == 1 and len(diff_pushes) == 2
    assert results == [("mockhost", 1, 2, 3)]


def test_runtime_serves_snapshots_and_the_planner_holds_a_registry():
    """A port ``WorkerRuntime`` starts its ``SnapshotServer`` over the
    registry it gives its scheduler and planner client; a reference
    client pushes to it. The planner has its registry and drops its
    snapshot clients with a removed host."""
    from tests.conftest import next_port_base

    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.runner import WorkerRuntime

    base = next_port_base()
    port_common.register_host_alias("rtplanner", "127.0.0.1", base)
    port_common.register_host_alias("rthost", "127.0.0.1", base + 1000)
    ref_common.register_host_alias("rthost", "127.0.0.1", base + 1000)
    planner = get_planner()
    planner.reset()
    server = PlannerServer(port_offset=base)
    server.start()
    worker = WorkerRuntime(host="rthost", slots=1,
                           factory=TorchExecutorFactory(device="cpu"),
                           planner_host="rtplanner")
    worker.start()
    client = ref_remote.SnapshotClient("rthost")
    try:
        assert worker.scheduler.snapshot_registry is worker.snapshot_registry
        assert worker.planner_client.snapshot_registry \
            is worker.snapshot_registry
        client.push_snapshot("w/k", _snapshot_for(REF))
        assert worker.snapshot_registry.get_snapshot("w/k").to_bytes() \
            == _snapshot_for(PORT).to_bytes()
        assert isinstance(planner.snapshot_registry,
                          port_snapshot.SnapshotRegistry)
        planner._snapshot_clients.get("rthost")
        planner.remove_host("rthost")
        assert not planner._snapshot_clients._clients
    finally:
        client.close()
        worker.shutdown()
        server.stop()
        planner.reset()
        from faabric_tpu_torch.executor import (
            clear_registered_functions,
            set_executor_factory,
        )

        clear_registered_functions()
        set_executor_factory(None)


# ---------------------------------------------------------------------------
# Guests: chip_smoke.py's phase 20 on a two-host port runtime
# ---------------------------------------------------------------------------

def test_snapshot_phase_on_two_hosts():
    """``chip_smoke.py``'s phase 20 at a small width on the CPU: hA's
    weights as a device state handle, its ``DeviceSnapshot`` pushed to
    hB, then a sparse SGD step and a full AdamW step whose on-device
    dirty pages equal the host oracle, whose counted copies are exact,
    and whose diffs, pushed to hB, let hB's guest score bit for bit as
    hA's."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.ops import _build
    from tests.conftest import next_port_base

    cfg = ModelConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=2,
                      d_ff=128, max_seq=512)
    launches = chip_smoke.snapshot_phase(torch.device("cpu"), _build,
                                         cfg=cfg, hosts=("snA", "snB"),
                                         base=next_port_base())
    assert launches == {}  # CPU tensors take the kernels' plain versions
