"""The port's native layer under the sanitizers.

Counterpart of ``tests/unit/test_native_san.py``.
``FAABRIC_NATIVE_SAN=tsan|asan`` makes ``faabric_tpu_torch/util/native.py``
compile every native helper (``util/csrc/{shm_ring,segv_tracker,
uffd_tracker,pagediff}.cpp``) with the matching ``-fsanitize`` flags into
a suffixed library. A sanitized library loads only after the sanitizer's
runtime, so each mode runs in a SUBPROCESS with
``LD_PRELOAD=$(g++ -print-file-name=lib<san>.so)``, building into a
temporary directory (``FAABRIC_NATIVE_BUILD_DIR``) so that the normal
build cache is untouched, and the test asserts (a) the exercise passes
and (b) the sanitizer printed no report.

Exercised under the sanitizer: the SPSC shm ring across many
wraparounds with a real producer and consumer thread, the page compare
and XOR of ``pagediff``, and the segv and uffd trackers' start and stop
with a dirty-page readback (those two best-effort: a signal-handler
tracker and a sanitizer runtime can be unavailable together on some
kernels, and the script says what it skipped; the ring and the page
compare are mandatory). Without the preload the same load fails like
any other failed load of the port: a warning, and no library.

Slow-marked: each run pays a sanitized g++ build and an interpreter
under interceptors.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent('''
    import os, sys, threading
    import numpy as np

    os.environ.setdefault("FAABRIC_METRICS", "0")
    from faabric_tpu_torch.transport import shm
    from faabric_tpu_torch.util import native

    ring_lib = native.get_shmring_lib()
    assert ring_lib is not None, "sanitized shm ring did not load"
    assert ".%s.so" % os.environ["FAABRIC_NATIVE_SAN"] in ring_lib._name
    if not shm.shm_available():
        print("SAN_SKIP: no /dev/shm")
        sys.exit(0)

    # -- ring wraparound under a real producer/consumer pair ----------
    r = shm.ShmRing.create("san", 1 << 14)
    c = shm.ShmRing.attach(r.name)
    rng = np.random.RandomState(7)
    frames = [rng.randint(0, 256, rng.randint(1, 3000), dtype=np.uint8)
              .astype(np.uint8) for _ in range(300)]
    got = []

    def produce():
        for f in frames:
            assert r.push([f], timeout=20.0)

    def consume():
        while len(got) < len(frames):
            f = c.try_pop()
            if f is None:
                c.wait_data(20_000)
            else:
                got.append(f)

    tp = threading.Thread(target=produce)
    tc = threading.Thread(target=consume)
    tp.start(); tc.start()
    tp.join(60); tc.join(60)
    assert not tp.is_alive() and not tc.is_alive(), "ring hung"
    assert len(got) == len(frames)
    for i, (a, b) in enumerate(zip(got, frames)):
        # np.array_equal, not np.testing: the testing machinery's import
        # under TSAN interceptors takes minutes
        assert np.array_equal(a, b), f"frame {i} corrupted"
    c.close()
    r.close(unlink=True)
    print("RING_OK")

    # -- page compare and XOR -----------------------------------------
    from faabric_tpu_torch.util.dirty import page_flags

    assert native.get_pagediff_lib() is not None, "pagediff did not load"
    old = rng.randint(0, 256, 9 * 4096 + 100).astype(np.uint8)
    new = old.copy()
    new[3 * 4096 + 7] ^= 1
    new[9 * 4096 + 50] ^= 1
    flags = page_flags(old, new)
    assert flags.tolist() == [i in (3, 9) for i in range(10)], flags
    lib = native.get_pagediff_lib()
    out = np.empty_like(old)
    lib.xor_buffers(old.ctypes.data, new.ctypes.data, out.ctypes.data,
                    old.size)
    assert np.array_equal(out, old ^ new)
    print("PAGEDIFF_OK")

    # -- tracker start/stop under the sanitizer (best-effort) ----------
    from faabric_tpu_torch.util.dirty import SegvTracker, UffdTracker

    for cls in (SegvTracker, UffdTracker):
        try:
            tr = cls()
        except RuntimeError as e:
            print(f"TRACKER_SKIP {cls.__name__}: {e}")
            continue
        buf = np.zeros(16 * 4096, dtype=np.uint8)
        tr.start_tracking(buf)
        buf[5 * 4096] = 1
        buf[9 * 4096] = 2
        pages = tr.get_dirty_pages(buf)
        tr.stop_tracking(buf)
        assert pages.sum() >= 2, (cls.__name__, pages)
        print(f"TRACKER_OK {cls.__name__}")

    print("SAN_OK")
''')

_SAN_REPORT_MARKERS = (
    "WARNING: ThreadSanitizer",
    "ERROR: AddressSanitizer",
    "SUMMARY: ThreadSanitizer",
    "SUMMARY: AddressSanitizer",
)

_LOAD = ("from faabric_tpu_torch.util import native\n"
         "libs = [native.get_shmring_lib(), native.get_pagediff_lib(),\n"
         "        native.get_segv_lib(), native.get_uffd_lib()]\n"
         "print('LOADED', [lib is not None for lib in libs])\n")


def _runtime_lib(name: str) -> str | None:
    try:
        out = subprocess.run(["g++", f"-print-file-name=lib{name}.so"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    path = (out.stdout or "").strip()
    # g++ echoes the bare name back when it cannot find the library
    if not path or path == f"lib{name}.so" or not os.path.exists(path):
        return None
    return path


def _env(mode: str, build_dir: Path, **extra) -> dict:
    env = dict(os.environ, FAABRIC_NATIVE_SAN=mode,
               FAABRIC_NATIVE_BUILD_DIR=str(build_dir), **extra)
    env.pop("LD_PRELOAD", None)
    env.update(extra)
    return env


@pytest.mark.slow
@pytest.mark.parametrize("mode,libname", [("tsan", "tsan"),
                                          ("asan", "asan")])
def test_native_layer_under_sanitizer(mode, libname, tmp_path):
    lib = _runtime_lib(libname)
    if lib is None:
        pytest.skip(f"lib{libname}.so not available from g++")
    # Build first WITHOUT the preload: every library compiles into the
    # temporary directory as lib<name>.<mode>.so, and loading them here
    # fails loudly (a warning a library, no library), as any failed
    # load of the port does
    pre = subprocess.run([sys.executable, "-c", _LOAD],
                         env=_env(mode, tmp_path), capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert pre.returncode == 0, pre.stderr[-3000:]
    assert "LOADED [False, False, False, False]" in pre.stdout, pre.stdout
    assert "Could not load" in pre.stderr, pre.stderr[-3000:]
    built = sorted(p.name for p in tmp_path.rglob("*.so"))
    assert built == sorted(f"lib{n}.{mode}.so" for n in (
        "pagediff", "segvtracker", "shmring", "uffdtracker")), built

    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        env=_env(mode, tmp_path, LD_PRELOAD=lib,
                 TSAN_OPTIONS="exitcode=66 halt_on_error=0",
                 ASAN_OPTIONS="detect_leaks=0 exitcode=66 "
                              "allocator_may_return_null=1"),
        capture_output=True, text=True, timeout=540, cwd=ROOT)
    text = (out.stdout or "") + (out.stderr or "")
    assert out.returncode == 0, text[-4000:]
    if "SAN_SKIP" in text:
        pytest.skip(text.strip().splitlines()[0])
    for marker in ("RING_OK", "PAGEDIFF_OK", "SAN_OK"):
        assert marker in text, text[-4000:]
    hits = [m for m in _SAN_REPORT_MARKERS if m in text]
    assert not hits, f"sanitizer reports under {mode}:\n{text[-6000:]}"
