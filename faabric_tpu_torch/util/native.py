"""Loader for the native C++ helpers of the snapshot stack.

Counterpart of ``faabric_tpu/util/native.py`` for its four libraries,
whose sources the port keeps under ``util/csrc/``:

- ``pagediff.cpp``: page and chunk compares and XOR over host buffers;
- ``shm_ring.cpp``: the lock-free SPSC byte ring over a /dev/shm
  mapping, the same-machine bulk data plane (``transport/shm.py``);
- ``segv_tracker.cpp``: the SIGSEGV write-fault dirty tracker;
- ``uffd_tracker.cpp``: the userfaultfd write-protect dirty tracker.

g++ compiles each one on first use (there is no pybind11, so the
bindings are ctypes over extern-C surfaces) into
``build/native/<cpu>/`` at the root of the checkout, which git ignores.
The libraries are built with ``-march=native``, so ``<cpu>`` names the
host's CPU (a hash of its model and flags): a library built on another
CPU is never loaded, and a checkout copied between machines rebuilds.
A library is tried once a process: callers check ``get_*_lib() is not
None`` and take the numpy path otherwise. The compile runs outside the
module lock, so one library's build never queues another's first use;
it writes a temporary file and renames it, so that processes building
the same library at once never load a half-written one.

The tracker libraries install process-wide state when loaded: a SIGSEGV
handler, or a userfaultfd with its event thread. Load them only in a
process that owns its signal handling (a test runs them in a subprocess
of its own).

Not ported: the sanitizer builds that ``FAABRIC_NATIVE_SAN`` selects
(``ROADMAP.md`` Queue 1 #8).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Callable, Optional

from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "native")

_lock = threading.Lock()
# name -> loaded lib, or None after a failed attempt (one try a process)
_cache: dict[str, Optional[ctypes.CDLL]] = {}
# name -> Event while a build or load is in flight; losers of the race
# wait on it, then read the cache again
_in_progress: dict[str, threading.Event] = {}


@functools.lru_cache(maxsize=None)
def build_dir() -> str:
    """``BUILD_ROOT/<cpu>``: the first "model name" and "flags" lines
    of /proc/cpuinfo, hashed with the machine's architecture."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and not any(
                        i.startswith(key) for i in ident):
                    ident.append(line.strip())
    except OSError:
        pass
    tag = hashlib.sha256("\n".join(ident).encode()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, tag)


def _compile(src: str, so: str, extra_args: tuple) -> None:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        src, "-o", tmp, *extra_args],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build_and_load(name: str, src_file: str, so_file: str,
                    declare: Callable[[ctypes.CDLL], None],
                    install: Optional[Callable[[ctypes.CDLL], bool]],
                    extra_args: tuple,
                    fail_note: str) -> Optional[ctypes.CDLL]:
    """Compile if stale, load, declare, install; no lock held."""
    src = os.path.join(_SRC_DIR, src_file)
    so = os.path.join(build_dir(), so_file)
    if not os.path.exists(src):
        return None
    if not os.path.exists(so) or (os.path.getmtime(so)
                                  < os.path.getmtime(src)):
        try:
            _compile(src, so, extra_args)
        except (subprocess.SubprocessError, OSError) as e:
            logger.warning("Native %s build failed (%s); %s",
                           name, e, fail_note)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        logger.warning("Could not load %s: %s", so, e)
        return None
    declare(lib)
    if install is not None and not install(lib):
        return None
    return lib


def _load_native(name: str, src_file: str, so_file: str,
                 declare: Callable[[ctypes.CDLL], None],
                 install: Optional[Callable[[ctypes.CDLL], bool]] = None,
                 extra_args: tuple = (),
                 fail_note: str = "") -> Optional[ctypes.CDLL]:
    """One attempt a process a library, the build outside the lock."""
    while True:
        with _lock:
            if name in _cache:
                return _cache[name]
            ev = _in_progress.get(name)
            if ev is None:
                _in_progress[name] = threading.Event()
                break
        ev.wait()
    lib: Optional[ctypes.CDLL] = None
    try:
        lib = _build_and_load(name, src_file, so_file, declare, install,
                              extra_args, fail_note)
    finally:
        with _lock:
            _cache[name] = lib
            _in_progress.pop(name).set()
    return lib


def _declare_pagediff(lib: ctypes.CDLL) -> None:
    # void* arguments: callers pass numpy buffer addresses
    lib.diff_pages.restype = ctypes.c_size_t
    lib.diff_pages.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_size_t, ctypes.c_size_t,
                               ctypes.c_void_p]
    lib.diff_ranges.restype = ctypes.c_size_t
    lib.diff_ranges.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_size_t,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t]
    lib.xor_buffers.restype = None
    lib.xor_buffers.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_size_t]


def get_pagediff_lib() -> Optional[ctypes.CDLL]:
    return _load_native("pagediff", "pagediff.cpp", "libpagediff.so",
                        _declare_pagediff, fail_note="using numpy path")


def _declare_shmring(lib: ctypes.CDLL) -> None:
    lib.ring_init.restype = ctypes.c_int
    lib.ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ring_check.restype = ctypes.c_int64
    lib.ring_check.argtypes = [ctypes.c_void_p]
    lib.ring_free_space.restype = ctypes.c_int64
    lib.ring_free_space.argtypes = [ctypes.c_void_p]
    lib.ring_try_pushv.restype = ctypes.c_int
    lib.ring_try_pushv.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_uint64]
    lib.ring_peek.restype = ctypes.c_int64
    lib.ring_peek.argtypes = [ctypes.c_void_p]
    lib.ring_pop.restype = ctypes.c_int64
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_uint64]
    lib.ring_pop_batch.restype = ctypes.c_int64
    lib.ring_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_uint64]
    lib.ring_wait_data.restype = ctypes.c_int
    lib.ring_wait_data.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ring_wait_space.restype = ctypes.c_int
    lib.ring_wait_space.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_uint32]


def get_shmring_lib() -> Optional[ctypes.CDLL]:
    """The SPSC shared-memory ring, the same-machine bulk plane's hot
    path. It installs nothing process-wide. None when g++ or the source
    is missing; callers then stay on TCP."""
    return _load_native("shm_ring", "shm_ring.cpp", "libshmring.so",
                        _declare_shmring,
                        fail_note="same-machine bulk stays on TCP")


def _declare_tracker(prefix: str) -> Callable[[ctypes.CDLL], None]:
    def declare(lib: ctypes.CDLL) -> None:
        install = getattr(lib, f"{prefix}_install")
        install.restype = ctypes.c_int
        install.argtypes = []
        start = getattr(lib, f"{prefix}_start")
        start.restype = ctypes.c_int
        start.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
        stop = getattr(lib, f"{prefix}_stop")
        stop.restype = ctypes.c_int
        stop.argtypes = [ctypes.c_int]
    return declare


def get_segv_lib() -> Optional[ctypes.CDLL]:
    """The SIGSEGV write-fault dirty tracker: O(dirty) page tracking
    with no baseline copy. Loading it installs a process-wide SIGSEGV
    handler. None when g++ or the source is missing."""
    def install(lib: ctypes.CDLL) -> bool:
        if lib.segv_install() != 0:
            logger.warning("segv_tracker handler install failed")
            return False
        return True

    return _load_native("segv_tracker", "segv_tracker.cpp",
                        "libsegvtracker.so", _declare_tracker("segv"),
                        install=install,
                        fail_note="segv dirty mode unavailable")


def get_uffd_lib() -> Optional[ctypes.CDLL]:
    """The userfaultfd write-protect dirty tracker: O(dirty) like the
    segv mode, with faults resolved by one event thread instead of a
    signal handler. None when the kernel lacks uffd-wp or the build
    fails."""
    def install(lib: ctypes.CDLL) -> bool:
        rc = lib.uffd_install()
        if rc != 0:
            logger.info("userfaultfd write-protect unavailable (rc=%d); "
                        "DIRTY_TRACKING_MODE=uffd falls back", rc)
            return False
        return True

    return _load_native("uffd_tracker", "uffd_tracker.cpp",
                        "libuffdtracker.so", _declare_tracker("uffd"),
                        install=install, extra_args=("-lpthread",),
                        fail_note="uffd dirty mode unavailable")
