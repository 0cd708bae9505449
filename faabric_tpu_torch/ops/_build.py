"""Build and load the port's CUDA kernels at first use.

Every source under ``csrc/`` is compiled for ``sm_90a`` by one
``torch.utils.cpp_extension.load`` call into ``build/torch_kernels/`` at
the repository root. Only ``csrc/binding.cpp`` includes PyTorch's headers;
the ``.cu`` files keep a plain C interface, so nvcc never compiles those
headers. Where ``ninja`` (which ``load`` needs) is missing, the ``.cu``
files are built with ``nvcc -shared`` into a plain library loaded through
``ctypes`` instead, behind the same five functions:

    rms_norm_fwd(x, scale, out, eps)
    flash_fwd(q, k, v, o, lse, scale, causal, body)
    flash_bwd_dq(q, k, v, do, out, lse, g_lse, delta, dq, scale, causal,
                 body)
    flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, scale, causal, body)
    ring_permute(ins, outs, shift)

A build failure raises; nothing swaps in the plain PyTorch versions.

``LAUNCHES`` counts the launches of each kernel. Each wrapper adds one
through ``count_launch`` right after it launches its kernel, so a run
can show that its path went through the kernels. Executor threads
launch kernels at once, so the first build and the counts are both
taken under locks.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

LAUNCHES: collections.Counter = collections.Counter()
_launch_lock = threading.Lock()


def count_launch(*names: str) -> None:
    """Add one launch to each of ``names`` (a read-modify-write of the
    shared counter, hence the lock)."""
    with _launch_lock:
        for name in names:
            LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_lock:
        LAUNCHES.clear()


def _cuda_sources() -> list[str]:
    return sorted(str(p) for p in CSRC.glob("*.cu"))


def _load_extension():
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="faabric_torch_kernels",
                sources=[str(CSRC / "binding.cpp"), *_cuda_sources()],
                build_directory=str(BUILD_DIR), extra_cflags=["-O3"],
                extra_cuda_cflags=CUDA_FLAGS)


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _load_with_nvcc():
    """nvcc -shared + ctypes: for machines without ninja."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found to build the kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / "libfaabric_torch_kernels.so"
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *CUDA_FLAGS,
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), *_cuda_sources()], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.faabric_rms_norm_fwd.argtypes = [p, p, p, i64, i, f, i, p]
    lib.faabric_rms_norm_fwd.restype = i
    lib.faabric_flash_fwd.argtypes = ([p] * 5 + [i] * 5 + [i64] * 9
                                      + [f, i, i, i, p])
    lib.faabric_flash_fwd.restype = i
    lib.faabric_flash_bwd_dq.argtypes = ([p] * 9 + [i] * 5 + [i64] * 15
                                         + [f, i, i, i, p])
    lib.faabric_flash_bwd_dq.restype = i
    lib.faabric_flash_bwd_dkv.argtypes = ([p] * 8 + [i] * 5 + [i64] * 12
                                          + [f, i, i, i, p])
    lib.faabric_flash_bwd_dkv.restype = i
    lib.faabric_ring_permute.argtypes = [p, p, i, i, i64, p]
    lib.faabric_ring_permute.restype = i

    def dtype_code(t):
        return {torch.float32: 0, torch.bfloat16: 1}[t.dtype]

    def stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def rms_norm_fwd(x, scale, out, eps):
        _check_rc("rms_norm_fwd", lib.faabric_rms_norm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], eps, dtype_code(x), stream(x)))

    def flash_fwd(q, k, v, o, lse, scale, causal, body):
        b, s_q, h, d = q.shape
        _check_rc("flash_fwd", lib.faabric_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, s_q, k.shape[1], d, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], scale, int(causal),
            dtype_code(q), body, stream(q)))

    def bwd_shape(q, k):
        b, s_q, h, d = q.shape
        return (b, h, s_q, k.shape[1], d, *q.stride()[:3], *k.stride()[:3])

    def flash_bwd_dq(q, k, v, do, out, lse, g_lse, delta, dq, scale, causal,
                     body):
        _check_rc("flash_bwd_dq", lib.faabric_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            None if g_lse is None else g_lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *bwd_shape(q, k), *v.stride()[:3],
            *do.stride()[:3], *out.stride()[:3], scale, int(causal),
            dtype_code(q), body, stream(q)))

    def flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, scale, causal, body):
        _check_rc("flash_bwd_dkv", lib.faabric_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *bwd_shape(q, k), *v.stride()[:3], *do.stride()[:3], scale,
            int(causal), dtype_code(q), body, stream(q)))

    def ring_permute(ins, outs, shift):
        n = len(ins)
        srcs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in ins))
        dsts = (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs))
        _check_rc("ring_permute", lib.faabric_ring_permute(
            srcs, dsts, n, shift, ins[0].numel() * ins[0].element_size(),
            stream(ins[0])))

    # The ctypes functions hold ``lib``; keep it alive with them
    return SimpleNamespace(rms_norm_fwd=rms_norm_fwd, flash_fwd=flash_fwd,
                           flash_bwd_dq=flash_bwd_dq,
                           flash_bwd_dkv=flash_bwd_dkv,
                           ring_permute=ring_permute, lib=lib)


def _load():
    from torch.utils.cpp_extension import is_ninja_available

    return _load_extension() if is_ninja_available() else _load_with_nvcc()


_kernels = None
_kernels_lock = threading.Lock()


def kernels():
    """The built kernels, built by the first call in a process: threads
    that call at once wait for that one build."""
    global _kernels
    if _kernels is None:
        with _kernels_lock:
            if _kernels is None:
                _kernels = _load()
    return _kernels
