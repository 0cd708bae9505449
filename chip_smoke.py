#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``faabric_tpu_torch/ops/csrc``, holds
each kernel against its plain PyTorch version at the serving shapes,
then serves the flagship transformer at full width (``ModelConfig()``:
vocab 32000, d_model 512, 4 layers, 8 heads, d_ff 2048, random weights
from seed 0) through the port's entry points: a scoring forward over
8 x 512 tokens, a forward at 1 x 2048, and greedy ``generate`` of 32
tokens after 8 x 512-token prompts. It checks the outputs, shows from
the kernels' launch counts that this path ran through them, times the
kernels, their plain versions and the nearest PyTorch library calls,
and prints one JSON line of kernel numbers and, last, the device line.

It needs a CUDA card and exits non-zero without one. It imports nothing
of JAX or of the JAX package. Any failed check raises and the script
exits non-zero; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores, published
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores

# Kernel against plain version, same inputs. fp32: summation order.
# bf16: the RMS kernel and its plain version both round once from fp32
# (one ulp of |out| < 8); flash rounds unnormalised p where the plain
# version rounds normalised probabilities (the JAX package's bf16 flash
# tolerance, 3e-2).
RMS_ATOL = {torch.float32: 1e-5, torch.bfloat16: 3.2e-2}
FLASH_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Median device time of one call. ``reps`` calls are captured in a
    CUDA graph and its replays timed with CUDA events, so the host's
    dispatch time between small launches is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs])) / reps


def profile_top(fn, label: str, top: int = 6) -> None:
    """Device time by kernel over one call of ``fn``, from torch.profiler:
    the device's busy time against the call's wall time, and the kernels
    that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile {label}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total:9.1f} us  x{e.count:<4d} "
            f"{e.key[:90]}")


def host_ms(fn, iters: int = 5) -> float:
    """Median wall time of calls that end in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok  {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "faabric_tpu_torch")):
        print("chip_smoke: faabric_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        forward,
        forward_with_cache,
        generate,
        init_kv_cache,
    )
    from faabric_tpu_torch.ops import _build
    from faabric_tpu_torch.ops.flash_attention import (
        _reference_attention,
        _reference_lse,
        flash_attention_with_lse,
    )
    from faabric_tpu_torch.ops.rms_norm import _reference_rms_norm, rms_norm
    from faabric_tpu_torch.util.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.kernels()
    log(f"kernel build seconds: {time.perf_counter() - t0:.1f}")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs: dict[str, float] = {}

    # -- 3. RMS kernel against its plain version -----------------------------
    log("phase 3: rms_norm kernel vs plain")
    for rows, d in [(4096, 512), (8, 512), (333, 512)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, d, device=dev, generator=gen).to(dtype)
            scale = torch.rand(d, device=dev, generator=gen) + 0.5
            out = rms_norm(x, scale)
            torch.cuda.synchronize()
            err = max_err(out, _reference_rms_norm(x, scale))
            if (rows, d, dtype) == (4096, 512, torch.bfloat16):
                errs["rms_norm"] = err
            check(err <= RMS_ATOL[dtype] and out.dtype == dtype,
                  f"rms_norm ({rows}, {d}) {dtype}: max |err| {err:.3g}")

    # -- 4. flash kernel against its plain version ---------------------------
    log("phase 4: flash attention kernel vs plain")
    for b, s_q, s_k, causal, dtype in [
            (8, 512, 512, True, torch.bfloat16),
            (8, 128, 512, True, torch.bfloat16),
            (8, 512, 512, False, torch.bfloat16),
            (8, 512, 512, True, torch.float32),
            (1, 2048, 2048, True, torch.bfloat16)]:
        q, k, v = (torch.randn(b, s, 8, 64, device=dev, generator=gen
                               ).to(dtype) for s in (s_q, s_k, s_k))
        out, lse = flash_attention_with_lse(q, k, v, causal)
        torch.cuda.synchronize()
        err_o = max_err(out, _reference_attention(q, k, v, causal))
        err_l = max_err(lse, _reference_lse(q, k, causal))
        if (b, s_q, s_k, causal, dtype) == (8, 512, 512, True, torch.bfloat16):
            errs["flash_attention"] = max(err_o, err_l)
        check(err_o <= FLASH_ATOL[dtype] and err_l <= FLASH_ATOL[dtype],
              f"flash ({b}, {s_q}/{s_k}, 8, 64) causal={causal} {dtype}: "
              f"max |err| O {err_o:.3g} lse {err_l:.3g}")

    # -- 5/6. the serving path at full width ---------------------------------
    cfg = ModelConfig()
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: ModelConfig() defaults, {n_params} params")
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, (8, 512)),
                             dtype=torch.int32, device=dev)
    long_tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, (1, 2048)),
                                  dtype=torch.int32, device=dev)
    n_new = 32

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with torch.inference_mode():
        logits = forward(model, tokens)
        long_logits = forward(model, long_tokens)
        new_tokens = generate(model, tokens, n_new)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path launches: {launches}")
    log("phase 5: full-width forward")
    for name in ("rms_norm", "flash_attention"):
        check(launches.get(name, 0) > 0, f"main path launched {name} "
              f"{launches.get(name, 0)} times")
    check(tuple(logits.shape) == (8, 512, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "8x512 logits finite, shape")
    check(tuple(long_logits.shape) == (1, 2048, cfg.vocab_size)
          and bool(torch.isfinite(long_logits).all()),
          "1x2048 logits finite, shape")

    # The same weights through the plain paths: in bf16, and in fp32 as
    # the yardstick. bf16 rounds at other places in the kernels than in
    # the plain path, so the kernel path is held to the plain bf16 path's
    # own distance from fp32: mean within 1.25x, max within 2x.
    def plain_logits(dtype):
        plain_cfg = dataclasses.replace(cfg, attention_impl="reference",
                                        norm_impl="reference",
                                        compute_dtype=dtype)
        plain = Transformer(plain_cfg, device=dev)
        plain.load_state_dict(model.state_dict())
        with torch.inference_mode():
            return forward(plain, tokens)

    f32_logits = plain_logits(torch.float32)
    ref_logits = plain_logits(torch.bfloat16)
    err_k = (logits - f32_logits).abs()
    err_r = (ref_logits - f32_logits).abs()
    noise_max = float(err_r.max())
    agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    log(f"  kernel path vs fp32: max {float(err_k.max()):.4g} mean "
        f"{float(err_k.mean()):.4g}; plain bf16 vs fp32: max {noise_max:.4g} "
        f"mean {float(err_r.mean()):.4g}; kernel vs plain bf16: max "
        f"{max_err(logits, ref_logits):.4g}, argmax agree {agree:.4f}")
    check(float(err_k.mean()) <= 1.25 * float(err_r.mean())
          and float(err_k.max()) <= 2 * noise_max,
          "kernel path as close to fp32 as the plain bf16 path")
    del f32_logits, ref_logits, err_k, err_r

    log("phase 6: generate")
    check(tuple(new_tokens.shape) == (8, n_new)
          and int(new_tokens.min()) >= 0
          and int(new_tokens.max()) < cfg.vocab_size, "tokens in range")
    with torch.inference_mode():
        cache = init_kv_cache(cfg, 8, dev)
        prefill = forward_with_cache(model, tokens, cache, 0)
        first = prefill[:, -1].argmax(-1).to(torch.int32)
        step = forward_with_cache(model, first[:, None], cache, 512)[:, -1]
        full = forward(model, torch.cat([tokens, first[:, None]], 1))[:, -1]
    check(torch.equal(new_tokens[:, 0], first)
          and torch.equal(new_tokens[:, 1], step.argmax(-1).to(torch.int32)),
          "generate's first two tokens are the greedy picks")
    step_err = max_err(step, full)
    check(step_err <= 2 * noise_max, f"first decode step vs full forward's "
          f"last position: max |err| {step_err:.3g} (limit {2 * noise_max:.3g})")

    # -- 7. timings ----------------------------------------------------------
    log("phase 7: timings")
    x = torch.randn(4096, 512, device=dev, generator=gen).to(torch.bfloat16)
    scale = torch.rand(512, device=dev, generator=gen) + 0.5
    scale_bf16 = scale.to(torch.bfloat16)
    rms = {
        "ms": time_ms(lambda: rms_norm(x, scale)),
        "plain_ms": time_ms(lambda: _reference_rms_norm(x, scale)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (512,), scale_bf16, 1e-6)),
    }
    rms_bytes = x.numel() * 2 * 2 + scale.numel() * 4
    rms_ops = 4 * x.numel()
    rms_bounds = {"bytes": rms_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": rms_ops / FP32_FLOP_PER_S * 1e3}

    q, k, v = (torch.randn(8, 512, 8, 64, device=dev, generator=gen
                           ).to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fl = {
        "ms": time_ms(lambda: flash_attention_with_lse(q, k, v, True)),
        "plain_ms": time_ms(lambda: _reference_attention(q, k, v, True)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
    }
    pairs = 8 * 8 * 512 * 513 // 2          # visible (query, key) pairs
    fl_flops = 4 * 64 * pairs                # Q.K^T and P.V
    fl_bytes = 4 * q.numel() * 2 + 8 * 8 * 512 * 4
    fl_bounds = {"bytes": fl_bytes / HBM_BYTES_PER_S * 1e3,
                 "operations": fl_flops / BF16_FLOP_PER_S * 1e3}

    with torch.inference_mode():
        fwd_ms = host_ms(lambda: forward(model, tokens))
        fwd_dev_ms = time_ms(lambda: forward(model, tokens), reps=3, iters=5)
        long_ms = host_ms(lambda: forward(model, long_tokens))
        profile_top(lambda: forward(model, tokens), "forward 8x512")
        profile_top(lambda: forward_with_cache(model, first[:, None], cache,
                                               512), "decode step (batch 8)")
    gen_ms = host_ms(lambda: generate(model, tokens, n_new + 1), iters=3)
    gen1_ms = host_ms(lambda: generate(model, tokens, 1), iters=3)
    decode_ms = (gen_ms - gen1_ms) / n_new
    log(f"rms_norm (4096, 512) bf16: kernel {rms['ms']:.4f} ms, plain "
        f"{rms['plain_ms']:.4f} ms, F.rms_norm {rms['library_ms']:.4f} ms, "
        f"bound {max(rms_bounds.values()):.4f} ms (bytes)")
    log(f"flash (8, 512, 8, 64) bf16 causal: kernel {fl['ms']:.4f} ms, plain "
        f"{fl['plain_ms']:.4f} ms, sdpa {fl['library_ms']:.4f} ms, bound "
        f"{max(fl_bounds.values()):.4f} ms "
        f"({max(fl_bounds, key=fl_bounds.get)})")
    log(f"forward 8x512: {fwd_ms:.3f} ms host, {fwd_dev_ms:.3f} ms as a graph, "
        f"{8 * 512 / fwd_ms * 1e3:.0f} tokens/s")
    log(f"forward 1x2048: {long_ms:.3f} ms host")
    log(f"generate 8x512 + {n_new}: {gen_ms:.1f} ms; decode "
        f"{decode_ms:.3f} ms/token-step (8 sequences)")
    log(f"peak memory on the main path: {peak_gib:.3f} GiB")

    def row(name, source, replaces, t, bounds, err):
        bound_by = max(bounds, key=bounds.get)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": bounds[bound_by], "bound_by": bound_by,
                "library_ms": t["library_ms"]}

    kernels = [
        row("rms_norm", "faabric_tpu_torch/ops/csrc/rms_norm.cu",
            "faabric_tpu/ops/rms_norm.py:26", rms, rms_bounds,
            errs["rms_norm"]),
        row("flash_attention", "faabric_tpu_torch/ops/csrc/flash_attention.cu",
            "faabric_tpu/ops/flash_attention.py:61", fl, fl_bounds,
            errs["flash_attention"]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
