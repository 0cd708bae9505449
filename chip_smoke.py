#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``faabric_tpu_torch/ops/csrc``, holds
each kernel against its plain PyTorch version at the serving and
training shapes, then runs the flagship transformer at full width
(``ModelConfig()``: vocab 32000, d_model 512, 4 layers, 8 heads, d_ff
2048, random weights from seed 0) through the port's entry points. The
serving path: a scoring forward over 8 x 512 tokens, a forward at
1 x 2048, and greedy ``generate`` of 32 tokens after 8 x 512-token
prompts. The training path: 10 AdamW steps on 8 x 512 batches from the
``DataLoader`` (remat on, bf16 compute over fp32 parameters), with a
checkpoint saved and restored mid-run and ``evaluate_perplexity`` after.
The MPI path: a 4-rank ``MpiWorld`` whose ranks are threads of this
process, all on the one card, activates its device plane and runs
allreduce of a 45,355,520-element fp32 gradient (the flagship's
parameter count), allgather and reduce_scatter, ``ring_permute`` and the
``allgather.ring`` schedule, whose ring phase is the ring-permute
kernel. faabric's own path: a planner and a worker runtime in this
process gang-schedule 4 ranks (barrier, ring handoff), then serve 8
requests of 512-token prompts through torch guest functions on executor
threads, each scoring its prompt and generating 32 greedy tokens with
the full-width model on the card. The mesh path: the port's
``dryrun_multichip`` (gang scheduling, a device allreduce, one sharded
train step, the pipeline, the MoE family, MoE stages in the pipeline)
with 8 ranks and with 4, all on the one card, at full width in fp32;
ring attention over 8 ranks against the same schedule with plain blocks;
the sharded step against the unsharded one on the same weights; three
full-width sharded steps. The pipeline path: 8 ranks (dp 2, tp 2, pp 2)
at full width, GPipe and 1F1B against each other and the unsharded
model, every stage-to-stage hop on the ring-permute kernel, three steps
of each schedule. The MoE path: ``MoEConfig()`` at the flagship's widths
with 4 experts, its unsharded forward on the RMS-norm and flash kernels,
train steps over (dp 4, ep 2) and (dp 2, tp 2, ep 2) against the
unsharded model, and MoE stages in the pipeline. faabric's MPI as
guests use it: a planner and two worker runtimes gang-schedule 4 torch
guests (2 + 2 across the hosts) through rank 0's ``ctx.mpi_world()``,
which run the reference's MPI programs with CUDA-tensor and numpy
payloads and one data-parallel step of the full-width model whose
gradient crosses hosts on the host ladder; one worker runtime with 4
slots trains 3 data-parallel steps whose gradient allreduce runs on the
device plane. The mesh half of serving: ``generate`` and
``evaluate_perplexity`` of the full-width model at 2 layers laid over
dp 2 x tp 4 (8 ranks on the card) against the unsharded model. faabric's
state KV as guests use it: over two hosts, one guest writes the
flagship's fp32 weights into a key, four pull them and score, four count
under the global lock and append, and a device state handle passes
between two guests. faabric's snapshots as guests use them: over two hosts, one
guest holds the flagship's fp32 weights as one flat tensor on the card
behind a device state handle and pushes its ``DeviceSnapshot`` to the
other host; after a sparse SGD step and a full AdamW step, the on-device
dirty pages and diffs cross as snapshot updates, and the other host's
guest scores from its merged snapshot bit for bit as the first.
faabric's fork-join model: a THREADS batch of 4 torch guests over two
hosts (2 + 2) restores the flagship's fp32 weights from the main
thread's snapshot, each thread adds its share's SGD update into its
host's memory image, and the hosts' diffs merge through a float SUM
region into the main snapshot, against the same shares' gradients taken
directly; a second batch is placed from the decision cache; a chained
call tree scores two prompts. faabric's data planes: the same two-host
gang takes the flagship's data-parallel step with its gradient on the
shm rings, on bulk TCP, with parameter broadcasts on the delta wire
codec, and on the int8 leader ring of the hierarchical allreduce,
against the raw and exact paths. faabric's telemetry and fault points:
the data-parallel step traced on one host's device plane and across
two hosts on bulk TCP (spans, the comm matrix, the collective profiler,
the perf store and a planted straggler checked against counters and
each other), with fault rules failing or healing exactly what they
name, then the same steps with telemetry off and on in child
processes. Live migration, spot freeze and thaw, recovery and aborts:
a data-parallel gang of the full-width model spread over two hosts
consolidates onto one after its second step, its moved ranks re-entering
there and taking rank 0's parameters; a spot-evicted serving guest parks
its memory image on the planner and is thawed on the other host, its
logits bitwise unchanged; a serving batch whose share on one host is
stranded is requeued onto the other; an abort crosses hosts directly and
through the planner's relay. A serving batch outlives its planner: the
planner runs as a child process over a write-ahead journal and is
SIGKILLed while 4 of 8 requests are held in their guests; the held
results wait on their workers and reach the restarted planner, which
replays the journal, without any request running twice. Hosts as
processes: the data-parallel step of the data planes again, with its
planner started through ``python -m faabric_tpu_torch.runner planner``
and its two worker hosts as child processes of this script
(``--worker-child``) on the card, held bitwise to the same step with
both hosts in this process, the worker processes under the port's
lock-order detector (``FAABRIC_LOCKCHECK=1``), which must see no
held-before cycle. Their telemetry, read live: after each
plane's steps the planner's REST endpoint (``/metrics``, ``/trace``,
``/commmatrix``, ``/healthz``, ``/topology``, ``/profile`` and the rest)
and the workers' own endpoints are scraped and held against the
children's counters, and the doctor, timeline, statemap, profile and
flightdump CLIs read them. The two worker processes also join a
2-process device plane through the planner at boot, and a gang of 2 + 2
ranks across them runs on it: int32 collectives against the host ring,
the flagship gradient's fp32 allreduce resident on the card, its bytes
crossing the processes through CUDA IPC windows, against the
single-process plane's fold, and the ring permute whose kernel writes
into the other process's window. Then a worker process is SIGKILLed under a
serving batch: 8 requests of the full-width model at 2 layers over the
two worker processes, the share of one held in its guests when that
process is killed; the planner finds the lost host by its host timeout
and requeues the share onto the other, every token equal to direct
serving. Every phase prints ``phase N: start`` and
``phase N: ok in X s``, and a failed check its phase. For each path
it checks the outputs and shows from the kernels' launch counts that
the path ran through them; it times the kernels, their plain versions and the nearest
PyTorch library calls, and prints one JSON line of kernel numbers (the
serving kernels' launches summed over the direct serving path and the
executors) and, last, the device line.

It needs a CUDA card and exits non-zero without one. It imports nothing
of JAX or of the JAX package. Any failed check raises and the script
exits non-zero; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
# Backward kernels against their plain version in fp32: summation order
# only, at the JAX package's gradient tolerance. bf16 has no fixed bound:
# see check_bwd.
BWD_ATOL, BWD_RTOL = 2e-4, 1e-3
# The MPI phases: the flagship's 45,355,520 fp32 parameters as one
# gradient per rank, and over 4 ranks as 11,338,880-element shards
GRAD_ELEMS = 45_355_520
MPI_RANKS = 4


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


def profile_top(fn, label: str, top: int = 6) -> tuple[float, dict]:
    """Device time by kernel over one call of ``fn``, from torch.profiler:
    logs the device's busy time against the call's wall time and the
    kernels that take most of it; returns the busy µs and the µs by
    kernel name. Annotated ranges (such as the optimizer's
    step) span kernels counted on their own, so they are left out. One
    warm-up call runs under the tracer first: without it, a call made on
    rank threads lost its first kernel from the trace on the card."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile {label}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total:9.1f} us  x{e.count:<4d} "
            f"{e.key[:90]}")
    return busy_us, {e.key: e.self_device_time_total for e in kernels}


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
    return float((a.detach().float() - b.detach().float()).abs().max())


_phase: dict = {"n": None, "t0": 0.0}


def begin_phase(n: int) -> None:
    """Close the phase that runs (``phase N: ok in X s``) and start phase
    ``n`` (``phase n: start``)."""
    end_phase()
    _phase.update(n=n, t0=time.perf_counter())
    log(f"phase {n}: start")


def end_phase() -> None:
    if _phase["n"] is not None:
        log(f"phase {_phase['n']}: ok in "
            f"{time.perf_counter() - _phase['t0']:.1f} s")
        _phase["n"] = None


def check(ok: bool, what: str) -> None:
    """Pass, or print the phase and what was compared and raise."""
    if not ok:
        where = "" if _phase["n"] is None else f"phase {_phase['n']}: "
        log(f"{where}check failed: {what}")
        raise AssertionError(what)
    log(f"  ok  {what}")


def close_or_as_close(got, want, f32, what: str) -> float:
    """fp32 ``got`` within BWD_ATOL + BWD_RTOL |want| of ``want``; bf16
    ``got`` as close to the fp32 computation ``f32`` as the plain bf16
    ``want`` is: max within 2x, mean within 1.25x. Returns max |got -
    want|."""
    err = max_err(got, want)
    if got.dtype == torch.float32:
        ok = bool(((got - want).abs() <= BWD_ATOL + BWD_RTOL * want.abs()).all())
        check(ok, f"{what}: max |err| {err:.3g}")
        return err
    err_k = (got.float() - f32).abs()
    err_r = (want.float() - f32).abs()
    check(float(err_k.max()) <= 2 * float(err_r.max()) + 1e-6
          and float(err_k.mean()) <= 1.25 * float(err_r.mean()) + 1e-7,
          f"{what}: max |err| {err:.3g}; vs fp32 max {float(err_k.max()):.3g} "
          f"mean {float(err_k.mean()):.3g} (plain bf16: max "
          f"{float(err_r.max()):.3g} mean {float(err_r.mean()):.3g})")
    return err


def run_ranks(n: int, fn) -> dict:
    """``fn(rank)`` on n threads, the ranks of one MPI world; re-raises
    the first error (a swallowed rank error would present as a hang)."""
    import threading

    results, errors = {}, []

    def run(r):
        try:
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("an MPI rank thread hung")
    return results


def world_ms(n: int, fn, iters: int = 10) -> float:
    """Wall ms per call of ``fn`` on n rank threads that are already
    running: rank 0's clock from a barrier to the end of ``iters`` calls,
    ending in a synchronize (thread start-up is not counted)."""
    import threading

    barrier = threading.Barrier(n)

    def body(r):
        fn(r)
        torch.cuda.synchronize()
        barrier.wait()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(r)
        torch.cuda.synchronize()
        barrier.wait()
        return (time.perf_counter() - t0) * 1e3 / iters

    return run_ranks(n, body)[0]


def ring_kernel_phase(dev) -> tuple[dict, dict, float]:
    """Phase 11: the ring-permute kernel against its plain version,
    bitwise, then its times at the main path's shape (4 ranks of
    11,338,880 fp32, the flagship's 45,355,520 parameters over 4: phase
    23a's round, too)."""
    from faabric_tpu_torch.ops.ring_permute import (
        _reference_ring_permute,
        ring_permute,
    )

    log("phase 11: ring_permute kernel vs plain")
    gen = torch.Generator(device=dev).manual_seed(11)
    n, m_main = MPI_RANKS, GRAD_ELEMS // MPI_RANKS
    worst = 0.0
    sizes = (m_main, 1_000_003, 1)
    for dtype in (torch.int32, torch.float32, torch.bfloat16, torch.uint8):
        for m in sizes:
            for off in (0, 1):
                bases = [torch.randint(0, 255, (m + off,), device=dev,
                                       generator=gen).to(dtype)
                         if not dtype.is_floating_point else
                         torch.randn(m + off, device=dev,
                                     generator=gen).to(dtype)
                         for _ in range(n)]
                ins = [b[off:] for b in bases]
                for shift in (1, 2, 3):
                    got = ring_permute(ins, shift)
                    want = [torch.empty_like(t) for t in ins]
                    _reference_ring_permute(ins, want, shift)
                    torch.cuda.synchronize()
                    same = all(torch.equal(g, w) for g, w in zip(got, want))
                    worst = max(worst, max(max_err(g, w)
                                           for g, w in zip(got, want)))
                    if not same:
                        raise AssertionError(
                            f"ring_permute {dtype} m={m} offset={off} "
                            f"shift={shift}: not bitwise equal")
                del bases, ins, got, want
        log(f"  ok  ring_permute {str(dtype)[6:]}: m in {sizes}, aligned and "
            f"one element off, shifts 1-3, bitwise")
    ins = [torch.randn(m_main, device=dev, generator=gen) for _ in range(n)]
    outs = [torch.empty_like(t) for t in ins]
    # The library's one call for the same function: a multi-tensor copy
    # into the outputs taken in ring order
    permuted = [outs[(r + 1) % n] for r in range(n)]
    torch._foreach_copy_(permuted, ins)
    check(all(torch.equal(outs[(r + 1) % n], ins[r]) for r in range(n)),
          "torch._foreach_copy_ computes the ring hop")

    t = {"ms": time_ms(lambda: ring_permute(ins, 1, outs)),
         "plain_ms": time_ms(lambda: _reference_ring_permute(ins, outs, 1)),
         "library_ms": time_ms(lambda: torch._foreach_copy_(permuted, ins))}
    moved = 2 * n * m_main * 4
    bounds = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "operations": 0.0}
    log(f"ring_permute 4 x {m_main} fp32: kernel {t['ms']:.4f} ms, plain "
        f"(copy_ loop) {t['plain_ms']:.4f} ms, torch._foreach_copy_ "
        f"{t['library_ms']:.4f} ms, bound "
        f"{bounds['bytes']:.4f} ms (bytes: {moved} moved), "
        f"{moved / t['ms'] / 1e6:.0f} GB/s")
    return t, bounds, worst


def mpi_world_phase(dev, build) -> dict:
    """Phase 12: a 4-rank MpiWorld whose ranks are threads of this
    process, every rank on ``dev``, driven through the device plane with
    device-resident tensors. Returns the ring-kernel launches of the
    phase's main run."""
    from faabric_tpu_torch.batch_scheduler import SchedulingDecision
    from faabric_tpu_torch.device_plane import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.mpi import MpiOp, MpiWorld
    from faabric_tpu_torch.mpi.schedule_compile import compile_schedule
    from faabric_tpu_torch.mpi.types import MpiMessageType
    from faabric_tpu_torch.transport import PointToPointBroker

    log("phase 12: MPI world of 4 ranks on one card")
    n, grad_elems = MPI_RANKS, GRAD_ELEMS
    k = grad_elems // n
    broker = PointToPointBroker("card")
    decision = SchedulingDecision(app_id=12, group_id=12)
    for r in range(n):
        decision.add_message("card", 120 + r, r, r, device_id=r)
    broker.set_up_local_mappings_from_decision(decision)
    world = MpiWorld(broker, 12, n, 12)
    world.refresh_rank_hosts()
    check(all(run_ranks(n, world.activate_device_plane).values()),
          "activate_device_plane on every rank")
    plane = world.device_plane()
    check(plane is not None and plane.device == dev
          and plane.devices == [dev] * n,
          f"plane active, all {n} ranks on {plane.device}")

    gen = torch.Generator(device=dev).manual_seed(12)
    grads = [torch.randn(grad_elems, device=dev, generator=gen)
             for _ in range(n)]
    shards = [torch.randn(k, device=dev, generator=gen) for _ in range(n)]
    sched = compile_schedule("allgather.ring", "allgather", world.topology())

    def ring_schedule(r, inputs):
        env = {("in", 0): inputs[r]}
        world._run_schedule(r, sched, env, None, lambda sym, e: k,
                            MpiMessageType.ALLGATHER)
        return torch.cat([torch.as_tensor(env[("out", q)]).to(dev)
                          for q in range(n)])

    calls = {
        "allreduce": lambda r: world.allreduce(r, grads[r], MpiOp.SUM),
        "allgather": lambda r: world.allgather(r, shards[r]),
        "reduce_scatter": lambda r: world.reduce_scatter(r, grads[r],
                                                         MpiOp.SUM),
        **{f"ring_permute shift {s}":
           (lambda r, s=s: plane.ring_permute(r, shards[r], s))
           for s in (1, 2, 3)},
        "allgather.ring schedule": lambda r: ring_schedule(r, shards),
    }
    ring_per_call = {"ring_permute shift 1": 1, "ring_permute shift 2": 1,
                     "ring_permute shift 3": 1,
                     "allgather.ring schedule": n - 1}

    def fold(parts):
        acc = parts[0] + parts[1]
        for t in parts[2:]:
            acc += t
        return acc

    # The plain results, in plain torch ops (the ring's are views)
    gathered = torch.cat(shards)
    want = {"allreduce": [fold(grads)] * n,
            "allgather": [gathered] * n,
            "reduce_scatter": [fold([g[r * k:(r + 1) * k] for g in grads])
                               for r in range(n)],
            "allgather.ring schedule": [gathered] * n,
            **{f"ring_permute shift {s}": [shards[(r - s) % n]
                                           for r in range(n)]
               for s in (1, 2, 3)}}

    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_device_copy_totals()
    build.reset_launch_counts()
    for name, fn in calls.items():
        before = build.LAUNCHES["ring_permute"]
        outs = run_ranks(n, fn)
        torch.cuda.synchronize()
        grew = build.LAUNCHES["ring_permute"] - before
        check(plane.disabled_reason is None
              and grew == ring_per_call.get(name, 0),
              f"{name}: plane enabled, ring kernel launched {grew} times")
        check(all(torch.equal(outs[r], want[name][r])
                  and outs[r].device == dev for r in range(n))
              and len({outs[r].data_ptr() for r in range(n)}) == n,
              f"{name}: bitwise equal to the plain result, one tensor a rank")
        del outs
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 - held_gib
    log(f"MPI phase launches: {launches}")
    copies = device_copy_totals()
    check(copies["count"] == 0, f"resident rounds moved no host copies "
          f"({copies})")
    del want

    # One host (numpy) round: one placement and one readback per rank
    host = [s[:1 << 20].cpu().numpy() for s in shards]
    reset_device_copy_totals()
    out = run_ranks(n, lambda r: world.allreduce(r, host[r], MpiOp.SUM))
    copies = device_copy_totals()["by_reason"]
    check(copies.get("h2d.input", {}).get("count") == n
          and copies.get("d2h.readback", {}).get("count") == n
          and set(copies) == {"h2d.input", "d2h.readback"}
          and all(np.array_equal(out[r], fold([torch.from_numpy(h)
                                               for h in host]).numpy())
                  for r in range(n)),
          f"numpy allreduce round: {n} h2d.input and {n} d2h.readback")

    # A ring kernel that does not build fails the resident schedule on
    # the caller: no host steps, no staging copy, the plane stays enabled
    def no_build():
        raise RuntimeError("injected: kernel build failed")

    kernels, build.kernels = build.kernels, no_build
    reset_device_copy_totals()
    try:
        run_ranks(n, lambda r: ring_schedule(r, shards))
        raised = None
    except RuntimeError as e:
        raised = e
    finally:
        build.kernels = kernels
    check(raised is not None and "injected" in str(raised)
          and device_copy_totals()["count"] == 0
          and plane.disabled_reason is None,
          "a failing ring kernel raises to the caller, no host re-run")

    log("MPI collectives, 4 ranks on one card (wall: rank 0's host clock "
        "over 10 calls by running rank threads, ending in a synchronize; "
        "device: busy time of one call from torch.profiler)")
    for name, fn in calls.items():
        log(f"  {name}: {world_ms(n, fn):.3f} ms wall per call")
        profile_top(lambda fn=fn: run_ranks(n, fn), name, top=3)
    check(plane.disabled_reason is None, "plane still enabled after timing")
    log(f"peak memory in the MPI phase: {peak_gib:.3f} GiB above the "
        f"{held_gib:.3f} GiB allocated when its collectives began")
    return launches


def faabric_phase(dev, model, build) -> dict:
    """Phase 13: faabric's own main path on the card. A port planner and
    one port WorkerRuntime (8 slots, one device id per CUDA device) in
    this process on localhost host aliases: stage 1 of
    ``__graft_entry__.py::dryrun_multichip`` (a gang of 4 through
    ``call_functions``: mappings, group barrier, ring handoff, barrier),
    then one batch of 8 ``serve``
    requests, each a 512-token prompt that a TorchExecutor guest scores
    with ``forward`` and continues with 32 greedy ``generate`` tokens on
    ``ctx.device``. The tokens must equal direct calls on the same
    prompts, and the batch's kernel launches must be exactly those of 8
    forwards and 8 generate calls. Returns the batch's launches."""
    from faabric_tpu_torch.executor import (
        GuestContext,
        TorchExecutor,
        TorchExecutorFactory,
        register_function,
    )
    from faabric_tpu_torch.models import forward, generate
    from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
    from faabric_tpu_torch.transport import PointToPointBroker

    log("phase 13: faabric's main path: planner, worker, executors, "
        "torch guests on the card")
    n_req, prompt_len, n_new = 8, 512, 32
    cfg = model.cfg
    timeout = 300.0

    @register_function("dryrun", "gang")
    def gang(ctx):
        msg, broker = ctx.message, ctx.broker
        broker.wait_for_mappings(msg.group_id, timeout=timeout)
        group = broker.get_group(msg.group_id)
        group.barrier(msg.group_idx, timeout=timeout)
        n = group.group_size
        nxt, prv = (msg.group_idx + 1) % n, (msg.group_idx - 1) % n
        broker.send_message(msg.group_id, msg.group_idx, nxt,
                            bytes([msg.group_idx]))
        got = broker.recv_message(msg.group_id, prv, msg.group_idx,
                                  timeout=timeout)
        if got != bytes([prv]):
            raise RuntimeError(f"rank {msg.group_idx} got {got!r} from {prv}")
        group.barrier(msg.group_idx, timeout=timeout)
        return str(ctx.device).encode()

    @register_function("smoke", "serve")
    def serve(ctx):
        if ctx.device != model.device:
            raise RuntimeError(f"pinned to {ctx.device}, the model is on "
                               f"{model.device}")
        t0 = time.perf_counter()
        prompt = torch.frombuffer(bytearray(ctx.message.input_data),
                                  dtype=torch.int32).to(ctx.device)[None]
        with torch.inference_mode():
            scores = forward(model, prompt)[0].argmax(-1).to(torch.int32)
            tokens = generate(model, prompt, n_new)[0]
        out = torch.cat([scores, tokens]).cpu().numpy().tobytes()
        ctx.message.int_exec_graph_details["run_us"] = int(
            (time.perf_counter() - t0) * 1e6)
        return out

    @register_function("smoke", "fail")
    def fail(ctx):
        raise RuntimeError("injected guest failure")

    planner_server, (worker,) = start_cluster({"smoke-host": n_req},
                                              TorchExecutorFactory())
    client = worker.planner_client

    def run_batch(user, function, inputs):
        req = batch_exec_factory(user, function, len(inputs))
        for m, data in zip(req.messages, inputs):
            m.input_data = data
        t0 = time.perf_counter()
        decision = client.call_functions(req)
        results = [client.get_message_result(req.app_id, m.id,
                                             timeout=timeout)
                   for m in req.messages]
        return decision, results, (time.perf_counter() - t0) * 1e3

    try:
        check(worker.n_devices == torch.cuda.device_count(),
              f"worker registers {worker.n_devices} CUDA device(s)")

        # -- 13a. stage 1 of dryrun_multichip ------------------------------
        decision, results, gang_ms = run_batch("dryrun", "gang", [b""] * 4)
        check(decision.n_messages == 4 and len(set(decision.group_idxs)) == 4
              and all(0 <= d < torch.cuda.device_count()
                      for d in decision.device_ids),
              f"gang of 4 scheduled, device ids {decision.device_ids}")
        check(all(r.return_value == int(ReturnValue.SUCCESS)
                  for r in results)
              and {r.output_data for r in results} == {str(dev).encode()},
              f"gang of 4: barrier, ring handoff and barrier on {dev} "
              f"({gang_ms:.1f} ms through the planner)")

        # -- 13b. serving through faabric ----------------------------------
        rng = np.random.RandomState(0)
        prompts = rng.randint(0, cfg.vocab_size,
                              (n_req, prompt_len)).astype(np.int32)
        inputs = [p.tobytes() for p in prompts]
        run_batch("smoke", "serve", inputs)  # warm: executors, threads
        torch.cuda.synchronize()
        build.reset_launch_counts()
        decision, results, round_trip_ms = run_batch("smoke", "serve",
                                                     inputs)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        log(f"faabric phase launches: {launches}")
        check(all(r.return_value == int(ReturnValue.SUCCESS)
                  for r in results),
              f"{n_req} serve requests SUCCESS ("
              + "; ".join(r.output_data.decode(errors="replace")[:80]
                          for r in results
                          if r.return_value != int(ReturnValue.SUCCESS))
              + ")")
        check(set(decision.hosts) == {"smoke-host"}
              and set(decision.device_ids) == {dev.index},
              f"all requests pinned to device {dev.index}")

        # Each prompt directly on this thread and alone through the
        # planner, in turns (direct first on even prompts, second on
        # odd), so both sides see the same stretch of the shared host
        def direct_call(p):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prompt = torch.as_tensor(p, device=dev)[None]
            with torch.inference_mode():
                scores = forward(model, prompt)[0].argmax(-1).to(torch.int32)
                tokens = generate(model, prompt, n_new)[0]
            out = torch.cat([scores, tokens]).cpu().numpy()
            return out, (time.perf_counter() - t0) * 1e3

        direct, direct_ms, alone, alone_ms = [], [], [], []
        for i, (p, data) in enumerate(zip(prompts, inputs)):
            if i % 2:
                _, (r,), ms = run_batch("smoke", "serve", [data])
                out, d_ms = direct_call(p)
            else:
                out, d_ms = direct_call(p)
                _, (r,), ms = run_batch("smoke", "serve", [data])
            direct.append(out)
            direct_ms.append(d_ms)
            alone.append(r)
            alone_ms.append(ms)
        check(all(r.return_value == int(ReturnValue.SUCCESS)
                  and np.array_equal(np.frombuffer(r.output_data, np.int32), d)
                  for r, d in zip(alone, direct)),
              f"{n_req} requests alone through the planner: same tokens as "
              f"direct")
        served = [np.frombuffer(r.output_data, np.int32) for r in results]
        check(all(s.shape == (prompt_len + n_new,) for s in served)
              and all(0 <= int(s.min()) and int(s.max()) < cfg.vocab_size
                      for s in served),
              "served argmax and tokens in range")
        check(all(np.array_equal(s, d) for s, d in zip(served, direct)),
              "served scoring argmax and 32 greedy tokens equal direct "
              "forward and generate on the card, token for token")
        rms_want = n_req * (9 + 9 * n_new)
        check(launches.get("flash_attention.wgmma", 0) == n_req * cfg.n_layers
              and launches.get("flash_attention", 0) == n_req * cfg.n_layers,
              f"flash forward: {launches.get('flash_attention.wgmma', 0)} "
              f"wgmma launches = {n_req} scoring forwards x {cfg.n_layers} "
              f"layers")
        check(launches.get("rms_norm", 0) == rms_want,
              f"rms_norm: {launches.get('rms_norm', 0)} launches = {n_req} "
              f"x (9 a forward + 9 x {n_new} in generate)")

        run_ms = [r.int_exec_graph_details["run_us"] / 1e3 for r in results]
        log(f"serving through the planner, {n_req} requests of 1 x "
            f"{prompt_len} + {n_new} tokens, {n_req} executor threads on "
            f"{dev}: round trip (submit to last result) {round_trip_ms:.1f} "
            f"ms, {round_trip_ms / n_req:.2f} ms wall per request; guest run "
            f"time mean {np.mean(run_ms):.1f} ms, max {np.max(run_ms):.1f} "
            f"ms")
        alone_run_ms = [r.int_exec_graph_details["run_us"] / 1e3
                        for r in alone]
        log(f"one request at a time through the planner, in turns with the "
            f"direct calls: round trip median {np.median(alone_ms):.2f} ms "
            f"(guest run time median {np.median(alone_run_ms):.2f} ms) "
            f"against direct {np.median(direct_ms):.2f} ms; the control "
            f"plane adds {np.median(alone_ms) - np.median(alone_run_ms):.2f} "
            f"ms a request; pairs (direct, guest alone) ms: "
            + ", ".join(f"({d:.1f}, {a:.1f})"
                        for d, a in zip(direct_ms, alone_run_ms)))
        profile_top(lambda: run_batch("smoke", "serve", inputs),
                    f"batch of {n_req} serve requests through the planner",
                    top=4)

        # -- 13c. nothing falls back -----------------------------------------
        _, results, _ = run_batch("smoke", "fail", [b""])
        check(results[0].return_value == int(ReturnValue.FAILED)
              and b"injected guest failure" in results[0].output_data,
              "a failing guest reaches the caller as FAILED")
        broker = PointToPointBroker("solo")
        from faabric_tpu_torch.batch_scheduler import SchedulingDecision

        missing = torch.cuda.device_count()
        pinned = SchedulingDecision(app_id=13, group_id=13)
        pinned.add_message("solo", 1, 0, 0, device_id=missing)
        broker.set_up_local_mappings_from_decision(pinned)
        req = batch_exec_factory("smoke", "serve", 1)
        req.messages[0].group_id = 13
        executor = TorchExecutor(req.messages[0], "cuda")
        executor.scheduler = type("Sched", (), {"ptp_broker": broker})()
        try:
            GuestContext(executor, req.messages[0], req).device
            raised = False
        except RuntimeError:
            raised = True
        check(raised, f"a guest pinned to device {missing}, which this host "
              f"lacks, raises")
    finally:
        stop_cluster(planner_server, [worker])
    return launches


def mesh_phase(dev, build, unsharded_step: tuple[float, float]) -> dict:
    """Phase 14: the port's ``dryrun_multichip`` on the card. Stages 1-5
    with 8 ranks (tp 2, sp 2, dp 2) and with 4 (tp 2, dp 2), every rank
    on ``dev``, at full width (``ModelConfig()`` and a ``MoEConfig`` of
    the same widths, head dim 64, fp32 compute). Then, on the 8-rank mesh: ring attention with the kernels
    against the same schedule with plain blocks at the ring's block shape;
    the sharded step against the unsharded one on the same weights and
    8 x 512 batch (fp32 compute at one layer: loss, gradients and updated
    parameters; bf16 at full width: the loss); three full-width bf16
    steps whose launches must be the schedule's (the main path of the
    phase, counts reset before and read after); one step of the 4-rank
    mesh likewise; timings, and the kernels' times at the ring blocks'
    shape. ``unsharded_step`` is phase 10's (host ms, device busy µs) of
    the unsharded step. Returns the main path's launches."""
    from faabric_tpu_torch.entry import dryrun_multichip
    from faabric_tpu_torch.models import (
        ModelConfig,
        MoEConfig,
        Transformer,
        data_sharding,
        loss_fn,
        make_optimizer,
        make_train_step,
        params_to_numpy,
        shard_params,
    )
    from faabric_tpu_torch.ops.flash_attention import (
        _kernel_flash,
        _kernel_flash_bwd_dkv,
        _kernel_flash_bwd_dq,
        _reference_attention,
    )
    from faabric_tpu_torch.models.transformer import _leaves
    from faabric_tpu_torch.ops.ring_permute import ring_permute
    from faabric_tpu_torch.parallel import (
        DeviceCollectives,
        MeshConfig,
        ShardSpec,
        build_mesh,
        ring_attention,
    )
    from faabric_tpu_torch.parallel.ring_attention import (
        _flash_block,
        _plain_block,
        _ring,
        schedule_counts,
    )

    log("phase 14: dryrun_multichip stages 1-5 on the card, full width, fp32")
    cfg = ModelConfig()
    # Full width with fp32 compute, so the dry run's own 1e-4 checks hold
    # as the reference's (fp32) do: ModelConfig() and, for stages 4-5,
    # the MoE family at the same widths (the reference's stage-4 layers
    # and experts: 1 layer, 2 experts)
    cfg32w = dataclasses.replace(cfg, compute_dtype=torch.float32)
    moe32w = MoEConfig(n_layers=1, n_experts=2, compute_dtype=torch.float32)
    for n in (8, 4):
        t0 = time.perf_counter()
        res = dryrun_multichip(n, cfg=cfg32w, moe_cfg=moe32w)
        check(all(np.isfinite(x) for x in res if x is not None)
              and (res.moe_pp_loss is None) == (n % 8 != 0),
              f"dryrun_multichip({n}): gang, allreduce vs numpy, the "
              f"sharded step, the pipeline (pp vs dense, GPipe vs 1F1B vs "
              f"the sharded step, 1e-4), the MoE step, MoE stages in the "
              f"pipeline; loss {res.loss:.4f} pp_loss {res.pp_loss} "
              f"moe_loss {res.moe_loss} moe_pp_loss {res.moe_pp_loss} "
              f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")

    mesh = build_mesh([dev] * 8, MeshConfig(tp=2, sp=2))
    shard = data_sharding(mesh).shard
    gen = torch.Generator(device=dev).manual_seed(14)

    # -- 14b. ring attention: kernels against plain blocks ------------------
    spec = ShardSpec(mesh, ("dp", "sp", "tp", None))
    # Each rank's q, k, v as views of its own (4, 256, 3, 4, 64) product,
    # as the model passes them
    pieces = spec.shard(torch.randn(8, 512, 8, 3, 64, device=dev,
                                    generator=gen))
    per_rank = [t.transpose(2, 3).contiguous() for t in pieces]
    cot = spec.shard(torch.randn(8, 512, 8, 64, device=dev, generator=gen))

    class PlainRing:
        """The K/V rotation in plain PyTorch (list indexing, which
        autograd differentiates), so that the plain schedule runs neither
        the flash kernels nor the ring kernel."""

        def __init__(self, n):
            self.n = n

        def shift(self, xs, disp=1):
            return [xs[(r - disp) % self.n].clone() for r in range(self.n)]

    def plain_ring_attention(q, k, v):
        out = [None] * mesh.size
        for ranks in mesh.groups("sp"):
            ys = _ring(PlainRing(len(ranks)), [q[r] for r in ranks],
                       [k[r] for r in ranks], [v[r] for r in ranks], True,
                       _plain_block)
            for r, y in zip(ranks, ys):
                out[r] = y
        return out

    def ring_run(kernels, dtype):
        qkv = [t.to(dtype) for t in per_rank]
        ts = [[t[:, :, i].detach().requires_grad_() for t in qkv]
              for i in range(3)]
        out = (ring_attention(*ts, mesh, block=_flash_block) if kernels
               else plain_ring_attention(*ts))
        torch.autograd.backward(out, [c.to(dtype) for c in cot])
        return out, [[t.grad for t in x] for x in ts]

    build.reset_launch_counts()
    out_k, grads_k = ring_run(True, torch.bfloat16)
    torch.cuda.synchronize()
    ring_counts = dict(build.LAUNCHES)
    once = schedule_counts(8, 2)
    check(all(ring_counts.get(f"{n}.wgmma", 0) == once["flash_attention"]
              for n in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"))
          and ring_counts.get("ring_permute", 0) == 2 * once["ring_permute"],
          f"ring attention over 8 ranks: {once['flash_attention']} flash "
          f"forwards, dQ and dK/dV passes, all wgmma, and "
          f"{2 * once['ring_permute']} ring launches ({ring_counts})")
    build.reset_launch_counts()
    out_p, grads_p = ring_run(False, torch.bfloat16)
    out_32, grads_32 = ring_run(False, torch.float32)
    torch.cuda.synchronize()
    check(sum(build.LAUNCHES.values()) == 0,
          f"the plain ring schedule launched no kernel ({build.LAUNCHES})")
    ring_err = max(max_err(a, b) for a, b in zip(out_k, out_p))
    check(ring_err <= FLASH_ATOL[torch.bfloat16],
          f"ring attention bf16 out vs plain blocks: max |err| {ring_err:.3g}")
    for name, gk, gp, g32 in zip("qkv", grads_k, grads_p, grads_32):
        close_or_as_close(torch.cat(gk), torch.cat(gp), torch.cat(g32),
                          f"ring attention d{name} (8 ranks of (4, 256, 4, "
                          f"64)) bf16")
    del out_k, grads_k, out_p, grads_p, out_32, grads_32, per_rank, pieces

    # -- 14c. sharded against unsharded, same weights and batch -------------
    rng = np.random.RandomState(0)
    batches = [[rng.randint(0, cfg.vocab_size, (8, 512)).astype(np.int32)
                for _ in range(2)] for _ in range(3)]
    tok_np, tgt_np = batches[0]
    tok_t, tgt_t = (torch.as_tensor(a, device=dev) for a in batches[0])
    spec_opt = make_optimizer()

    cfg32 = dataclasses.replace(cfg, n_layers=1, compute_dtype=torch.float32)
    plain = Transformer(cfg32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    sharded = shard_params(plain, mesh, cfg32)
    loss_p = float(make_train_step(cfg32, spec_opt)(
        plain, spec_opt.init(plain), tok_t, tgt_t))
    grads_p = {n: p.grad.clone() for n, p in plain.named_parameters()}
    loss_s = float(make_train_step(cfg32, spec_opt)(
        sharded, spec_opt.init(sharded), shard(tok_np), shard(tgt_np))[0])
    check(abs(loss_s - loss_p) <= 1e-4,
          f"fp32, 1 layer: sharded loss {loss_s:.6f} vs unsharded "
          f"{loss_p:.6f} (|diff| {abs(loss_s - loss_p):.2e}, limit 1e-4)")
    worst = 0.0
    for name, pspec in sharded.specs.items():
        g = pspec.gather([p.grad for p in sharded.copies(name)])
        worst = max(worst, float((g - grads_p[name]).norm()
                                 / grads_p[name].norm()))
    check(worst <= 1e-4, f"fp32 gradients, gathered from the shards: worst "
          f"relative L2 error {worst:.2e} (limit 1e-4)")
    flat = [(a, b) for (_, a), (_, b) in zip(
        _leaves(params_to_numpy(sharded)), _leaves(params_to_numpy(plain)))]
    # AdamW's first step moves an element by about lr·sign(g): where |g|
    # is within summation noise of 0 it may go either way (up to lr)
    err_max = max(float(np.abs(a - b).max()) for a, b in flat)
    loose = sum(int((np.abs(a - b) > 2e-6).sum()) for a, b in flat)
    total = sum(a.size for a, _ in flat)
    check(err_max <= spec_opt.lr and loose <= 1e-3 * total,
          f"fp32 updated parameters: max |diff| {err_max:.2e} (limit lr "
          f"{spec_opt.lr}), {loose} of {total} beyond 2e-6")
    del plain, sharded, grads_p, flat

    model_p = Transformer(cfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    model = shard_params(model_p, mesh, cfg)
    with torch.no_grad():
        bf_p = float(loss_fn(model_p, tok_t, tgt_t))
        bf_s = float(loss_fn(model, shard(tok_np), shard(tgt_np))[0])
    check(abs(bf_s - bf_p) <= 2e-2,
          f"bf16, full width: sharded loss {bf_s:.5f} vs unsharded "
          f"{bf_p:.5f} (|diff| {abs(bf_s - bf_p):.2e}, limit 2e-2, 0.2% of "
          f"the loss)")
    del model_p

    # -- 14d. the main path: three full-width steps over 8 ranks -----------
    opt = spec_opt.init(model)
    step = make_train_step(cfg, spec_opt)
    shards = [(shard(t), shard(y)) for t, y in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    losses = [step(model, opt, *b)[0] for b in shards]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    log(f"mesh path launches (3 steps): {launches}")
    check(all(np.isfinite(losses)), "three full-width steps over 8 ranks, "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}")

    def expect(n, sp, steps):
        per = (schedule_counts(n, sp) if sp > 1
               else {"flash_attention": n, "ring_permute": 0})
        layers = cfg.n_layers
        return {"flash_attention": steps * 2 * layers * per["flash_attention"],
                "flash_bwd_dq": steps * layers * per["flash_attention"],
                "flash_bwd_dkv": steps * layers * per["flash_attention"],
                "ring_permute": steps * 3 * layers * per["ring_permute"]}

    def check_counts(got, want, label):
        for name, n in want.items():
            bodies = (got.get(name, 0) if name == "ring_permute"
                      else got.get(f"{name}.wgmma", 0))
            check(got.get(name, 0) == n and bodies == n,
                  f"{label}: {name} launched {got.get(name, 0)} times, the "
                  f"schedule's {n}"
                  + ("" if name == "ring_permute" else ", all wgmma"))
        check(got.get("rms_norm", 0) == 0,
              f"{label}: no RMS-norm kernel (a mesh takes the plain norm)")

    check_counts(launches, expect(8, 2, 3), "8 ranks, 3 steps")
    mesh4 = build_mesh([dev] * 4, MeshConfig(tp=2))
    m4 = shard_params(Transformer(cfg, device=dev), mesh4, cfg)
    step4 = make_train_step(cfg, spec_opt)
    shard4 = data_sharding(mesh4).shard
    build.reset_launch_counts()
    loss4 = float(step4(m4, spec_opt.init(m4), shard4(tok_np),
                        shard4(tgt_np))[0])
    torch.cuda.synchronize()
    check(np.isfinite(loss4), f"one step over 4 ranks (tp 2, dp 2): loss "
          f"{loss4:.4f}")
    check_counts(dict(build.LAUNCHES), expect(4, 1, 1), "4 ranks, 1 step")
    del m4, step4

    # -- 14e. timings ----------------------------------------------------------
    tok, tgt = shards[0]
    step_ms = host_ms(lambda: step(model, opt, tok, tgt), iters=3)
    busy_us, by_kernel = profile_top(lambda: step(model, opt, tok, tgt),
                                     "sharded train step, 8 ranks on one "
                                     "card, 8x512", top=8)
    ring_us = sum(t for n, t in by_kernel.items() if "ring_permute" in n)
    flash_us = sum(t for n, t in by_kernel.items() if "flash" in n)
    log(f"sharded step 8x512 over 8 ranks (dp 2, tp 2, sp 2) on {dev}: "
        f"{step_ms:.1f} ms wall, device busy {busy_us / 1e3:.2f} ms "
        f"({flash_us:.1f} us in the flash kernels, {ring_us:.1f} us in "
        f"the ring kernel); the unsharded step (phase 10): "
        f"{unsharded_step[0]:.1f} ms wall, {unsharded_step[1] / 1e3:.2f} ms "
        f"busy; peak memory over the 3 steps {peak_gib:.3f} GiB")

    # The kernels at the ring blocks' shape, causal (diagonal) and not
    # (past), beside SDPA there
    times = {}
    b, s, h, d = 4, 256, 4, 64
    q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen
                               ).to(torch.bfloat16) for _ in range(4))
    qt, kt, vt, dot_ = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.clone().requires_grad_() for t in (qt, kt, vt))
    for causal in (True, False):
        out, lse = _kernel_flash(q, k, v, causal)
        _, delta = _kernel_flash_bwd_dq(q, k, v, do, out, lse, None, causal)

        def sdpa_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            torch.autograd.grad(o, (qg, kg, vg), dot_)

        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        times[causal] = {
            "fwd": time_ms(lambda: _kernel_flash(q, k, v, causal)),
            "dq": time_ms(lambda: _kernel_flash_bwd_dq(q, k, v, do, out, lse,
                                                       None, causal)),
            "dkv": time_ms(lambda: _kernel_flash_bwd_dkv(q, k, v, do, lse,
                                                         delta, causal)),
            "plain_fwd": time_ms(lambda: _reference_attention(q, k, v,
                                                              causal)),
            "sdpa_fwd": sdpa_fwd, "sdpa_bwd": time_ms(sdpa_bwd) - sdpa_fwd}
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        bound = max((4 * q.numel() * 2 + b * h * s * 4) / HBM_BYTES_PER_S,
                    4 * d * pairs / BF16_FLOP_PER_S) * 1e3
        t = times[causal]
        log(f"({b}, {s}, {h}, {d}) bf16 {'causal' if causal else 'non-causal'}"
            f" [wgmma]: forward {t['fwd']:.5f} ms (bound {bound:.5f}, plain "
            f"{t['plain_fwd']:.4f}, sdpa {t['sdpa_fwd']:.5f}); dQ "
            f"{t['dq']:.5f} + dK/dV {t['dkv']:.5f} = "
            f"{t['dq'] + t['dkv']:.5f} ms (sdpa backward {t['sdpa_bwd']:.5f})")
    kv = [torch.randn(b, s, h, d, device=dev, generator=gen).to(torch.bfloat16)
          for _ in range(2)]
    # The ring kernel at the main path's blocks, bitwise against its plain
    # version: rings of 2 (sp), shifted forward (+1) and back (-1, the
    # backward's inverse shift), and a ring of 4 where the two differ
    for ring in (kv, kv + [t.flip(0).contiguous() for t in kv]):
        m = len(ring)
        for disp in (1, -1):
            got = ring_permute(ring, disp)
            want = [ring[(r - disp) % m] for r in range(m)]
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"ring_permute of {m} (4, 256, 4, 64) bf16 blocks by "
                  f"{disp:+d}: bitwise the plain rotation")
    # The differentiable shift on K views of a QKV product, as the model
    # hands them over: the forward and the inverse shift of the
    # cotangents, bitwise against list indexing
    qkv2 = [torch.randn(b, s, 3, h, d, device=dev, generator=gen
                        ).to(torch.bfloat16) for _ in range(2)]
    ks = [t[:, :, 1].detach().requires_grad_() for t in qkv2]
    gs = [torch.randn_like(k) for k in ks]
    build.reset_launch_counts()
    moved = DeviceCollectives([dev, dev]).shift(ks, 1)
    torch.autograd.backward(moved, gs)
    torch.cuda.synchronize()
    check(build.LAUNCHES["ring_permute"] == 2
          and all(torch.equal(moved[r], ks[(r - 1) % 2]) for r in range(2))
          and all(torch.equal(ks[r].grad, gs[(r + 1) % 2])
                  for r in range(2)),
          "differentiable shift over a ring of 2 on strided K views: one "
          "ring launch forward and one backward, both bitwise the plain "
          "rotation")
    ring_ms = time_ms(lambda: ring_permute(kv, 1))
    kv_out = [torch.empty_like(t) for t in kv]
    lib_ms = time_ms(lambda: torch._foreach_copy_(kv_out[::-1], kv))
    log(f"ring_permute of a K block over a ring of 2 ((4, 256, 4, 64) bf16):"
        f" {ring_ms:.5f} ms (bound {4 * kv[0].numel() * 2 / HBM_BYTES_PER_S * 1e3:.5f}, "
        f"torch._foreach_copy_ {lib_ms:.5f})")
    del model, opt, shards
    torch.cuda.empty_cache()
    return launches


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def pipeline_phase(dev, build) -> dict:
    """Phase 15: the pipeline at full width (``ModelConfig()``, bf16
    compute) over 8 ranks on ``dev`` (dp 2, tp 2, pp 2), 8 x 512 batches
    in 4 microbatches, so each rank holds (1, 512) tokens a microbatch.
    The pp loss against the unsharded one (fp32 at 2 layers, 1e-4; bf16
    at full width, 2e-2); GPipe against 1F1B (fp32 at 2 layers: loss and
    every gradient, as phase 14 holds the sharded step); a plain-hop
    baseline (list indexing, no kernel) giving the same loss bit for bit;
    then the main path, three GPipe and three 1F1B steps, whose ring
    launches must be ``hop_counts`` per pp group; timings and the ring
    kernel at the hop's shape. Returns the main path's launches."""
    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        loss_fn,
        make_optimizer,
    )
    from faabric_tpu_torch.models.transformer import _leaves, _param_tree, _tree
    from faabric_tpu_torch.ops.ring_permute import ring_permute
    from faabric_tpu_torch.parallel import (
        MeshConfig,
        PipelinedTransformer,
        build_mesh,
        init_pp_train_state,
        make_pp_1f1b_value_and_grad,
        make_pp_loss,
        make_pp_train_step,
        microbatch,
        pp_data_sharding,
        unstack_block_params,
    )
    from faabric_tpu_torch.parallel import pipeline
    from faabric_tpu_torch.parallel.pipeline import hop_counts

    log("phase 15: the pipeline at full width, 8 ranks (dp 2, tp 2, pp 2)")
    cfg = ModelConfig()
    mesh = build_mesh([dev] * 8, MeshConfig(tp=2, pp=2))
    groups = mesh.size // mesh.shape["pp"]
    n_mb = 4
    hops = {k: v * groups for k, v in hop_counts(2, n_mb).items()}
    rng = np.random.RandomState(15)
    batches = [[rng.randint(0, cfg.vocab_size, (8, 512)).astype(np.int32)
                for _ in range(2)] for _ in range(3)]

    def shard(a):
        return pp_data_sharding(mesh).shard(microbatch(a, n_mb))

    tok_np, tgt_np = batches[0]
    tok_t, tgt_t = (torch.as_tensor(a, device=dev) for a in batches[0])

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def pp_grads(model):
        whole = _tree({n: spec.gather([p.grad for p in model.copies(n)])
                       for n, spec in model.specs.items()})
        return dict(_leaves(unstack_block_params(whole)))

    # -- 15a. fp32 at 2 layers: against the unsharded model, GPipe
    #    against 1F1B, loss and every gradient
    cfg32 = dataclasses.replace(cfg, n_layers=2, compute_dtype=torch.float32)
    plain = Transformer(cfg32, device=dev, generator=gen(0))
    model = PipelinedTransformer(cfg32, mesh, _param_tree(plain))
    loss_p = loss_fn(plain, tok_t, tgt_t)
    loss_p.backward()
    grads_p = {n: p.grad for n, p in plain.named_parameters()}
    tok, tgt = shard(tok_np), shard(tgt_np)
    loss_g = make_pp_loss(cfg32, mesh)(model, tok, tgt)
    loss_g[0].backward()
    model.allreduce_grads()
    grads_g = pp_grads(model)
    loss_1 = make_pp_1f1b_value_and_grad(cfg32, mesh)(model, tok, tgt)
    grads_1 = pp_grads(model)
    loss_p, loss_g, loss_1 = (float(x.detach())
                              for x in (loss_p, loss_g[0], loss_1[0]))
    check(abs(loss_g - loss_p) <= 1e-4 and abs(loss_1 - loss_g) <= 1e-4,
          f"fp32, 2 layers: GPipe loss {loss_g:.6f}, 1F1B {loss_1:.6f}, "
          f"unsharded {loss_p:.6f} (limit 1e-4)")
    worst_s = max(rel_l2(grads_1[n], grads_g[n]) for n in grads_p)
    worst_p = max(rel_l2(grads_g[n], grads_p[n]) for n in grads_p)
    check(worst_s <= 1e-4 and worst_p <= 1e-4,
          f"fp32 gradients, every parameter: 1F1B vs GPipe worst relative "
          f"L2 {worst_s:.2e}, GPipe vs unsharded {worst_p:.2e} (limit 1e-4)")
    del plain, model, grads_p, grads_g, grads_1

    # -- 15b. bf16 at full width: against the unsharded loss, and the
    #    kernel's hops against plain list-indexing hops, bit for bit
    whole = Transformer(cfg, device=dev, generator=gen(0))
    model = PipelinedTransformer(cfg, mesh, _param_tree(whole))
    with torch.no_grad():
        want = float(loss_fn(whole, tok_t, tgt_t))
        build.reset_launch_counts()
        got = make_pp_loss(cfg, mesh)(model, tok, tgt)[0]
        torch.cuda.synchronize()
        kernel_hops = build.LAUNCHES.get("ring_permute", 0)
        real_hop = pipeline._hop

        def plain_hop(mesh_, xs, disp):
            out = [None] * mesh_.size
            for ranks in mesh_.groups("pp"):
                for i, r in enumerate(ranks):
                    out[ranks[(i + disp) % len(ranks)]] = xs[r].clone()
            return out

        pipeline._hop = plain_hop
        try:
            build.reset_launch_counts()
            got_plain = make_pp_loss(cfg, mesh)(model, tok, tgt)[0]
            torch.cuda.synchronize()
            plain_launches = build.LAUNCHES.get("ring_permute", 0)
        finally:
            pipeline._hop = real_hop
    check(abs(float(got) - want) <= 2e-2,
          f"bf16, full width: pp loss {float(got):.5f} vs unsharded "
          f"{want:.5f} (limit 2e-2)")
    check(kernel_hops == hops["loss"] and plain_launches == 0
          and torch.equal(got, got_plain),
          f"pp loss: {kernel_hops} ring launches ({hops['loss']} = "
          f"{hop_counts(2, n_mb)['loss']} hops x {groups} pp groups); plain "
          f"list-indexing hops launch none and give the same loss bit for "
          f"bit")
    del whole, model

    # -- 15c. the main path: three GPipe and three 1F1B steps. One
    #    schedule's model and AdamW state at a time, so each peak is that
    #    schedule's own; one launch-count window over both
    spec = make_optimizer()
    shards = [(shard(t), shard(y)) for t, y in batches]
    peaks, losses = {}, {}
    build.reset_launch_counts()
    for name in ("gpipe", "1f1b"):
        m_, o_ = init_pp_train_state(gen(0), cfg, mesh, spec)
        step = make_pp_train_step(cfg, spec, n_mb, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses[name] = [step(m_, o_, *b)[0] for b in shards]
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        del m_, o_, step
        torch.cuda.empty_cache()
    launches = dict(build.LAUNCHES)
    log(f"pipeline path launches (3 GPipe + 3 1F1B steps): {launches}")
    losses = {k: [float(x) for x in v] for k, v in losses.items()}
    check(all(np.isfinite(losses["gpipe"] + losses["1f1b"]))
          and abs(losses["gpipe"][0] - losses["1f1b"][0]) <= 2e-2,
          f"three steps each, same init: GPipe "
          f"{', '.join(f'{x:.4f}' for x in losses['gpipe'])}; 1F1B "
          f"{', '.join(f'{x:.4f}' for x in losses['1f1b'])}")
    want_ring = 3 * (hops["gpipe"] + hops["1f1b"])
    check(launches.get("ring_permute", 0) == want_ring,
          f"ring kernel launched {launches.get('ring_permute', 0)} times: "
          f"3 x ({hops['gpipe']} + {hops['1f1b']}), every hop of both "
          f"schedules, forward and backward, on the kernel")
    check(all(launches.get(k, 0) == 0 for k in
              ("rms_norm", "flash_attention", "flash_bwd_dq",
               "flash_bwd_dkv")),
          "no norm or flash kernel: pipeline stages run plain attention and "
          "norm, as the reference's")

    # -- 15d. timings, one schedule's state at a time ----------------------
    tok, tgt = shards[0]
    for name in ("gpipe", "1f1b"):
        m_, o_ = init_pp_train_state(gen(0), cfg, mesh, spec)
        step = make_pp_train_step(cfg, spec, n_mb, name)
        wall = host_ms(lambda: step(m_, o_, tok, tgt), iters=3)
        busy, by_kernel = profile_top(lambda: step(m_, o_, tok, tgt),
                                      f"{name} step, 8 ranks, 8x512", top=8)
        ring_us = sum(t for n, t in by_kernel.items() if "ring_permute" in n)
        log(f"{name} step 8x512 over (dp 2, tp 2, pp 2), M = {n_mb}, on {dev}:"
            f" {wall:.1f} ms wall, device busy {busy / 1e3:.2f} ms "
            f"({ring_us:.1f} us in the ring kernel), peak memory over its "
            f"3 steps, its own model and AdamW state alone "
            f"{peaks[name]:.3f} GiB")
        del m_, o_, step
        torch.cuda.empty_cache()
    del shards
    # The ring kernel at the hop's shape: each rank's (1, 512, 512) bf16
    # activation, a ring of 2 (one pp group)
    act = [torch.randn(1, 512, 512, device=dev, generator=gen(7)
                       ).to(torch.bfloat16) for _ in range(2)]
    for disp in (1, -1):
        out = ring_permute(act, disp)
        check(all(torch.equal(out[r], act[(r - disp) % 2]) for r in range(2)),
              f"ring_permute of 2 (1, 512, 512) bf16 activations by {disp:+d}:"
              f" bitwise the plain rotation")
    outs = [torch.empty_like(t) for t in act]
    hop = {"ms": time_ms(lambda: ring_permute(act, 1, outs)),
           "library_ms": time_ms(lambda: torch._foreach_copy_(outs[::-1],
                                                              act))}
    bound = 2 * 2 * act[0].numel() * 2 / HBM_BYTES_PER_S * 1e3
    log(f"ring_permute of a pp hop (2 x (1, 512, 512) bf16): {hop['ms']:.5f} "
        f"ms (bound {bound:.5f}, torch._foreach_copy_ "
        f"{hop['library_ms']:.5f})")
    torch.cuda.empty_cache()
    return launches


def moe_phase(dev, build) -> dict:
    """Phase 16: the MoE family at full width (``MoEConfig()``: the
    flagship's widths, 4 experts, top-1, capacity 1.25, aux 0.01). The
    unsharded forward (8 x 512, bf16) with its exact kernel launches,
    against the plain path; the sharded loss and gradients on (dp 4, ep
    2) and (dp 2, tp 2, ep 2) against the plain unsharded model's (fp32
    at one layer: 1e-4; bf16 at full width: the loss, 2e-2; phases 4 and
    8 hold the kernels at these meshes' per-rank shapes); the MoE pipeline
    (pp 2, ep 2, dp 2, aux 0) against ``moe_loss_fn``; then the main
    path: the unsharded forward, one train step on each mesh and the
    MoE pipeline's loss, whose launches must be exact; timings. Returns
    the main path's launches."""
    from faabric_tpu_torch.models import (
        MoEConfig,
        MoETransformer,
        data_sharding,
        make_moe_train_step,
        make_optimizer,
        moe_forward,
        moe_loss_fn,
        shard_moe_params,
    )
    from faabric_tpu_torch.models.transformer import _param_tree
    from faabric_tpu_torch.parallel import (
        MeshConfig,
        PipelinedTransformer,
        build_mesh,
        make_pp_loss,
        microbatch,
        pp_data_sharding,
    )
    from faabric_tpu_torch.parallel.pipeline import hop_counts

    log("phase 16: the MoE family at full width")
    cfg = MoEConfig()
    layers = cfg.n_layers

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    whole = MoETransformer(cfg, device=dev, generator=gen(16))
    n_params = sum(p.numel() for p in whole.parameters())
    check(n_params == 70_529_536, f"MoEConfig(): {n_params} fp32 params, 4 "
          f"experts, capacity {int(np.ceil(512 * 1.25 / 4))} at S = 512")
    rng = np.random.RandomState(16)
    tok_np, tgt_np = (rng.randint(0, cfg.vocab_size, (8, 512)).astype(np.int32)
                      for _ in range(2))
    tok_t, tgt_t = (torch.as_tensor(a, device=dev) for a in (tok_np, tgt_np))
    meshes = {"dp 4, ep 2": build_mesh([dev] * 8, MeshConfig(ep=2)),
              "dp 2, tp 2, ep 2": build_mesh([dev] * 8, MeshConfig(tp=2, ep=2))}

    # -- 16a. the unsharded forward against the plain path ---------------
    build.reset_launch_counts()
    with torch.inference_mode():
        logits, aux = moe_forward(whole, tok_t)
    torch.cuda.synchronize()
    fwd = dict(build.LAUNCHES)
    check(fwd.get("rms_norm", 0) == layers
          and fwd.get("flash_attention", 0) == layers
          and fwd.get("flash_attention.wgmma", 0) == layers,
          f"unsharded forward 8x512: {layers} RMS-norm launches (ln1) and "
          f"{layers} flash forwards, all wgmma ({fwd})")
    check(tuple(logits.shape) == (8, 512, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and 0.9 < float(aux) < cfg.n_experts,
          f"logits finite, shape; aux {float(aux):.4f}")

    def plain_logits(dtype, kernels=False):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        if not kernels:
            c = dataclasses.replace(c, attention_impl="reference",
                                    norm_impl="reference")
        m = MoETransformer(c, device=dev)
        m.load_state_dict(whole.state_dict())
        with torch.inference_mode():
            return moe_forward(m, tok_t)[0]

    f32 = plain_logits(torch.float32)
    f32_k = plain_logits(torch.float32, kernels=True)
    err32 = max_err(f32_k, f32)
    check(err32 <= 1e-3, f"fp32: kernel path (FMA flash, fused norm) vs "
          f"plain: max |err| {err32:.3g} (limit 1e-3)")
    ref = plain_logits(torch.bfloat16)
    err_k, err_r = (logits - f32).abs(), (ref - f32).abs()
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    # As phase 5 holds the dense forward. A token whose top two router
    # probabilities lie within bf16 noise of each other may take another
    # expert on either bf16 path, so the max errors are those tokens'
    check(float(err_k.mean()) <= 1.25 * float(err_r.mean())
          and float(err_k.max()) <= 2 * float(err_r.max()),
          f"bf16 kernel path as close to fp32 as the plain bf16 path: mean "
          f"{float(err_k.mean()):.4g} vs {float(err_r.mean()):.4g}, max "
          f"{float(err_k.max()):.4g} vs {float(err_r.max()):.4g}; argmax "
          f"agree {agree:.4f}")
    del f32, f32_k, ref, err_k, err_r, logits

    # -- 16b. sharded against unsharded: the sharded models run each
    #    rank's flash kernels, the fp32 yardstick the plain attention and
    #    norm
    cfg1 = dataclasses.replace(cfg, n_layers=1, compute_dtype=torch.float32)
    plain = MoETransformer(dataclasses.replace(
        cfg1, attention_impl="reference", norm_impl="reference"),
        device=dev, generator=gen(1))
    loss_p = moe_loss_fn(plain, tok_t, tgt_t)
    loss_p.backward()
    loss_p = float(loss_p.detach())
    grads_p = {n: p.grad for n, p in plain.named_parameters()}
    with torch.no_grad():
        loss_bf = float(moe_loss_fn(whole, tok_t, tgt_t))
    for label, mesh in meshes.items():
        shard = data_sharding(mesh).shard
        sharded = shard_moe_params(plain, mesh, cfg1)
        losses = moe_loss_fn(sharded, shard(tok_np), shard(tgt_np))
        losses[0].backward()
        sharded.allreduce_grads()
        worst = max(rel_l2(spec.gather([p.grad for p in sharded.copies(n)]),
                           grads_p[n]) for n, spec in sharded.specs.items())
        got = float(losses[0].detach())
        check(abs(got - loss_p) <= 1e-4 and worst <= 1e-4,
              f"fp32, 1 layer, {label}: loss {got:.6f} vs unsharded "
              f"{loss_p:.6f}, gradients worst relative L2 "
              f"{worst:.2e} (limits 1e-4)")
        with torch.no_grad():
            got_bf = float(moe_loss_fn(shard_moe_params(whole, mesh, cfg),
                                       shard(tok_np), shard(tgt_np))[0])
        check(abs(got_bf - loss_bf) <= 2e-2,
              f"bf16, full width, {label}: loss {got_bf:.5f} vs unsharded "
              f"{loss_bf:.5f} (limit 2e-2)")
    del plain, grads_p, sharded

    # -- 16c. MoE stages in the pipeline ----------------------------------
    cfg_pp = dataclasses.replace(cfg, aux_loss_weight=0.0)
    pp_mesh = build_mesh([dev] * 8, MeshConfig(pp=2, ep=2))
    pp_model = PipelinedTransformer(cfg_pp, pp_mesh, _param_tree(whole))
    pp_shard = pp_data_sharding(pp_mesh).shard
    pp_tok, pp_tgt = (pp_shard(microbatch(a, 4)) for a in (tok_np, tgt_np))
    with torch.no_grad():
        whole_pp = MoETransformer(cfg_pp, device=dev)
        whole_pp.load_state_dict(whole.state_dict())
        want_pp = float(moe_loss_fn(whole_pp, tok_t, tgt_t))
        got_pp = float(make_pp_loss(cfg_pp, pp_mesh)(pp_model, pp_tok,
                                                      pp_tgt)[0])
    check(abs(got_pp - want_pp) <= 2e-2,
          f"bf16, full width: MoE pipeline loss {got_pp:.5f} vs moe_loss_fn "
          f"{want_pp:.5f} (limit 2e-2)")
    del whole_pp

    # -- 16d. the main path -----------------------------------------------
    spec = make_optimizer()
    step = make_moe_train_step(cfg, spec)
    runs = {}
    for label, mesh in meshes.items():
        m_ = shard_moe_params(whole, mesh, cfg)
        shard = data_sharding(mesh).shard
        runs[label] = (m_, spec.init(m_), shard(tok_np), shard(tgt_np))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    with torch.inference_mode():
        moe_forward(whole, tok_t)
    step_losses = {label: step(m_, o_, t_, y_)[0]
                   for label, (m_, o_, t_, y_) in runs.items()}
    with torch.no_grad():
        make_pp_loss(cfg_pp, pp_mesh)(pp_model, pp_tok, pp_tgt)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"MoE path launches: {launches}")
    check(all(np.isfinite(float(x)) for x in step_losses.values()),
          "a train step on each mesh: losses "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in step_losses.items()))
    per_step = layers * 8  # each rank's flash forward, dQ, dK/dV a layer
    want = {"rms_norm": layers, "flash_attention": layers + 2 * per_step,
            "flash_bwd_dq": 2 * per_step, "flash_bwd_dkv": 2 * per_step,
            "ring_permute": hop_counts(2, 4)["loss"] * 4}
    for name, n in want.items():
        got_n = launches.get(name, 0)
        body = (got_n if name in ("rms_norm", "ring_permute")
                else launches.get(f"{name}.wgmma", 0))
        check(got_n == n and body == n,
              f"MoE path: {name} launched {got_n} times, expected {n}"
              + ("" if name in ("rms_norm", "ring_permute") else ", all wgmma"))

    # -- 16e. timings ------------------------------------------------------
    for label, (m_, o_, t_, y_) in runs.items():
        wall = host_ms(lambda: step(m_, o_, t_, y_), iters=3)
        busy, by_kernel = profile_top(lambda: step(m_, o_, t_, y_),
                                      f"MoE step, {label}, 8x512", top=8)
        flash_us = sum(t for n, t in by_kernel.items() if "flash" in n)
        log(f"MoE train step 8x512 over ({label}) on {dev}: {wall:.1f} ms "
            f"wall, device busy {busy / 1e3:.2f} ms ({flash_us:.1f} us in "
            f"the flash kernels)")
    log(f"peak memory on the MoE main path: {peak_gib:.3f} GiB")
    del runs, whole, pp_model
    torch.cuda.empty_cache()
    return launches


def _as_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def mpi_suite(world, rank: int, payload) -> dict:
    """The reference's dist programs for faabric's MPI, on one rank of
    ``world`` (``tests/dist/procs.py``: ``fn_mpi_collectives`` :282-353,
    ``fn_mpi_p2p_suite`` :355-414, ``fn_mpi_isendrecv`` :626-655,
    ``fn_mpi_cartesian`` :517-547) and the split and group-communicator
    pass of ``examples/subcomms.py``. ``payload(array)`` is what the
    guest hands the world: a tensor on its device, or the array. Every
    result is held against numpy; returns this rank's wall ms per call
    of each collective."""
    size = world.size
    ms: dict[str, float] = {}

    def timed(name, fn, calls: int = 1):
        t0 = time.perf_counter()
        out = fn()
        ms[name] = (time.perf_counter() - t0) * 1e3 / calls
        return out

    def want(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"rank {rank}: {what}")

    # -- fn_mpi_collectives -------------------------------------------------
    n_per = 4
    got = timed("allgather", lambda: world.allgather(rank, payload(
        np.arange(rank * n_per, (rank + 1) * n_per, dtype=np.int32))))
    want(np.array_equal(_as_np(got), np.arange(size * n_per, dtype=np.int32)),
         f"allgather {_as_np(got)[:8]}")
    expected = np.array([0, 1, 2, 3], np.int32)
    got = timed("broadcast", lambda: world.broadcast(
        2, rank, payload(expected) if rank == 2 else np.empty(0)))
    want(np.array_equal(_as_np(got), expected), f"broadcast {_as_np(got)}")
    got = timed("gather", lambda: world.gather(rank, 2, payload(
        np.arange(rank * n_per, (rank + 1) * n_per, dtype=np.int32))))
    want(rank != 2 or np.array_equal(
        _as_np(got), np.arange(size * n_per, dtype=np.int32)), "gather")
    all_data = (payload(np.arange(size * n_per, dtype=np.int32))
                if rank == 0 else np.empty(0, np.int32))
    got = timed("scatter", lambda: world.scatter(0, rank, all_data, n_per))
    want(np.array_equal(_as_np(got), np.arange(
        rank * n_per, (rank + 1) * n_per, dtype=np.int32)), "scatter")
    from faabric_tpu_torch.mpi import MpiOp

    got = timed("scan", lambda: world.scan(rank, payload(np.array(
        [rank * 10 + i for i in range(3)], np.int64)), MpiOp.SUM))
    want(np.array_equal(_as_np(got), np.array(
        [sum(r * 10 + i for r in range(rank + 1)) for i in range(3)],
        np.int64)), f"scan {_as_np(got)}")
    got = timed("reduce", lambda: world.reduce(
        rank, 3, payload(np.full(5, rank, np.int64)), MpiOp.SUM))
    want(rank != 3 or np.array_equal(
        _as_np(got), np.full(5, sum(range(size)), np.int64)), "reduce")
    got = timed("allreduce", lambda: world.allreduce(
        rank, payload(np.arange(6, dtype=np.float32) * (rank + 1)),
        MpiOp.SUM))
    want(np.array_equal(_as_np(got), np.arange(6, dtype=np.float32)
                        * sum(range(1, size + 1))), "allreduce")
    k = 3
    got = timed("reduce_scatter", lambda: world.reduce_scatter(
        rank, payload(np.arange(size * k, dtype=np.int64) + rank),
        MpiOp.SUM))
    total = sum(np.arange(size * k, dtype=np.int64) + r for r in range(size))
    want(np.array_equal(_as_np(got), total[rank * k:(rank + 1) * k]),
         "reduce_scatter")
    timed("barrier", lambda: world.barrier(rank))

    # -- fn_mpi_p2p_suite -----------------------------------------------------
    if rank == 0:
        timed("send", lambda: world.send(0, 1, payload(
            np.array([42], np.int32))))
    elif rank == 1:
        got, _ = timed("recv", lambda: world.recv(0, 1))
        want(int(got[0]) == 42, f"send {got}")
    right, left = (rank + 1) % size, (rank - 1) % size
    got, status = timed("sendrecv", lambda: world.sendrecv(
        payload(np.array([rank], np.int32)), rank, right, left, rank))
    want(int(got[0]) == left and status.count == 1, f"sendrecv {got}")

    def alltoall_rounds():
        for i in range(10):
            world.barrier(rank)
            mixed = world.alltoall(rank, payload(
                np.full(size, rank * 100 + i, np.int32)))
            want(np.array_equal(_as_np(mixed), np.array(
                [r * 100 + i for r in range(size)], np.int32)),
                f"alltoall {_as_np(mixed)}")

    timed("barrier+alltoall", alltoall_rounds, calls=10)
    d1 = world.cart_create(world.cart_dims())
    d2 = world.cart_create(world.cart_dims())
    want(d1 == d2 and world.cart_rank(world.cart_coords(rank)) == rank,
         f"cart_create {d1} {d2}")

    # -- fn_mpi_isendrecv ---------------------------------------------------
    def isendrecv():
        recv_req = world.irecv(left, rank)
        send_req = world.isend(rank, right, payload(
            np.array([rank], np.int32)))
        return world.waitall(rank, [recv_req, send_req])

    results = timed("isend+irecv+waitall", isendrecv)
    want(int(results[0][0][0]) == left and results[1] is None, "isendrecv")
    world.barrier(rank)

    # -- fn_mpi_cartesian -----------------------------------------------------
    world.cart_create(world.cart_dims())
    coords = world.cart_coords(rank)
    src, dst = world.cart_shift(rank, 0, 1)
    want(world.cart_rank(coords) == rank
         and dst == world.cart_rank((coords[0] + 1, coords[1]))
         and src == world.cart_rank((coords[0] - 1, coords[1])),
         f"cartesian {coords} {src} {dst}")

    # -- examples/subcomms.py: per-host split, then the host leaders ----------
    host_comm, host_rank = timed("split_type_shared",
                                 lambda: world.split_type_shared(rank))
    local = host_comm.allreduce(host_rank, payload(
        np.array([rank + 1], np.int64)), MpiOp.SUM)
    host = world.host_for_rank(rank)
    want(int(_as_np(local)[0]) == sum(
        r + 1 for r in world.ranks_on_host(host)), "host allreduce")
    leaders = list(world.topology().leaders)
    leader_comm, lr = timed("create_group_comm",
                            lambda: world.create_group_comm(rank, leaders))
    if leader_comm is not None:
        total = leader_comm.allreduce(lr, _as_np(local), MpiOp.SUM)
        want(int(total[0]) == sum(range(1, size + 1)), "leaders' allreduce")
    else:
        want(rank not in leaders, "leader without a communicator")
    world.barrier(rank)
    return ms


def ddp_step(world, rank: int, model, tokens, targets, lr: float,
             reduce=None):
    """One data-parallel SGD step (the reference's ``fn_train``,
    ``tests/dist/procs.py:1004-1064``): this rank's gradient of
    ``loss_fn`` on its shard, the flat fp32 gradient allreduced with SUM
    through ``world.allreduce`` (or ``reduce(flat)``), divided by the
    world size, applied. Returns the allreduce's wall ms."""
    from faabric_tpu_torch.models import loss_fn
    from faabric_tpu_torch.mpi import MpiOp

    model.zero_grad(set_to_none=True)
    loss_fn(model, tokens, targets).backward()
    flat = torch.cat([p.grad.reshape(-1).float()
                      for p in model.parameters()])
    t0 = time.perf_counter()
    summed = (world.allreduce(rank, flat, MpiOp.SUM) if reduce is None
              else reduce(flat))
    if flat.is_cuda:
        torch.cuda.synchronize(flat.device)
    ar_ms = (time.perf_counter() - t0) * 1e3
    summed = torch.as_tensor(summed, device=flat.device) / world.size
    with torch.no_grad():
        off = 0
        for p in model.parameters():
            n = p.numel()
            p -= lr * summed[off:off + n].view_as(p).to(p.dtype)
            off += n
    return ar_ms


def flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def register_mpi_guests(job: dict) -> None:
    """Two torch guests over the gang's MPI world (``ctx.mpi_world()``):
    ``mpi/suite`` runs :func:`mpi_suite` with tensor payloads on the
    guest's device when ``job["tensors"]``, numpy ones otherwise;
    ``mpi/ddp`` activates the device plane on the guest's device, builds
    ``job["model"](device)`` and takes ``job["steps"]`` steps of
    :func:`ddp_step` on ``job["batch"](step, rank, device)``, leaving its
    flat parameters in ``job["params"][rank]``. Each returns JSON: its
    host, timings, the rung each collective took and the plane
    verdict."""
    from faabric_tpu_torch.executor import register_function

    def record(world, rank, **fields):
        rungs = {kind: algo for (r, kind), algo in world.rungs.items()
                 if r == rank}
        return json.dumps({"rank": rank, "host": world.host_for_rank(rank),
                           "rungs": rungs, **fields}).encode()

    @register_function("mpi", "suite")
    def suite(ctx):
        world = ctx.mpi_world()
        rank = ctx.message.mpi_rank
        dev = ctx.device
        payload = ((lambda a: torch.as_tensor(a, device=dev))
                   if job["tensors"] else (lambda a: a))
        return record(world, rank, ms=mpi_suite(world, rank, payload))

    @register_function("mpi", "ddp")
    def ddp(ctx):
        world = ctx.mpi_world()
        rank = ctx.message.mpi_rank
        dev = ctx.device
        plane = world.activate_device_plane(rank, device=dev)
        model = job["model"](dev)
        step_ms, ar_ms = [], []
        for step in range(job["steps"]):
            tokens, targets = job["batch"](step, rank, dev)
            t0 = time.perf_counter()
            ar_ms.append(ddp_step(world, rank, model, tokens, targets,
                                  job["lr"]))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        job["params"][rank] = flat_params(model)
        world.barrier(rank)
        return record(world, rank, plane=plane, step_ms=step_ms,
                      allreduce_ms=ar_ms)


def run_gang(client, function: str, size: int, timeout: float = 300.0):
    """Submit rank 0 of an ``mpi/<function>`` world of ``size`` ranks:
    its ``ctx.mpi_world()`` chains ranks 1..size-1 through the planner.
    Returns every rank's result (by MPI rank), the decision of rank 0
    and the wall ms from submission to the last result."""
    from faabric_tpu_torch.proto import batch_exec_factory

    req = batch_exec_factory("mpi", function, 1)
    req.messages[0].mpi_world_size = size
    t0 = time.perf_counter()
    client.call_functions(req)
    deadline = time.monotonic() + timeout
    while True:
        status = client.get_batch_results(req.app_id)
        if status.finished and len(status.message_results) == size:
            break
        if time.monotonic() > deadline:
            raise AssertionError(
                f"mpi/{function}: {len(status.message_results)} of {size} "
                f"results after {timeout} s")
        time.sleep(0.01)
    wall_ms = (time.perf_counter() - t0) * 1e3
    results = sorted(status.message_results, key=lambda m: m.mpi_rank)
    return results, wall_ms


def guest_outputs(results, what: str) -> list[dict]:
    from faabric_tpu_torch.proto import ReturnValue

    bad = [f"rank {m.mpi_rank}: {m.output_data[:300]!r}" for m in results
           if m.return_value != int(ReturnValue.SUCCESS)]
    check(not bad, f"{what}: every rank SUCCESS ({'; '.join(bad)})")
    return [json.loads(m.output_data) for m in results]


def random_port_base() -> int:
    """A port offset for a cluster's aliases: listener ports stay below
    the client source ports (30500 up)."""
    import random

    return random.randint(100, 190) * 100


def start_cluster(hosts: dict, factory, base: int | None = None,
                  planner: bool = True):
    """A port planner and one started WorkerRuntime per ``hosts`` entry
    (name → slots) on localhost aliases from port offset ``base`` (drawn
    at random by default); returns (planner server, workers). With
    ``planner=False`` the planner at ``base`` is another process's and
    the planner server returned is None."""
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.runner import WorkerRuntime
    from faabric_tpu_torch.transport import register_host_alias

    if base is None:
        base = random_port_base()
    register_host_alias("smoke-planner", "127.0.0.1", base)
    planner_server = None
    if planner:
        get_planner().reset()
        planner_server = PlannerServer(port_offset=base)
        planner_server.start()
    workers = []
    try:
        for i, (name, slots) in enumerate(hosts.items()):
            register_host_alias(name, "127.0.0.1", base + 1000 * (i + 1))
            w = WorkerRuntime(host=name, slots=slots, factory=factory,
                              planner_host="smoke-planner")
            workers.append(w)
            w.start()
    except BaseException:
        stop_cluster(planner_server, workers)
        raise
    return planner_server, workers


def stop_cluster(planner_server, workers) -> None:
    from faabric_tpu_torch.executor import (
        clear_registered_functions,
        set_executor_factory,
    )
    from faabric_tpu_torch.planner import get_planner
    from faabric_tpu_torch.transport import clear_host_aliases

    try:
        for w in workers:
            w.shutdown()
    finally:
        if planner_server is not None:
            planner_server.stop()
        get_planner().reset()
        clear_registered_functions()
        set_executor_factory(None)
        clear_host_aliases()


def mpi_guest_phase(dev, build) -> dict:
    """Phase 17: faabric's MPI as guests use it, on the card, at the
    flagship's full width. 17a: a planner and two WorkerRuntimes (2
    slots each) gang-schedule 4 ranks through rank 0's
    ``ctx.mpi_world()``, 2 + 2 across the hosts, and each runs
    :func:`mpi_suite` with CUDA-tensor and then numpy payloads. 17c: the
    same two-host gang trains one :func:`ddp_step` of the full-width
    model, its gradient crossing hosts on the host ladder. 17b: one
    WorkerRuntime (4 slots) trains 3 steps through the device plane;
    the ranks' parameters must agree bit for bit, the kernels' launches
    must be one rank's step's times 4 ranks times 3 steps, and the
    gradient allreduce must put no byte on the host; then an fp32 step
    against the unsharded step on the whole batch. Returns the launches
    of 17b's and 17c's steps."""
    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig, Transformer, loss_fn

    log("phase 17: faabric's MPI through torch guests on the card")
    t_phase = time.perf_counter()
    n, per_rank, seq, lr = MPI_RANKS, 2, 512, 0.5
    cfg = ModelConfig()
    corpus = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (3, n * per_rank, seq + 1)).astype(np.int64)

    def batch(step, rank, device, rows=slice(None)):
        if rank is not None:
            rows = slice(rank * per_rank, (rank + 1) * per_rank)
        b = torch.as_tensor(corpus[step, rows], device=device)
        return b[:, :-1], b[:, 1:]

    def model_of(c):
        return lambda device: Transformer(
            c, device=device,
            generator=torch.Generator(device=device).manual_seed(0))

    params: dict = {}
    job = {"tensors": True, "model": model_of(cfg), "batch": batch,
           "steps": 1, "lr": lr, "params": params}
    register_mpi_guests(job)
    factory = TorchExecutorFactory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # One rank's step, alone: the kernel launches a step of the path makes
    model = model_of(cfg)(dev)
    build.reset_launch_counts()
    loss_fn(model, *batch(0, 0, dev)).backward()
    torch.cuda.synchronize()
    per_step = {k: v for k, v in build.LAUNCHES.items() if "." not in k}
    log(f"one rank's step (2 x 512, bf16, remat) launches: {per_step} "
        f"(phase 9's counts per step: 8 flash forwards, 4 dQ, 4 dK/dV)")
    check(all(per_step.get(k, 0) > 0 for k in (
        "flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "rms_norm")),
        "a rank's step launches all four kernels of the path")
    del model

    launches: dict = {}
    planner_server, workers = start_cluster(
        {"mpi-host-a": 2, "mpi-host-b": 2}, factory)
    try:
        client = workers[0].planner_client
        # -- 17a. the MPI suite over two hosts ---------------------------
        for tensors in (True, False):
            job["tensors"] = tensors
            results, wall = run_gang(client, "suite", n)
            outs = guest_outputs(results, f"17a suite ({'tensor' if tensors else 'numpy'} payloads)")
            hosts = [o["host"] for o in outs]
            check(sorted(hosts) == ["mpi-host-a"] * 2 + ["mpi-host-b"] * 2,
                  f"17a: 4 ranks split 2 + 2 across the hosts {hosts}; "
                  f"{'CUDA-tensor' if tensors else 'numpy'} payloads, "
                  f"every result held against numpy ({wall:.1f} ms "
                  f"through the planner)")
            log(f"  17a rungs of rank 0: {outs[0]['rungs']}")
            for name in outs[0]["ms"]:
                log(f"  17a {'tensor' if tensors else 'numpy '} {name:22s} "
                    + ", ".join(f"{o['ms'].get(name, float('nan')):.3f}"
                                for o in outs) + " ms (ranks 0-3)")

        # -- 17c. one full-width step across the two hosts ----------------
        job.update(tensors=True, steps=1)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        results, wall = run_gang(client, "ddp", n)
        torch.cuda.synchronize()
        launches_c = dict(build.LAUNCHES)
        outs = guest_outputs(results, "17c DDP step over two hosts")
        check(not any(o["plane"] for o in outs),
              "17c: the registry refuses the device plane for a world "
              "whose ranks span two hosts")
        check(all(o["rungs"].get("allreduce") == "ring" for o in outs),
              f"17c: the gradient allreduce took the flat ring over "
              f"loopback ({outs[0]['rungs'].get('allreduce')})")
        flat = [params[r] for r in range(n)]
        check(all(torch.equal(flat[0], f) for f in flat[1:]),
              "17c: the ranks' parameters are bitwise equal after the step")
        log(f"  17c step wall ms by rank: "
            + ", ".join(f"{o['step_ms'][0]:.1f}" for o in outs)
            + "; gradient allreduce (host ring, 45,355,520 fp32) ms: "
            + ", ".join(f"{o['allreduce_ms'][0]:.1f}" for o in outs)
            + f"; {wall:.1f} ms through the planner")
        busy_c, _ = profile_top(lambda: run_gang(client, "ddp", n),
                                "17c: a DDP step over two hosts", top=4)
        params.clear()
    finally:
        stop_cluster(planner_server, workers)

    planner_server, workers = start_cluster({"mpi-host": 4}, factory)
    register_mpi_guests(job)
    try:
        client = workers[0].planner_client
        # -- 17b. three steps through the device plane on one host -------
        job.update(steps=3)
        torch.cuda.synchronize()
        reset_device_copy_totals()
        build.reset_launch_counts()
        results, wall = run_gang(client, "ddp", n)
        torch.cuda.synchronize()
        launches_b = dict(build.LAUNCHES)
        copies = device_copy_totals()
        outs = guest_outputs(results, "17b DDP over the device plane")
        check(all(o["plane"] for o in outs)
              and all(o["rungs"].get("allreduce") == "device"
                      for o in outs),
              "17b: every rank activated the device plane and allreduced "
              "its gradient on it")
        flat = [params[r] for r in range(n)]
        check(all(torch.equal(flat[0], f) for f in flat[1:]),
              "17b: the ranks' parameters are bitwise equal after 3 steps")
        check(copies["bytes"] == 0,
              f"17b: the gradient allreduce put {copies['bytes']} payload "
              f"bytes on the host ({copies['by_reason']})")
        for name in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv",
                     "rms_norm"):
            check(launches_b.get(name, 0) == per_step.get(name, 0) * n * 3,
                  f"17b: {name} launched {launches_b.get(name, 0)} times = "
                  f"{per_step.get(name, 0)} a step x {n} ranks x 3 steps")
        check(launches_b.get("flash_attention.wgmma", 0)
              == launches_b.get("flash_attention", -1),
              "17b: every flash forward took the wgmma body")
        log(f"  17b step wall ms by rank and step: "
            + "; ".join(", ".join(f"{t:.1f}" for t in o["step_ms"])
                        for o in outs)
            + "; gradient allreduce (device plane) ms: "
            + "; ".join(", ".join(f"{t:.2f}" for t in o["allreduce_ms"])
                        for o in outs)
            + f"; {wall:.1f} ms through the planner")
        job.update(steps=1)
        busy_b, _ = profile_top(lambda: run_gang(client, "ddp", n),
                                "17b: a DDP step on the device plane", top=4)

        # -- 17b, fp32: one DDP step against the unsharded step ----------
        cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        job.update(model=model_of(cfg32))
        params.clear()
        guest_outputs(run_gang(client, "ddp", n)[0], "17b fp32 DDP step")
        ref = model_of(cfg32)(dev)
        start = flat_params(ref)
        loss_fn(ref, *batch(0, None, dev)).backward()
        with torch.no_grad():
            for p in ref.parameters():
                p -= lr * p.grad
        want = flat_params(ref)
        rel = max(float((params[r] - want).norm() / want.norm())
                  for r in range(n))
        check(rel <= 1e-5, f"17b fp32: the ranks' parameters after one step "
              f"match the unsharded step on the whole 8 x 512 batch "
              f"(relative L2 {rel:.3g})")
        # The initial weights dominate the parameters' norm: the update
        # itself is held too, so that a gradient reduced wrongly (in bf16,
        # say) shows
        step = want - start
        rel_d = max(float((params[r] - start - step).norm() / step.norm())
                    for r in range(n))
        check(rel_d <= 1e-4, f"17b fp32: the ranks' updates match the "
              f"unsharded step's (relative L2 {rel_d:.3g})")
        del ref, want, start, step
        params.clear()
    finally:
        stop_cluster(planner_server, workers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  17 device busy: 17b {busy_b:.0f} us, 17c {busy_c:.0f} us of "
        f"their profiled steps; peak memory {peak:.3f} GiB; phase 17 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    for name in set(launches_b) | set(launches_c):
        launches[name] = launches_b.get(name, 0) + launches_c.get(name, 0)
    return launches


def sharded_serving_phase(dev, build) -> dict:
    """Phase 18: the mesh half of serving at full width (``ModelConfig()``
    with its depth cut to 2 layers, which keeps the script inside its
    time limit; weights from ``params_to_numpy``'s numpy form, as
    ``params_from_jax`` takes them) over dp 2 x tp 4, 8 ranks on the one
    card. In fp32 the
    tp-sharded greedy decode of 32 tokens from a (4, 128) prompt must give
    the unsharded port's tokens, with whole-prompt and chunked (48)
    prefill, and every rank of a decode must have run the RMS-norm kernel
    2L + 1 times a forward; ``evaluate_perplexity`` over two 4 x 512
    batches must agree with the unsharded model's within 1e-5 relative.
    In bf16 it times the sharded and unsharded decode and one tp
    allreduce of a decode step. Returns the launches of the fp32 decodes
    and the sharded perplexity (the phase's main path)."""
    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        evaluate_perplexity,
        generate,
        params_from_jax,
        params_to_numpy,
        shard_params,
    )
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh, named

    log("phase 18: tp-sharded decode and perplexity, dp 2 x tp 4, full "
        "width at 2 layers")
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(ModelConfig(), n_layers=2)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    np_params = params_to_numpy(Transformer(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(18)))
    mesh = build_mesh([dev] * 8, MeshConfig(dp=2, tp=4))
    rows = named(mesh, "dp", None)
    batch, s_p, n_new, chunk = 4, 128, 32, 48
    prompt = torch.randint(0, cfg.vocab_size, (batch, s_p),
                           generator=torch.Generator().manual_seed(18)
                           ).to(dev)

    plain32 = params_from_jax(np_params, cfg32, device=dev)
    sharded32 = shard_params(np_params, mesh, cfg32)
    want = generate(plain32, prompt, n_new)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    got = rows.gather(generate(sharded32, rows.shard(prompt), n_new))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check(torch.equal(got, want),
          f"18: the tp-sharded fp32 greedy decode of {n_new} tokens from a "
          f"({batch}, {s_p}) prompt gives the unsharded port's tokens")
    per_forward = 2 * cfg.n_layers + 1
    expect = mesh.size * n_new * per_forward
    check(launches.get("rms_norm", 0) == expect,
          f"18: one sharded decode launched the RMS kernel "
          f"{launches.get('rms_norm', 0)} times = {mesh.size} ranks x "
          f"{n_new} forwards (prefill + {n_new - 1} steps) x {per_forward} "
          f"norms; {launches.get('flash_attention', 0)} flash launches "
          f"(cached decode attends in plain PyTorch, as the reference)")
    check(launches.get("flash_attention", 0) == 0,
          "18: the cached decode launched no flash kernel")

    build.reset_launch_counts()
    got = rows.gather(generate(sharded32, rows.shard(prompt), n_new,
                               prefill_chunk=chunk))
    torch.cuda.synchronize()
    chunked = dict(build.LAUNCHES)
    n_fwd = -(-s_p // chunk) + n_new - 1
    check(torch.equal(got, want) and chunked.get("rms_norm", 0)
          == mesh.size * n_fwd * per_forward,
          f"18: chunked prefill ({chunk}) gives the same tokens, with "
          f"{chunked.get('rms_norm', 0)} RMS launches = {mesh.size} x "
          f"{n_fwd} forwards x {per_forward}")
    for k, v in chunked.items():
        launches[k] = launches.get(k, 0) + v

    corpus = np.random.RandomState(18).randint(
        0, cfg.vocab_size, (2, batch, 513)).astype(np.int64)
    batches = [(torch.as_tensor(c[:, :-1], device=dev),
                torch.as_tensor(c[:, 1:], device=dev)) for c in corpus]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    ppl = evaluate_perplexity(sharded32, batches)
    torch.cuda.synchronize()
    ppl_ms = (time.perf_counter() - t0) * 1e3
    scored = dict(build.LAUNCHES)
    # sp = 1: each rank attends its (2, 512, 2, 64) slab with the flash
    # kernel; under a mesh the sharded forward takes the plain norm, as
    # the reference resolves it
    want_scored = {"flash_attention": mesh.size * len(batches) * cfg.n_layers,
                   "rms_norm": 0}
    check(all(scored.get(k, 0) == n for k, n in want_scored.items()),
          f"18: the sharded perplexity launched {scored}: {mesh.size} ranks "
          f"x {len(batches)} batches x {cfg.n_layers} flash and no RMS "
          f"kernel, expected {want_scored}")
    for k, v in scored.items():
        launches[k] = launches.get(k, 0) + v
    ppl_want = evaluate_perplexity(plain32, batches)
    rel = abs(ppl["perplexity"] - ppl_want["perplexity"]) / ppl_want["perplexity"]
    check(ppl["tokens"] == ppl_want["tokens"] == 2 * batch * 512
          and rel <= 1e-5,
          f"18: sharded perplexity {ppl['perplexity']:.6f} against the "
          f"unsharded {ppl_want['perplexity']:.6f} over 2 x {batch} x 512 "
          f"(relative {rel:.3g}, limit 1e-5; {ppl_ms:.0f} ms)")
    del plain32, sharded32

    # bf16: throughput and the card's busy share
    plain16 = params_from_jax(np_params, cfg, device=dev)
    sharded16 = shard_params(np_params, mesh, cfg)
    shards = rows.shard(prompt)

    def sharded_decode():
        return generate(sharded16, shards, n_new)

    def plain_decode():
        return generate(plain16, prompt, n_new)

    ms_sh = host_ms(sharded_decode, iters=3)
    ms_pl = host_ms(plain_decode, iters=3)
    same = float((rows.gather(sharded_decode()) == plain_decode()
                  ).float().mean())
    busy_sh, _ = profile_top(sharded_decode, "18: sharded bf16 decode", top=4)
    busy_pl, _ = profile_top(plain_decode, "18: unsharded bf16 decode", top=4)
    xs = [torch.randn(batch // 2, 1, cfg.d_model, device=dev,
                      dtype=torch.bfloat16) for _ in range(mesh.size)]
    ar_ms = host_ms(lambda: mesh.over(
        "tp", xs, lambda coll, t: coll.allreduce(t)), iters=20)
    log(f"  18 bf16 decode of {n_new} tokens from ({batch}, {s_p}): sharded "
        f"{ms_sh:.1f} ms ({batch * n_new / ms_sh * 1e3:.1f} tokens/s, "
        f"{busy_sh:.0f} us of device time), unsharded {ms_pl:.1f} ms "
        f"({batch * n_new / ms_pl * 1e3:.1f} tokens/s, {busy_pl:.0f} us; "
        f"the busy shares are the profiled calls' above); one tp allreduce of a "
        f"decode step's ({batch // 2}, 1, {cfg.d_model}) bf16 over 4 groups "
        f"of 4 ranks: {ar_ms:.3f} ms host, {2 * cfg.n_layers + 1} of them a "
        f"token (embedding, attention and w2 per layer); bf16 tokens equal "
        f"to the unsharded bf16 decode's: {100 * same:.1f}%; phase 18 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def load_flat(model, flat: torch.Tensor):
    """Copy a flat parameter vector (``flat_params``' order) into
    ``model``'s parameters."""
    with torch.no_grad():
        offset = 0
        for p in model.parameters():
            p.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
    if offset != flat.numel():
        raise ValueError(f"{flat.numel()} values for {offset} parameters")
    return model


def register_state_guests(job: dict) -> None:
    """Torch guests over faabric's state KV (``ctx.state()``), on the
    keys of user ``job["user"]``: ``state/write`` puts
    ``job["model"](device)``'s flat fp32 parameters into key weights
    (``set_from_device``, ``push_full``), creates the counter and the
    log keys, and keeps its logits on ``job["tokens"]``; ``state/read`` pulls the weights, loads a model of
    ``job["cfg"]`` from ``get_device_array(torch.float32)`` and keeps its
    logits; ``state/count`` adds ``job["iters"]`` to the counter under the
    global lock and appends once; ``handle/push`` registers a tensor
    under a device state handle and returns it as a dict, which
    ``handle/pull`` pulls. Each returns JSON with its host, its timings
    and the class of the key's authority; the logits and the pushed
    tensor go to ``job["out"]``."""
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.models import Transformer, forward
    from faabric_tpu_torch.state import get_device_handle_registry

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def reply(ctx, kv=None, **fields):
        if kv is not None:
            fields["backend"] = type(kv.authority).__name__
        return json.dumps({"host": ctx.state().host, **fields}).encode()

    def score(model, dev):
        with torch.no_grad():
            logits = forward(model, job["tokens"].to(dev))
        sync(dev)
        return logits

    @register_function("smoke", "state_write")
    def write(ctx):
        dev, state = ctx.device, ctx.state()
        model = job["model"](dev)
        flat = flat_params(model)
        kv = state.get_kv(job["user"], "weights", flat.numel() * 4)
        sync(dev)
        t0 = time.perf_counter()
        kv.set_from_device(flat)
        t1 = time.perf_counter()
        kv.push_full()
        t2 = time.perf_counter()
        for key in ("counter", "log"):
            small = state.get_kv(job["user"], key, 8)
            small.set(bytes(8))
            small.push_full()
        job["out"]["writer"] = (state.host, score(model, dev), flat)
        return reply(ctx, kv, set_ms=(t1 - t0) * 1e3,
                     push_ms=(t2 - t1) * 1e3, master=kv.is_master,
                     backup=kv.backup_host)

    @register_function("smoke", "state_read")
    def read(ctx):
        # One reader of a host at a time: the first pulls the value
        # (nothing to pull on the master's host) and makes the device
        # view, the second finds both done
        dev, state = ctx.device, ctx.state()
        kv = state.get_kv(job["user"], "weights")
        with job["locks"][state.host]:
            first = state.host not in job["pulled"]
            t0 = time.perf_counter()
            if first:
                kv.pull()
                job["pulled"].add(state.host)
            t1 = time.perf_counter()
            flat = kv.get_device_array(torch.float32)
            sync(dev)
            t2 = time.perf_counter()
            cached = kv.get_device_array(torch.float32) is flat
        model = load_flat(Transformer(job["cfg"], device=dev), flat)
        job["out"][ctx.message.id] = (state.host, score(model, dev))
        return reply(ctx, kv, pull_ms=(t1 - t0) * 1e3,
                     view_ms=(t2 - t1) * 1e3, first=first, cached=cached,
                     ptr=flat.data_ptr(), master=kv.is_master, size=kv.size)

    @register_function("smoke", "state_count")
    def count(ctx):
        state = ctx.state()
        kv = state.get_kv(job["user"], "counter")
        t0 = time.perf_counter()
        for _ in range(job["iters"]):
            kv.lock_global()
            try:
                kv.pull()
                value = int.from_bytes(kv.get_chunk(0, 8), "little")
                kv.set_chunk(0, (value + 1).to_bytes(8, "little"))
                kv.push_partial()
            finally:
                kv.unlock_global()
        ms = (time.perf_counter() - t0) * 1e3
        state.get_kv(job["user"], "log").append(
            f"{state.host}/{ctx.message.id}".encode())
        return reply(ctx, kv, ms=ms, master=kv.is_master)

    @register_function("smoke", "handle_push")
    def push(ctx):
        tensor = torch.randn(4096, 1024, device=ctx.device, generator=(
            torch.Generator(device=ctx.device).manual_seed(19)))
        handle = get_device_handle_registry().push(
            ctx.message.app_id, 0, "embed", tensor)
        job["out"]["pushed"] = tensor
        return reply(ctx, handle=handle.to_dict())

    @register_function("smoke", "handle_pull")
    def pull(ctx):
        handle = json.loads(ctx.message.input_data)["handle"]
        tensor = get_device_handle_registry().pull(handle)
        return reply(ctx, ptr=tensor.data_ptr(), handle=handle)


def run_batch(client, function: str, n: int, input_data: bytes = b"",
              timeout: float = 300.0, hosts=None):
    """Submit ``n`` messages of ``smoke/<function>`` (each with
    ``input_data``) and wait for all of them; returns the results in
    message order and the wall ms. ``hosts`` (one a message) places the
    batch by a decision preloaded through the planner client."""
    from faabric_tpu_torch.batch_scheduler import SchedulingDecision
    from faabric_tpu_torch.proto import batch_exec_factory

    req = batch_exec_factory("smoke", function, n)
    for m in req.messages:
        m.input_data = input_data
    if hosts is not None:
        decision = SchedulingDecision(req.app_id, 0)
        for m, host in zip(req.messages, hosts, strict=True):
            decision.add_message(host, m.id, m.app_idx, m.app_idx)
        client.preload_scheduling_decision(decision)
    t0 = time.perf_counter()
    client.call_functions(req)
    deadline = time.monotonic() + timeout
    while True:
        status = client.get_batch_results(req.app_id)
        if status.finished and len(status.message_results) == n:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"smoke/{function}: "
                                 f"{len(status.message_results)} of {n} "
                                 f"results after {timeout} s")
        time.sleep(0.01)
    wall = (time.perf_counter() - t0) * 1e3
    return sorted(status.message_results, key=lambda m: m.app_idx), wall


def state_phase(dev, build, cfg=None, iters: int = 1000,
                hosts=("state-host-a", "state-host-b"),
                base: int | None = None, redis_iters: int = 250) -> dict:
    """Phase 19: faabric's state KV through torch guests on two hosts (a
    port planner and two WorkerRuntimes, 2 slots each, ``inmemory`` mode
    with one backup a key). A guest puts the flagship's whole fp32
    parameter vector into a key; four guests over both hosts pull it,
    load a model from ``get_device_array(torch.float32)`` and score a
    (1, 512) batch whose logits must equal the writer's bit for bit;
    four guests add ``iters`` each to a counter under ``lock_global``
    (exact) and append once (every value back); a device state handle
    passed between two guests of one host is the same storage, with no
    counted copy, and ``pull_host`` counts one. Then 19r on the same
    cluster (``redis_state_part``) with ``redis_iters`` increments a
    counter guest. Returns the launches of the writers' and readers'
    batches (the phase's main path) of both parts."""
    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig, Transformer
    from faabric_tpu_torch.state import get_device_handle_registry
    from faabric_tpu_torch.util.config import get_system_config

    log("phase 19: faabric's state KV through torch guests on two hosts")
    t_phase = time.perf_counter()
    cfg = cfg or ModelConfig()
    conf = get_system_config()
    check(conf.state_mode == "inmemory" and conf.state_replicas == 1,
          f"19: STATE_MODE {conf.state_mode}, FAABRIC_STATE_REPLICAS "
          f"{conf.state_replicas}")
    out: dict = {}
    tokens = torch.randint(0, cfg.vocab_size, (1, 512),
                           generator=torch.Generator().manual_seed(19))
    job = {"cfg": cfg, "tokens": tokens, "iters": iters, "out": out,
           "user": "smoke", "pulled": set(),
           "locks": {h: threading.Lock() for h in hosts},
           "model": lambda device: Transformer(
               cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(19))}
    register_state_guests(job)
    n_params = sum(p.numel() for p in job["model"](dev).parameters())
    factory = TorchExecutorFactory(device=dev.type)
    planner_server, workers = start_cluster(dict.fromkeys(hosts, 2), factory,
                                            base)
    try:
        client = workers[0].planner_client
        if dev.type == "cuda":
            torch.cuda.synchronize()
        reset_device_copy_totals()
        build.reset_launch_counts()
        w_res, w_wall = run_batch(client, "state_write", 1)
        (w,) = guest_outputs(w_res, "19 writer")
        r_res, r_wall = run_batch(client, "state_read", 4)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        copies = device_copy_totals()
        readers = guest_outputs(r_res, "19 readers")
        writer_host, want, _ = out.pop("writer")
        check(w["master"] and w["backup"] and w["backup"] != writer_host,
              f"19: the writer on {writer_host} is the key's master, its "
              f"backup {w['backup']}; {n_params:,} fp32 parameters, "
              f"{n_params * 4:,} bytes: set_from_device "
              f"{w['set_ms']:.1f} ms, push_full {w['push_ms']:.1f} ms "
              f"(with the backup forward); {w_wall:.1f} ms through the "
              f"planner")
        got = [out.pop(m.id) for m in r_res]
        remote = [r for r in readers if r["host"] != writer_host]
        check(sorted(h for h, _ in got) == sorted(list(hosts) * 2)
              and len(remote) == 2
              and all(r["size"] == n_params * 4 for r in readers),
              f"19: four readers, two on each host; the two on "
              f"{remote[0]['host'] if remote else '?'} pull from the master "
              f"on {writer_host}")
        check(all(torch.equal(lg, want) for _, lg in got),
              f"19: every reader's (1, 512) logits equal the writer's bit "
              f"for bit ({tuple(want.shape)})")
        by_host = {h: [r for r in readers if r["host"] == h] for h in hosts}
        check(all(r["cached"] for r in readers)
              and all(sorted(r["first"] for r in rs) == [False, True]
                      and len({r["ptr"] for r in rs}) == 1
                      for rs in by_host.values()),
              "19: on each host the first reader made the device view and "
              "the second got the same cached tensor")
        for r in readers:
            log(f"  19 reader on {r['host']} "
                f"({'master' if r['master'] else 'remote'}, "
                f"{'first' if r['first'] else 'second'}): pull "
                f"{r['pull_ms']:.1f} ms, device view {r['view_ms']:.1f} ms")
        h2d = copies["by_reason"].get("h2d.state", {})
        d2h = copies["by_reason"].get("d2h.state", {})
        check(h2d.get("count") == 2 and h2d.get("bytes") == 2 * n_params * 4
              and d2h.get("count") == 1 and d2h.get("bytes") == n_params * 4,
              f"19: copies counted: {copies['by_reason']} (one D2H of the "
              f"weights by the writer, one H2D a host)")
        per_forward = {"rms_norm": 2 * cfg.n_layers + 1,
                       "flash_attention": cfg.n_layers}
        if dev.type == "cuda":
            for name, n in per_forward.items():
                check(launches.get(name, 0) == 5 * n,
                      f"19: {name} launched {launches.get(name, 0)} times = 5 "
                      f"forwards (writer and 4 readers) x {n}")
        log(f"  19 readers: {r_wall:.1f} ms through the planner")

        c_res, c_wall = run_batch(client, "state_count", 4)
        counters = guest_outputs(c_res, "19 counters")
        kv = workers[0].state.get_kv("smoke", "counter")
        kv.pull()
        value = int.from_bytes(kv.get_chunk(0, 8), "little")
        check(value == 4 * iters and sorted(c["host"] for c in counters)
              == sorted(list(hosts) * 2),
              f"19: four guests (two a host) each added {iters} under "
              f"lock_global: the counter reads {value}; "
              + ", ".join(f"{c['host']} {'master' if c['master'] else 'remote'} "
                          f"{c['ms'] / iters:.3f} ms an increment"
                          for c in counters))
        appended = workers[1].state.get_kv("smoke", "log").get_appended(4)
        want_log = sorted(f"{c['host']}/{m.id}".encode()
                          for c, m in zip(counters, c_res))
        check(sorted(appended) == want_log,
              f"19: get_appended returns every guest's value {appended}")

        reg = get_device_handle_registry()
        p_res, _ = run_batch(client, "handle_push", 1)
        (pushed,) = guest_outputs(p_res, "19 handle push")
        reset_device_copy_totals()
        q_res, _ = run_batch(client, "handle_pull", 1,
                             json.dumps({"handle": pushed["handle"]}).encode())
        (pulled,) = guest_outputs(q_res, "19 handle pull")
        tensor = out.pop("pushed")
        copies = device_copy_totals()
        check(pulled["host"] == pushed["host"]
              and pulled["ptr"] == tensor.data_ptr()
              and copies["count"] == 0,
              f"19: the handle pushed on {pushed['host']} and pulled by the "
              f"next guest there is the same storage, with "
              f"{copies['count']} counted copies")
        nbytes = tensor.numel() * tensor.element_size()
        host_copy = reg.pull_host(pushed["handle"])
        copies = device_copy_totals()
        check(torch.equal(host_copy, tensor.cpu())
              and copies["by_reason"] == {"d2h.state": {"count": 1,
                                                        "bytes": nbytes}},
              f"19: pull_host counts one D2H copy of {nbytes:,} bytes")
        reg.drop(pushed["handle"])
        log(f"  phase 19 before 19r: {time.perf_counter() - t_phase:.1f} s")
        r_launches = redis_state_part(dev, build, client, job, hosts,
                                      n_params, redis_iters)
        launches = {k: launches.get(k, 0) + r_launches.get(k, 0)
                    for k in {*launches, *r_launches}}
    finally:
        t_stop = time.perf_counter()
        stop_cluster(planner_server, workers)
        log(f"  19: the cluster stopped in {time.perf_counter() - t_stop:.1f} s")
    log(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def redis_state_part(dev, build, client, job: dict, hosts, n_params: int,
                     iters: int) -> dict:
    """Phase 19r: phase 19's state path on a Redis authority, on phase
    19's running cluster. The port's ``MiniRedisServer`` serves on a
    thread of this process and ``STATE_MODE=redis`` points both
    runtimes at it (the config is read again, and restored after). The
    writer puts the flagship's fp32 weights into a Redis-backed key from
    a tensor on ``dev``; two readers, one on each host by a preloaded
    decision, pull the key and score it bitwise equal to the writer;
    four guests add ``iters`` each to a counter under ``lock_global``
    and append once. Every guest's key must be a ``RedisAuthority``, and
    the server must hold the weights' exact bytes. Returns the launches
    of the writer's and readers' batches."""
    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.redis import MiniRedisServer
    from faabric_tpu_torch.state import State
    from faabric_tpu_torch.util.config import get_system_config

    log("phase 19r: the state path on a Redis authority")
    t_part = time.perf_counter()
    if dev.type == "cuda":
        log("  19r card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    knobs = ("STATE_MODE", "REDIS_STATE_HOST", "REDIS_PORT")
    saved = {k: os.environ.get(k) for k in knobs}
    server = MiniRedisServer()
    server.start()
    conf = get_system_config()
    out = job["out"]
    try:
        os.environ.update(STATE_MODE="redis", REDIS_STATE_HOST="127.0.0.1",
                          REDIS_PORT=str(server.port))
        conf.reset()
        check(conf.state_mode == "redis"
              and conf.redis_port == server.port,
              f"19r: STATE_MODE {conf.state_mode}, REDIS_PORT "
              f"{conf.redis_port}")
        user = job["user"] = "smoke-redis"
        job["pulled"], job["iters"] = set(), iters
        if dev.type == "cuda":
            torch.cuda.synchronize()
        reset_device_copy_totals()
        build.reset_launch_counts()
        w_res, w_wall = run_batch(client, "state_write", 1)
        (w,) = guest_outputs(w_res, "19r writer")
        r_res, r_wall = run_batch(client, "state_read", 2,
                                  hosts=list(hosts))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        copies = device_copy_totals()
        readers = guest_outputs(r_res, "19r readers")
        writer_host, want, flat = out.pop("writer")
        # One D2H copy of the writer's parameters, outside the counted
        # window, to hold the server's value against byte for byte
        want_bytes = flat.cpu().numpy().tobytes()
        del flat
        value = server.store.data.get(f"fstate:{user}/weights".encode())
        check(all(g["backend"] == "RedisAuthority" for g in [w, *readers])
              and len(want_bytes) == n_params * 4 and value == want_bytes,
              f"19r: the writer's and readers' keys are Redis-backed "
              f"({[g['backend'] for g in [w, *readers]]}), the server "
              f"holds {len(value) if value is not None else 0:,} bytes, "
              f"equal to the writer's {n_params * 4:,}: "
              f"{value == want_bytes}")
        del want_bytes
        got = [out.pop(m.id) for m in r_res]
        check(sorted(h for h, _ in got) == sorted(hosts)
              and all(r["first"] and r["cached"]
                      and r["size"] == n_params * 4 for r in readers),
              f"19r: one reader on each host ({[h for h, _ in got]}), "
              "each pulled the key and made the device view")
        check(all(torch.equal(lg, want) for _, lg in got),
              f"19r: both readers' (1, 512) logits equal the writer's bit "
              f"for bit ({tuple(want.shape)})")
        h2d = copies["by_reason"].get("h2d.state", {})
        d2h = copies["by_reason"].get("d2h.state", {})
        check(h2d.get("count") == 2 and h2d.get("bytes") == 2 * n_params * 4
              and d2h.get("count") == 1 and d2h.get("bytes") == n_params * 4,
              f"19r: copies counted: {copies['by_reason']}")
        per_forward = {"rms_norm": 2 * job["cfg"].n_layers + 1,
                       "flash_attention": job["cfg"].n_layers}
        if dev.type == "cuda":
            for name, n in per_forward.items():
                check(launches.get(name, 0) == 3 * n,
                      f"19r: {name} launched {launches.get(name, 0)} times "
                      f"= 3 forwards (writer and 2 readers) x {n}")
        log(f"  19r writer on {writer_host}: {n_params * 4:,} bytes, "
            f"set_from_device {w['set_ms']:.1f} ms, push_full to Redis "
            f"{w['push_ms']:.1f} ms; {w_wall:.1f} ms through the planner")
        for r in readers:
            log(f"  19r reader on {r['host']}: pull from Redis "
                f"{r['pull_ms']:.1f} ms, device view {r['view_ms']:.1f} ms")
        log(f"  19r readers: {r_wall:.1f} ms through the planner")

        c_res, c_wall = run_batch(client, "state_count", 4)
        counters = guest_outputs(c_res, "19r counters")
        probe = State("19r-probe", device=torch.device("cpu"))
        kv = probe.get_kv(user, "counter")
        kv.pull()
        total = int.from_bytes(kv.get_chunk(0, 8), "little")
        check(total == 4 * iters
              and all(c["backend"] == "RedisAuthority" for c in counters)
              and sorted(c["host"] for c in counters)
              == sorted(list(hosts) * 2),
              f"19r: four guests (two a host) each added {iters} under "
              f"lock_global on Redis: the counter reads {total}; "
              + ", ".join(f"{c['host']} {c['ms'] / iters:.3f} ms an "
                          "increment" for c in counters))
        appended = probe.get_kv(user, "log").get_appended(4)
        want_log = sorted(f"{c['host']}/{m.id}".encode()
                          for c, m in zip(counters, c_res))
        check(sorted(appended) == want_log,
              f"19r: get_appended returns every guest's value {appended}")
        log(f"  19r counters: {c_wall:.1f} ms through the planner")
    finally:
        job["user"] = "smoke"
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        conf.reset()
        t_stop = time.perf_counter()
        server.stop()
        log(f"  19r took {time.perf_counter() - t_part:.1f} s (the server's "
            f"stop {time.perf_counter() - t_stop:.1f} s)")
    return launches


def bind_flat(model, flat: torch.Tensor):
    """Make ``model``'s parameters views of one flat tensor
    (``flat_params``' order, with their values), so that an optimizer
    step writes into ``flat`` in place."""
    offset = 0
    for p in model.parameters():
        p.data = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    if offset != flat.numel():
        raise ValueError(f"{flat.numel()} values for {offset} parameters")
    return model


def register_snapshot_guests(job: dict) -> None:
    """Torch guests over faabric's snapshots. Each batch is one message a
    host (one slot a host), and a guest acts by its host:

    - ``smoke/snap_step`` on ``job["hosts"][0]`` (hA), with input
      ``{"stage": ...}``: ``init`` builds ``job["model"](device)``, holds
      its weights as one flat tensor whose views the parameters are,
      pushes it as a device state handle, takes the handle's
      ``DeviceSnapshot`` (``snapshot_of``) and pushes
      ``to_host_snapshot()`` to hB under ``job["key"]``; ``sparse``
      takes one SGD step (no weight decay) of the last block and the
      final norm, ``full`` one AdamW step of the whole model
      (``make_train_step``); after either, it checks ``dirty_pages``
      against ``page_flags`` over host copies from before and after,
      takes ``diff(update_baseline=True)`` and pushes the diffs with
      ``push_snapshot_update``. The guest on hB does nothing.
    - ``smoke/snap_score``: on hA, scores ``job["tokens"]`` with the live
      weights; on hB, takes the snapshot from its host's registry, writes
      the queued diffs, loads the image onto its device and scores.

    Times, pages and copy counts come back as JSON; logits and host
    images go to ``job["out"]``."""
    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.models import (
        Transformer,
        forward,
        loss_fn,
        make_optimizer,
        make_train_step,
    )
    from faabric_tpu_torch.snapshot import SnapshotClient
    from faabric_tpu_torch.state import get_device_handle_registry
    from faabric_tpu_torch.util.dirty import page_flags

    hA, hB = job["hosts"]

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def clocked(fn, dev):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    def host_image(flat):
        # The oracle's copies: not the snapshot's, so not counted
        return flat.detach().cpu().numpy().view(np.uint8).copy()

    def score(model, dev):
        with torch.no_grad():
            logits = forward(model, job["tokens"].to(dev))
        sync(dev)
        return logits

    def push(fn):
        client = SnapshotClient(hB)
        try:
            return clocked(lambda: fn(client), torch.device("cpu"))[1]
        finally:
            client.close()

    def init(dev):
        model = job["make_model"](dev)
        flat = flat_params(model)
        bind_flat(model, flat)
        handle = get_device_handle_registry().push(0, 0, "weights", flat)
        snap = get_device_handle_registry().snapshot_of(handle)
        host = snap.to_host_snapshot()
        push_ms = push(lambda c: c.push_snapshot(job["key"], host))
        job.update(model=model, handle=handle, snap=snap)
        job["out"]["image"] = host.data
        return {"push_ms": push_ms, "bytes": host.size,
                "pages": snap.n_pages}

    def train(dev, stage):
        model = job["model"]
        flat = get_device_handle_registry().pull(job["handle"])
        snap = job["snap"]
        tok, tgt = job["batch"](dev)
        before = host_image(flat)
        if stage == "sparse":
            last = list(model.blocks[-1].parameters()) + [model.ln_f]
            for p in model.parameters():
                p.requires_grad_(False)
            for p in last:
                p.requires_grad_(True)
            model.zero_grad(set_to_none=True)
            loss_fn(model, tok, tgt).backward()
            with torch.no_grad():
                for p in last:
                    p.add_(p.grad, alpha=-job["lr"])
        else:
            for p in model.parameters():
                p.requires_grad_(True)
            spec = make_optimizer(lr=job["lr"])
            make_train_step(model.cfg, spec)(model, spec.init(model), tok,
                                             tgt)
        model.zero_grad(set_to_none=True)
        sync(dev)
        after = host_image(flat)
        oracle = page_flags(before, after)
        flags, flags_ms = clocked(lambda: snap.dirty_pages(flat), dev)
        repeat_ms = [clocked(lambda: snap.dirty_pages(flat), dev)[1]
                     for _ in range(5)]
        reset_device_copy_totals()
        diffs, diff_ms = clocked(lambda: snap.diff(flat, update_baseline=True),
                                 dev)
        copies = device_copy_totals()["by_reason"]
        push_ms = push(lambda c: c.push_snapshot_update(job["key"], diffs))
        job["out"]["image"] = after
        return {"dirty": int(flags.sum()), "oracle_dirty": int(oracle.sum()),
                "flags_equal": bool(np.array_equal(flags, oracle)),
                "changed_pages": int(oracle.sum()), "pages": snap.n_pages,
                "dirty_ms": flags_ms,
                "dirty_ms_median": float(np.median(repeat_ms)),
                "diff_ms": diff_ms, "push_ms": push_ms, "diffs": len(diffs),
                "diff_bytes": sum(len(d.data) for d in diffs),
                "d2h": copies.get("d2h.snapshot", {}),
                "copies": sorted(copies)}

    @register_function("smoke", "snap_step")
    def step(ctx):
        sched = ctx.executor.scheduler
        out = {"host": sched.host}
        if sched.host == hA:
            stage = json.loads(ctx.message.input_data)["stage"]
            out.update(init(ctx.device) if stage == "init"
                       else train(ctx.device, stage))
        return json.dumps(out).encode()

    @register_function("smoke", "snap_score")
    def score_guest(ctx):
        sched, dev = ctx.executor.scheduler, ctx.device
        out = {"host": sched.host}
        if sched.host == hA:
            job["out"][hA] = score(job["model"], dev)
            return json.dumps(out).encode()
        snap = sched.snapshot_registry.get_snapshot(job["key"])
        out["queued"] = snap.queued_diff_count()
        out["written"], out["write_ms"] = clocked(snap.write_queued_diffs,
                                                  torch.device("cpu"))
        out["equal"] = bool(np.array_equal(snap.data, job["out"]["image"]))
        flat, out["load_ms"] = clocked(
            lambda: torch.from_numpy(snap.data.view(np.float32)).to(dev),
            dev)
        model = load_flat(Transformer(job["cfg"], device=dev), flat)
        job["out"][hB] = score(model, dev)
        return json.dumps(out).encode()


def snapshot_phase(dev, build, cfg=None,
                   hosts=("snap-host-a", "snap-host-b"),
                   base: int | None = None) -> dict:
    """Phase 20: faabric's snapshots through torch guests on two hosts (a
    port planner and two WorkerRuntimes, one slot each), at full width.
    A guest on hA holds the flagship's fp32 weights (seed 20) as one
    flat tensor, pushed as a device state handle; the handle's
    ``DeviceSnapshot`` goes to hB as a host snapshot
    (``push_snapshot``). Then (a) one bf16 8 x 512 SGD step of the last
    block and the final norm and (b) one AdamW step of the whole model
    (``make_train_step``): after each, the on-device ``dirty_pages``
    must equal ``page_flags`` over host copies from before and after,
    page for page, the counted device-to-host bytes of
    ``diff(update_baseline=True)`` must be the dirty pages x 4096 plus
    the flag vector, and after ``push_snapshot_update`` hB's snapshot,
    its queued diffs written, must equal hA's weights, and hB's guest
    must score a (1, 512) prompt from it bit for bit as hA's guest does
    from its live weights. Returns the launches of the whole sequence
    (the phase's main path)."""
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig, Transformer
    from faabric_tpu_torch.state import get_device_handle_registry

    log("phase 20: faabric's snapshots through torch guests on two hosts")
    t_phase = time.perf_counter()
    cfg = cfg or ModelConfig()
    hA, hB = hosts
    out: dict = {}
    tokens = torch.randint(0, cfg.vocab_size, (1, 512),
                           generator=torch.Generator().manual_seed(20))
    batch = torch.randint(0, cfg.vocab_size, (8, 513),
                          generator=torch.Generator().manual_seed(21))
    job = {"cfg": cfg, "tokens": tokens, "hosts": hosts, "out": out,
           "key": "smoke/weights", "lr": 1e-2,
           "batch": lambda device: (batch[:, :-1].to(device),
                                    batch[:, 1:].to(device)),
           "make_model": lambda device: Transformer(
               cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(20))}
    register_snapshot_guests(job)
    factory = TorchExecutorFactory(device=dev.type)
    planner_server, workers = start_cluster(dict.fromkeys(hosts, 1), factory,
                                            base)
    launches: dict = {}

    def stage_launches(before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                if v != before.get(k, 0)}

    def run_both(function: str, stage: str = "") -> dict:
        """One message a host; returns each host's reply by host."""
        res, _ = run_batch(client, function, 2,
                           json.dumps({"stage": stage}).encode())
        replies = guest_outputs(res, f"20 {function} {stage}")
        by_host = {r["host"]: r for r in replies}
        check(sorted(by_host) == sorted(hosts),
              f"20 {function} {stage}: one guest on each host "
              f"({sorted(by_host)})")
        return by_host

    def scores(what: str) -> dict:
        got = run_both("snap_score")[hB]
        a, b = out.pop(hA), out.pop(hB)
        check(got["equal"] and got["written"] == got["queued"],
              f"20 {what}: hB wrote {got['written']} queued diff(s) in "
              f"{got['write_ms']:.2f} ms and its snapshot equals hA's "
              f"weights byte for byte")
        check(torch.equal(a, b),
              f"20 {what}: hB's (1, 512) logits from its snapshot equal "
              f"hA's from its live weights bit for bit ({tuple(b.shape)}; "
              f"image loaded onto {dev.type} in {got['load_ms']:.1f} ms)")
        return got

    try:
        client = workers[0].planner_client
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build.reset_launch_counts()
        init = run_both("snap_step", "init")[hA]
        n_bytes = init["bytes"]
        check(n_bytes == 4 * sum(p.numel() for p in job["model"].parameters())
              and init["pages"] == -(-n_bytes // 4096),
              f"20: hA pushed its {n_bytes:,}-byte snapshot "
              f"({init['pages']:,} pages) to hB in {init['push_ms']:.1f} ms")
        scores("initial push")
        bound_ms = 2 * n_bytes / HBM_BYTES_PER_S * 1e3
        for stage, what in (("sparse", "(a) SGD step of the last block and "
                             "the final norm"),
                            ("full", "(b) AdamW step of the whole model")):
            before = dict(build.LAUNCHES)
            got = run_both("snap_step", stage)[hA]
            step_launches = stage_launches(before)
            check(got["flags_equal"] and got["dirty"] > 0,
                  f"20 {what}: dirty_pages equals the host oracle page for "
                  f"page ({got['dirty']:,} of {got['pages']:,} pages dirty)")
            if stage == "full":
                check(got["dirty"] == got["changed_pages"],
                      f"20 {what}: every changed page is dirty")
            want_d2h = {"count": 2,
                        "bytes": got["dirty"] * 4096 + got["pages"]}
            check(got["d2h"] == want_d2h and got["copies"] == ["d2h.snapshot"],
                  f"20 {what}: diff copied {got['d2h']} device to host "
                  f"= {got['dirty']:,} dirty pages x 4096 + the "
                  f"{got['pages']:,}-byte flag vector, and nothing else")
            sc = scores(what)
            log(f"  20 {what}: dirty pages {got['dirty']:,}; dirty_pages "
                f"{got['dirty_ms']:.3f} ms (median of 5 more "
                f"{got['dirty_ms_median']:.3f} ms), diff {got['diff_ms']:.3f} "
                f"ms ({got['diffs']} diff(s), {got['diff_bytes']:,} bytes), "
                f"compare bound {bound_ms:.3f} ms (2 x {n_bytes:,} B / 3.35 "
                f"TB/s); push_snapshot {init['push_ms']:.1f} ms, "
                f"push_snapshot_update {got['push_ms']:.1f} ms; hB wrote "
                f"the queued diffs in {sc['write_ms']:.2f} ms; launches "
                f"{step_launches}")
            job[stage] = step_launches
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        if dev.type == "cuda":
            want = {"sparse": {"flash_attention": cfg.n_layers + 1,
                               "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                               "rms_norm": 2 * cfg.n_layers + 3},
                    "full": {"flash_attention": 2 * cfg.n_layers,
                             "flash_bwd_dq": cfg.n_layers,
                             "flash_bwd_dkv": cfg.n_layers,
                             "rms_norm": 4 * cfg.n_layers + 1}}
            for stage, counts in want.items():
                for name, n in counts.items():
                    check(job[stage].get(name, 0) == n,
                          f"20 {stage} step: {name} launched "
                          f"{job[stage].get(name, 0)} times, {n} expected")
            # Three scorings on each host: (1, 512) forwards
            check(launches.get("flash_attention", 0)
                  == 6 * cfg.n_layers + sum(
                      job[s]["flash_attention"] for s in want),
                  f"20: {launches.get('flash_attention', 0)} flash launches "
                  f"= 6 scoring forwards x {cfg.n_layers} + the steps'")
        get_device_handle_registry().drop(job["handle"])
    finally:
        stop_cluster(planner_server, workers)
    log(f"  phase 20 launches: {launches}")
    log(f"  phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def share_step(model, flat: torch.Tensor, tokens: torch.Tensor,
               targets: torch.Tensor):
    """The gradient of the mean loss over ``tokens`` at the weights
    ``flat`` (``flat_params``' order), with ``model``'s parameters bound
    as views of ``flat``: (the loss, the flat fp32 gradient). Guests and
    the oracle both take their steps through this."""
    from faabric_tpu_torch.models import loss_fn

    bind_flat(model, flat)
    for p in model.parameters():
        p.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens, targets)
    loss.backward()
    g = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    model.zero_grad(set_to_none=True)
    return loss.detach(), g


def register_threads_guests(job: dict) -> None:
    """Torch guests of faabric's fork-join model:

    - ``smoke/threads_sgd``, a THREADS thread: it reads the weights from
      its executor's memory image (restored from the main thread's
      snapshot), waits until every thread of its host has read them,
      takes the gradient ``g_i`` of its (2, seq) share of the batch on
      its device (``share_step``), and under its executor's lock adds
      ``-(lr / n) g_i`` into the image and writes its fp32 loss into its
      128-byte slot of the results page;
    - ``smoke/chain_parent`` chains two ``smoke/chain_score`` calls,
      each scoring its own (1, seq) prompt with ``job["score_model"]``
      and returning the greedy next token; the parent returns their sum.

    A guest raises when the factory runs on CUDA and its device is not a
    CUDA device. Replies are JSON with each step's times."""
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.models import Transformer, forward
    from faabric_tpu_torch.scheduler.chain import await_chained, chain_function

    n_bytes, lr, n = job["n_bytes"], job["lr"], job["n_threads"]
    guard = threading.Lock()
    locks: dict = {}
    barriers: dict = {}

    def device_of(ctx):
        dev = ctx.device
        if job["device_type"] == "cuda" and dev.type != "cuda":
            raise RuntimeError(f"guest {ctx.message.function} on {dev}, "
                               "not on the CUDA device it was built for")
        return dev

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @register_function("smoke", "threads_sgd")
    def sgd(ctx):
        dev = device_of(ctx)
        ex, i = ctx.executor, ctx.message.app_idx
        with guard:
            lock = locks.setdefault(id(ex), threading.Lock())
            barrier = barriers.setdefault(
                (id(ex), ctx.request.app_id),
                threading.Barrier(ctx.request.n_messages()))
        mem = ex.get_memory_view()
        t0 = time.perf_counter()
        flat = torch.from_numpy(mem[:n_bytes].view(np.float32)).to(
            dev, copy=True)
        sync(dev)
        t1 = time.perf_counter()
        barrier.wait(300)
        model = Transformer(job["cfg"], device=dev)
        tok, tgt = job["share"](i, dev)
        loss, g = share_step(model, flat, tok, tgt)
        update = (g * (-lr / n)).cpu().numpy()
        loss_bytes = loss.float().cpu().numpy().tobytes()
        t2 = time.perf_counter()
        with lock:
            mem[:n_bytes].view(np.float32)[:] += update
        slot = n_bytes + SLOT_BYTES * i
        mem[slot:slot + 4] = np.frombuffer(loss_bytes, np.uint8)
        t3 = time.perf_counter()
        return json.dumps({
            "host": ctx.executor.scheduler.host, "i": i,
            "device": str(dev), "load_ms": (t1 - t0) * 1e3,
            "step_ms": (t2 - t1) * 1e3, "add_ms": (t3 - t2) * 1e3}).encode()

    @register_function("smoke", "chain_score")
    def score(ctx):
        dev = device_of(ctx)
        k = int(ctx.message.input_data)
        with torch.no_grad():
            logits = forward(job["score_model"], job["prompts"][k].to(dev))
        return str(int(logits[0, -1].argmax())).encode()

    @register_function("smoke", "chain_parent")
    def parent(ctx):
        device_of(ctx)
        ids = [chain_function("chain_score", str(k).encode())
               for k in range(2)]
        tokens = [int(await_chained(m, timeout=300).output_data)
                  for m in ids]
        return json.dumps({"host": ctx.executor.scheduler.host,
                           "tokens": tokens, "sum": sum(tokens)}).encode()


SLOT_BYTES = 128   # one diff chunk: concurrent writers never share one


def threads_phase(dev, build, cfg=None, seq: int = 512,
                  hosts=("thr-host-a", "thr-host-b"),
                  base: int | None = None) -> dict:
    """Phase 21: faabric's fork-join model on two hosts (a port planner
    and two WorkerRuntimes with 2 slots each), at full width. The main
    thread (this script, on hA) holds the flagship's fp32 weights (seed
    21) and a 4096-byte results page as one snapshot: a FLOAT SUM merge
    region over the weights and four 128-byte bytewise loss slots. (a) A
    THREADS batch of 4 through hA's planner client, bin-packed 2 + 2 (hB
    restores from the snapshot the planner pushed): each thread takes the
    bf16 gradient of its (2, seq) share of one 8 x (seq + 1) batch, remat
    on, and adds ``-(lr / 4) g_i`` into its host's image (lr 1e-2); each
    host's diffs merge into the main snapshot. The merged weights must
    equal ``w - (lr / 4) sum g_i`` within 1e-6 (the oracle's ``g_i`` from
    the same shares run here), the slots the shares' losses bit for bit,
    and the update one unsharded 8-row step's direction (relative L2 at
    most 1e-2). (b) The same batch again: served from the decision cache,
    the merged image pushed again, two steps within 2e-6 of the
    oracle's. (c) A parent guest chains two children, each scoring a
    (1, seq) prompt; their greedy tokens' sum must be the direct
    forwards', and the exec graph has 3 nodes with queue and run times.
    On the card the THREADS batches launch exactly 4 times a train
    step's kernels each, and the chain 2 scoring forwards'. Returns the
    launches of the guests' runs (the phase's main path)."""
    from faabric_tpu_torch.batch_scheduler import (
        get_batch_scheduler,
        get_decision_cache,
    )
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig, Transformer, forward
    from faabric_tpu_torch.planner import get_planner
    from faabric_tpu_torch.proto import (
        BatchExecuteType,
        ReturnValue,
        batch_exec_factory,
    )
    from faabric_tpu_torch.snapshot import (
        SnapshotClient,
        SnapshotData,
        SnapshotDataType,
        SnapshotMergeOperation,
    )
    from faabric_tpu_torch.util.exec_graph import build_exec_graph, node_timing

    log("phase 21: THREADS batches of torch guests over two hosts, merged "
        "through snapshot diffs; chaining")
    t_phase = time.perf_counter()
    cfg = cfg or ModelConfig()
    hA, hB = hosts
    n_threads, lr, key = 4, 1e-2, "smoke/threads_weights"
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(21))
    w = flat_params(model)
    n_bytes = w.numel() * 4
    w_host = w.cpu().numpy()
    image = np.concatenate([w_host.view(np.uint8), np.zeros(4096, np.uint8)])
    batch = torch.randint(0, cfg.vocab_size, (2 * n_threads, seq + 1),
                          generator=torch.Generator().manual_seed(21))
    prompts = [torch.randint(0, cfg.vocab_size, (1, seq),
                             generator=torch.Generator().manual_seed(210 + k))
               for k in range(2)]

    def share(i, device):
        rows = batch[2 * i:2 * i + 2]
        return rows[:, :-1].to(device), rows[:, 1:].to(device)

    job = {"cfg": cfg, "n_bytes": n_bytes, "lr": lr, "n_threads": n_threads,
           "device_type": dev.type, "share": share, "prompts": prompts,
           "score_model": model}
    register_threads_guests(job)

    snap = SnapshotData(image)
    snap.add_merge_region(0, n_bytes, SnapshotDataType.FLOAT,
                          SnapshotMergeOperation.SUM)
    for i in range(n_threads):
        snap.add_merge_region(n_bytes + SLOT_BYTES * i, SLOT_BYTES)
    snap.fill_gaps_with_bytewise_regions()
    n_pages = -(-snap.size // 4096)
    log(f"  21: main-thread snapshot {snap.size:,} bytes ({n_pages:,} "
        f"pages): FLOAT SUM over {n_bytes:,} bytes of weights, "
        f"{n_threads} bytewise loss slots")

    # Instruments: the snapshot pushes and each host's batch diff, timed
    pushes, diffs = [], []
    real_push = SnapshotClient.push_snapshot
    real_diff = SnapshotData.diff_with_dirty_regions

    def timed_push(client, k, s):
        t0 = time.perf_counter()
        real_push(client, k, s)
        pushes.append((client.host, (time.perf_counter() - t0) * 1e3))

    def timed_diff(s, mem, dirty_pages):
        t0 = time.perf_counter()
        out = real_diff(s, mem, dirty_pages)
        diffs.append((id(s), (time.perf_counter() - t0) * 1e3,
                      int(np.count_nonzero(dirty_pages)), len(out)))
        return out

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def counted(fn):
        sync()
        before = dict(build.LAUNCHES)
        out = fn()
        sync()
        return out, {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                     if v != before.get(k, 0)}

    def oracle_step(flat):
        """Each share's (loss, g) at ``flat``, run here."""
        skel = Transformer(cfg, device=dev)
        return [share_step(skel, flat, *share(i, dev))
                for i in range(n_threads)]

    factory = TorchExecutorFactory(device=dev.type)
    planner_server, workers = start_cluster({hA: 2, hB: 2}, factory, base)
    path: dict = {}
    SnapshotClient.push_snapshot = timed_push
    SnapshotData.diff_with_dirty_regions = timed_diff
    policy = get_batch_scheduler()
    policy_calls = []
    real_policy = policy.make_scheduling_decision

    def counted_policy(*args, **kwargs):
        policy_calls.append(1)
        return real_policy(*args, **kwargs)

    policy.make_scheduling_decision = counted_policy
    try:
        client = workers[0].planner_client
        workers[0].snapshot_registry.register_snapshot(key, snap)
        w_oracle = w.double()
        current = w
        for step, what in ((1, "(a)"), (2, "(b)")):
            del pushes[:], diffs[:]
            calls_before = len(policy_calls)
            req = batch_exec_factory("smoke", "threads_sgd", n_threads)
            req.type = int(BatchExecuteType.THREADS)
            req.snapshot_key = key
            cached = get_decision_cache().get_cached_decision(req)

            def run():
                t0 = time.perf_counter()
                decision = client.call_functions(req)
                results = [client.get_message_result(req.app_id, m.id,
                                                     timeout=300)
                           for m in req.messages]
                return decision, results, (time.perf_counter() - t0) * 1e3

            (decision, results, wall_ms), launches = counted(run)
            bad = [m.output_data[:300] for m in results
                   if m.return_value != int(ReturnValue.SUCCESS)]
            check(not bad, f"21 {what}: every thread SUCCESS {bad}")
            replies = [json.loads(m.output_data) for m in results]
            check(sorted(decision.hosts) == [hA, hA, hB, hB]
                  and sorted(r["host"] for r in replies) == [hA, hA, hB, hB],
                  f"21 {what}: bin-pack put 2 threads on each host "
                  f"({decision.hosts})")
            if step == 2:
                check(cached is not None and cached.hosts == decision.hosts
                      and len(policy_calls) == calls_before,
                      f"21 {what}: the planner served the placement from "
                      f"the decision cache without asking the policy")
            check([h for h, _ in pushes] == ["smoke-planner", hB],
                  f"21 {what}: the main thread's snapshot went to the "
                  f"planner, then to hB "
                  f"({', '.join(f'{h} {ms:.1f} ms' for h, ms in pushes)})")
            hb_snap = workers[1].snapshot_registry.get_snapshot(key)
            by_host = {id(snap): hA, id(hb_snap): hB}
            check(sorted(by_host.get(s, "?") for s, *_ in diffs) == [hA, hB],
                  f"21 {what}: one batch diff a host")
            t0 = time.perf_counter()
            applied = snap.write_queued_diffs()
            write_ms = (time.perf_counter() - t0) * 1e3
            check(applied >= 2, f"21 {what}: {applied} diffs merged")

            merged = torch.from_numpy(
                snap.data[:n_bytes].view(np.float32).copy()).to(dev)
            (shares), oracle_launches = counted(lambda: oracle_step(current))
            g_sum = torch.stack([g.double() for _, g in shares]).sum(0)
            w_oracle = w_oracle - lr / n_threads * g_sum
            err = float((merged.double() - w_oracle).abs().max())
            limit = 1e-6 * step
            check(err <= limit,
                  f"21 {what}: merged weights equal the oracle's {step} "
                  f"step(s) within {limit:g} (max |err| {err:.3g})")
            slots = snap.data[n_bytes:n_bytes + SLOT_BYTES * n_threads]
            got_losses = [bytes(slots[SLOT_BYTES * i:SLOT_BYTES * i + 4])
                          for i in range(n_threads)]
            want_losses = [loss.float().cpu().numpy().tobytes()
                           for loss, _ in shares]
            check(got_losses == want_losses,
                  f"21 {what}: the loss slots hold the shares' losses bit "
                  f"for bit ({[float(l) for l, _ in shares]})")
            if step == 1:
                full, full_launches = counted(lambda: share_step(
                    Transformer(cfg, device=dev), current,
                    batch[:, :-1].to(dev), batch[:, 1:].to(dev)))
                upd = merged.double() - current.double()
                upd_full = -lr * full[1].double()
                rel = float((upd - upd_full).norm() / upd_full.norm())
                check(rel <= 1e-2,
                      f"21 {what}: the update's relative L2 to one "
                      f"unsharded {2 * n_threads} x {seq} step's is "
                      f"{rel:.4g} (at most 1e-2)")
                log(f"  21 {what}: unsharded step launches {full_launches}")
            log(f"  21 {what}: oracle share steps' launches {oracle_launches}")
            for r in sorted(replies, key=lambda r: r["i"]):
                log(f"  21 {what}: thread {r['i']} on {r['host']} "
                    f"({r['device']}): load {r['load_ms']:.1f} ms, step "
                    f"{r['step_ms']:.1f} ms, add under the lock "
                    f"{r['add_ms']:.1f} ms")
            for s, ms, dirty, n_diffs in diffs:
                log(f"  21 {what}: {by_host[s]} diff_with_dirty_regions "
                    f"{ms:.1f} ms over {dirty:,} dirty pages ({n_diffs} "
                    f"diffs)")
            log(f"  21 {what}: batch wall {wall_ms:.1f} ms through the "
                f"planner; snapshot pushes "
                f"{', '.join(f'{h} {ms:.1f} ms' for h, ms in pushes)}; "
                f"write_queued_diffs {write_ms:.1f} ms ({applied} diffs); "
                f"launches {launches}")
            if dev.type == "cuda":
                want = {"flash_attention": 2 * cfg.n_layers * n_threads,
                        "flash_bwd_dq": cfg.n_layers * n_threads,
                        "flash_bwd_dkv": cfg.n_layers * n_threads,
                        "rms_norm": (4 * cfg.n_layers + 1) * n_threads}
                for name, count in want.items():
                    check(launches.get(name, 0) == count,
                          f"21 {what}: {name} launched "
                          f"{launches.get(name, 0)} times, {count} expected")
                check(launches.get("flash_attention.wgmma", 0)
                      == launches["flash_attention"],
                      f"21 {what}: every flash forward took the wgmma body")
            for k, v in launches.items():
                path[k] = path.get(k, 0) + v
            current = merged

        # (c) chaining: the children score with the merged weights
        load_flat(model, current)
        req = batch_exec_factory("smoke", "chain_parent", 1)
        req.messages[0].record_exec_graph = True

        def chain():
            t0 = time.perf_counter()
            client.call_functions(req)
            result = client.get_message_result(req.app_id, req.messages[0].id,
                                               timeout=300)
            return result, (time.perf_counter() - t0) * 1e3

        (result, chain_ms), launches = counted(chain)
        check(result.return_value == int(ReturnValue.SUCCESS),
              f"21 (c): the parent SUCCESS ({result.output_data[:300]!r})")
        reply = json.loads(result.output_data)
        with torch.no_grad():
            direct, direct_launches = counted(lambda: [
                int(forward(model, p.to(dev))[0, -1].argmax())
                for p in prompts])
        check(reply["tokens"] == direct and reply["sum"] == sum(direct),
              f"21 (c): the children's greedy tokens {reply['tokens']} "
              f"(sum {reply['sum']}) are the direct forwards' {direct}")
        planner = get_planner()
        graph = build_exec_graph(
            lambda a, m: planner.get_message_result(a, m), result.id,
            req.app_id)
        nodes = [graph.root, *graph.root.children]
        timings = [node_timing(n.msg) for n in nodes]
        check(graph.count_nodes() == 3 and all(
            {"queue_ms", "exec_ms"} <= set(t) for t in timings),
              f"21 (c): the exec graph has {graph.count_nodes()} nodes, each "
              f"with queue and run times ({timings})")
        log(f"  21 (c): parent on {reply['host']}, chain wall {chain_ms:.1f} "
            f"ms; launches {launches}; direct forwards' {direct_launches}")
        if dev.type == "cuda":
            for name, count in (("flash_attention", 2 * cfg.n_layers),
                                ("rms_norm", 2 * (2 * cfg.n_layers + 1))):
                check(launches.get(name, 0) == count,
                      f"21 (c): {name} launched {launches.get(name, 0)} "
                      f"times, {count} expected")
            check(launches.get("flash_attention.wgmma", 0)
                  == launches["flash_attention"],
                  "21 (c): every flash forward took the wgmma body")
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
    finally:
        SnapshotClient.push_snapshot = real_push
        SnapshotData.diff_with_dirty_regions = real_diff
        del policy.make_scheduling_decision
        stop_cluster(planner_server, workers)
    log(f"  phase 21 launches: {path}")
    log(f"  phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return path


def register_planes_guests(job: dict) -> None:
    """Phase 22's guest, ``mpi/planes_step``: ``job["steps"]`` steps of
    :func:`ddp_step` of ``job["model"](device)`` over the gang's world,
    after setting ``job["world"]``'s attributes on it (every rank sets
    the same). With ``job["broadcast"]`` each step starts with a
    broadcast of rank 0's flat parameters, which the other ranks load.
    With ``job["exact"]`` the gradient also goes through an exact fp32
    allreduce (``allreduce_quant`` off) after the step's: each rank's
    gradient lands in ``job["grads"]``, rank 0's two sums in
    ``job["sums"]``. Each rank leaves its flat parameters in
    ``job["params"]`` (and, when the job holds a ``"first"`` dict, its
    parameters after the first step there) and returns JSON: its host,
    the world's leaders, the rungs, step, broadcast and allreduce ms, and
    the bytes its host's bulk client to the other host put on the wire
    during each allreduce."""
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.mpi import MpiOp

    @register_function("mpi", "planes_step")
    def planes_step(ctx):
        world = ctx.mpi_world()
        rank = ctx.message.mpi_rank
        dev = ctx.device
        for k, v in job["world"].items():
            setattr(world, k, v)
        host = world.host_for_rank(rank)
        peer = next(h for h in world.hosts() if h != host)
        bulk = world.broker._get_bulk_client(peer)
        model = job["model"](dev)
        out = {"step_ms": [], "bcast_ms": [], "allreduce_ms": [],
               "wire_bytes": [], "exact_ms": [], "exact_wire_bytes": []}

        def reduce(flat):
            w0 = bulk.wire_bytes
            t0 = time.perf_counter()
            summed = world.allreduce(rank, flat, MpiOp.SUM)
            out["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
            out["wire_bytes"].append(bulk.wire_bytes - w0)
            if job["exact"]:
                world.barrier(rank)
                world.allreduce_quant = ""
                w0 = bulk.wire_bytes
                t0 = time.perf_counter()
                exact = world.allreduce(rank, flat, MpiOp.SUM)
                out["exact_ms"].append((time.perf_counter() - t0) * 1e3)
                out["exact_wire_bytes"].append(bulk.wire_bytes - w0)
                world.allreduce_quant = job["world"].get(
                    "allreduce_quant", "")
                job["grads"][rank] = _as_np(flat).copy()
                if rank == 0:
                    job["sums"]["quant"] = np.array(summed, copy=True)
                    job["sums"]["exact"] = np.array(exact, copy=True)
            return summed

        for s in range(job["steps"]):
            t0 = time.perf_counter()
            if job["broadcast"]:
                got = world.broadcast(0, rank, flat_params(model) if rank == 0
                                      else np.empty(0, np.float32))
                if rank != 0:
                    # A receive may share the codec cache's read-only
                    # base: copy before the tensor takes it
                    load_flat(model, torch.from_numpy(
                        np.array(got, np.float32, copy=True)).to(dev))
                out["bcast_ms"].append((time.perf_counter() - t0) * 1e3)
            tokens, targets = job["batch"](s, rank, dev)
            ddp_step(world, rank, model, tokens, targets, job["lr"],
                     reduce=reduce)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if s == 0 and "first" in job:
                job["first"][rank] = flat_params(model)
        job["params"][rank] = flat_params(model)
        world.barrier(rank)
        rungs = {kind: algo for (r, kind), algo in world.rungs.items()
                 if r == rank}
        return json.dumps({"rank": rank, "host": host, "rungs": rungs,
                           "leaders": list(world.topology().leaders),
                           **out}).encode()


def _metric(snap: dict, name: str, **labels) -> float:
    """The sum of a family's series matching ``labels`` in a metrics
    snapshot: counters' and gauges' values, histograms' sums."""
    fam = snap.get(name, {})
    key = "sum" if fam.get("type") == "histogram" else "value"
    return sum(row[key] for row in fam.get("series", [])
               if all(row["labels"].get(k) == v for k, v in labels.items()))


def plane_bytes() -> dict:
    """Process-wide bytes (and frames) sent on each plane so far: shm
    rings, bulk TCP, the RPC plane's data channel (and with the
    coordination channel, ``rpc_all``); coded delta frames and
    full-frame escapes."""
    from faabric_tpu_torch.telemetry import get_metrics

    snap = get_metrics().snapshot()
    return {"shm": _metric(snap, "faabric_bulk_tx_bytes_total", path="shm"),
            "tcp": _metric(snap, "faabric_bulk_tx_bytes_total", path="tcp"),
            "rpc": _metric(snap, "faabric_ptp_rpc_bytes_total",
                           channel="data"),
            "rpc_all": _metric(snap, "faabric_ptp_rpc_bytes_total"),
            "rpc_frames": _metric(snap, "faabric_ptp_rpc_frames_total",
                                  channel="data"),
            "delta_frames": _metric(snap, "faabric_codec_frames_total",
                                    codec="delta"),
            "escapes": _metric(snap, "faabric_codec_escapes_total")}


PLANES_HOSTS = {"mpi-host-a": 2, "mpi-host-b": 2}
# Phase 26's planner process's host timeout (s): phase 28 waits one out
# when it kills a worker process, and the workers' keep-alives every
# half of it must hold through phase 26's steps
PROCESS_HOST_TIMEOUT = 8.0


def _planes_job(cfg, per_rank: int, seq: int) -> dict:
    """Phase 22's (and 26's) model and batches: ``cfg`` from seed 22,
    each of the 4 ranks (per_rank, seq) tokens of a seeded corpus, SGD at
    lr 0.5."""
    from faabric_tpu_torch.models import Transformer

    corpus = np.random.RandomState(22).randint(
        0, cfg.vocab_size, (2, MPI_RANKS * per_rank, seq + 1)
    ).astype(np.int64)

    def batch(step, rank, device):
        b = torch.as_tensor(corpus[step % 2, rank * per_rank:
                                   (rank + 1) * per_rank], device=device)
        return b[:, :-1], b[:, 1:]

    return {"model": lambda device: Transformer(
                cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(22)),
            "batch": batch, "lr": 0.5, "params": {}, "grads": {},
            "sums": {}}


def planes_phase(dev, build, cfg=None, per_rank: int = 2, seq: int = 512,
                 base: int | None = None, keep: dict | None = None) -> dict:
    """Phase 22: the flagship's data-parallel step across two hosts on
    each of faabric's data planes. A planner and two WorkerRuntimes
    (``mpi-host-a``, ``mpi-host-b``, 2 slots each) gang-schedule 4 ranks,
    2 + 2, of :func:`register_planes_guests`' step at full width (bf16
    compute); each rank takes (per_rank, seq) tokens, and the fp32
    gradient crosses the hosts on the host ladder. Both hosts are
    aliases of this machine.

    22a, shm rings: one step on the flat ring; the bulk clients' ring
    frames grow and their rings are live, the RPC plane carries no
    data-channel message, the ranks' parameters are bitwise equal. 22c,
    the int8 leader ring (same cluster): every rank's world with
    ``hier_enabled="force"`` and ``allreduce_quant="int8"``, one step on
    the hier rung; the parameters agree bitwise; the same gradients'
    exact hier sum is within max|chunk| / 254 (plus fp32 rounding) of
    the quantised one chunk by chunk, the chunk being the sending
    leader's host-reduced one; the leaders' wire bytes are about 5/8 of
    the exact ring's. 22b, bulk TCP (a fresh cluster with
    ``SHM_BULK=0``): the same step from the same start, bitwise equal to
    22a's, its frames on the data stripes (more than one when
    ``BULK_STRIPES`` > 1) and on no ring; then 2 steps that each start
    with a broadcast of rank 0's parameters on the raw wire, and the same
    2 steps with the codec forced to delta (``FAABRIC_DELTA_CACHE_MB``
    raised to 1024, so one step's stream fits the caches): coded frames
    sent, deltas found their bases, parameters bitwise equal to the raw
    wire's. Every part's kernel launches are one rank's step's times 4
    times its steps, every flash forward on the ``wgmma`` body (on the
    card). Logs per plane the step and allreduce ms by rank, the bytes on
    rings, TCP and RPC, the device busy share and peak memory. Returns
    the parts' launches. ``keep``, when given, receives what phase 26
    compares with: the flat parameters the step starts from
    (``"start"``), those after 22a's and 22b's one step (``"shm"``,
    ``"tcp"``) and those steps' wall ms by rank (``"step_ms"``)."""
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.mpi import world as world_mod
    from faabric_tpu_torch.transport import bulk as bulk_mod
    from faabric_tpu_torch.transport.codec import (
        reset_wire_governor,
        set_wire_codec,
    )

    log("phase 22: the data-parallel step across two hosts on the shm, "
        "bulk TCP and wire-codec planes and the int8 leader ring")
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card:
        log("  22 card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cfg = cfg or ModelConfig()
    n = MPI_RANKS
    hosts = PLANES_HOSTS
    job = _planes_job(cfg, per_rank, seq)
    params, grads, sums = job["params"], job["grads"], job["sums"]
    if keep is not None:
        keep["start"] = flat_params(job["model"](dev))
        keep["step_ms"] = {}
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                "rms_norm": 4 * cfg.n_layers + 1}
    log(f"  22: BULK_STRIPES {bulk_mod.BULK_STRIPES}, a ring budget of "
        f"{int(os.environ.get('SHM_RING_BYTES', 32 << 20)):,} bytes a peer, "
        f"ring chunks of {world_mod.RING_CHUNK_BYTES:,} bytes")
    path: dict = {}
    factory = TorchExecutorFactory(device=dev.type)
    saved_env = {k: os.environ.get(k)
                 for k in ("SHM_BULK", "FAABRIC_DELTA_CACHE_MB")}

    def clients(workers):
        return [c for w in workers
                for c in w.ptp_broker._bulk_clients.values()]

    def run_part(label, client, steps, **updates):
        """One gang run of ``steps`` steps; checks its launches and logs
        its times and bytes. Returns (guest outputs, bytes moved)."""
        job.update(steps=steps, broadcast=False, exact=False, world={})
        job.update(updates)
        params.clear()
        if on_card:
            torch.cuda.synchronize()
        before, launches0 = plane_bytes(), dict(build.LAUNCHES)
        results, wall = run_gang(client, "planes_step", n)
        if on_card:
            torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in plane_bytes().items()}
        launches = {k: v - launches0.get(k, 0)
                    for k, v in build.LAUNCHES.items()
                    if v != launches0.get(k, 0)}
        outs = guest_outputs(results, f"22{label}")
        check(sorted(o["host"] for o in outs)
              == sorted(h for h, k in hosts.items() for _ in range(k)),
              f"22{label}: 4 ranks split 2 + 2 across the hosts")
        flat = [params[r] for r in range(n)]
        check(all(torch.equal(flat[0], f) for f in flat[1:]),
              f"22{label}: the ranks' parameters are bitwise equal after "
              f"{steps} step(s)")
        if on_card:
            for name, count in per_step.items():
                check(launches.get(name, 0) == count * n * steps,
                      f"22{label}: {name} launched {launches.get(name, 0)} "
                      f"times = {count} a step x {n} ranks x {steps} steps")
            check(launches.get("flash_attention.wgmma", 0)
                  == launches.get("flash_attention", -1),
                  f"22{label}: every flash forward took the wgmma body")
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        log(f"  22{label} step wall ms by rank: "
            + "; ".join(", ".join(f"{t:.1f}" for t in o["step_ms"])
                        for o in outs)
            + "; allreduce ms: "
            + "; ".join(", ".join(f"{t:.1f}" for t in o["allreduce_ms"])
                        for o in outs)
            + (("; broadcast ms: " + "; ".join(
                ", ".join(f"{t:.1f}" for t in o["bcast_ms"]) for o in outs))
               if job["broadcast"] else "")
            + f"; {wall:.1f} ms through the planner")
        log(f"  22{label} bytes sent: rings {moved['shm']:,.0f}, bulk TCP "
            f"{moved['tcp']:,.0f}, RPC data {moved['rpc']:,.0f} in "
            f"{moved['rpc_frames']:.0f} messages; launches {launches}")
        return outs, moved

    def profile(label, client, **updates):
        if not on_card:
            return
        job.update(steps=1, broadcast=False, exact=False, world={})
        job.update(updates)
        busy, _ = profile_top(lambda: run_gang(client, "planes_step", n),
                              f"22{label}: a step over two hosts", top=4)
        params.clear()
        log(f"  22{label} device busy {busy:.0f} us of the profiled step; "
            f"peak memory so far {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    register_planes_guests(job)
    os.environ["SHM_BULK"] = "1"
    planner_server, workers = start_cluster(hosts, factory, base)
    try:
        client = workers[0].planner_client
        # -- 22a. shm rings ------------------------------------------------
        outs, moved = run_part("a (shm rings)", client, 1)
        check(all(o["rungs"].get("allreduce") == "ring" for o in outs),
              "22a: the gradient allreduce took the flat ring")
        bulk = clients(workers)
        check(len(bulk) == 2 and all(c.shm_frames > 0 and c.rings()
                                     for c in bulk),
              f"22a: both hosts' bulk clients pushed frames into live rings "
              f"({[c.shm_frames for c in bulk]} ring frames, "
              f"{[len(c.rings()) for c in bulk]} rings)")
        check(moved["rpc_frames"] == 0 and moved["tcp"] == 0,
              f"22a: the RPC plane carried {moved['rpc_frames']:.0f} "
              f"data-channel messages and bulk TCP {moved['tcp']:.0f} bytes")
        params_a = params[0].clone()
        if keep is not None:
            keep["shm"] = params_a
            keep["step_ms"]["shm"] = {o["rank"]: o["step_ms"] for o in outs}
        log(f"  22a: a gradient of {params_a.numel():,} fp32 values a rank")
        profile("a (shm rings)", client)

        # -- 22c. the int8 leader ring -------------------------------------
        knobs = {"hier_enabled": "force", "allreduce_quant": "int8"}
        outs, moved = run_part("c (int8 leader ring)", client, 1,
                               world=knobs, exact=True)
        check(all(o["rungs"].get("allreduce") == "hier" for o in outs),
              "22c: every rank's allreduce took the hier rung")
        leaders = outs[0]["leaders"]
        on_host = {}
        for o in outs:
            on_host.setdefault(o["host"], []).append(o["rank"])
        host_of = {o["rank"]: o["host"] for o in outs}
        host_acc = [sum(grads[r] for r in on_host[host_of[ld]])
                    for ld in leaders]
        quant, exact = sums["quant"], sums["exact"]
        eps = float(np.finfo(np.float32).eps)
        ratios, over = [], []
        for s, ld in enumerate(leaders):
            lo = (s * quant.size) // len(leaders)
            hi = ((s + 1) * quant.size) // len(leaders)
            for clo, chi in world_mod.MpiWorld._ring_chunks(lo, hi, 4):
                peak = float(np.abs(host_acc[s][clo:chi]).max())
                err = float(np.abs(quant[clo:chi] - exact[clo:chi]).max())
                # The scale's half step, and fp32 rounding of the
                # quantise, decode and fold
                bound = peak / 254 + 4 * eps * (peak + float(
                    np.abs(exact[clo:chi]).max()))
                ratios.append(err / bound if bound else 0.0)
                if err > bound:
                    over.append((ld, clo, err, bound))
        check(not over, f"22c: the int8 sum is within max|chunk| / 254 of "
              f"the exact hier sum in all {len(ratios)} chunks (the worst "
              f"at {max(ratios):.6f} of its bound; max |err| "
              f"{float(np.abs(quant - exact).max()):.4g}; over: {over[:4]})")
        lead = [o for o in outs if o["rank"] in leaders]
        q_bytes = sum(o["wire_bytes"][0] for o in lead)
        x_bytes = sum(o["exact_wire_bytes"][0] for o in lead)
        ratio = q_bytes / x_bytes if x_bytes else float("nan")
        check(0.60 <= ratio <= 0.65,
              f"22c: the leaders put {q_bytes:,} bytes on the wire against "
              f"{x_bytes:,} for the exact ring ({ratio:.4f}, about 5/8)")
        log(f"  22c: exact hier allreduce ms "
            + ", ".join(f"{o['exact_ms'][0]:.1f}" for o in outs))
        grads.clear()
        sums.clear()
        profile("c (int8 leader ring)", client, world=knobs)
    finally:
        stop_cluster(planner_server, workers)

    # -- 22b. bulk TCP, then the delta codec --------------------------------
    os.environ["SHM_BULK"] = "0"
    register_planes_guests(job)
    planner_server, workers = start_cluster(hosts, factory, base)
    try:
        client = workers[0].planner_client
        outs, moved = run_part("b (bulk TCP)", client, 1)
        check(torch.equal(params[0], params_a),
              "22b: the parameters are bitwise equal to 22a's")
        if keep is not None:
            keep["tcp"] = params[0].clone()
            keep["step_ms"]["tcp"] = {o["rank"]: o["step_ms"] for o in outs}
        bulk = clients(workers)
        stripes = [c.stripe_frames() for c in bulk]
        data_used = [sum(1 for i, (tcp, _) in sf.items() if i and tcp)
                     for sf in stripes]
        check(all(u >= (2 if bulk_mod.BULK_STRIPES > 1 else 1)
                  for u in data_used),
              f"22b: the gradient's frames went out on {data_used} data "
              f"stripes a host (BULK_STRIPES {bulk_mod.BULK_STRIPES}; frames "
              f"by stripe {stripes})")
        check(moved["shm"] == 0 and not any(c.rings() or c.shm_frames
                                             for c in bulk),
              "22b: no ring was used")
        profile("b (bulk TCP)", client)
        run_part("b (raw, broadcast)", client, 2, broadcast=True)
        params_raw = params[0].clone()
        os.environ["FAABRIC_DELTA_CACHE_MB"] = "1024"
        set_wire_codec("delta")
        coded0 = sum(c.coded_frames for c in bulk)
        _, moved = run_part("b (delta codec)", client, 2, broadcast=True)
        bulk = clients(workers)
        coded = sum(c.coded_frames for c in bulk) - coded0
        check(coded > 0 and moved["delta_frames"] > 0,
              f"22b: {coded} coded frames sent, {moved['delta_frames']:.0f} "
              f"of them deltas against a cached base")
        check(torch.equal(params[0], params_raw),
              "22b: the parameters after 2 steps on the delta codec are "
              "bitwise equal to the same 2 steps on the raw wire")
        wire = sum(s.wire_bytes for c in bulk for s in c.stripes()
                   if s.coded_frames)
        raw = sum(s.raw_bytes for c in bulk for s in c.stripes()
                  if s.coded_frames)
        log(f"  22b delta codec: wire {wire:,} bytes for {raw:,} raw bytes "
            f"on the coded stripes ({wire / max(raw, 1):.4f}); "
            f"{sum(c.escape_frames for c in bulk)} full-frame escapes, "
            f"{moved['escapes']:.0f} escapes counted")
    finally:
        reset_wire_governor()
        stop_cluster(planner_server, workers)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if on_card:
        log(f"  22 peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB")
    log(f"  phase 22 launches: {path}")
    log(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return path


def register_telemetry_guests(job: dict) -> None:
    """Phase 23's guests. ``mpi/traced_step``: when ``job["plane"]``,
    activates the device plane on the guest's device; takes
    ``job["steps"]`` steps of :func:`ddp_step` of ``job["model"](device)``
    (each starting with a broadcast of rank 0's flat parameters when
    ``job["broadcast"]``); rank ``job["straggler"]`` sleeps
    ``job["straggle_s"]`` before the allreduce of step
    ``job["straggle_step"]``; after the first step each rank reads the
    perf store's ``bulk-tcp`` rate toward ``job["peer_of"][host]``, and
    with ``job["arm_after_first"]`` rank 0 installs that fault spec
    between two barriers (no frame is in flight while it arms); with
    ``job["keep_sums"]`` (a dict) ranks 0 and 3 keep each step's summed
    gradient there. With
    ``job["ring"]`` (a dict) each rank then passes its shard of the flat
    parameters one hop round the device plane's ring
    (``ring_permute``), leaving (shard, received) there. Each rank leaves
    its flat parameters in ``job["params"]`` and returns JSON: rank,
    host, world id, rungs, plane verdict, step ms, the link rate read.
    ``mpi/faulty``: a barrier, then an allreduce of 1,024 ones.
    ``smoke/echo``: returns its input."""
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.faults import install_faults
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.telemetry import get_perf_store

    @register_function("mpi", "traced_step")
    def traced_step(ctx):
        world = ctx.mpi_world()
        rank = ctx.message.mpi_rank
        dev = ctx.device
        plane = (world.activate_device_plane(rank, device=dev)
                 if job["plane"] else False)
        host = world.host_for_rank(rank)
        model = job["model"](dev)
        step_ms, link = [], None
        for s in range(job["steps"]):
            t0 = time.perf_counter()
            if job["broadcast"]:
                got = world.broadcast(0, rank, flat_params(model) if rank == 0
                                      else np.empty(0, np.float32))
                if rank != 0:
                    load_flat(model, torch.from_numpy(
                        np.array(got, np.float32, copy=True)).to(dev))

            def reduce(flat, s=s):
                if (s == job.get("straggle_step")
                        and rank == job.get("straggler")):
                    time.sleep(job["straggle_s"])
                out = world.allreduce(rank, flat, MpiOp.SUM)
                if job.get("keep_sums") is not None and rank in (0, 3):
                    job["keep_sums"][rank, s] = np.array(_as_np(out),
                                                         copy=True)
                return out

            tokens, targets = job["batch"](s, rank, dev)
            ddp_step(world, rank, model, tokens, targets, job["lr"],
                     reduce=reduce)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if s == 0 and job.get("peer_of"):
                link = get_perf_store().link_gibs(job["peer_of"][host],
                                                  plane="bulk-tcp")
            if s == 0 and job.get("arm_after_first"):
                world.barrier(rank)
                if rank == 0:
                    install_faults(job["arm_after_first"])
                world.barrier(rank)
        flat = flat_params(model)
        if job.get("ring") is not None:
            k = flat.numel() // world.size
            shard = flat[rank * k:(rank + 1) * k].contiguous()
            job["ring"][rank] = (shard, world.device_plane().ring_permute(
                rank, shard, 1))
        job["params"][rank] = flat
        world.barrier(rank)
        rungs = {kind: algo for (r, kind), algo in world.rungs.items()
                 if r == rank}
        return json.dumps({"rank": rank, "host": host, "world": world.id,
                           "rungs": rungs, "plane": plane,
                           "step_ms": step_ms, "link_gibs": link}).encode()

    @register_function("mpi", "faulty")
    def faulty(ctx):
        world = ctx.mpi_world()
        rank = ctx.message.mpi_rank
        world.barrier(rank)
        out = world.allreduce(rank, torch.ones(1024, device=ctx.device),
                              MpiOp.SUM)
        return json.dumps({"rank": rank,
                           "sum": float(_as_np(out).sum())}).encode()

    @register_function("smoke", "echo")
    def echo(ctx):
        return ctx.message.input_data


def _telemetry_job(cfg, per_rank: int = 2, seq: int = 512) -> dict:
    """Phase 23's model and batches: ``cfg`` from seed 23, each rank
    (per_rank, seq) tokens of a seeded corpus, SGD at lr 0.5."""
    from faabric_tpu_torch.models import Transformer

    corpus = np.random.RandomState(23).randint(
        0, cfg.vocab_size, (3, MPI_RANKS * per_rank, seq + 1)
    ).astype(np.int64)

    def batch(step, rank, device):
        b = torch.as_tensor(corpus[step % 3, rank * per_rank:
                                   (rank + 1) * per_rank], device=device)
        return b[:, :-1], b[:, 1:]

    return {"model": lambda device: Transformer(
                cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(23)),
            "batch": batch, "lr": 0.5, "params": {}, "plane": False,
            "steps": 1, "broadcast": False, "ring": None, "peer_of": None,
            "arm_after_first": None, "keep_sums": None}


TELEMETRY_HOSTS = {"tel-host-a": 2, "tel-host-b": 2}


def telemetry_steps(base: int) -> dict:
    """23b's three steps again, without the straggler, in a process whose
    telemetry the environment set (run as ``chip_smoke.py
    --telemetry-steps <base>`` by phase 23), on a cluster of its own at
    port offset ``base``. It first takes one untimed step on such a
    cluster and stops it, so that the process is warm (the CUDA context,
    the libraries' first calls, the allocator); then it prints a ``warm``
    line and waits for a line on its standard input, so that its start
    and warm-up overlap the other children's while the timed steps run
    one child at a time. Returns which planes were on and each rank's
    step ms."""
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.ops import _build
    from faabric_tpu_torch.telemetry import metrics_enabled, tracing_enabled
    from faabric_tpu_torch.telemetry.profiler import profile_enabled

    _build.kernels()
    job = _telemetry_job(ModelConfig())

    def gang(steps: int, what: str) -> list:
        job.update(steps=steps)
        register_telemetry_guests(job)
        planner_server, workers = start_cluster(
            TELEMETRY_HOSTS, TorchExecutorFactory(), base)
        try:
            return guest_outputs(run_gang(workers[0].planner_client,
                                          "traced_step", MPI_RANKS)[0], what)
        finally:
            stop_cluster(planner_server, workers)

    gang(1, "23d: the warm-up step")
    print(json.dumps({"warm": True}), flush=True)
    sys.stdin.readline()
    outs = gang(3, "23d: three steps")
    return {"metrics": metrics_enabled(), "tracing": tracing_enabled(),
            "profiler": profile_enabled(),
            "steps": {str(o["rank"]): o["step_ms"] for o in outs}}


def telemetry_phase(dev, build, cfg=None, seq: int = 512,
                    base: int | None = None, straggle_s: float = 1.0,
                    child: bool = True) -> dict:
    """Phase 23: faabric's telemetry and fault points on the flagship's
    data-parallel step, tracing on (``FAABRIC_TRACING=1`` in the
    environment and ``set_tracing``). 23a: one host, 4 ranks on the
    device plane, one step and one ``ring_permute`` round of each rank's
    parameter shard: one ``compile`` span per new key and one
    ``execute`` span per round, the comm matrix's ``device`` cells equal
    to the deposited bytes, one ``execute`` record per round in the
    collective profiler, and the perf store's ``("mesh", "device")``
    rate at most 105% of the card's HBM peak (the execute phase is timed
    by CUDA events and ends when the card has). 23b: two loopback hosts,
    2 + 2, bulk TCP (``SHM_BULK=0``), 3 steps: the comm matrix's bytes a
    plane equal the counters' (``plane_bytes``), the cross-host link is
    measured after step 1, the Chrome trace (``build/telemetry_23b.json``,
    parsed back) holds 3 ``mpi``/``allreduce`` spans a rank with their
    ``mpi.phase`` children inside, and a planted straggler (rank 3 sleeps
    ``straggle_s`` before step 3's allreduce) is the one rank
    ``find_stragglers`` flags; ``critical_path`` of that round names the
    rank bound by the wait, not the straggler, whose own total is the
    round's shortest.
    23c, faults armed through ``install_faults`` on 23b's cluster:
    ``mpi.collective=raise@after=2`` fails a 2-rank gang's guests with
    the fault's text and the next gang after ``clear_faults`` succeeds;
    ``executor.run=raise@times=1`` fails exactly one of 4 messages;
    ``transport.bulk=drop@codec=delta@times=1``, armed between two
    broadcast steps on the forced delta codec, corrupts the second
    step's first delta frame, which heals through the NACK: the ranks'
    parameters and summed gradients are bitwise equal to the same steps
    on the raw wire. 23d: 23b's three steps again (no straggler), each
    in a child process after an untimed warm-up step there (the four
    children warm up together): telemetry off (``FAABRIC_METRICS=0``),
    metrics without the stack profiler (``FAABRIC_PROFILE=0``), metrics
    with it, and all of it with tracing; their step times are printed
    side by side, a plain measurement (``child=False`` leaves 23d out:
    the children need the card). ``straggle_s`` is the planted sleep; ranks whose idle gap exceeds the round's median by
    less than half of it are not stragglers. The finder also wants the
    sleep above 0.15 of the round's median total, which on a slower card
    host (an allreduce of 1.4 s) 300 ms was not: 1 s stands above both.
    Returns the phase's kernel launches."""
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.faults import clear_faults, install_faults
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.telemetry import (
        chrome_trace_json,
        get_collective_profiler,
        get_comm_matrix,
        get_metrics,
        get_perf_store,
        reset_tracing,
        set_tracing,
    )
    from faabric_tpu_torch.telemetry.perfprofile import (
        critical_path,
        find_stragglers,
    )
    from faabric_tpu_torch.transport.codec import (
        reset_wire_governor,
        set_wire_codec,
    )

    log("phase 23: telemetry and fault points on the data-parallel step")
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    cfg = cfg or ModelConfig()
    n = MPI_RANKS
    job = _telemetry_job(cfg, seq=seq)
    params = job["params"]
    factory = TorchExecutorFactory(device=dev.type)
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                "rms_norm": 4 * cfg.n_layers + 1}
    matrix, store, prof = (get_comm_matrix(), get_perf_store(),
                           get_collective_profiler())
    saved_env = {k: os.environ.get(k) for k in (
        "FAABRIC_TRACING", "SHM_BULK", "FAABRIC_DELTA_CACHE_MB")}
    os.environ["FAABRIC_TRACING"] = "1"
    set_tracing(True)
    path: dict = {}

    def gang(client, label, function="traced_step", size=n, **updates):
        """One gang run; returns (outputs, launches, wall ms)."""
        job.update(updates)
        params.clear()
        if on_card:
            torch.cuda.synchronize()
        launches0 = dict(build.LAUNCHES)
        results, wall = run_gang(client, function, size)
        if on_card:
            torch.cuda.synchronize()
        launches = {k: v - launches0.get(k, 0)
                    for k, v in build.LAUNCHES.items()
                    if v != launches0.get(k, 0)}
        return guest_outputs(results, label), launches, wall

    def count_launches(label, launches, steps, extra=None):
        want = {k: c * n * steps for k, c in per_step.items()}
        want.update(extra or {})
        if on_card:
            for name, count in want.items():
                check(launches.get(name, 0) == count,
                      f"{label}: {name} launched {launches.get(name, 0)} "
                      f"times = {count}")
            check(launches.get("flash_attention.wgmma", 0)
                  == launches.get("flash_attention", -1),
                  f"{label}: every flash forward took the wgmma body")
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v

    try:
        # -- 23a. one host, the device plane -------------------------------
        register_telemetry_guests(job)
        planner_server, workers = start_cluster({"tel-host": n}, factory,
                                                base)
        try:
            matrix.reset()
            store.reset()
            reset_tracing()
            ring: dict = {}
            outs, launches, wall = gang(
                workers[0].planner_client, "23a step on the device plane",
                plane=True, steps=1, ring=ring)
            check(all(o["plane"] and o["rungs"].get("allreduce") == "device"
                      for o in outs),
                  "23a: every rank activated the device plane and allreduced "
                  "its gradient on it")
            flat = [params[r] for r in range(n)]
            check(all(torch.equal(flat[0], f) for f in flat[1:]),
                  "23a: the ranks' parameters are bitwise equal")
            check(all(torch.equal(ring[r][1], ring[(r - 1) % n][0])
                      for r in range(n)),
                  "23a: ring_permute handed each rank its predecessor's "
                  "shard, bitwise")
            count_launches("23a", launches, 1, {"ring_permute": 1})
            world_id = outs[0]["world"]
            spans = [e for e in json.loads(chrome_trace_json())["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "mpi.phase"
                     and e["args"].get("world") == world_id]
            by = {}
            for e in spans:
                key = (e["name"], e["args"]["kind"])
                by[key] = by.get(key, 0) + 1
            check(by == {("compile", "allreduce"): 1,
                         ("execute", "allreduce"): 1,
                         ("compile", "ring_permute"): 1,
                         ("execute", "ring_permute"): 1},
                  f"23a: one compile span a new key and one execute span "
                  f"a round ({by})")
            grad_bytes = flat[0].numel() * 4
            deposited = n * grad_bytes + n * (grad_bytes // n)
            cells = (matrix.snapshot() or {}).get("cells", [])
            device_bytes = sum(c["bytes"] for c in cells
                               if c["plane"] == "device")
            check(device_bytes == deposited and all(
                c["plane"] == "device" for c in cells),
                  f"23a: the comm matrix's device cells hold "
                  f"{device_bytes:,} bytes = the {deposited:,} deposited, "
                  f"and no other plane has a cell")
            series = {s["collective"]: s for s in prof.snapshot()
                      if s["world"] == world_id}
            executes = {k: sum("execute" in p for rd in s["rounds"].values()
                               for p in rd.values())
                        for k, s in series.items()}
            check(executes == {"allreduce": 1, "ring_permute": 1},
                  f"23a: the profiler holds one execute record a round "
                  f"({executes})")
            gibs = store.link_gibs("mesh", plane="device")
            rate = (gibs or 0.0) * (1 << 30)
            check(gibs is not None and rate <= 1.05 * HBM_BYTES_PER_S,
                  f"23a: the device plane's measured rate "
                  f"{rate / 1e12:.4f} TB/s is within 105% of the card's "
                  f"HBM peak ({HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
            log(f"  23a step wall ms by rank: "
                + ", ".join(f"{o['step_ms'][0]:.1f}" for o in outs)
                + f"; {wall:.1f} ms through the planner; execute phases "
                + ", ".join(f"{k} {p['execute'] * 1e3:.3f} ms"
                            for k, s in series.items()
                            for rd in s["rounds"].values()
                            for p in rd.values() if "execute" in p))
        finally:
            stop_cluster(planner_server, workers)

        # -- 23b. two hosts on bulk TCP, 3 steps ---------------------------
        os.environ["SHM_BULK"] = "0"
        register_telemetry_guests(job)
        planner_server, workers = start_cluster(TELEMETRY_HOSTS, factory,
                                                base)
        try:
            client = workers[0].planner_client
            matrix.reset()
            store.reset()
            prof.reset()
            reset_tracing()
            before = plane_bytes()
            outs, launches, wall = gang(
                client, "23b three steps over two hosts", plane=False,
                steps=3, ring=None, straggler=3, straggle_step=2,
                straggle_s=straggle_s,
                peer_of={"tel-host-a": "tel-host-b",
                         "tel-host-b": "tel-host-a"})
            moved = {k: v - before[k] for k, v in plane_bytes().items()}
            count_launches("23b", launches, 3)
            check(sorted(o["host"] for o in outs)
                  == ["tel-host-a"] * 2 + ["tel-host-b"] * 2,
                  "23b: 4 ranks split 2 + 2 across the hosts")
            flat = [params[r] for r in range(n)]
            check(all(torch.equal(flat[0], f) for f in flat[1:]),
                  "23b: the ranks' parameters are bitwise equal")
            on_steps = {o["rank"]: o["step_ms"] for o in outs}
            cells = (matrix.snapshot() or {}).get("cells", [])
            by_plane = {}
            for c in cells:
                by_plane[c["plane"]] = by_plane.get(c["plane"], 0) + c["bytes"]
            want = {"bulk-tcp": moved["tcp"], "shm": moved["shm"],
                    "ptp": moved["rpc_all"]}
            check(all(by_plane.get(k, 0) == v for k, v in want.items())
                  and set(by_plane) <= set(want) and moved["tcp"] > 0,
                  f"23b: the comm matrix's bytes a plane {by_plane} equal "
                  f"the counters' {want}")
            links = [o["link_gibs"] for o in outs]
            check(all(g is not None and g > 0 for g in links),
                  f"23b: the cross-host bulk-tcp link is measured after step "
                  f"1 (GiB/s read by each rank: {links})")
            trace_path = os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "build", "telemetry_23b.json")
            os.makedirs(os.path.dirname(trace_path), exist_ok=True)
            with open(trace_path, "w") as f:
                f.write(chrome_trace_json())
            with open(trace_path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
            world_ids = {o["world"] for o in outs}
            ars = [e for e in events if e["cat"] == "mpi"
                   and e["name"] == "allreduce"]
            kids: dict = {}
            for e in events:
                parent = e.get("args", {}).get("parent_span_id")
                if e["cat"] == "mpi.phase" and parent is not None:
                    kids.setdefault(parent, []).append(e)
            per_rank = {}
            nested = True
            for e in ars:
                r = e["args"]["rank"]
                per_rank[r] = per_rank.get(r, 0) + 1
                children = kids.get(e["args"]["span_id"], [])
                nested &= bool(children) and all(
                    c["ts"] >= e["ts"] - 1
                    and c["ts"] + c["dur"] <= e["ts"] + e["dur"] + 1
                    for c in children)
            check(per_rank == {r: 3 for r in range(n)} and nested,
                  f"23b: the Chrome trace ({len(events):,} spans, "
                  f"{os.path.getsize(trace_path):,} bytes, parsed back) "
                  f"holds {per_rank} mpi/allreduce spans by rank, each with "
                  f"its mpi.phase children inside it")
            series = [s for s in prof.snapshot()
                      if s["world"] in world_ids
                      and s["collective"] == "allreduce"]
            check(len(series) == 1, "23b: one allreduce series")
            rounds = series[0]["rounds"]
            flagged = find_stragglers(rounds, factor=0.15, min_rounds=1,
                                      min_skew_s=straggle_s / 2)
            check(sorted(flagged) == [3],
                  f"23b: find_stragglers flags rank 3 alone ({flagged})")
            late = rounds["2"]
            cp = critical_path({2: late})
            totals = {int(r): p["total"] for r, p in late.items()}
            totals_ms = {r: round(t * 1e3, 1) for r, t in totals.items()}
            check(cp["dominant_rank"] != 3
                  and min(totals, key=totals.get) == 3
                  and totals[cp["dominant_rank"]] - totals[3]
                  >= 2 * straggle_s / 3,
                  f"23b: critical_path of the straggler's round names rank "
                  f"{cp['dominant_rank']}, bound by the wait "
                  f"(totals ms {totals_ms}); "
                  f"rank 3's own total is the shortest")
            log(f"  23b step wall ms by rank (telemetry on, tracing on; "
                f"step 3 holds the planted {straggle_s * 1e3:.0f} ms): "
                + "; ".join(f"{r}: " + ", ".join(f"{t:.1f}" for t in ms)
                            for r, ms in sorted(on_steps.items()))
                + f"; {wall:.1f} ms through the planner; bytes: bulk TCP "
                f"{moved['tcp']:,.0f}, RPC {moved['rpc_all']:,.0f}")

            # -- 23c. faults armed through install_faults -----------------
            install_faults("mpi.collective=raise@after=2")
            try:
                results, _ = run_gang(client, "faulty", 2)
            finally:
                clear_faults()
            texts = [bytes(m.output_data).decode(errors="replace")
                     for m in results]
            check(len(results) == 2 and all(
                m.return_value != 0 and "mpi.collective: injected fault" in t
                for m, t in zip(results, texts)),
                f"23c: mpi.collective=raise@after=2 failed both guests of the "
                f"gang with the fault's text ({texts})")
            outs = guest_outputs(run_gang(client, "faulty", 2)[0],
                                 "23c after clear_faults")
            check(all(o["sum"] == 2048.0 for o in outs),
                  "23c: after clear_faults the same gang succeeds")
            install_faults("executor.run=raise@times=1")
            try:
                results, _ = run_batch(client, "echo", 4, b"x")
            finally:
                clear_faults()
            failed = [m for m in results if m.return_value != 0]
            check(len(failed) == 1 and b"executor.run: injected fault"
                  in bytes(failed[0].output_data)
                  and all(bytes(m.output_data) == b"x" for m in results
                          if m.return_value == 0),
                  f"23c: executor.run=raise@times=1 failed exactly one of 4 "
                  f"messages ({len(failed)} failed)")
            # A dropped delta frame on the forced delta codec. The rule is
            # armed after step 1, between barriers, and step 2 repeats step
            # 1 (lr 0, the same batch): its broadcast's first chunk, the
            # first coded frame after arming, is a delta against step 1's
            # (a ``codec=delta`` matcher also matches ``delta-full``, and
            # a dropped full frame corrupts nothing). The stream's bases
            # must fit the caches (as in 22b)
            os.environ["FAABRIC_DELTA_CACHE_MB"] = "1024"
            first = job["batch"]

            def same_batch(step, rank, device):
                return first(0, rank, device)

            snap0 = get_metrics().snapshot()
            set_wire_codec("delta")
            coded_sums: dict = {}
            try:
                _, launches_coded, _ = gang(
                    client, "23c delta steps with a dropped frame", steps=2,
                    broadcast=True, lr=0.0, batch=same_batch,
                    straggler=None, peer_of=None, keep_sums=coded_sums,
                    arm_after_first="transport.bulk=drop@codec=delta"
                                    "@times=1")
            finally:
                clear_faults()
            count_launches("23c delta", launches_coded, 2)
            flat = [params[r] for r in range(n)]
            check(all(torch.equal(flat[0], f) for f in flat[1:]),
                  "23c: every rank loaded rank 0's parameters bitwise "
                  "through the healed broadcast")
            snap = get_metrics().snapshot()

            def grew(name, **labels):
                return (_metric(snap, name, **labels)
                        - _metric(snap0, name, **labels))

            drops = grew("faabric_faults_fired_total",
                         point="transport.bulk", action="drop")
            nacks = grew("faabric_codec_escapes_total", reason="nack")
            set_wire_codec("raw")
            raw_sums: dict = {}
            _, launches_raw, _ = gang(
                client, "23c the same steps raw", steps=2, broadcast=True,
                lr=0.0, batch=same_batch, keep_sums=raw_sums,
                arm_after_first=None)
            count_launches("23c raw", launches_raw, 2)
            check(drops == 1 and nacks >= 1
                  and sorted(coded_sums) == sorted(raw_sums)
                  and all(np.array_equal(coded_sums[k], raw_sums[k])
                          for k in raw_sums),
                  f"23c: transport.bulk=drop fired {drops:.0f} time(s) on a "
                  f"delta frame, {nacks:.0f} NACK heal(s); the coded steps' "
                  f"summed gradients are bitwise equal to the raw wire's "
                  f"({len(raw_sums)} sums)")
        finally:
            reset_wire_governor()
            stop_cluster(planner_server, workers)
    finally:
        set_tracing(False)
        reset_tracing()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # -- 23d. the same three steps with telemetry on and off, each in a
    # child process (the knobs are read at import) ------------------------
    if not child:
        log(f"  phase 23 launches: {path}")
        return path
    # The four children start and warm up together, each on a cluster of
    # its own 3000 ports from the others', and each runs its timed steps
    # alone once all are warm: their start-ups overlap, their steps do not
    bases = [10000 + 3000 * i for i in range(4)]
    for b in bases:
        wait_ports_free(b, label="23d")
        for off in (1000, 2000):
            wait_ports_free(b + off, label="23d", ports=worker_ports())
    env = {k: None for k in os.environ if k.startswith("FAABRIC_")}
    env["SHM_BULK"] = "0"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase23d-", dir=os.path.join(here,
                                                                 "build"))
    children = []
    try:
        for i, (label, knobs, want) in enumerate((
                ("off", {"FAABRIC_METRICS": "0"}, (False, False, False)),
                ("metrics", {"FAABRIC_PROFILE": "0"}, (True, False, False)),
                ("metrics, profiler", {}, (True, False, True)),
                ("metrics, profiler, tracing", {"FAABRIC_TRACING": "1"},
                 (True, True, True)))):
            children.append((label, knobs, want, JsonChild(
                [sys.executable, os.path.abspath(__file__),
                 "--telemetry-steps", str(bases[i])], {**env, **knobs},
                os.path.join(work, f"child-{i}.log"),
                f"23d {label}: the child")))
        for _, _, _, c in children:
            c.expect("warm", 600)
        for label, knobs, want, c in children:
            c.send("go")
            got = c.expect("steps", 600)
            check(c.proc.wait(60) == 0, f"23d {label}: the child exited "
                  f"{c.proc.returncode}")
            check((got["metrics"], got["tracing"], got["profiler"]) == want,
                  f"23d {label}: metrics, tracing, profiler "
                  f"{got['metrics'], got['tracing'], got['profiler']}")
            log(f"  23d step wall ms by rank, {label} ({knobs or 'defaults'}; "
                f"a child process): "
                + "; ".join(f"{r}: " + ", ".join(f"{t:.1f}" for t in ms)
                            for r, ms in sorted(got["steps"].items()))
                + f" [{smi}]")
    finally:
        for _, _, _, c in children:
            c.kill()
        shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 23 launches: {path}")
    log(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return path


def register_restart_guests(job: dict) -> None:
    """Phase 25's torch guest. ``rst/serve`` scores its prompt and
    generates ``job["n_new"]`` greedy tokens with ``job["model"]``; the
    first ``job["hold"]`` requests to reach each host first record their
    id and host in ``job["held"]`` (and call ``job["on_hold"](id, host)``
    where the job has one) and block until ``job["release"]`` is set."""
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.models import forward, generate

    @register_function("rst", "serve")
    def serve(ctx):
        host = ctx.executor.scheduler.host
        with job["lock"]:
            hold = sum(h == host for h in job["held"].values()) < job["hold"]
            if hold:
                job["held"][ctx.message.id] = host
                if len(job["held"]) == 2 * job["hold"]:
                    job["all_held"].set()
        if hold and job.get("on_hold") is not None:
            job["on_hold"](ctx.message.id, host)
        if hold and not job["release"].wait(300):
            raise RuntimeError("a held request was never released")
        model = job["model"]
        prompt = torch.frombuffer(bytearray(ctx.message.input_data),
                                  dtype=torch.int32).to(ctx.device)[None]
        with torch.inference_mode():
            scores = forward(model, prompt)[0].argmax(-1).to(torch.int32)
            tokens = generate(model, prompt, job["n_new"])[0]
        return torch.cat([scores, tokens]).cpu().numpy().tobytes()


def planner_child(argv: list[str]) -> int:
    """``chip_smoke.py --planner-child <base> <host>=<offset> ...``: phase
    25's planner, a process of its own. It serves a port planner at port
    offset ``base``, reaching the named worker hosts at their offsets,
    under the journal and timeout knobs of its environment; it prints one
    JSON line once it serves (its boot id and journal replay stats), one
    when the reconcile after a replay has run, one with its
    ``health_summary()`` for each ``health`` line on its standard input,
    and one when that input closes, on which it stops the server
    (draining and closing the journal) and exits."""
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.transport import register_host_alias

    base = int(argv[0])
    for spec in argv[1:]:
        host, offset = spec.split("=")
        register_host_alias(host, "127.0.0.1", int(offset))
    planner = get_planner()
    server = PlannerServer(port_offset=base)
    server.start()
    out_lock = threading.Lock()

    def emit(doc: dict) -> None:
        with out_lock:
            sys.stdout.write(json.dumps(doc) + "\n")
            sys.stdout.flush()

    emit({"ready": True, "boot": planner.boot_id,
          "journal": planner._journal.enabled,
          "replay": planner._journal_replay_stats})
    closed = threading.Event()

    def read_stdin() -> None:
        for line in sys.stdin:
            if line.strip() == "health":
                emit({"health": planner.health_summary()})
        closed.set()

    threading.Thread(target=read_stdin, name="planner-child/stdin",
                     daemon=True).start()
    reported = False
    while not closed.wait(0.05):
        if not reported and planner._reconcile_stats is not None:
            emit({"reconcile": planner._reconcile_stats})
            reported = True
    server.stop()
    emit({"stopped": True})
    return 0


class JsonChild:
    """A child process of this script: ``argv`` started with ``env``
    added to this process's environment (a None value removes the
    variable), in this script's directory, its standard error in
    ``log_path`` and its JSON lines on standard output read by a thread.
    ``label`` names it in failed checks."""

    def __init__(self, argv: list[str], env: dict, log_path: str,
                 label: str):
        import queue

        self.label = label
        self.log_path = log_path
        self.lines: queue.Queue = queue.Queue()
        self._log = open(log_path, "ab")
        full_env = {k: v for k, v in os.environ.items()
                    if k not in env or env[k] is not None}
        full_env.update({k: v for k, v in env.items() if v is not None})
        self.t_spawn = time.perf_counter()
        self.proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._log, env=full_env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        threading.Thread(target=self._read, name=f"{label}/out",
                         daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                self.lines.put(json.loads(line))
            except ValueError:
                continue
        self.lines.put(None)

    def expect(self, key: str, timeout: float) -> dict:
        """The next JSON line that holds ``key``; fails after ``timeout``
        seconds or when the child's output ends first."""
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                got = self.lines.get(timeout=max(0.0, deadline
                                                 - time.monotonic()))
            except queue.Empty:
                got = None
            if got is None:
                with open(self.log_path, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
                check(False, f"{self.label} printed no {key!r} line "
                      f"(exit code {self.proc.poll()}; its log ends: {tail})")
            if key in got:
                return got

    def send(self, line: str) -> None:
        self.proc.stdin.write(line.encode() + b"\n")
        self.proc.stdin.flush()

    def stop(self) -> dict:
        """Close its standard input and wait for a clean exit; returns
        its ``stopped`` line."""
        self.proc.stdin.close()
        line = self.expect("stopped", 60)
        check(self.proc.wait(60) == 0, f"{self.label} exited 0")
        return line

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        self._log.close()


class PlannerChild(JsonChild):
    """A ``--planner-child`` process (phase 25), ready once it serves."""

    def __init__(self, base: int, hosts: dict, env: dict, log_path: str):
        super().__init__(
            [sys.executable, os.path.abspath(__file__), "--planner-child",
             str(base), *(f"{h}={o}" for h, o in hosts.items())],
            env, log_path, "25: the planner child")
        self.ready = self.expect("ready", 180)
        self.ready_s = time.perf_counter() - self.t_spawn


def worker_ports() -> tuple:
    """The service ports a worker host binds: all but the planner's."""
    from faabric_tpu_torch.transport.bulk import BULK_PORT
    from faabric_tpu_torch.transport.common import (
        POINT_TO_POINT_SYNC_PORT,
        STATE_ASYNC_PORT,
    )

    return (*range(STATE_ASYNC_PORT, POINT_TO_POINT_SYNC_PORT + 1),
            BULK_PORT)


def wait_ports_free(base: int, timeout: float = 30.0, label: str = "25",
                    ports=None) -> None:
    """Wait until ``ports`` (by default the planner's and its snapshot
    server's) at offset ``base`` bind again, as the servers bind them."""
    import socket

    from faabric_tpu_torch.transport.common import (
        PLANNER_ASYNC_PORT,
        PLANNER_SYNC_PORT,
        SNAPSHOT_ASYNC_PORT,
        SNAPSHOT_SYNC_PORT,
    )

    deadline = time.monotonic() + timeout
    for port in ports or (PLANNER_ASYNC_PORT, PLANNER_SYNC_PORT,
                          SNAPSHOT_ASYNC_PORT, SNAPSHOT_SYNC_PORT):
        while True:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("0.0.0.0", base + port))
                break
            except OSError:
                check(time.monotonic() < deadline,
                      f"{label}: port {base + port} is free again")
                time.sleep(0.05)
            finally:
                s.close()


def restart_phase(dev, build, cfg=None, serve_len: int = 512,
                  n_new: int = 32, base: int | None = None,
                  host_timeout: float = 3.0, grace: float = 5.0) -> dict:
    """Phase 25: a serving batch that outlives a SIGKILLed planner, at
    the flagship's full width (``ModelConfig()`` with its depth cut to 2
    layers, which keeps the script inside its time limit; bf16 compute,
    seeded weights). The planner is a child process of this script
    (``--planner-child``) with its write-ahead journal under ``build/``,
    a ``host_timeout`` s host timeout and a ``grace`` s reconcile grace;
    two WorkerRuntimes of 4 slots run here on loopback aliases. Their
    planner clients' breakers reset after 1 s instead of 5 s, as the
    grace is 5 s instead of the default 30 s: a breaker still open at
    the grace's end would let the reconcile requeue live hosts' rows.

    (a) 8 requests of phase 13 (``serve_len``-token prompts, ``n_new``
    greedy tokens); the first 2 to reach each host block in the guest
    until the phase releases them, and one waiter thread blocks in
    ``get_message_result`` for each request. Once the planner has
    recorded the 4 free results, it is SIGKILLed; the held guests are
    released and their results, which cannot reach the planner, wait on
    their workers (buffered, or in the recent window when a write went
    into the dead connection); the planner restarts on the same port
    offset and journal. Checked: every waiter returns; all 8 results
    SUCCESS with the tokens of direct ``forward`` and ``generate``; the
    results recorded before the kill kept; the replay finds 1 in-flight
    app; both workers register again and the reconcile requeues
    nothing; the held results arrive through ``FLUSH_RESULTS`` (each
    worker's pending queue drained, a ``results_flushed`` flight record
    each host); the launches are one batch's, so no request ran twice.
    The port's ``journaldump --verify`` of the journal exits 0. (b) The
    same batch with no crash, with the journal on and then off: the two
    walls, with nothing checked about speed. (c) After (b)'s journal-on
    batch, on the same planner child: the 8 requests as 8 apps through
    one ``submit_functions_many`` call (SUBMIT_BATCH; ``call_functions``
    is made to fail meanwhile), each result awaited. Checked: the tokens
    of direct ``forward`` and ``generate``; by the child's
    ``health_summary()["ingress"]``, 8 messages admitted through a tick,
    none shed and none on the immediate path; the 8 apps' ``app_update``
    records inside ``group`` records of the journal and nowhere else;
    the launches one batch's. Returns the phase's kernel launches."""
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        forward,
        generate,
    )
    from faabric_tpu_torch.planner.journal import (
        JOURNAL_FILE,
        SNAPSHOT_FILE,
        load_journal_dir,
    )
    from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
    from faabric_tpu_torch.telemetry import get_flight, get_metrics

    log("phase 25: a serving batch that outlives a SIGKILLed planner")
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card:
        log("  25 card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    cfg = cfg or dataclasses.replace(ModelConfig(), n_layers=2)
    L, n_req = cfg.n_layers, 8
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    prompts = np.random.RandomState(25).randint(
        0, cfg.vocab_size, (n_req, serve_len)).astype(np.int32)
    direct = []
    with torch.inference_mode():
        for p in prompts:
            prompt = torch.as_tensor(p, device=dev)[None]
            scores = forward(model, prompt)[0].argmax(-1)
            tokens = generate(model, prompt, n_new)[0]
            direct.append(torch.cat([scores.to(torch.int32),
                                     tokens]).cpu().numpy())
    job = {"model": model, "n_new": n_new, "lock": threading.Lock(),
           "held": {}, "hold": 2, "all_held": threading.Event(),
           "release": threading.Event()}
    register_restart_guests(job)
    want = {"flash_attention": n_req * L,
            "rms_norm": n_req * (2 * L + 1) * (1 + n_new)}
    launches: dict = {}

    def counted(fn):
        if on_card:
            torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        got = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
               if v != before.get(k, 0)}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return out, got

    def metric(name):
        fam = get_metrics().snapshot().get(name, {})
        return sum(r["value"] for r in fam.get("series", []))

    def new_request():
        req = batch_exec_factory("rst", "serve", n_req)
        for m, p in zip(req.messages, prompts):
            m.input_data = p.tobytes()
        return req

    def check_outputs(results, what):
        check(all(r.return_value == int(ReturnValue.SUCCESS)
                  and np.array_equal(np.frombuffer(r.output_data, np.int32),
                                     d)
                  for r, d in zip(results, direct)),
              f"{what}: all 8 results SUCCESS, tokens equal to direct "
              "forward and generate")

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase25-", dir=os.path.join(here,
                                                                "build"))
    journal_dir = os.path.join(work, "journal")
    base = random_port_base() if base is None else base
    hosts = {"rst-host-a": 4, "rst-host-b": 4}
    offsets = {h: base + 1000 * (i + 1) for i, h in enumerate(hosts)}
    knobs = {"FAABRIC_PLANNER_JOURNAL_DIR": journal_dir,
             "PLANNER_HOST_TIMEOUT": str(host_timeout),
             "FAABRIC_PLANNER_RECONCILE_GRACE": str(grace)}
    children: list = []

    def child(**env):
        c = PlannerChild(base, offsets, {**knobs, **env},
                         os.path.join(work, f"planner-{len(children)}.log"))
        children.append(c)
        return c

    def rejoined(workers, planner, timeout=60.0):
        """Each host's seconds from ``planner``'s spawn to its client
        seeing the planner's boot id."""
        boot = planner.ready["boot"]
        times = {}
        deadline = time.monotonic() + timeout
        while len(times) < len(workers) and time.monotonic() < deadline:
            for w in workers:
                if w.host not in times and w.planner_client._planner_boot \
                        == boot:
                    times[w.host] = time.perf_counter() - planner.t_spawn
            time.sleep(0.01)
        check(len(times) == len(workers), f"25: hosts {sorted(times)} of "
              f"{sorted(hosts)} registered with the planner {boot[:8]}")
        return times

    def serve_batch(client):
        t0 = time.perf_counter()
        req = new_request()
        client.call_functions(req)
        results = [client.get_message_result(req.app_id, m.id, timeout=300)
                   for m in req.messages]
        return results, (time.perf_counter() - t0) * 1e3

    def ingress_of(planner):
        planner.send("health")
        return planner.expect("health", 60)["health"]["ingress"]

    def submit_batch(client, reqs):
        """The requests through one SUBMIT_BATCH call; CALL_BATCH fails
        meanwhile."""
        def no_call_batch(_req):
            raise AssertionError("25c: a request went through CALL_BATCH")

        t0 = time.perf_counter()
        client.call_functions = no_call_batch
        try:
            accepted, retry_after = client.submit_functions_many(reqs)
        finally:
            del client.call_functions
        check(accepted, f"25c: SUBMIT_BATCH accepted the {len(reqs)} "
              f"requests (retry after {retry_after} s)")
        results = [client.get_message_result(r.app_id, r.messages[0].id,
                                             timeout=300) for r in reqs]
        return results, (time.perf_counter() - t0) * 1e3

    saved_reset = os.environ.get("TRANSPORT_BREAKER_RESET")
    workers: list = []
    try:
        first = child()
        check(first.ready["journal"] and first.ready["replay"] is None,
              "25: the planner child serves with its journal on and "
              "nothing to replay")
        os.environ["TRANSPORT_BREAKER_RESET"] = "1.0"
        try:
            _, workers = start_cluster(
                hosts, TorchExecutorFactory(device=dev.type), base,
                planner=False)
        finally:
            if saved_reset is None:
                os.environ.pop("TRANSPORT_BREAKER_RESET", None)
            else:
                os.environ["TRANSPORT_BREAKER_RESET"] = saved_reset
        client = workers[0].planner_client
        clients = [w.planner_client for w in workers]

        # -- (a) the crash and the restart ------------------------------
        buffered0 = metric("faabric_planner_client_buffered_results_total")
        flushed0 = metric("faabric_planner_client_flushed_results_total")
        t_wall0 = time.time()
        req = new_request()
        done: dict = {}

        def wait_one(m):
            done[m.id] = (client.get_message_result(req.app_id, m.id,
                                                    timeout=300),
                          time.perf_counter())

        def crash_and_restart():
            decision = client.call_functions(req)
            waiters = [threading.Thread(target=wait_one, args=(m,),
                                        name=f"phase25/wait@{m.id}",
                                        daemon=True) for m in req.messages]
            for t in waiters:
                t.start()
            check(job["all_held"].wait(300), "25a: 4 requests are held "
                  "in their guests")
            deadline = time.monotonic() + 300
            pre = []
            while time.monotonic() < deadline:
                pre = client.get_batch_results(req.app_id).message_results
                if len(pre) >= n_req - len(job["held"]):
                    break
                time.sleep(0.02)
            check(len(pre) == n_req - len(job["held"]),
                  f"25a: the planner recorded {len(pre)} free results")
            # Every waiter asked the planner before the kill (a sync
            # call queues behind their asks on the client's sync lock)
            while time.monotonic() < deadline and any(
                    m.id not in client._result_interest
                    and m.id not in done for m in req.messages):
                time.sleep(0.01)
            client.ping()
            first.proc.kill()
            first.proc.wait(60)
            t_kill = time.perf_counter()
            job["release"].set()
            # The held results wait on their workers before the restart:
            # buffered, or in the recent window (a write that went into
            # the dead connection)
            held = set(job["held"])

            def parked():
                ids = set()
                for c in clients:
                    with c._pending_lock:
                        ids |= {m.id for m in c._pending_results}
                        ids |= {m.id for _, m in c._recent_results}
                return ids

            while time.monotonic() < deadline and not held <= parked():
                time.sleep(0.01)
            check(held <= parked(), "25a: the 4 held results wait on "
                  "their workers while the planner is down")
            pending = {w.host: len(w.planner_client._pending_results)
                       for w in workers}
            wait_ports_free(base)
            second = child()
            rejoin = rejoined(workers, second)
            for t in waiters:
                t.join(300)
            check(not any(t.is_alive() for t in waiters)
                  and len(done) == n_req, f"25a: {len(done)} of the "
                  f"{n_req} waiters returned")
            return (decision, pre, t_kill, pending, second, rejoin)

        (decision, pre, t_kill, pending, second, rejoin), got = counted(
            crash_and_restart)
        results = [done[m.id][0] for m in req.messages]
        check_outputs(results, "25a")
        kill_to_last = max(t for _, t in done.values()) - t_kill
        host_of = dict(zip(decision.message_ids, decision.hosts))
        check({host_of[mid] for mid in job["held"]} == set(hosts),
              f"25a: the held requests {sorted(job['held'].values())} lie "
              "on both hosts by the decision")
        post = client.get_batch_results(req.app_id)
        check(post.finished and len(post.message_results) == n_req,
              "25a: the restarted planner holds all 8 results")
        after = {m.id: m.output_data for m in post.message_results}
        check(all(after.get(m.id) == m.output_data for m in pre),
              "25a: the results recorded before the kill are kept")
        replay = second.ready["replay"]
        check(replay is not None and replay["inFlightApps"] == 1,
              f"25a: the replay found {replay and replay['inFlightApps']} "
              "in-flight app(s), 1 expected")
        reconcile = second.expect("reconcile", grace + 60)["reconcile"]
        check(reconcile["requeuedMessages"] == 0
              and not reconcile["missingHosts"],
              f"25a: the reconcile requeued {reconcile['requeuedMessages']}"
              f" messages, missing {reconcile['missingHosts']}")
        check(all(len(c._pending_results) == 0 for c in clients),
              "25a: each worker's pending queue drained")
        flushed_hosts = {e.get("host") for e in get_flight().events()
                         if e["kind"] == "results_flushed"
                         and e["ts"] >= t_wall0}
        check(flushed_hosts >= set(hosts), f"25a: results_flushed flight "
              f"records of {sorted(flushed_hosts)}")
        buffered = (metric("faabric_planner_client_buffered_results_total")
                    - buffered0)
        flushed = (metric("faabric_planner_client_flushed_results_total")
                   - flushed0)
        check(flushed >= len(job["held"]), f"25a: {flushed} results came "
              f"through FLUSH_RESULTS, the {len(job['held'])} held among "
              "them")
        if on_card:
            for k, v in want.items():
                check(got.get(k, 0) == v, f"25a: {k} launched "
                      f"{got.get(k, 0)} times, one batch's {v} expected")
            check(got.get("flash_attention.wgmma", 0)
                  == got["flash_attention"],
                  "25a: every flash forward took the wgmma body")

        # -- (b) the journal's cost: a batch with no crash, on and off ---
        job["hold"] = 0
        rejoined(workers, second)
        (results_on, wall_on), _ = counted(lambda: serve_batch(client))
        check_outputs(results_on, "25b (journal on)")

        # -- (c) the batch through the ingress: SUBMIT_BATCH -----------
        ing0 = ingress_of(second)
        singles = []
        for p in prompts:
            r = batch_exec_factory("rst", "serve", 1)
            r.messages[0].input_data = p.tobytes()
            singles.append(r)
        (results_c, wall_c), got_c = counted(
            lambda: submit_batch(client, singles))
        check_outputs(results_c, "25c")
        ing1 = ingress_of(second)
        delta = {k: ing1[k] - ing0[k] for k in (
            "admittedTotal", "shedTotal", "immediateTotal", "batchedTotal",
            "ticks")}
        check(delta["admittedTotal"] == n_req and delta["shedTotal"] == 0
              and delta["immediateTotal"] == 0
              and delta["batchedTotal"] == n_req and delta["ticks"] >= 1
              and ing1["batchedTotal"] >= 1 and ing1["ticks"] >= 1
              and ing1["queueDepth"] == 0,
              f"25c: the planner's ingress admitted every message through "
              f"its ticks and shed none: {delta}")
        if on_card:
            for k, v in want.items():
                check(got_c.get(k, 0) == v, f"25c: {k} launched "
                      f"{got_c.get(k, 0)} times, one batch's {v} expected")
            check(got_c.get("flash_attention.wgmma", 0)
                  == got_c["flash_attention"],
                  "25c: every flash forward took the wgmma body")
        second.stop()
        dump = subprocess.run(
            [sys.executable, "-m", "faabric_tpu_torch.runner.journaldump",
             journal_dir, "--verify"], capture_output=True, text=True,
            timeout=120, cwd=here)
        check(dump.returncode == 0, f"25a: journaldump --verify exits "
              f"{dump.returncode} ({dump.stderr[-500:]})")
        snap, records, meta = load_journal_dir(journal_dir)
        c_apps = {r.app_id for r in singles}
        grouped = {sub["app_id"] for rec in records if rec["k"] == "group"
                   for sub in rec["recs"] if sub["k"] == "app_update"}
        loose = {rec["app_id"] for rec in records
                 if rec["k"] == "app_update"}
        n_groups = sum(rec["k"] == "group" for rec in records)
        check(n_groups >= 1 and c_apps <= grouped and not c_apps & loose,
              f"25c: the journal holds {n_groups} group record(s) with "
              f"{len(c_apps & grouped)} of the 8 apps' app_updates, "
              f"{len(c_apps & loose)} outside them")
        jbytes = os.path.getsize(os.path.join(journal_dir, JOURNAL_FILE))
        sbytes = os.path.getsize(os.path.join(journal_dir, SNAPSHOT_FILE))
        wait_ports_free(base)
        third = child(FAABRIC_PLANNER_JOURNAL_DIR=None)
        check(not third.ready["journal"], "25b: the third planner child "
              "runs without a journal")
        rejoined(workers, third)
        (results_off, wall_off), _ = counted(lambda: serve_batch(client))
        check_outputs(results_off, "25b (journal off)")
        log(f"  25a replay {replay['seconds']} s ({replay['records']} "
            f"records, snapshot {replay['snapshot']}, "
            f"{replay['inFlightMessages']} in-flight messages, "
            f"{replay['results']} results); kill to last result "
            f"{kill_to_last:.3f} s; restart (spawn) to serving "
            f"{second.ready_s:.3f} s, to rejoin by host (s): "
            + ", ".join(f"{h} {t:.3f}" for h, t in sorted(rejoin.items()))
            + f"; pending at restart {pending}; buffered {buffered:g}, "
            f"flushed {flushed:g}; reconcile {reconcile}; launches {got}")
        log(f"  25a journal at the end: {jbytes} bytes and {len(records)} "
            f"records in {JOURNAL_FILE}, {sbytes} bytes in {SNAPSHOT_FILE} "
            f"folding {meta.get('records_folded')} records")
        log(f"  25b batch of 8 wall: journal on {wall_on:.1f} ms, journal "
            f"off {wall_off:.1f} ms")
        log(f"  25c 8 apps through SUBMIT_BATCH to their last result: "
            f"{wall_c:.1f} ms; ingress {delta}, last tick "
            f"{ing1['lastTickMs']} ms, {ing1['lastTickBatch']} request(s); "
            f"launches {got_c}")
    finally:
        job["release"].set()
        try:
            stop_cluster(None, workers)
        finally:
            for c in children:
                c.kill()
            shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 25 launches: {launches}")
    log(f"  phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return launches


SPOT_HEADER = 4096   # the spot guest's marker page ahead of its weights
SPOT_MARKER = 4242


def register_migration_guests(job: dict) -> None:
    """Phase 24's torch guests. ``mig/block`` holds its slot until
    ``job["blockers_go"]`` is set. ``mpi/migrate`` is the data-parallel
    trainer of ``mpi/ddp`` over ``ctx.mpi_world()`` (the reference's
    ``fn_mpi_migrate``, ``tests/dist/procs.py:709-786``, with a
    training step for its all-to-all round): after step
    ``job["migrate_after"]`` rank 0 asks the planner for a migration,
    the moved ranks prepare the world and raise
    ``FunctionMigratedException``, and on re-entry as a MIGRATION batch
    they join the stayed ranks' post-migration barrier, re-run the
    device plane's handshake and take rank 0's parameters by
    ``world.broadcast``. ``mig/spot`` (``fn_spot``, :888-926) writes the
    model's seeded fp32 weights into its executor's memory image,
    scores a prompt, and once its app leaves the planner's in-flight set
    parks the image on the planner's snapshot registry and raises
    ``FunctionFrozenException``; thawed on an image that holds the
    weights, it rebuilds the model from the image and scores again.
    ``mig/serve`` scores a prompt and generates ``job["n_new"]`` tokens.
    ``mpi/abort``: the last rank aborts the world while the others are
    blocked in an allreduce of a tensor on the guest's device; they
    report how long the abort took to reach them."""
    from faabric_tpu_torch.executor import (
        FunctionFrozenException,
        FunctionMigratedException,
        register_function,
    )
    from faabric_tpu_torch.models import forward, generate
    from faabric_tpu_torch.mpi import MpiOp, MpiWorldAborted
    from faabric_tpu_torch.proto import BatchExecuteType
    from faabric_tpu_torch.snapshot import SnapshotClient, SnapshotData

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @register_function("mig", "block")
    def block(ctx):
        if not job["blockers_go"].wait(300):
            raise RuntimeError("blocker never released")

    @register_function("mpi", "migrate")
    def migrate(ctx):
        msg, broker = ctx.message, ctx.broker
        sched = ctx.executor.scheduler
        pc = sched.planner_client
        rank, dev = msg.mpi_rank, ctx.device
        migrated_entry = ctx.request.type == int(BatchExecuteType.MIGRATION)
        world = ctx.mpi_world()
        model = job["model"](dev)
        check_at = job["migrate_after"]
        log_ = {"step_ms": [], "rungs": [], "n_hosts": []}
        if migrated_entry:
            # The stayed ranks wait in the new group's barrier for this
            # rank before anyone touches the rewired world
            broker.post_migration_hook(msg.group_id, msg.group_idx)
            world.refresh_rank_hosts()
            plane = world.activate_device_plane(rank, device=dev)
            flat = world.broadcast(0, rank, np.empty(job["n_params"],
                                                     np.float32))
            load_flat(model, torch.as_tensor(flat, device=dev))
            start = check_at
            log_.update(job["pre"].pop(rank))
        else:
            plane = world.activate_device_plane(rank, device=dev)
            start = 0
        t_pause, pause_ms = None, None
        for step in range(start, job["steps"]):
            tokens, targets = job["batch"](step, rank, dev)
            sync(dev)
            t0 = time.perf_counter()
            ddp_step(world, rank, model, tokens, targets, job["lr"])
            sync(dev)
            log_["step_ms"].append((time.perf_counter() - t0) * 1e3)
            log_["rungs"].append(world.rungs.get((rank, "allreduce")))
            log_["n_hosts"].append(len(world.hosts()))
            if t_pause is not None:
                pause_ms, t_pause = (time.perf_counter() - t_pause) * 1e3, None
            if migrated_entry or check_at is None or step != check_at - 1:
                continue
            # -- the migration point (reference mpiMigrationPoint) --------
            t_pause = time.perf_counter()
            # Co-located ranks share one world object, whose group id the
            # first to prepare changes: read it before anyone can
            old_gid = world.group_id
            world.barrier(rank)
            if rank == 0:
                # The blockers' results are in: a check while some are
                # still running would find a partial consolidation
                job["at_check"].set()
                if not job["blockers_done"].wait(120):
                    raise RuntimeError("the blockers never finished")
                t_check = time.perf_counter()
                dec = pc.check_migration(msg.app_id)
                job["check_ms"] = (time.perf_counter() - t_check) * 1e3
                world.broadcast(0, 0, np.array([dec is not None], np.int64))
                found = dec is not None
            else:
                found = bool(world.broadcast(0, rank,
                                             np.zeros(1, np.int64))[0])
            if not found:
                raise RuntimeError("no migration opportunity")
            dec, deadline = None, time.monotonic() + 60
            while dec is None or dec.group_id == old_gid:
                if time.monotonic() > deadline:
                    raise RuntimeError("the new decision never arrived")
                dec = pc.get_scheduling_decision(msg.app_id)
                if dec is None or dec.group_id == old_gid:
                    time.sleep(0.01)
            idx = dec.app_idxs.index(msg.app_idx)
            # Every rank is done with the old group before any prepares
            world.barrier(rank)
            world.prepare_migration(rank, dec.group_id)
            if dec.hosts[idx] != sched.host:
                job["pre"][rank] = {k: list(v) for k, v in log_.items()}
                raise FunctionMigratedException()
            broker.post_migration_hook(dec.group_id, dec.group_idxs[idx])
            world.refresh_rank_hosts()
            plane = world.activate_device_plane(rank, device=dev)
            flat = world.broadcast(0, rank, flat_params(model))
            if rank != 0:
                load_flat(model, torch.as_tensor(flat, device=dev))
        job["params"][rank] = flat_params(model)
        world.barrier(rank)
        return json.dumps({"rank": rank, "host": sched.host, "plane": plane,
                           "migrated": migrated_entry, "pause_ms": pause_ms,
                           **log_}).encode()

    @register_function("mig", "spot")
    def spot(ctx):
        ex, dev = ctx.executor, ctx.device
        pc = ex.scheduler.planner_client
        need = SPOT_HEADER + 4 * job["n_params"]
        mem = ex.get_memory_view()
        thawed = (mem.size >= need
                  and int(mem[:8].view(np.int64)[0]) == SPOT_MARKER)
        if not thawed:
            ex.set_memory_size(need)
            mem = ex.get_memory_view()
            weights = flat_params(job["spot_model"](dev)).cpu().numpy()
            mem[SPOT_HEADER:need].view(np.float32)[:] = weights
            mem[:8].view(np.int64)[0] = SPOT_MARKER
        image = torch.from_numpy(mem[SPOT_HEADER:need].view(np.float32))
        model = load_flat(job["blank_model"](dev), image.to(dev))
        prompt = torch.as_tensor(job["spot_prompt"], device=dev)[None]
        with torch.inference_mode():
            logits = forward(model, prompt)
        sync(dev)
        job["logits"]["thawed" if thawed else "first"] = logits
        if thawed:
            return json.dumps({"host": ex.scheduler.host}).encode()
        job["scored"].set()
        deadline = time.monotonic() + 120
        while pc.get_scheduling_decision(ctx.message.app_id) is not None:
            if time.monotonic() > deadline:
                raise RuntimeError("never frozen")
            time.sleep(0.02)
        # Frozen: the image goes to the planner, from which the thaw
        # host restores it
        t0 = time.perf_counter()
        client = SnapshotClient(pc.host)
        try:
            client.push_snapshot(ctx.request.snapshot_key, SnapshotData(mem))
        finally:
            client.close()
        job["park_ms"] = (time.perf_counter() - t0) * 1e3
        raise FunctionFrozenException()

    @register_function("mig", "serve")
    def serve(ctx):
        model = job["serve_model"]
        prompt = torch.frombuffer(bytearray(ctx.message.input_data),
                                  dtype=torch.int32).to(ctx.device)[None]
        with torch.inference_mode():
            scores = forward(model, prompt)[0].argmax(-1).to(torch.int32)
            tokens = generate(model, prompt, job["n_new"])[0]
        return torch.cat([scores, tokens]).cpu().numpy().tobytes()

    @register_function("mpi", "abort")
    def abort(ctx):
        world = ctx.mpi_world()
        rank, dev = ctx.message.mpi_rank, ctx.device
        host = ctx.executor.scheduler.host
        if rank == world.size - 1:
            # Abort once the other ranks are blocked in the allreduce
            if not job["blocked"].wait(60):
                raise RuntimeError("the other ranks never reached the "
                                   "allreduce")
            time.sleep(0.3)
            job["t_abort"] = time.perf_counter()
            world.abort("rank 3 aborts")
            return json.dumps({"rank": rank, "host": host,
                               "aborted_by_me": True}).encode()
        data = torch.ones(job["abort_elems"], device=dev)
        with job["lock"]:
            job["n_blocked"] += 1
            if job["n_blocked"] == world.size - 1:
                job["blocked"].set()
        try:
            world.allreduce(rank, data, MpiOp.SUM)
        except MpiWorldAborted as e:
            arrived = time.perf_counter() - job["t_abort"]
            return json.dumps({"rank": rank, "host": host,
                               "arrived_s": arrived,
                               "reason": e.reason}).encode()
        raise RuntimeError("the allreduce completed without its last rank")


def migration_phase(dev, build, cfg=None, per_rank: int = 2,
                    seq: int = 512, prompt_len: int = 2048,
                    serve_len: int = 512, n_new: int = 32,
                    base: int | None = None, parts: str = "abcd",
                    tol: float = 1e-5) -> dict:
    """Phase 24: live migration, spot freeze and thaw, recovery requeues
    and cross-host group aborts, each on a port planner and two
    WorkerRuntimes on loopback aliases, at the flagship's full width
    (``ModelConfig()``, bf16 compute, seeded weights).

    (a) A 4-rank data-parallel gang (``mpi/migrate``, ``per_rank`` x ``seq``
    tokens a rank, lr 0.5) is spread 2 + 2 by blocker guests; after step
    2 of 6 the blockers finish, rank 0 calls ``check_migration``, the 2
    ranks on the other host prepare the world and re-enter on rank 0's
    host as a MIGRATION batch, every rank runs ``post_migration_hook``
    and re-activates the device plane, the re-entered ranks take rank
    0's parameters by ``world.broadcast``, and steps 3-6 follow. One
    migration is counted; every rank ends SUCCESS on the consolidated
    host; the allreduces before it take a cross-host rung on a 2-host
    world and after it the device rung; the final parameters are
    bitwise equal across ranks and within ``tol`` relative L2 of an
    unmigrated run of the same 6 steps (one host, the device rung
    throughout: on the card the sums before the migration run in
    another order); each run's launches are 4 ranks x 6 steps x (2L
    flash forwards, L dQ, L dK/dV, 4L + 1 RMS), every one on the
    ``wgmma`` bodies. (b) Spot
    (``fn_spot``): a THREADS guest on host B writes the seeded weights
    into its executor's memory image and scores a 1 x ``prompt_len``
    prompt; host B is marked for eviction while the blockers fill host
    A, ``check_migration`` returns MUST_FREEZE, the guest parks its
    image on the planner and vacates; with every slot free the app is
    in ``get_frozen_apps()``; the thaw lands on host A, which restores
    the image, and the rebuilt model's logits are bitwise equal to
    those before the freeze. (c) Recovery: phase 13's batch of 8
    requests (``serve_len``-token prompts, ``n_new`` greedy tokens),
    4 + 4 over the hosts; ``planner.dispatch=drop@host=B`` strands host
    B's share, and once host A's share has returned,
    ``keepalive=suppress@host=B`` silences host B, whose expiry (host
    timeout 4 s for the part) requeues its share onto host A's free
    slots (the planner's recovery finds no capacity while host A's share
    runs, and the app then completes around the requeue, as the
    reference's does, so the expiry must not come first): every
    result SUCCESS with direct ``generate``'s tokens, the requeued
    messages counter up by host B's share, an ``rqu`` stamp in each
    requeued ledger, and exactly one batch's launches. (d) A 4-rank world
    2 + 2 blocked in an allreduce of a tensor on the guest's device:
    rank 3 aborts it and every other rank raises ``MpiWorldAborted``,
    once directly and once with the direct abort dropped by a
    ``transport.send`` rule, so that only the planner's relay reaches
    the far host. ``parts`` picks the parts to run. Returns the phase's
    kernel launches."""
    from faabric_tpu_torch.batch_scheduler import reset_batch_scheduler
    from faabric_tpu_torch.batch_scheduler.decision import MUST_FREEZE
    from faabric_tpu_torch.executor import TorchExecutor, TorchExecutorFactory
    from faabric_tpu_torch.faults import (
        clear_faults,
        get_fault_registry,
        install_faults,
    )
    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        forward,
        generate,
    )
    from faabric_tpu_torch.planner import get_planner
    from faabric_tpu_torch.proto import (
        BatchExecuteType,
        ReturnValue,
        batch_exec_factory,
    )
    from faabric_tpu_torch.telemetry import get_metrics
    from faabric_tpu_torch.telemetry.lifecycle import PHASE_REQUEUE
    from faabric_tpu_torch.util.config import get_system_config

    log("phase 24: live migration, spot freeze and thaw, recovery "
        "requeues and cross-host aborts")
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card:
        log("  24 card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cfg = cfg or ModelConfig()
    n, steps, lr, L = MPI_RANKS, 6, 0.5, cfg.n_layers
    corpus = np.random.RandomState(24).randint(
        0, cfg.vocab_size, (steps, n * per_rank, seq + 1)).astype(np.int64)

    def batch(step, rank, device):
        b = torch.as_tensor(corpus[step, rank * per_rank:
                                   (rank + 1) * per_rank], device=device)
        return b[:, :-1], b[:, 1:]

    def seeded(seed):
        return lambda device: Transformer(
            cfg, device=device,
            generator=torch.Generator(device=device).manual_seed(seed))

    class TimedExecutor(TorchExecutor):
        """Times the restore of a THREADS batch's memory image."""

        def restore(self, snapshot_key: str) -> None:
            t0 = time.perf_counter()
            super().restore(snapshot_key)
            job["restore_ms"] = (time.perf_counter() - t0) * 1e3

    class TimedFactory(TorchExecutorFactory):
        def create_executor(self, msg):
            return TimedExecutor(msg, self.device_type)

    job = {"model": seeded(0), "blank_model": lambda d: Transformer(cfg,
                                                                    device=d),
           "spot_model": seeded(1), "batch": batch, "lr": lr,
           "steps": steps, "n_params": 0, "params": {}, "pre": {},
           "logits": {}, "n_new": n_new, "lock": threading.Lock()}
    job["n_params"] = sum(p.numel() for p in job["blank_model"](dev)
                          .parameters())
    register_migration_guests(job)
    factory = TimedFactory(device=dev.type)
    planner = get_planner()
    conf = get_system_config()
    launches: dict = {}
    wgmma = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")

    def add_launches(got, what, want=None):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if not on_card:
            return
        if want is not None:
            for k, v in want.items():
                check(got.get(k, 0) == v,
                      f"{what}: {k} launched {got.get(k, 0)} times, {v} "
                      f"expected")
        for k in wgmma:
            if got.get(k):
                check(got.get(f"{k}.wgmma", 0) == got[k],
                      f"{what}: every {k} launch took the wgmma body")

    def counted(fn):
        if on_card:
            torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                     if v != before.get(k, 0)}

    def metric(name):
        """A counter's value, or a histogram's (sum, count)."""
        fam = get_metrics().snapshot().get(name, {})
        rows = fam.get("series", [])
        if fam.get("type") == "histogram":
            return (sum(r["sum"] for r in rows), sum(r["count"] for r in rows))
        return sum(r["value"] for r in rows)

    # -- (a) a training gang migrated mid-run ----------------------------
    if "a" in parts:
        per_step = {"flash_attention": 2 * L, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L, "rms_norm": 4 * L + 1}
        hosts = {"mig-host-a": 4, "mig-host-b": 4}
        planner_server, workers = start_cluster(hosts, factory, base)
        try:
            client = workers[0].planner_client
            # Unmigrated: one host from the start, the device rung
            job.update(migrate_after=None)
            job["params"].clear()
            (results, wall_u), got_u = counted(
                lambda: run_gang(client, "migrate", n))
            outs_u = guest_outputs(results, "24a unmigrated run")
            add_launches(got_u, "24a unmigrated run",
                         {k: v * n * steps for k, v in per_step.items()})
            check(len({o["host"] for o in outs_u}) == 1
                  and all(set(o["rungs"]) == {"device"} for o in outs_u),
                  "24a unmigrated run: 4 ranks on one host, every "
                  "allreduce on the device rung")
            want = {r: job["params"][r] for r in range(n)}
            # Migrated: blockers hold 2 slots a host, so the gang spreads
            # 2 + 2 (the reference test's recipe)
            job.update(migrate_after=2, blockers_go=threading.Event(),
                       at_check=threading.Event(),
                       blockers_done=threading.Event())
            job["params"].clear()
            blockers = []
            for _ in range(2):
                b = batch_exec_factory("mig", "block", 2)
                blockers.append((b, client.call_functions(b)))
            check(sorted(h for _, d in blockers for h in d.hosts)
                  == sorted(list(hosts) * 2),
                  f"24a: the blockers hold 2 slots on each host")

            def release_blockers():
                # 1. the blockers finish; 2. rank 0 checks for a migration
                job["at_check"].wait(300)
                job["blockers_go"].set()
                for b, _ in blockers:
                    for m in b.messages:
                        client.get_message_result(b.app_id, m.id, timeout=60)
                job["blockers_done"].set()

            releaser = threading.Thread(target=release_blockers, daemon=True)
            releaser.start()
            migrations0 = client.get_num_migrations()
            (results, wall_m), got = counted(
                lambda: run_gang(client, "migrate", n))
            releaser.join(5)
            outs = guest_outputs(results, "24a migrated run")
            migrations = client.get_num_migrations() - migrations0
            check(migrations == 1, f"24a: the planner counted {migrations} "
                  f"migration(s), 1 expected")
            final = {o["host"] for o in outs}
            moved = [o["rank"] for o in outs if o["migrated"]]
            check(len(final) == 1 and len(moved) == 2,
                  f"24a: every rank SUCCESS on the consolidated host "
                  f"{sorted(final)}; ranks {moved} re-entered there "
                  f"({[(o['rank'], o['host']) for o in outs]})")
            pre = [rg for o in outs for rg, h in zip(o["rungs"][:2],
                                                     o["n_hosts"][:2])
                   if h == 2 and rg != "device"]
            post = [rg for o in outs for rg in o["rungs"][2:]]
            check(len(pre) == 2 * n and all(o["n_hosts"][2:] == [1] * 4
                                            for o in outs)
                  and post == ["device"] * 4 * n,
                  f"24a: steps 1-2 allreduced on a cross-host rung of a "
                  f"2-host world ({sorted(set(pre))}), steps 3-6 on the "
                  f"device rung of a 1-host world")
            flat = [job["params"][r] for r in range(n)]
            check(all(torch.equal(flat[0], f) for f in flat[1:]),
                  "24a: the ranks' final parameters are bitwise equal")
            rel = float((flat[0] - want[0]).norm() / want[0].norm())
            check(rel <= tol, f"24a: final parameters against the "
                  f"unmigrated run's: relative L2 {rel:.3g} (bound {tol:g})")
            add_launches(got, "24a", {k: v * n * steps
                                      for k, v in per_step.items()})
            log(f"  24a launches: {got}")
            pre_ms = [t for o in outs for t in o["step_ms"][:2]]
            post_ms = [t for o in outs for t in o["step_ms"][3:]]
            pause = outs[0]["pause_ms"]
            log(f"  24a step ms before the migration (2 hosts, host ladder) "
                f"median {np.median(pre_ms):.1f} (by rank and step: "
                + "; ".join(", ".join(f"{t:.1f}" for t in o["step_ms"][:2])
                            for o in outs)
                + f"); after (one host, device rung, steps 4-6) median "
                f"{np.median(post_ms):.1f} (by rank and step: "
                + "; ".join(", ".join(f"{t:.1f}" for t in o["step_ms"][3:])
                            for o in outs)
                + f"); migration pause (rank 0 at the "
                f"migration point to the end of step 3, waiting for the "
                f"blockers' results included) {pause:.1f} ms, "
                f"check_migration {job['check_ms']:.1f} ms;"
                f" the unmigrated run's step ms median "
                f"{np.median([t for o in outs_u for t in o['step_ms']]):.1f}"
                f" (range {min(t for o in outs_u for t in o['step_ms']):.1f}"
                f"-{max(t for o in outs_u for t in o['step_ms']):.1f})"
                f"; gang wall {wall_m:.0f} ms migrated, {wall_u:.0f} ms "
                f"unmigrated")
            job["params"].clear()
            del want, flat
        finally:
            for ev in ("blockers_go", "blockers_done"):
                job.get(ev, threading.Event()).set()
            stop_cluster(planner_server, workers)
            register_migration_guests(job)

    # -- (b) spot freeze and thaw of a serving guest ---------------------
    if "b" in parts:
        job.update(spot_prompt=np.random.RandomState(241).randint(
            0, cfg.vocab_size, prompt_len), scored=threading.Event(),
            blockers_go=threading.Event())
        job["logits"].clear()
        host_a, host_b = "spot-host-a", "spot-host-b"
        reset_batch_scheduler("spot")
        planner_server, workers = start_cluster({host_a: 2, host_b: 2},
                                                factory, base)
        try:
            wa, wb = workers
            req = batch_exec_factory("mig", "spot", 1)
            req.type = int(BatchExecuteType.THREADS)
            req.snapshot_key = f"mig/spot_{req.app_id}"
            (d, got1) = counted(lambda: (
                wb.planner_client.call_functions(req),
                job["scored"].wait(300)))
            check(d[0].hosts == [host_b] and d[1],
                  f"24b: the guest runs on {d[0].hosts} and scored")
            blk = batch_exec_factory("mig", "block", 2)
            check(wa.planner_client.call_functions(blk).hosts
                  == [host_a, host_a], "24b: blockers fill host A")
            planner.set_next_evicted_host_ips([host_b])
            dec = wa.planner_client.check_migration(req.app_id)
            check(dec is not None and dec.app_id == MUST_FREEZE,
                  "24b: with host B evicted and host A full, "
                  "check_migration returns MUST_FREEZE")
            deadline = time.monotonic() + 120
            while "park_ms" not in job and time.monotonic() < deadline:
                time.sleep(0.01)
            check("park_ms" in job, "24b: the guest parked its image")
            job["blockers_go"].set()
            for m in blk.messages:
                wa.planner_client.get_message_result(blk.app_id, m.id,
                                                     timeout=60)
            free = all(h.used_slots == 0
                       for h in planner.get_available_hosts())
            check(req.app_id in planner.get_frozen_apps() and free,
                  "24b: the app is parked in get_frozen_apps() with every "
                  "slot free")
            thaw = batch_exec_factory("mig", "spot", 1)
            thaw.app_id = req.app_id
            t0 = time.perf_counter()

            def thaw_run():
                d2 = wa.planner_client.call_functions(thaw)
                return d2, wa.planner_client.get_message_result(
                    req.app_id, d2.message_ids[0], timeout=300)

            (d2, res), got2 = counted(thaw_run)
            thaw_ms = (time.perf_counter() - t0) * 1e3
            check(d2.hosts == [host_a] and res.return_value
                  == int(ReturnValue.SUCCESS)
                  and json.loads(res.output_data)["host"] == host_a,
                  f"24b: the thaw ran on {d2.hosts}: "
                  f"{res.output_data[:200]!r}")
            check(req.app_id not in planner.get_frozen_apps(),
                  "24b: the app left the frozen set")
            before, after = job["logits"]["first"], job["logits"]["thawed"]
            check(torch.equal(before, after),
                  f"24b: the logits of {tuple(after.shape)} after the thaw "
                  f"on host A are bitwise equal to those before the freeze")
            spot_launches = {k: got1.get(k, 0) + got2.get(k, 0)
                             for k in set(got1) | set(got2)}
            add_launches(spot_launches, "24b",
                         {"flash_attention": 2 * L,
                          "rms_norm": 2 * (2 * L + 1)})
            log(f"  24b image {4 * job['n_params'] + SPOT_HEADER} bytes: park"
                f" {job['park_ms']:.1f} ms, restore on host A "
                f"{job['restore_ms']:.1f} ms, thaw round trip (call_functions"
                f" to the result, the planner's push of the image included) "
                f"{thaw_ms:.1f} ms")
        finally:
            job["blockers_go"].set()
            planner.set_next_evicted_host_ips([])
            reset_batch_scheduler()
            stop_cluster(planner_server, workers)
            job["logits"].clear()
            register_migration_guests(job)

    # -- (c) recovery of a serving batch ---------------------------------
    if "c" in parts:
        n_req = 8
        host_a, host_b = "rec-host-a", "rec-host-b"
        serve_model = seeded(0)(dev)
        job["serve_model"] = serve_model
        prompts = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (n_req, serve_len)).astype(np.int32)
        direct = []
        with torch.inference_mode():
            for p in prompts:
                prompt = torch.as_tensor(p, device=dev)[None]
                scores = forward(serve_model, prompt)[0].argmax(-1)
                tokens = generate(serve_model, prompt, n_new)[0]
                direct.append(torch.cat([scores.to(torch.int32),
                                         tokens]).cpu().numpy())
        saved_timeout = conf.planner_host_timeout
        conf.planner_host_timeout = 4.0
        planner_server, workers = start_cluster({host_a: 4, host_b: 4},
                                                factory, base)
        try:
            client = workers[0].planner_client
            req = batch_exec_factory("mig", "serve", n_req)
            for m, p in zip(req.messages, prompts):
                m.input_data = p.tobytes()
            requeued0 = metric("faabric_planner_requeued_messages_total")
            rec0 = metric("faabric_planner_recovery_seconds")
            install_faults(f"planner.dispatch=drop@host={host_b}")
            t0 = time.perf_counter()

            def serve_batch():
                d = client.call_functions(req)
                by_id = dict(zip(d.message_ids, d.hosts))
                results = {m.id: client.get_message_result(
                    req.app_id, m.id, timeout=300)
                    for m in req.messages if by_id[m.id] == host_a}
                install_faults(f"planner.dispatch=drop@host={host_b};"
                               f"keepalive=suppress@host={host_b}")
                results.update({m.id: client.get_message_result(
                    req.app_id, m.id, timeout=300)
                    for m in req.messages if m.id not in results})
                return d, [results[m.id] for m in req.messages]

            (decision, results), got = counted(serve_batch)
            wall = (time.perf_counter() - t0) * 1e3
            clear_faults()
            share = {mid for mid, h in zip(decision.message_ids,
                                           decision.hosts) if h == host_b}
            check(len(share) == n_req // 2 and len(set(decision.hosts)) == 2,
                  f"24c: the batch spread {n_req - len(share)} + "
                  f"{len(share)} over the hosts")
            check(all(r.return_value == int(ReturnValue.SUCCESS)
                      and np.array_equal(np.frombuffer(r.output_data,
                                                       np.int32), d)
                      for r, d in zip(results, direct)),
                  "24c: all 8 results SUCCESS, tokens equal to direct "
                  "forward and generate")
            requeued = (metric("faabric_planner_requeued_messages_total")
                        - requeued0)
            check(requeued == len(share), f"24c: requeued messages rose by "
                  f"{requeued}, host B's share is {len(share)}")
            stamped = [r for r in results if r.id in share
                       and PHASE_REQUEUE in r.lc]
            check(len(stamped) == len(share), f"24c: {len(stamped)} of the "
                  f"{len(share)} requeued ledgers hold an rqu stamp")
            add_launches(got, "24c", {
                "flash_attention": n_req * L,
                "rms_norm": n_req * ((2 * L + 1) * (1 + n_new))})
            rec = metric("faabric_planner_recovery_seconds")
            log(f"  24c recovery seconds (histogram, detection to "
                f"re-dispatch): {rec[0] - rec0[0]:.3f} over "
                f"{rec[1] - rec0[1]} requeue(s); the batch's wall "
                f"{wall:.0f} ms with a 4 s host timeout; launches {got}")
        finally:
            clear_faults()
            conf.planner_host_timeout = saved_timeout
            stop_cluster(planner_server, workers)
            register_migration_guests(job)
            del serve_model
            job.pop("serve_model", None)

    # -- (d) a cross-host abort, direct and through the planner's relay --
    if "d" in parts:
        planner_server, workers = start_cluster(
            {"abt-host-a": 2, "abt-host-b": 2}, factory, base)
        try:
            client = workers[0].planner_client
            far = None
            for label in ("direct", "relay"):
                job.update(blocked=threading.Event(), n_blocked=0,
                           abort_elems=1 << 20)
                fired = {}
                if label == "relay":
                    # Rank 3's host sends the abort to the far host, then
                    # asks the planner to relay it: dropping the first
                    # ABORT_GROUP frame to the far host leaves the relay
                    # as the only way there
                    install_faults(f"transport.send=drop@host={far}"
                                   f"@code=8@plane=async@times=1")
                try:
                    results, wall = run_gang(client, "abort", n)
                finally:
                    fired = get_fault_registry().snapshot()
                    clear_faults()
                outs = guest_outputs(results, f"24d abort ({label})")
                aborter, others = outs[-1], outs[:-1]
                far_side = [o for o in others if o["host"] != aborter["host"]]
                far = far_side[0]["host"] if far_side else None
                check(aborter.get("aborted_by_me")
                      and all("arrived_s" in o for o in others)
                      and len(far_side) == 2,
                      f"24d ({label}): rank 3 on {aborter['host']} aborted; "
                      f"ranks {[o['rank'] for o in others]} raised "
                      f"MpiWorldAborted, {len(far_side)} of them on the "
                      f"far host {far}")
                if label == "relay":
                    dropped = sum(r["fired"]
                                  for r in fired.get("transport.send", []))
                    check(dropped == 1, f"24d (relay): the rule dropped "
                          f"{dropped} abort frame(s), 1 expected")
                    check(all("planner relay" in o["reason"]
                              for o in far_side),
                          "24d (relay): the far host learned of the abort "
                          "through the planner's relay")
                log(f"  24d ({label}) abort arrival by rank: "
                    + ", ".join(f"r{o['rank']}@{o['host']} "
                                f"{o['arrived_s'] * 1e3:.1f} ms"
                                for o in others)
                    + f"; gang wall {wall:.0f} ms")
        finally:
            clear_faults()
            stop_cluster(planner_server, workers)

    if on_card:
        log(f"  24 peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
            f" GiB")
    log(f"  phase 24 launches: {launches}")
    log(f"  phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 29's int32 payload a rank (divisible by the 4 ranks)
XPROC_INT_ELEMS = 4096
# Phase 29's timed rounds of each kind (after one checked round)
XPROC_ITERS = 5


def rank_event_ms(fn, iters: int, dev) -> tuple:
    """``iters`` calls of ``fn`` on a rank's thread, each timed by a CUDA
    event pair on the thread's current stream (host clock on the CPU):
    (the last call's result, the ms of each call). A collective's time
    runs from this rank's arrival to its result being ready."""
    ms, res = [], None
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            res = fn()
            ms.append((time.perf_counter() - t0) * 1e3)
    return res, ms


def register_xproc_guests(job: dict) -> None:
    """Phase 29's guest, ``mpi/plane_xproc``: one rank of a world whose
    ranks live in two worker processes of one device plane. First the
    host ring's int32 ``allreduce``, ``allgather`` and ``reduce_scatter``;
    then the plane, activated explicitly on the rank's device; the same
    three on it (bitwise against the host ring and numpy); a
    device-resident fp32 allreduce of ``job["elems"]`` elements a rank
    (the inputs from ``torch.Generator`` seeds ``job["seed"] + rank`` on
    the device): a warm-up round, which grows the exchange's windows,
    then ``XPROC_ITERS`` rounds timed by CUDA events on the rank's
    stream, with the host↔device copies and the bytes on rings and bulk
    TCP counted around them; then the ring permute (shift 1) at that
    size against its plain version over the regenerated inputs, and
    ``XPROC_ITERS`` timed hops, each a round (the rank's arrival to its
    result) and, from the plane's summary, the ring kernel's launch
    alone in this process. Returns JSON: its host, the verdict, the
    plane's summary, the checks, the result's digest, the times."""
    from faabric_tpu_torch.device_plane import device_copy_totals
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.ops.ring_permute import _reference_ring_permute

    @register_function("mpi", "plane_xproc")
    def plane_xproc(ctx):
        world = ctx.mpi_world()
        rank = ctx.message.mpi_rank
        dev = ctx.device
        n = world.size
        out = {"rank": rank, "host": world.host_for_rank(rank)}
        rng = np.random.default_rng(29)
        ints = [rng.integers(-9999, 9999, XPROC_INT_ELEMS).astype(np.int32)
                for _ in range(n)]
        k = XPROC_INT_ELEMS // n

        def three():
            return (world.allreduce(rank, ints[rank].copy(), MpiOp.SUM),
                    world.allgather(rank, ints[rank][:64].copy()),
                    world.reduce_scatter(rank, ints[rank].copy(), MpiOp.SUM))

        host = three()
        out["active"] = world.activate_device_plane(rank, device=dev)
        plane = world.device_plane()
        if plane is None:
            return json.dumps(out).encode()
        summary = plane.summary()
        out["plane"] = {key: summary[key] for key in (
            "process_index", "process_count", "size", "device")}
        got = three()
        want = (sum(ints), np.concatenate([a[:64] for a in ints]),
                sum(ints)[rank * k:(rank + 1) * k])
        out["int32"] = {
            kind: bool(g.dtype == np.int32 and np.array_equal(g, h)
                       and np.array_equal(g, w)
                       and world.rungs[rank, kind] == "device")
            for kind, g, h, w in zip(("allreduce", "allgather",
                                      "reduce_scatter"), got, host, want)}

        def make(r):
            return torch.randn(job["elems"], device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(job["seed"] + r))

        x = make(rank)
        world.allreduce(rank, x, MpiOp.SUM)  # the windows grow here
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        world.barrier(rank)
        c0, b0 = device_copy_totals(), plane_bytes()
        y, out["allreduce_ms"] = rank_event_ms(
            lambda: world.allreduce(rank, x, MpiOp.SUM), XPROC_ITERS, dev)
        c1, b1 = device_copy_totals(), plane_bytes()
        out["copies"] = [c1["count"] - c0["count"], c1["bytes"] - c0["bytes"]]
        out["host_bytes"] = [b1["shm"] - b0["shm"], b1["tcp"] - b0["tcp"]]
        out["resident"] = bool(y.device == dev and world.rungs[
            rank, "allreduce"] == "device")
        out["digest"] = _digest(y)
        del y
        world.barrier(rank)
        hop = plane.ring_permute(rank, x, 1)
        ins = [make(r) for r in range(n)]
        outs = [torch.empty_like(t) for t in ins]
        _reference_ring_permute(ins, outs, 1)
        out["ring_bitwise"] = bool(torch.equal(hop, outs[rank]))
        del ins, outs, hop
        world.barrier(rank)
        _, out["ring_ms"] = rank_event_ms(
            lambda: plane.ring_permute(rank, x, 1), XPROC_ITERS, dev)
        world.barrier(rank)
        # The process's launches of the timed hops, the kernel alone
        out["ring_kernel_ms"] = plane.summary()["ring_kernel_ms"][
            -XPROC_ITERS:]
        return json.dumps(out).encode()


def xproc_phase(dev, children: dict, client,
                elems: int = GRAD_ELEMS) -> dict:
    """Phase 29: the device plane across phase 26's two worker processes,
    which joined a 2-process plane through the planner at boot. A gang of
    4 ranks (2 a process) of :func:`register_xproc_guests`' guest; the
    children's launches since the last report are read first, so that
    the gang's alone come back after it. Checked: the ranks split 2 + 2,
    the plane activated on every rank over 2 processes; its int32
    allreduce, allgather and reduce_scatter bitwise against the host ring
    and numpy; the resident fp32 allreduce of ``elems`` a rank (the
    flagship's gradient by default) stayed on the device with zero
    host↔device copies and zero bytes on rings or bulk TCP, and is
    bitwise equal to the single-process plane's fold of the same inputs
    (computed here); the ring permute across the processes bitwise
    against its plain version, with one ring launch a round in each
    process (on the card). Logs the cross-process times beside the
    single-process plane's at the same size. Returns the children's
    launches."""
    from faabric_tpu_torch.device_plane import DevicePlane
    from faabric_tpu_torch.mpi import MpiOp

    log("phase 29: the device plane across the worker processes")
    on_card = dev.type == "cuda"
    if on_card:
        log("  29 card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    for c in children.values():
        c.send("launches")
        c.expect("launches", 60)
    results, wall = run_gang(client.planner_client, "plane_xproc", MPI_RANKS)
    outs = guest_outputs(results, "29")
    check(sorted(o["host"] for o in outs) == sorted(
        h for h, k in PLANES_HOSTS.items() for _ in range(k)),
        "29: 4 ranks split 2 + 2 across the processes")
    check(all(o["active"] and o["plane"]["process_count"] == 2
              and o["plane"]["size"] == MPI_RANKS for o in outs),
          f"29: the plane activated on every rank over 2 processes "
          f"({[o.get('plane') for o in outs]})")
    check(len({o["plane"]["process_index"] for o in outs}) == 2,
          "29: the ranks' plane process indices split 2 + 2")
    for kind in ("allreduce", "allgather", "reduce_scatter"):
        check(all(o["int32"][kind] for o in outs),
              f"29: int32 {kind} on the plane across the processes bitwise "
              f"against the host ring and numpy")
    check(all(o["resident"] for o in outs),
          "29: the fp32 allreduce stayed on the device rung")
    check(all(o["copies"] == [0, 0] for o in outs),
          f"29: the resident fp32 allreduce of {elems:,} elements a rank "
          f"made zero host<->device copies ({[o['copies'] for o in outs]})")
    check(all(o["host_bytes"] == [0, 0] for o in outs),
          f"29: and put zero bytes on rings and bulk TCP "
          f"({[o['host_bytes'] for o in outs]})")
    check(all(o["ring_bitwise"] for o in outs),
          "29: the ring permute across the processes is bitwise its plain "
          "version")

    # The single-process plane on the same inputs, in this process
    ins = [torch.randn(elems, device=dev, generator=torch.Generator(
        device=dev).manual_seed(2900 + r)) for r in range(MPI_RANKS)]
    plane = DevicePlane(2929, [dev] * MPI_RANKS, range(MPI_RANKS), 0)
    single = run_ranks(MPI_RANKS, lambda r: plane.allreduce(
        r, ins[r], MpiOp.SUM))
    want = _digest(single[0])
    check(all(_digest(single[r]) == want for r in range(MPI_RANKS)),
          "29: the single-process plane's ranks agree")
    del single
    check(all(o["digest"] == want for o in outs),
          f"29: the cross-process fp32 allreduce ({elems * 4:,} bytes a "
          f"rank) is bitwise equal to the single-process plane's fold")
    launches: dict = {}
    for h, c in children.items():
        c.send("launches")
        got = c.expect("launches", 60)["launches"]
        if on_card:
            check(got.get("ring_permute", 0) == XPROC_ITERS + 1,
                  f"29: the ring kernel launched {got.get('ring_permute', 0)}"
                  f" times in the {h} process = one a ring round "
                  f"({XPROC_ITERS + 1})")
        for key, v in got.items():
            launches[key] = launches.get(key, 0) + v
    if on_card:
        def single_ms(fn):
            # As the guests time theirs: each rank thread's own events
            got = run_ranks(MPI_RANKS, lambda r: rank_event_ms(
                lambda: fn(r), XPROC_ITERS, dev)[1])
            return [t for r in range(MPI_RANKS) for t in got[r]]

        ar1 = single_ms(lambda r: plane.allreduce(r, ins[r], MpiOp.SUM))
        ring1 = single_ms(lambda r: plane.ring_permute(r, ins[r], 1))
        ar2 = [t for o in outs for t in o["allreduce_ms"]]
        ring2 = [t for o in outs for t in o["ring_ms"]]
        # One launch a process: each process's ranks report the same
        kern = {o["host"]: o["ring_kernel_ms"] for o in outs}
        kern2 = [t for h in sorted(kern) for t in kern[h]]
        check(len(kern2) == len(kern) * XPROC_ITERS,
              f"29: the ring kernel's own times came back, {XPROC_ITERS} "
              f"a process ({len(kern2)})")
        bound_ms = 2 * 2 * elems * 4 / HBM_BYTES_PER_S * 1e3
        log(f"  29 allreduce of {elems:,} fp32 a rank x {MPI_RANKS} ranks, "
            f"CUDA-event ms (median): across 2 processes "
            f"{np.median(ar2):.4f} (by rank, first to last: "
            + ", ".join(f"{t:.4f}" for t in ar2) + "); single-process "
            f"plane {np.median(ar1):.4f} (" + ", ".join(
                f"{t:.4f}" for t in ar1) + ")")
        log(f"  29 ring kernel across the processes, its launch alone "
            f"(2 shards of {elems:,} fp32 into a local output and a peer's "
            f"IPC window), CUDA-event ms (median): "
            f"{np.median(kern2):.4f} (by process: " + "; ".join(
                f"{h} " + ", ".join(f"{t:.4f}" for t in kern[h])
                for h in sorted(kern)) + f"); a launch reads "
            f"{2 * elems * 4:,} bytes and writes as many, bound "
            f"{bound_ms:.4f} ms")
        log(f"  29 ring hop round of {elems:,} fp32 a rank (a rank's "
            f"arrival to its result: rendezvous, the launch, syncs, "
            f"barriers, the copy-out), CUDA-event ms (median): across 2 "
            f"processes {np.median(ring2):.4f} (by rank: " + ", ".join(
                f"{t:.4f}" for t in ring2) + "); single-process plane "
            f"{np.median(ring1):.4f} (" + ", ".join(
                f"{t:.4f}" for t in ring1) + ")")
        log("  29 times: " + json.dumps({
            "elems": elems, "xproc_allreduce_ms": float(np.median(ar2)),
            "single_allreduce_ms": float(np.median(ar1)),
            "xproc_ring_kernel_ms": float(np.median(kern2)),
            "xproc_ring_kernel_bound_ms": bound_ms,
            "xproc_ring_ms": float(np.median(ring2)),
            "single_ring_ms": float(np.median(ring1))}))
    del ins, plane
    log(f"  29 gang through the planner: {wall:.1f} ms")
    return launches


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def worker_child(argv: list[str]) -> int:
    """``chip_smoke.py --worker-child <spec>``: one host of phase 26, a
    process of its own. ``spec`` is JSON: the host's name and slots, the
    planner's host, the model config, the per-rank batch shape, the steps
    a gang takes, the file of fp32 parameters every rank starts from, a
    directory for its reports and the device its guests run on. It loads
    the kernels this script built (it never builds them) and registers
    phase 22's guest (:func:`register_planes_guests`) while the planner
    starts; then it takes lines on its standard input and prints JSON
    lines. ``boot`` (once the planner serves) starts a ``WorkerRuntime``
    and prints ``ready`` with the top-level modules it loaded, the device
    plane's summary and the seconds its join took; ``report
    <plane>`` prints ``report``: its ranks' parameters after the gang's
    first step (written to a file), the digests of their final
    parameters, the kernel launches and plane bytes since the last
    report, and the lock-order detector's summary; ``restart <SHM_BULK>
    [<slots>]`` restarts the runtime under that value (a fresh broker, so
    fresh links), with ``slots`` slots when given, its ``ready`` line
    adding the seconds of the shutdown, of the plane's leave within it
    and of the boot; ``launches`` prints
    ``launches``: the kernel launches since the last report and the
    detector's summary. Phase 28's serving guest (phase 25's ``rst/serve``
    over ``spec["serve"]["cfg"]``, seeded as the parent's direct model)
    holds the first ``spec["serve"]["hold"]`` requests that reach this
    host and prints ``held`` for each. With ``FAABRIC_LOCKCHECK=1`` the
    process runs under the lock-order detector (installed before any
    module of the port loads); it exits 1 when the detector saw a
    held-before cycle. When its standard input closes it shuts the
    runtime down and prints ``stopped`` with the seconds of its plane's
    leave."""
    from faabric_tpu_torch.analysis import lockcheck

    lockcheck.install_from_env()

    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig, Transformer
    from faabric_tpu_torch.ops import _build
    from faabric_tpu_torch.runner import WorkerRuntime

    spec = json.loads(argv[0])
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.kernels()
    cfg = ModelConfig(**{**spec["cfg"], "compute_dtype": getattr(
        torch, spec["cfg"]["compute_dtype"])})
    start = torch.from_numpy(np.fromfile(spec["start"], np.float32)).to(dev)
    job = _planes_job(cfg, spec["per_rank"], spec["seq"])
    make = job["model"]
    job.update(model=lambda device: load_flat(make(device), start),
               steps=spec["steps"], broadcast=False, exact=False, world={},
               first={})
    register_planes_guests(job)
    register_xproc_guests({"elems": spec.get("xproc_elems", GRAD_ELEMS),
                           "seed": 2900})
    host = spec["host"]
    serve = spec["serve"]
    scfg = ModelConfig(**{**serve["cfg"], "compute_dtype": getattr(
        torch, serve["cfg"]["compute_dtype"])})

    def on_hold(msg_id, on_host):
        # One write, so that the line never interleaves with another
        sys.stdout.write(json.dumps({"held": msg_id, "host": on_host})
                         + "\n")
        sys.stdout.flush()

    register_restart_guests({
        "model": Transformer(scfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(serve["seed"])),
        "n_new": serve["n_new"], "lock": threading.Lock(), "held": {},
        "hold": serve["hold"], "all_held": threading.Event(),
        "release": threading.Event(), "on_hold": on_hold})

    def lockcheck_summary():
        return lockcheck.exit_summary() if lockcheck.installed() else None

    def boot():
        runtime = WorkerRuntime(host=host, slots=spec["slots"],
                                factory=TorchExecutorFactory(dev.type),
                                planner_host=spec["planner"],
                                device_plane_size=spec.get("plane", 0),
                                plane_devices=[dev])
        runtime.start()
        return runtime

    def ready_line(restart=None):
        from faabric_tpu_torch.parallel import current_plane, plane_summary

        print(json.dumps({"ready": True, "host": host,
                          "plane": (plane_summary() if current_plane()
                                    else None),
                          "plane_join_s": runtime.plane_join_s,
                          "restart": restart,
                          "modules": sorted({m.split(".")[0]
                                             for m in sys.modules})}),
              flush=True)

    runtime = None
    build_launches, bytes0 = dict(_build.LAUNCHES), plane_bytes()
    try:
        for line in sys.stdin:
            cmd, _, arg = line.strip().partition(" ")
            if cmd == "boot":
                runtime = boot()
                ready_line()
            elif cmd == "report":
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ranks = sorted(job["params"])
                path = os.path.join(spec["out"], f"{host}-{arg}.f32")
                with open(path, "wb") as f:
                    for r in ranks:
                        job["first"][r].cpu().numpy().tofile(f)
                moved = {k: v - bytes0[k] for k, v in plane_bytes().items()}
                launches = {k: v - build_launches.get(k, 0)
                            for k, v in _build.LAUNCHES.items()
                            if v != build_launches.get(k, 0)}
                print(json.dumps({
                    "report": arg, "host": host, "ranks": ranks,
                    "first": path, "final": {str(r): _digest(job["params"][r])
                                             for r in ranks},
                    "launches": launches, "bytes": moved,
                    "modules": sorted({m.split(".")[0]
                                       for m in sys.modules}),
                    "lockcheck": lockcheck_summary()}), flush=True)
                job["params"].clear()
                job["first"].clear()
                build_launches, bytes0 = dict(_build.LAUNCHES), plane_bytes()
            elif cmd == "launches":
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                launches = {k: v - build_launches.get(k, 0)
                            for k, v in _build.LAUNCHES.items()
                            if v != build_launches.get(k, 0)}
                print(json.dumps({"launches": launches, "host": host,
                                  "lockcheck": lockcheck_summary()}),
                      flush=True)
                build_launches = dict(_build.LAUNCHES)
            elif cmd == "restart":
                t0 = time.perf_counter()
                runtime.shutdown()
                restart = {"shutdown_s": time.perf_counter() - t0,
                           "plane_leave_s": runtime.plane_leave_s}
                shm_bulk, _, slots = arg.partition(" ")
                os.environ["SHM_BULK"] = shm_bulk
                if slots:
                    spec["slots"] = int(slots)
                t0 = time.perf_counter()
                runtime = boot()
                restart["boot_s"] = time.perf_counter() - t0
                ready_line(restart)
    finally:
        if runtime is not None:
            runtime.shutdown()
    print(json.dumps({"stopped": True, "plane_leave_s": (
        runtime.plane_leave_s if runtime is not None else None)}),
        flush=True)
    # Under the detector: the report line on standard error, and 1 for
    # a held-before cycle
    return lockcheck.finish()


# A host's HTTP endpoint port past its alias offset (phase 27): the
# services take 8003-8014 and MPI worlds 8020 up
HTTP_PORT = 8016


def _get(url: str, timeout: float = 60.0,
         tag: str = "27") -> tuple[bytes, float]:
    """One GET: (body, ms); fails phase ``tag`` unless it answers 200."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        body = resp.read()
        status = resp.status
    ms = (time.perf_counter() - t0) * 1e3
    check(status == 200, f"{tag}: GET {url} answers 200 ({status})")
    return body, ms


def _cli_out(main_fn, argv: list[str]) -> tuple[int, str]:
    """A CLI's ``main(argv)`` run in this process: (exit code, stdout)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    return rc, out.getvalue()


SURFACES = ("/metrics", "/trace", "/commmatrix", "/healthz", "/topology",
            "/profile", "/statemap", "/perf", "/timeseries", "/flight")


def scrape_phase(plane: str, base_url: str, worker_urls: dict, outs: list,
                 sent: dict, app_id: int, on_card: bool, work: str) -> None:
    """Phase 27: the telemetry surfaces of phase 26's live cluster, read
    after ``plane``'s steps and before its children stop. Every GET
    surface of the planner's endpoint answers and parses; ``/metrics``
    has rows of the planner and both hosts, and each host's bulk bytes
    there equal what its child reported (``sent``: host → plane bytes
    so far); ``/trace`` holds the three processes under three pids, the
    guests' MPI spans, cross-process flow pairs and remote-parent links;
    ``/commmatrix``'s cells on the plane run between the two hosts'
    ranks and their bytes equal the children's plane counters (and the
    matrix's Prometheus view is within 5% of its JSON); ``/healthz``
    lists both hosts with breaker rows and the journal; ``/topology``
    both hosts with their devices; ``/profile`` rows of each host; each
    worker's own ``/healthz`` and ``/metrics`` answer. Then the CLIs: the
    doctor against the live endpoint (exit 0, findings JSON), as a
    subprocess on the tcp plane and in this process on the shm plane,
    the doctor's ``--dir`` mode in this process over the sources
    dumped to files (the findings of the live view of the same
    sources), and ``timeline``, ``statemap``, ``profile`` and
    ``flightdump --url`` through their ``main``. Starts no process but
    the doctor's and checks no wall time; logs each surface's bytes and
    response time and the doctor's findings."""
    import re

    from faabric_tpu_torch.runner import (
        doctor,
        flightdump,
        profile,
        statemap,
        timeline,
    )

    begin_phase(27)
    tag = f"27 ({plane})"
    if on_card:
        log(f"  {tag} card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    hosts = list(PLANES_HOSTS)
    bodies: dict = {}
    sizes = []
    for path in SURFACES:
        body, ms = _get(base_url + path)
        bodies[path] = body.decode()
        sizes.append(f"{path} {len(body):,} B {ms:.1f} ms")
    log(f"  {tag} planner surfaces: " + "; ".join(sizes))
    docs = {p: json.loads(b) for p, b in bodies.items() if p != "/metrics"}

    # /metrics: Prometheus text, rows of every process
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? ([0-9.eE+-]+|\+Inf)$')
    rows = [ln for ln in bodies["/metrics"].splitlines()
            if ln and not ln.startswith("#")]
    bad = [ln for ln in rows if not sample_re.match(ln)]
    check(rows and not bad, f"{tag}: /metrics parses as Prometheus text "
          f"({len(rows)} samples; unparseable: {bad[:2]})")
    for h in ("planner", *hosts):
        check(any(f'host="{h}"' in ln for ln in rows),
              f"{tag}: /metrics has rows under host={h}")

    def host_sum(family: str, host: str, **labels) -> float:
        want = [f'host="{host}"'] + [f'{k}="{v}"' for k, v in labels.items()]
        return sum(float(ln.rsplit(" ", 1)[1]) for ln in rows
                   if ln.startswith(family + "{")
                   and all(w in ln for w in want))

    for h in hosts:
        for path in ("shm", "tcp"):
            got = host_sum("faabric_bulk_tx_bytes_total", h, path=path)
            check(got == sent[h][path],
                  f"{tag}: /metrics' {path} bytes of {h} ({got:,.0f}) equal "
                  f"what its child reported ({sent[h][path]:,.0f})")

    # /trace: three processes, MPI spans, flows and remote parents
    events = docs["/trace"]["traceEvents"]
    labels = {e["pid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    procs = {lab: pid for pid, lab in labels.items()}
    want = ["planner", *(f"worker-{h}" for h in hosts)]
    check(all(w in procs for w in want)
          and len({procs[w] for w in want}) == 3,
          f"{tag}: /trace merges the planner's and both hosts' spans under "
          f"three pids ({labels})")
    for h in hosts:
        n = sum(1 for e in events if e.get("pid") == procs[f"worker-{h}"]
                and e.get("cat") == "mpi" and e.get("ph") == "X")
        check(n > 0, f"{tag}: /trace holds {n} MPI spans of {h}'s guests")
    starts = {e["id"]: e["pid"] for e in events
              if e.get("ph") == "s" and e.get("cat") == "flow"}
    finishes: dict = {}
    for e in events:
        if e.get("ph") == "f" and e.get("cat") == "flow":
            finishes.setdefault(e["id"], set()).add(e["pid"])
    cross = sum(1 for fid, pid in starts.items()
                if any(p != pid for p in finishes.get(fid, ())))
    check(starts and cross >= 0.9 * len(starts),
          f"{tag}: {cross} of {len(starts)} remote sends' flows finish in "
          f"another process (at least 90%)")
    home = {e["args"]["span_id"]: e["pid"] for e in events
            if e.get("ph") == "X" and "span_id" in e.get("args", {})}
    linked = sum(1 for e in events if e.get("ph") == "X"
                 and e.get("args", {}).get("remote_parent")
                 and home.get(e["args"].get("parent_span_id"),
                              e["pid"]) != e["pid"])
    check(linked > 0, f"{tag}: {linked} spans link to a remote parent in "
          f"another process")

    # /commmatrix against the children's plane counters
    host_of = {str(o["rank"]): o["host"] for o in outs}
    mplane = {"shm": "shm", "tcp": "bulk-tcp"}[plane]
    cells = [c for h in hosts for c in docs["/commmatrix"]["hosts"].get(h, [])
             if c["plane"] == mplane]
    check(cells and all(host_of.get(c["src"]) != host_of.get(c["dst"])
                        and {host_of.get(c["src"]), host_of.get(c["dst"])}
                        <= set(hosts) for c in cells),
          f"{tag}: /commmatrix has {len(cells)} {mplane} cells, each between "
          f"the two hosts' ranks")
    m_bytes = sum(c["bytes"] for c in cells)
    c_bytes = sum(sent[h][plane] for h in hosts)
    check(m_bytes == c_bytes, f"{tag}: /commmatrix's {mplane} bytes "
          f"({m_bytes:,}) equal the children's plane counters "
          f"({c_bytes:,.0f})")
    all_cells = sum(c["bytes"] for h in hosts
                    for c in docs["/commmatrix"]["hosts"].get(h, []))
    prom = sum(host_sum("faabric_comm_bytes_total", h) for h in hosts)
    check(abs(prom - all_cells) <= 0.05 * all_cells,
          f"{tag}: /metrics' faabric_comm_bytes_total of the hosts "
          f"({prom:,.0f}) is within 5% of /commmatrix's ({all_cells:,})")

    # /healthz, /topology, /profile
    health = {r["host"]: r for r in docs["/healthz"]["hosts"]}
    check(all(h in health and health[h]["breaker"] for h in hosts)
          and "journal" in docs["/healthz"],
          f"{tag}: /healthz lists both hosts with breaker rows "
          f"({ {h: health.get(h, {}).get('breaker') for h in hosts} }) and "
          f"the journal")
    n_dev = torch.cuda.device_count() if on_card else 0
    topo = docs["/topology"]["hosts"]
    check(all(topo.get(h, {}).get("n_devices") == n_dev for h in hosts)
          and (not on_card or n_dev == 1),
          f"{tag}: /topology lists both hosts with n_devices {n_dev} "
          f"({topo})")
    prof_hosts = {r["host"] for r in docs["/profile"].get("stacks", [])}
    check(set(hosts) <= prof_hosts,
          f"{tag}: /profile has rows of each host ({sorted(prof_hosts)})")
    for key, path in (("keys", "/statemap"), ("links", "/perf"),
                      ("hosts", "/timeseries"), ("events", "/flight")):
        check(key in docs[path], f"{tag}: {path} parses ({key})")
    for h, url in worker_urls.items():
        body, ms = _get(url + "/healthz")
        hz = json.loads(body)
        mt, mms = _get(url + "/metrics")
        check(hz["status"] == "ok" and hz["host"] == h
              and b"faabric_process" in mt,
              f"{tag}: {h}'s own /healthz ({ms:.1f} ms) and /metrics "
              f"({len(mt):,} B, {mms:.1f} ms) answer")

    # The CLIs: the doctor as a subprocess on the last plane (its torch
    # import costs seconds on the card host, so once is enough), in this
    # process on the first; the others in this process
    t0 = time.perf_counter()
    if plane == "tcp":
        out = subprocess.run(
            [sys.executable, "-m", "faabric_tpu_torch.runner.doctor",
             "--url", base_url, "--json"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        rc, text, how = out.returncode, out.stdout, "as a subprocess"
        err = out.stderr[-500:]
    else:
        rc, text = _cli_out(doctor.main, ["--url", base_url, "--json"])
        how, err = "in this process", ""
    doctor_s = time.perf_counter() - t0
    check(rc == 0, f"{tag}: the doctor CLI against the live endpoint exits "
          f"0 {how} ({rc}; {err})")
    live_findings = json.loads(text)["findings"]
    shown = "; ".join(f"[{f['severity']}] {f['kind']}: {f['subject']}"
                      for f in live_findings[:8])
    log(f"  {tag} doctor --url {how} ({doctor_s:.1f} s, "
        f"{len(live_findings)} findings): {shown or 'none'}")
    ddir = os.path.join(work, f"doctor-{plane}")
    os.makedirs(ddir, exist_ok=True)
    for name in doctor.SOURCES:
        body = bodies[f"/{name}"]
        fname = "metrics.txt" if name == "metrics" else f"{name}.json"
        with open(os.path.join(ddir, fname), "w") as f:
            f.write(body)
    sources = {name: (doctor.parse_prometheus(bodies[f"/{name}"])
                      if name == "metrics" else docs[f"/{name}"])
               for name in doctor.SOURCES}
    rc, text = _cli_out(doctor.main, ["--dir", ddir, "--json"])
    dir_findings = json.loads(text)["findings"]
    check(rc == 0 and dir_findings == json.loads(json.dumps(
        doctor.diagnose(sources))),
          f"{tag}: the doctor's --dir mode over the dumped sources gives the "
          f"findings of the same sources read live ({len(dir_findings)})")
    # Each CLI exits 1 when its document is empty: phase 26's step uses
    # no state key, so the state map has no rows
    for name, main_fn, argv, want_rc in (
            ("timeline", timeline.main, [str(app_id), "--url", base_url], 0),
            ("statemap", statemap.main, ["--url", base_url],
             0 if docs["/statemap"]["keys"] else 1),
            ("profile", profile.main, ["--url", base_url, "--top", "5"], 0),
            ("flightdump", flightdump.main,
             ["--url", base_url, *(a for u in worker_urls.values()
                                   for a in ("--url", u)), "--last", "5"],
             0)):
        rc, text = _cli_out(main_fn, argv)
        check(rc == want_rc and text.strip(), f"{tag}: {name} prints a "
              f"rendering ({len(text):,} chars, exit code {rc})")
        log(f"  {tag} {name}: " + " | ".join(text.strip().splitlines()[:3]))

def _planner_scrape(base_url: str, family: str) -> float:
    """The sum of ``family``'s samples of the planner's own process in
    its endpoint's merged ``/metrics``."""
    body, _ms = _get(base_url + "/metrics", tag="28")
    return sum(float(ln.rsplit(" ", 1)[1])
               for ln in body.decode().splitlines()
               if ln.startswith(family + "{") and 'host="planner"' in ln)


def _s(x) -> str:
    return "none" if x is None else f"{x:.3f}"


def log_restarts(tag: str, readies: dict) -> None:
    """Each child's restart from its ``ready`` line: the shutdown with
    the device plane's leave within it, the boot with the plane's join
    (the planner's roster and the rendezvous with the other child)."""
    log(f"  {tag} restart (s): " + "; ".join(
        f"{h} shutdown {_s(r['restart']['shutdown_s'])} (plane leave "
        f"{_s(r['restart']['plane_leave_s'])}), boot "
        f"{_s(r['restart']['boot_s'])} (plane join {_s(r['plane_join_s'])})"
        for h, r in readies.items()))


def kill_phase(dev, children: dict, dead: list, client, base_url: str,
               serve_cfg, serve_len: int, n_new: int) -> dict:
    """Phase 28: a serving batch across phase 26's live worker processes,
    one of them SIGKILLed under it. The children restart with 4 slots
    each and serve phase 25's guest (``rst/serve``: ``serve_cfg``, seed
    0, ``serve_len``-token prompts, ``n_new`` greedy tokens); the one on
    ``mpi-host-b`` holds every request that reaches it. 8 requests go in
    one batch; once ``mpi-host-a``'s share returned and every request of
    ``mpi-host-b``'s share is held there, that child is SIGKILLed (and
    moved from ``children`` to ``dead``). The planner finds the loss by
    its host timeout (``PROCESS_HOST_TIMEOUT``) and requeues the share onto
    ``mpi-host-a``. Checked: the batch spread 4 + 4; all 8 results
    SUCCESS with the tokens of direct ``forward`` and ``generate``; the
    requeued ones ran on ``mpi-host-a`` and carry the ``rqu`` stamp; by
    the planner's scrape, ``faabric_planner_recovery_seconds`` counted
    one recovery more; the killed child exited -9; on the card,
    ``mpi-host-a``'s launches are the 8 requests' (every request ran
    once there) and its lock-order detector saw no cycle. Logs the kill
    to the last result, the recovery seconds and the launches; returns
    the launches."""
    from faabric_tpu_torch.models import Transformer, forward, generate
    from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
    from faabric_tpu_torch.telemetry.lifecycle import PHASE_REQUEUE

    log("phase 28: a worker process SIGKILLed under a serving batch")
    on_card = dev.type == "cuda"
    if on_card:
        log("  28 card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    host_a, host_b = list(PLANES_HOSTS)
    n_req, L = 8, serve_cfg.n_layers
    model = Transformer(serve_cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    prompts = np.random.RandomState(28).randint(
        0, serve_cfg.vocab_size, (n_req, serve_len)).astype(np.int32)
    direct = []
    with torch.inference_mode():
        for p in prompts:
            prompt = torch.as_tensor(p, device=dev)[None]
            scores = forward(model, prompt)[0].argmax(-1)
            tokens = generate(model, prompt, n_new)[0]
            direct.append(torch.cat([scores.to(torch.int32),
                                     tokens]).cpu().numpy())
    del model
    for c in children.values():
        c.send("restart 0 4")
    log_restarts("28", {h: c.expect("ready", 180)
                        for h, c in children.items()})
    # The launch counts of the batch start here
    for c in children.values():
        c.send("launches")
        c.expect("launches", 60)
    rec0 = _planner_scrape(base_url, "faabric_planner_recovery_seconds_count")
    rec_s0 = _planner_scrape(base_url, "faabric_planner_recovery_seconds_sum")
    req = batch_exec_factory("rst", "serve", n_req)
    for m, p in zip(req.messages, prompts):
        m.input_data = p.tobytes()
    pc = client.planner_client
    decision = pc.call_functions(req)
    by_id = dict(zip(decision.message_ids, decision.hosts))
    share = sorted(mid for mid, h in by_id.items() if h == host_b)
    check(len(share) == n_req // 2 and set(by_id.values()) == {host_a,
                                                                host_b},
          f"28: the batch spread {n_req - len(share)} + {len(share)} over "
          f"{host_a} and {host_b}")
    results = {mid: pc.get_message_result(req.app_id, mid, timeout=300)
               for mid, h in by_id.items() if h == host_a}
    held = set()
    while len(held) < len(share):
        got = children[host_b].expect("held", 300)
        held.add(got["held"])
    check(held == set(share), f"28: every request of {host_b}'s share ran "
          f"on {host_b} before the kill ({len(held)} held there)")
    victim = children.pop(host_b)
    dead.append(victim)
    t_kill = time.perf_counter()
    victim.proc.kill()
    rc = victim.proc.wait(60)
    check(rc == -9, f"28: the {host_b} child exited -9 on SIGKILL ({rc})")
    for mid in share:
        results[mid] = pc.get_message_result(req.app_id, mid, timeout=300)
    kill_s = time.perf_counter() - t_kill
    ordered = [results[m.id] for m in req.messages]
    check(all(r.return_value == int(ReturnValue.SUCCESS)
              and np.array_equal(np.frombuffer(r.output_data, np.int32), d)
              for r, d in zip(ordered, direct)),
          "28: all 8 results SUCCESS, tokens equal to direct forward and "
          "generate")
    moved = [results[mid] for mid in share]
    check(all(r.executed_host == host_a and PHASE_REQUEUE in r.lc
              for r in moved),
          f"28: the {len(share)} requeued requests ran on {host_a} and "
          f"carry the rqu stamp ("
          f"{[(r.executed_host, PHASE_REQUEUE in r.lc) for r in moved]})")
    rec = _planner_scrape(base_url,
                          "faabric_planner_recovery_seconds_count") - rec0
    rec_s = _planner_scrape(base_url,
                            "faabric_planner_recovery_seconds_sum") - rec_s0
    check(rec == 1, f"28: the planner's faabric_planner_recovery_seconds "
          f"count rose by 1 in its scrape ({rec:g})")
    children[host_a].send("launches")
    rep = children[host_a].expect("launches", 60)
    got = rep["launches"]
    if on_card:
        want = {"flash_attention": n_req * L,
                "rms_norm": n_req * (2 * L + 1) * (1 + n_new)}
        for name, count in want.items():
            check(got.get(name, 0) == count,
                  f"28: {name} launched {got.get(name, 0)} times in the "
                  f"{host_a} process = the 8 requests' {count}")
    lc = rep["lockcheck"]
    check(lc is not None and lc["cycles"] == [],
          f"28: the {host_a} process's lock-order detector saw no "
          f"held-before cycle ({lc and lc['cycles']})")
    log(f"  28 SIGKILL to the last result {kill_s:.3f} s with a "
        f"{PROCESS_HOST_TIMEOUT:g} s host timeout; recovery seconds "
        f"(detection to re-dispatch, the planner's histogram) "
        f"{rec_s:.3f}; launches in "
        f"the {host_a} process {got}")
    return got


def processes_phase(dev, build, keep: dict, cfg=None, per_rank: int = 2,
                    seq: int = 512, steps: int = 3, base: int | None = None,
                    child_argv: list[str] | None = None, serve_cfg=None,
                    serve_len: int = 512, n_new: int = 32,
                    xproc_elems: int = GRAD_ELEMS,
                    parts: tuple = ("26", "29", "28")) -> dict:
    """Phase 26: phase 22's two-host step with its hosts as OS
    processes. The planner is ``python -m faabric_tpu_torch.runner
    planner`` and ``mpi-host-a`` and ``mpi-host-b`` are ``chip_smoke.py
    --worker-child`` processes (:func:`worker_child`; ``child_argv``
    replaces that command line), each a ``WorkerRuntime`` of 2 slots
    whose guests run on ``dev``; this process is a 0-slot client host
    that submits the 4-rank gang (2 + 2) of :func:`register_planes_guests`'
    step, ``steps`` steps at ``cfg``'s width, from the flat parameters
    phase 22 started from (``keep["start"]``, handed over in a file).
    First on the shm rings, now crossing a process boundary, then on bulk
    TCP (the children restarted under ``SHM_BULK=0``). For each plane:
    the ranks split 2 + 2 and took the flat ring; each child's ranks'
    parameters after the first step are bitwise equal to phase 22's one
    step on the same plane from the same start (``keep["shm"]``,
    ``keep["tcp"]``), and the four ranks' final parameters are bitwise
    equal to each other; the children's bytes went on the plane's path
    alone; their kernel launches are 2 ranks' steps each (on the card),
    every flash forward on ``wgmma``; no child loaded JAX or the JAX
    package. Logs each child's spawn to ready, each rank's first step
    and the median of the others against phase 22's in-process step, and
    the bytes on rings and TCP. The planner serves its REST endpoint
    (``--http-port``) and each child its worker endpoint
    (``WORKER_HTTP_PORT``), each at its offset plus ``HTTP_PORT``, and
    every process traces: after each plane's steps, before its children
    stop, phase 27 (:func:`scrape_phase`) reads the live cluster through
    them. The children run under the lock-order detector
    (``FAABRIC_LOCKCHECK=1``): each report carries its summary, any
    held-before cycle fails the phase, and the same-site nestings,
    blocking sites and longest holds are logged. The planner's host
    timeout is ``PROCESS_HOST_TIMEOUT``. After phase 27's scrape of bulk TCP,
    phase 28 (:func:`kill_phase`) SIGKILLs ``mpi-host-b``'s child under
    a serving batch of ``serve_cfg`` (``ModelConfig()`` at 2 layers by
    default). The children join a 2-process device plane through the
    planner at boot (and again at each restart); the steps above keep to
    the host planes they name, since nothing activates the plane on its
    own. Before phase 28, phase 29 (:func:`xproc_phase`) runs a gang on
    that plane at ``xproc_elems`` fp32 a rank. ``parts`` picks phases
    26 (with 27), 29 and 28. Every child is stopped, and killed if it
    does not stop, before the phase returns. Returns the children's
    launches, phases 28's and 29's included."""
    import queue
    import signal
    import statistics

    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.runner import WorkerRuntime
    from faabric_tpu_torch.transport import (
        clear_host_aliases,
        register_host_alias,
    )

    log("phase 26: the two-host step with its hosts as processes")
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card:
        log("  26 card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    cfg = cfg or ModelConfig()
    serve_cfg = serve_cfg or dataclasses.replace(ModelConfig(), n_layers=2)
    n = MPI_RANKS
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                "rms_norm": 4 * cfg.n_layers + 1}
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase26-", dir=os.path.join(here,
                                                                "build"))
    base = random_port_base() if base is None else base
    planner_host, client_host = "proc-planner", "proc-client"
    offsets = {planner_host: base, client_host: base + 2500}
    for i, h in enumerate(PLANES_HOSTS):
        offsets[h] = base + 1000 * (i + 1)
    wait_ports_free(base, label="26")
    for h, off in offsets.items():
        if h != planner_host:
            wait_ports_free(off, label="26", ports=worker_ports())
        if h != client_host:
            wait_ports_free(off, label="26", ports=(HTTP_PORT,))
    env = {"FAABRIC_HOST_ALIASES": ",".join(
        f"{h}=127.0.0.1+{o}" for h, o in offsets.items()), "SHM_BULK": "1",
        "FAABRIC_TRACING": "1"}
    base_url = f"http://127.0.0.1:{base + HTTP_PORT}"
    worker_urls = {h: f"http://127.0.0.1:{offsets[h] + HTTP_PORT}"
                   for h in PLANES_HOSTS}
    sent = {h: {"shm": 0.0, "tcp": 0.0} for h in PLANES_HOSTS}
    start_path = os.path.join(work, "start.f32")
    keep["start"].cpu().numpy().tofile(start_path)
    cfg_spec = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if f.name not in ("compute_dtype", "param_dtype")}
    cfg_spec["compute_dtype"] = str(cfg.compute_dtype).split(".")[-1]
    serve_spec = {f.name: getattr(serve_cfg, f.name)
                  for f in dataclasses.fields(serve_cfg)
                  if f.name not in ("compute_dtype", "param_dtype")}
    serve_spec["compute_dtype"] = str(serve_cfg.compute_dtype).split(".")[-1]
    check(cfg.param_dtype == torch.float32, "26: fp32 parameters")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    argv = child_argv or [sys.executable, os.path.abspath(__file__),
                          "--worker-child"]
    planner = None
    children: dict = {}
    dead: list = []
    client = None
    path: dict = {}
    plog = open(os.path.join(work, "planner.log"), "ab")
    try:
        # The planner, through the port's deployment entry point, and the
        # worker hosts, which load while it starts and boot once it serves
        t0 = time.perf_counter()
        planner = subprocess.Popen(
            [sys.executable, "-m", "faabric_tpu_torch.runner", "planner",
             "--port-offset", str(base), "--http-port",
             str(base + HTTP_PORT)], cwd=here, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            env={**os.environ, **env,
                 "PLANNER_HOST_TIMEOUT": str(PROCESS_HOST_TIMEOUT)})
        up: queue.Queue = queue.Queue()

        def read_planner():
            for line in planner.stderr:
                plog.write(line)
                plog.flush()
                if b"Planner up" in line:
                    up.put(True)
            up.put(False)

        threading.Thread(target=read_planner, name="26/planner-log",
                         daemon=True).start()
        for h, slots in PLANES_HOSTS.items():
            spec = {"host": h, "slots": slots, "planner": planner_host,
                    "cfg": cfg_spec, "per_rank": per_rank, "seq": seq,
                    "steps": steps, "start": start_path, "out": work,
                    "device": str(dev), "plane": len(PLANES_HOSTS),
                    "xproc_elems": xproc_elems,
                    "serve": {"cfg": serve_spec, "n_new": n_new, "seed": 0,
                              "hold": 0 if h == "mpi-host-a" else 4}}
            children[h] = JsonChild(
                [*argv, json.dumps(spec)],
                {**env, "WORKER_HTTP_PORT": str(offsets[h] + HTTP_PORT),
                 "FAABRIC_LOCKCHECK": "1"},
                os.path.join(work, f"{h}.log"), f"26: the {h} child")
        try:
            served = up.get(timeout=180)
        except queue.Empty:
            served = False
        check(served, f"26: the planner process serves (exit code "
              f"{planner.poll()}; log {os.path.join(work, 'planner.log')})")
        planner_s = time.perf_counter() - t0
        for c in children.values():
            c.send("boot")
        spawn_s, joins = {}, {}
        for h, c in children.items():
            ready = c.expect("ready", 180)
            spawn_s[h] = time.perf_counter() - c.t_spawn
            joins[h] = ready["plane_join_s"]
            bad = sorted(set(ready["modules"])
                         & {"jax", "jaxlib", "faabric_tpu", "tests"})
            check(not bad and "faabric_tpu_torch" in ready["modules"],
                  f"26: the {h} child loaded the port and nothing of JAX or "
                  f"the JAX package ({bad})")
            plane = ready["plane"] or {}
            check(plane.get("process_count") == len(PLANES_HOSTS)
                  and plane.get("local_devices") == 1,
                  f"26: the {h} child joined the {len(PLANES_HOSTS)}-process "
                  f"device plane at boot ({plane})")
        log("  26 spawn to ready (s): planner " f"{planner_s:.3f}, "
            + ", ".join(f"{h} {t:.3f}" for h, t in spawn_s.items())
            + "; the device plane's join within it: " + ", ".join(
                f"{h} {_s(r)}" for h, r in joins.items()))
        for h, off in offsets.items():
            register_host_alias(h, "127.0.0.1", off)
        client = WorkerRuntime(host=client_host, slots=0,
                               factory=TorchExecutorFactory(dev.type),
                               planner_host=planner_host)
        client.start()
        for plane in ("shm", "tcp") if "26" in parts else ():
            if plane == "tcp":
                for c in children.values():
                    c.send("restart 0")
                log_restarts("26 (tcp)", {h: c.expect("ready", 180)
                                          for h, c in children.items()})
            results, wall = run_gang(client.planner_client, "planes_step", n)
            outs = guest_outputs(results, f"26 ({plane})")
            check(sorted(o["host"] for o in outs) == sorted(
                h for h, k in PLANES_HOSTS.items() for _ in range(k)),
                f"26 ({plane}): 4 ranks split 2 + 2 across the processes")
            check(all(o["rungs"].get("allreduce") == "ring" for o in outs),
                  f"26 ({plane}): the gradient allreduce took the flat ring")
            for c in children.values():
                c.send(f"report {plane}")
            reports = {h: c.expect("report", 300)
                       for h, c in children.items()}
            want = keep[plane].cpu()
            finals = set()
            moved = {"shm": 0.0, "tcp": 0.0}
            for h, rep in reports.items():
                flat = torch.from_numpy(np.fromfile(rep["first"], np.float32))
                os.remove(rep["first"])
                flat = flat.view(len(rep["ranks"]), -1)
                for r, got in zip(rep["ranks"], flat):
                    same = torch.equal(got, want)
                    diff = 0.0 if same else float((got - want).abs().max())
                    check(same, f"26 ({plane}): rank {r}'s parameters "
                          f"after the first step in the {h} process are "
                          f"bitwise equal to phase 22's in-process step "
                          f"(max |diff| {diff:.6g})")
                finals |= set(rep["final"].values())
                for k in moved:
                    moved[k] += rep["bytes"][k]
                    sent[h][k] += rep["bytes"][k]
                bad = sorted(set(rep["modules"])
                             & {"jax", "jaxlib", "faabric_tpu", "tests"})
                check(not bad, f"26 ({plane}): the {h} child loaded nothing "
                      f"of JAX or the JAX package ({bad})")
                lc = rep["lockcheck"]
                check(lc is not None and lc["cycles"] == [],
                      f"26 ({plane}): the {h} process ran under the "
                      f"lock-order detector ({lc and lc['sites']} sites, "
                      f"{lc and lc['edges']} held-before edges) and saw no "
                      f"cycle ({lc and lc['cycles']})")
                log(f"  26 ({plane}) {h} lockcheck: same-site nestings "
                    f"{lc['same_site_nesting']}; blocking sites "
                    + "; ".join(f"{b['call']} x{b['n']} holding "
                                f"{b['held']}" for b in lc["blocking"])
                    + "; longest holds " + "; ".join(
                        f"{x['site']} {x['max_s'] * 1e3:.2f} ms"
                        for x in lc["longest_holds"]))
                got = rep["launches"]
                if on_card:
                    for name, count in per_step.items():
                        check(got.get(name, 0) == count * 2 * steps,
                              f"26 ({plane}): {name} launched "
                              f"{got.get(name, 0)} times in the {h} process "
                              f"= {count} a step x 2 ranks x {steps} steps")
                    check(got.get("flash_attention.wgmma", 0)
                          == got.get("flash_attention", -1),
                          f"26 ({plane}): every flash forward in the {h} "
                          f"process took the wgmma body")
                for k, v in got.items():
                    path[k] = path.get(k, 0) + v
            check(len(finals) == 1, f"26 ({plane}): the 4 ranks' parameters "
                  f"after {steps} steps are bitwise equal across the "
                  f"processes ({len(finals)} digests)")
            if plane == "shm":
                check(moved["shm"] > 0 and moved["tcp"] == 0,
                      f"26 (shm): the children put {moved['shm']:,.0f} bytes "
                      f"on rings and {moved['tcp']:,.0f} on bulk TCP")
            else:
                check(moved["tcp"] > 0 and moved["shm"] == 0,
                      f"26 (tcp): the children put {moved['tcp']:,.0f} bytes "
                      f"on bulk TCP and {moved['shm']:,.0f} on rings")
            ref = keep["step_ms"][plane]
            log(f"  26 ({plane}) first step ms by rank: "
                + ", ".join(f"{o['step_ms'][0]:.1f}" for o in outs)
                + "; median of steps 2-" f"{steps} by rank: "
                + ", ".join(f"{statistics.median(o['step_ms'][1:]):.1f}"
                            for o in outs)
                + "; phase 22's in-process step by rank: "
                + ", ".join(f"{ref[o['rank']][0]:.1f}" for o in outs)
                + f"; {wall:.1f} ms through the planner")
            log(f"  26 ({plane}) bytes the children sent: rings "
                f"{moved['shm']:,.0f}, bulk TCP {moved['tcp']:,.0f}; launches "
                + "; ".join(f"{h} {rep['launches']}"
                            for h, rep in reports.items()))
            # -- 27. the live cluster's telemetry surfaces ----------------
            scrape_phase(plane, base_url, worker_urls, outs, sent,
                         results[0].app_id, on_card, work)
            if plane == "shm":
                begin_phase(26)
        # -- 29. the device plane across the worker processes -------------
        if "29" in parts:
            begin_phase(29)
            for k, v in xproc_phase(dev, children, client,
                                    elems=xproc_elems).items():
                path[k] = path.get(k, 0) + v
        # -- 28. a worker process SIGKILLed under a serving batch ---------
        if "28" in parts:
            begin_phase(28)
            for k, v in kill_phase(dev, children, dead, client, base_url,
                                   serve_cfg, serve_len, n_new).items():
                path[k] = path.get(k, 0) + v
        begin_phase(26)
    finally:
        try:
            if client is not None:
                client.shutdown()
            for h, c in list(children.items()):
                left = c.stop()["plane_leave_s"]
                log(f"  26 the {h} child left the device plane in "
                    f"{_s(left)} s at its stop")
            if planner is not None and planner.poll() is None:
                planner.send_signal(signal.SIGTERM)
                check(planner.wait(60) == 0,
                      "26: the planner process stopped on SIGTERM with 0")
        finally:
            for c in [*children.values(), *dead]:
                c.kill()
            if planner is not None and planner.poll() is None:
                planner.kill()
                planner.wait(60)
            plog.close()
            clear_host_aliases()
            shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 26 launches: {path}")
    log(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return path


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if (sys.argv[1:2] == ["--planner-child"]
            and os.path.isdir(os.path.join(here, "faabric_tpu_torch"))):
        # Phase 25's planner process: host code, which needs no card
        sys.path.insert(0, here)
        return planner_child(sys.argv[2:])
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
    if sys.argv[1:2] == ["--telemetry-steps"]:
        # Phase 23d's child: 23b's steps under the knobs it was given
        print(json.dumps(telemetry_steps(int(sys.argv[2]))), flush=True)
        return 0
    if sys.argv[1:2] == ["--worker-child"]:
        # Phase 26's worker hosts
        return worker_child(sys.argv[2:])
    # Arm the fault registry before the port loads (an inert rule on a
    # point nothing fires): its call sites keep live handles, and phase
    # 23's install_faults arms them
    os.environ.setdefault("FAABRIC_FAULTS", "chip_smoke.armed=delay:0")

    from faabric_tpu_torch.data import DataLoader, TokenDataset
    from faabric_tpu_torch.models import (
        ModelConfig,
        Transformer,
        evaluate_perplexity,
        forward,
        forward_with_cache,
        generate,
        init_kv_cache,
        init_train_state,
        loss_fn,
        make_optimizer,
        make_train_step,
        restore_train_state,
        save_train_state,
    )
    from faabric_tpu_torch.ops import _build
    from faabric_tpu_torch.ops.flash_attention import (
        _bwd_body,
        _fwd_body,
        _kernel_flash,
        _kernel_flash_bwd_dkv,
        _kernel_flash_bwd_dq,
        _reference_attention,
        _reference_bwd_dkv,
        _reference_bwd_dq_with_delta,
        _reference_flash_bwd,
        _reference_lse,
        flash_attention,
        flash_attention_with_lse,
    )
    from faabric_tpu_torch.ops.rms_norm import _reference_rms_norm, rms_norm
    from faabric_tpu_torch.util.device import resolve_device

    begin_phase(1)
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
    begin_phase(2)
    t0 = time.perf_counter()
    _build.kernels()
    log(f"kernel build seconds: {time.perf_counter() - t0:.1f}")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs: dict[str, float] = {}

    # -- 3. RMS kernel against its plain version -----------------------------
    begin_phase(3)
    log("phase 3: rms_norm kernel vs plain")
    # (512, 512) and (1, 512): the faabric phase's scoring forward and
    # each of its decode steps; (1024, 512): each DDP rank's 2 x 512 rows
    # in phase 17 (bf16 steps and the fp32 step). Phase 18's sharded
    # decode (dp 2): a
    # rank's 2 rows a step, its (2, 128) whole prefill, its chunked
    # prefill's (2, 48) and (2, 32); the unsharded yardstick's (4, 1)
    # steps and its (4, 512) perplexity batches. Phase 20's steps run
    # (4096, 512) and its scorings (512, 512); phase 21's threads
    # (1024, 512), its scorings (512, 512); phases 22-23's ranks
    # (1024, 512); phase 24's ranks (1024, 512), its spot scorings
    # (2048, 512), its served requests (512, 512) and (1, 512)
    for rows, d in [(4096, 512), (8, 512), (333, 512), (512, 512), (1, 512),
                    (1024, 512), (2, 512), (256, 512), (96, 512), (64, 512),
                    (4, 512), (2048, 512)]:
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
    begin_phase(4)
    log("phase 4: flash attention kernel vs plain")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # views: q, k, v as views of one (B, S, 3, H, 64) product, as the
    # model passes them; (1, 512) is the faabric phase's scoring forward,
    # (2, 512, 8 heads) and (4, 512, 4 heads) each rank's attention in the
    # MoE steps of phase 16 (dp 4 x ep 2; dp 2 x tp 2 x ep 2); in fp32,
    # (2, 512, 2 heads) each rank's attention in phase 18's sharded
    # perplexity (dp 2 x tp 4) and (4, 512, 8 heads) its unsharded
    # yardstick's; phase 20's steps run (8, 512, 8 heads) and its
    # scorings (1, 512, 8 heads); phase 21's threads (2, 512, 8 heads),
    # its scorings (1, 512, 8 heads); phases 22-23's ranks (2, 512, 8
    # heads); phase 24's ranks (2, 512, 8 heads), its spot scorings
    # (1, 2048, 8 heads) and its served requests (1, 512, 8 heads), as
    # QKV views
    for b, s_q, s_k, h, causal, dtype, views in [
            (8, 512, 512, 8, True, torch.bfloat16, False),
            (8, 128, 512, 8, True, torch.bfloat16, False),
            (8, 512, 512, 8, False, torch.bfloat16, False),
            (8, 448, 512, 8, True, torch.bfloat16, False),
            (8, 500, 530, 8, False, torch.bfloat16, False),
            (8, 512, 512, 8, True, torch.float32, False),
            (1, 2048, 2048, 8, True, torch.bfloat16, False),
            (1, 2048, 2048, 8, True, torch.bfloat16, True),
            (1, 512, 512, 8, True, torch.bfloat16, False),
            (1, 512, 512, 8, True, torch.bfloat16, True),
            (2, 512, 512, 8, True, torch.bfloat16, False),
            (2, 512, 512, 8, True, torch.bfloat16, True),
            (4, 512, 512, 4, True, torch.bfloat16, False),
            (4, 512, 512, 4, True, torch.bfloat16, True),
            (2, 512, 512, 2, True, torch.float32, False),
            (2, 512, 512, 2, True, torch.float32, True),
            (4, 512, 512, 8, True, torch.float32, False)]:
        if views:
            q, k, v = torch.randn(b, s_q, 3, h, 64, device=dev,
                                  generator=gen).to(dtype).unbind(2)
        else:
            q, k, v = (torch.randn(b, s, h, 64, device=dev, generator=gen
                                   ).to(dtype) for s in (s_q, s_k, s_k))
        # Keys a softmax step of the wgmma body covers, as its launcher
        # picks them: 128 where the grid has at most two CTAs a SM
        keys = 128 if b * h * -(-s_q // 64) <= 2 * sms else 64
        body = _fwd_body(q, k, v)
        before = _build.LAUNCHES[f"flash_attention.{body}"]
        out, lse = flash_attention_with_lse(q, k, v, causal)
        torch.cuda.synchronize()
        err_o = max_err(out, _reference_attention(q, k, v, causal))
        err_l = max_err(lse, _reference_lse(q, k, causal))
        if (b, s_q, s_k, causal, dtype) == (8, 512, 512, True, torch.bfloat16):
            errs["flash_attention"] = max(err_o, err_l)
        label = (f"flash ({b}, {s_q}/{s_k}, {h}, 64) causal={causal} {dtype}"
                 f"{' qkv views' if views else ''} keys/step {keys}")
        if dtype == torch.bfloat16:
            check(body == "wgmma" and _build.LAUNCHES[
                "flash_attention.wgmma"] == before + 1,
                  f"{label}: took the wgmma body")
        check(err_o <= FLASH_ATOL[dtype] and err_l <= FLASH_ATOL[dtype],
              f"{label} [{body}]: max |err| O {err_o:.3g} lse {err_l:.3g}")

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
    begin_phase(5)
    log("phase 5: full-width forward")
    for name in ("rms_norm", "flash_attention"):
        check(launches.get(name, 0) > 0, f"main path launched {name} "
              f"{launches.get(name, 0)} times")
    check(launches.get("flash_attention.wgmma", 0)
          == launches["flash_attention"],
          f"every flash forward launch on the serving path took the wgmma "
          f"body ({launches.get('flash_attention.wgmma', 0)} of "
          f"{launches['flash_attention']})")
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

    begin_phase(6)
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
    begin_phase(7)
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

    # The forward at the serving shape and at 1 x 2048: the wgmma body
    # the path takes, the mma body on the same tensors, the plain
    # version, SDPA and the bound
    fl_times = {}
    for b, s in ((8, 512), (1, 2048)):
        q, k, v = (torch.randn(b, s, 8, 64, device=dev, generator=gen
                               ).to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        t = {"ms": time_ms(lambda: _kernel_flash(q, k, v, True, "wgmma")),
             "mma_ms": time_ms(lambda: _kernel_flash(q, k, v, True, "mma")),
             "plain_ms": time_ms(lambda: _reference_attention(q, k, v, True)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True))}
        pairs = b * 8 * s * (s + 1) // 2     # visible (query, key) pairs
        # q, k, v read and O written in bf16, lse written in fp32; Q.K^T
        # and P.V
        fl_times[(b, s)] = t, {
            "bytes": (4 * q.numel() * 2 + b * 8 * s * 4)
            / HBM_BYTES_PER_S * 1e3,
            "operations": 4 * 64 * pairs / BF16_FLOP_PER_S * 1e3}
    fl, fl_bounds = fl_times[(8, 512)]

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
    for (b, s), (t, bounds) in fl_times.items():
        log(f"flash ({b}, {s}, 8, 64) bf16 causal: wgmma body {t['ms']:.5f} "
            f"ms, mma body {t['mma_ms']:.5f} ms ({t['mma_ms'] / t['ms']:.2f}x),"
            f" plain {t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.5f} ms "
            f"(wgmma / sdpa {t['ms'] / t['library_ms']:.3f}), bound "
            f"{max(bounds.values()):.5f} ms ({max(bounds, key=bounds.get)}; "
            f"bytes {bounds['bytes']:.5f}, products {bounds['operations']:.5f})")
    log(f"forward 8x512: {fwd_ms:.3f} ms host, {fwd_dev_ms:.3f} ms as a graph, "
        f"{8 * 512 / fwd_ms * 1e3:.0f} tokens/s")
    log(f"forward 1x2048: {long_ms:.3f} ms host")
    log(f"generate 8x512 + {n_new}: {gen_ms:.1f} ms; decode "
        f"{decode_ms:.3f} ms/token-step (8 sequences)")
    log(f"peak memory on the main path: {peak_gib:.3f} GiB")


    # -- 8. backward kernels against their plain version ---------------------
    begin_phase(8)
    log("phase 8: flash backward kernels (dQ with delta, dK/dV) vs plain")

    def bwd_inputs(b, s_q, s_k, h, d, causal, dtype, g_lse=False,
                   strided=False):
        """q, k, v (views of one QKV product when ``strided``), a
        cotangent, the forward kernel's O and lse, and the lse's cotangent
        (None unless ``g_lse``)."""
        if strided:
            qkv = torch.randn(b, s_q, 3, h, d, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn(b, s, h, d, device=dev, generator=gen
                                   ).to(dtype) for s in (s_q, s_k, s_k))
        do = torch.randn(b, s_q, h, d, device=dev, generator=gen).to(dtype)
        with torch.no_grad():
            out, lse = flash_attention_with_lse(q, k, v, causal)
        g = (torch.randn(b * h, s_q, device=dev, generator=gen)
             if g_lse else None)
        return q, k, v, do, out, lse, g

    def bwd_kernels(q, k, v, do, out, lse, g, causal):
        dq, delta = _kernel_flash_bwd_dq(q, k, v, do, out, lse, g, causal)
        return (dq, *_kernel_flash_bwd_dkv(q, k, v, do, lse, delta, causal),
                delta)

    # (2, 512, 8 heads) and (4, 512, 4 heads): each rank's attention in
    # the MoE train steps of phase 16 (dp 4 x ep 2; dp 2 x tp 2 x ep 2)
    # and each thread's step of phase 21, each rank's step of phases
    # 22-23; (8, 512, 8 heads) also phase 20's steps
    bwd_cases = [(b, s_q, s_k, h, d, causal, dtype, g_lse, strided)
                 for dtype in (torch.bfloat16, torch.float32)
                 for b, s_q, s_k, h, d, causal, g_lse, strided in [
                     (8, 512, 512, 8, 64, True, False, False),
                     (8, 512, 512, 8, 64, False, False, False),
                     (8, 128, 512, 8, 64, True, False, False),
                     (2, 100, 157, 8, 64, True, False, False),
                     (2, 100, 157, 2, 32, True, False, False),
                     (1, 2048, 2048, 8, 64, True, False, False),
                     (8, 512, 512, 8, 64, True, True, False),
                     (8, 512, 512, 8, 64, True, False, True),
                     (2, 512, 512, 8, 64, True, False, False),
                     (2, 512, 512, 8, 64, True, False, True),
                     (4, 512, 512, 4, 64, True, False, False),
                     (4, 512, 512, 4, 64, True, False, True)]]
    for b, s_q, s_k, h, d, causal, dtype, g_lse, strided in bwd_cases:
        ins = bwd_inputs(b, s_q, s_k, h, d, causal, dtype, g_lse, strided)
        q, k, v, do, out, lse, g = ins
        body = _bwd_body(q, k, v, do, out)
        before = dict(_build.LAUNCHES)
        *got, delta = bwd_kernels(*ins, causal)
        again = bwd_kernels(*ins, causal)
        torch.cuda.synchronize()
        grew = {n: _build.LAUNCHES[n] - before.get(n, 0)
                for n in (f"flash_bwd_dq.{body}", f"flash_bwd_dkv.{body}")}
        dq_r, delta_r = _reference_bwd_dq_with_delta(q, k, v, do, out, lse,
                                                     g, causal)
        want = (dq_r, *_reference_bwd_dkv(q, k, v, do, lse, delta_r, causal))
        f32 = _reference_flash_bwd(q.float(), k.float(), v.float(),
                                   do.float(), lse, delta_r, causal)
        label = (f"({b}, {s_q}/{s_k}, {q.shape[2]}, {d}) causal={causal} "
                 f"{str(dtype)[6:]}{' g_lse' if g_lse else ''}"
                 f"{' strided' if strided else ''} [{body}]")
        if dtype == torch.bfloat16 and d == 64:
            check(body == "wgmma" and all(n == 2 for n in grew.values()),
                  f"{label}: both passes took the wgmma body ({grew})")
        check(all(torch.equal(x, y) for x, y in zip((*got, delta), again)),
              f"{label}: a second call repeats dq, dk, dv and delta bitwise")
        err_d = max_err(delta, delta_r)
        check(bool(((delta - delta_r).abs()
                    <= 1e-5 + 1e-5 * delta_r.abs()).all()),
              f"{label}: delta vs _row_correction max |err| {err_d:.3g}")
        e = [close_or_as_close(gt, w, y, f"{n} {label}")
             for n, gt, w, y in zip(("dq", "dk", "dv"), got, want, f32)]
        if (b, s_q, causal, dtype, g_lse, strided) == (
                8, 512, True, torch.bfloat16, False, False):
            errs["flash_bwd_dq"], errs["flash_bwd_dkv"] = e[0], max(e[1:])
        del ins, got, again, want, f32

    # The whole Function (forward kernel, delta, both backward kernels)
    # against autograd through the plain attention and lse
    base = [torch.randn(8, 512, 8, 64, device=dev, generator=gen)
            for _ in range(3)]
    g_out = torch.randn(8, 512, 8, 64, device=dev, generator=gen)
    g_lse = torch.randn(64, 512, device=dev, generator=gen)

    def attn_grads(fn, dtype, with_lse):
        ts = [t.to(dtype).requires_grad_() for t in base]
        out, lse = fn(*ts)
        loss = (out.float() * g_out).sum()
        if with_lse:
            loss = loss + (lse * g_lse).sum()
        return torch.autograd.grad(loss, ts)

    def plain_attn(q, k, v):
        return _reference_attention(q, k, v), _reference_lse(q, k, True)

    for with_lse in (False, True):
        def kernel_attn(q, k, v):
            if with_lse:
                return flash_attention_with_lse(q, k, v)
            return flash_attention(q, k, v), None

        f32 = attn_grads(plain_attn, torch.float32, with_lse)
        for dtype in (torch.float32, torch.bfloat16):
            got = attn_grads(kernel_attn, dtype, with_lse)
            want = attn_grads(plain_attn, dtype, with_lse)
            for n, g, w, y in zip(("dq", "dk", "dv"), got, want, f32):
                close_or_as_close(
                    g, w, y, f"autograd {n} (8, 512, 8, 64) {str(dtype)[6:]}"
                    f"{' with g_lse' if with_lse else ''}")
    del base, g_out, g_lse, f32, got, want

    # -- 9. the training path at full width ----------------------------------
    begin_phase(9)
    log("phase 9: training, ModelConfig() defaults, 8 x 512 batches")
    n_steps, resume_at = 10, 5
    corpus = np.random.RandomState(0).randint(
        0, cfg.vocab_size, 8 * 512 * 16 + 1).astype(np.int32)
    dataset = TokenDataset(corpus, 512)
    spec = make_optimizer(lr=3e-4, warmup_steps=2, total_steps=20,
                          clip_norm=1.0)
    train_model, opt = init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, dev, spec)
    init_weights = {k: v.clone() for k, v in train_model.state_dict().items()}
    step = make_train_step(cfg, spec)
    held = next(iter(DataLoader(dataset, 8, device=dev, seed=0)))
    with torch.no_grad():
        held_before = float(loss_fn(train_model, *held))
    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt = os.path.join(ckpt_dir.name, "train_state.pt")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    batches, losses = [], []
    for i, (tok, tgt) in zip(range(n_steps), DataLoader(dataset, 8,
                                                         device=dev, seed=0)):
        batches.append((tok, tgt))
        losses.append(step(train_model, opt, tok, tgt))
        if i + 1 == resume_at:
            save_train_state(ckpt, train_model, opt, step=resume_at)
    torch.cuda.synchronize()
    train_launches = dict(_build.LAUNCHES)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    log(f"training path launches: {train_launches}")
    log(f"losses: {', '.join(f'{x:.4f}' for x in losses)}")
    check(all(np.isfinite(losses)) and len(losses) == n_steps,
          f"{n_steps} steps, losses finite")
    per_step = {"flash_attention": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    for name, n in per_step.items():
        check(train_launches.get(name, 0) == n * n_steps
              and train_launches.get(f"{name}.wgmma", 0) == n * n_steps,
              f"training path launched {name} {train_launches.get(name, 0)} "
              f"times ({n} per step), all on the wgmma body")
    check(train_launches.get("rms_norm", 0) > 0,
          f"training path launched rms_norm {train_launches.get('rms_norm', 0)}"
          " times")
    with torch.no_grad():
        held_after = float(loss_fn(train_model, *held))
    check(held_after < held_before, f"loss on a repeated batch falls: "
          f"{held_before:.4f} -> {held_after:.4f}")

    resumed, resumed_opt = init_train_state(
        torch.Generator(device=dev).manual_seed(1), cfg, dev, spec)
    check(restore_train_state(ckpt, resumed, resumed_opt) == resume_at,
          "checkpoint restores its step")
    again = [float(step(resumed, resumed_opt, *b)) for b in batches[resume_at:]]
    resume_err = max(abs(a - b) for a, b in zip(again, losses[resume_at:]))
    check(resume_err <= 1e-5, f"restored run continues with the same losses "
          f"(max |diff| {resume_err:.3g})")
    ckpt_dir.cleanup()
    del resumed, resumed_opt

    ppl = evaluate_perplexity(train_model, DataLoader(dataset, 8, device=dev,
                                                      seed=1), max_batches=2)
    check(ppl["tokens"] == 2 * 8 * 512 and np.isfinite(ppl["nll"]),
          f"evaluate_perplexity on two batches: nll {ppl['nll']:.4f}, "
          f"perplexity {ppl['perplexity']:.1f}")

    # One step's loss and gradients from the same weights: the kernel path
    # against the plain bf16 path, both against an fp32 step. bf16 rounds
    # at other places in the kernels than in the plain path, so the kernel
    # path is held to the plain bf16 path's distance from fp32, per
    # parameter: relative L2 error within 2x.
    tok, tgt = batches[0]

    def one_step_grads(**changes):
        m = Transformer(dataclasses.replace(cfg, **changes), device=dev)
        m.load_state_dict(init_weights)
        loss = loss_fn(m, tok, tgt)
        loss.backward()
        return float(loss.detach()), {n: p.grad
                                      for n, p in m.named_parameters()}

    loss_k, grads_k = one_step_grads(attention_impl="flash", norm_impl="fused")
    loss_r, grads_r = one_step_grads(attention_impl="reference",
                                     norm_impl="reference")
    loss_32, grads_32 = one_step_grads(attention_impl="reference",
                                       norm_impl="reference",
                                       compute_dtype=torch.float32)
    log(f"  one-step loss: kernel path {loss_k:.6f}, plain bf16 {loss_r:.6f}, "
        f"fp32 {loss_32:.6f}")
    check(abs(loss_k - loss_32) <= 2 * abs(loss_r - loss_32) + 1e-3,
          "kernel-path loss as close to fp32 as the plain bf16 path's")
    worst = 0.0
    for name, g32 in grads_32.items():
        ref = float(g32.norm())
        rel_k = float((grads_k[name] - g32).norm()) / ref
        rel_r = float((grads_r[name] - g32).norm()) / ref
        worst = max(worst, rel_k / max(rel_r, 1e-12))
        log(f"    {name:22s} rel L2 err: kernel {rel_k:.3e}, plain bf16 "
            f"{rel_r:.3e}")
        check(rel_k <= 2 * rel_r, f"{name} gradient as close to fp32 as the "
              "plain bf16 path's")
    log(f"  worst kernel/plain gradient error ratio: {worst:.3f}")
    del grads_k, grads_r, grads_32

    # -- 10. training timings -------------------------------------------------
    begin_phase(10)
    log("phase 10: training timings")
    tok, tgt = batches[0]
    step_ms = host_ms(lambda: step(train_model, opt, tok, tgt))
    step_busy, step_kernels = profile_top(
        lambda: step(train_model, opt, tok, tgt), "train step 8x512", top=10)
    for label, key in (("forward", "flash_fwd"), ("backward", "flash_bwd")):
        us = {n: t for n, t in step_kernels.items() if key in n}
        log(f"  flash {label} kernels in the step: {sum(us.values()):.1f} "
            f"of {step_busy:.1f} us busy "
            f"({100 * sum(us.values()) / step_busy:.2f}%): "
            + "; ".join(f"{n[:60]} {t:.1f} us" for n, t in us.items()))
    q, k, v, do, out, lse, _ = bwd_inputs(8, 512, 512, 8, 64, True,
                                          torch.bfloat16)
    check(_bwd_body(q, k, v, do, out) == "wgmma",
          "the timed training shape takes the wgmma body")
    _, delta = _kernel_flash_bwd_dq(q, k, v, do, out, lse, None, True)
    dq_args = (q, k, v, do, out, lse, None, True)
    dkv_args = (q, k, v, do, lse, delta, True)

    qt, kt, vt, dot_ = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.clone().requires_grad_() for t in (qt, kt, vt))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), dot_)

    dq_t = {"ms": time_ms(lambda: _kernel_flash_bwd_dq(*dq_args)),
            "plain_ms": time_ms(lambda: _reference_bwd_dq_with_delta(
                *dq_args))}
    dkv_t = {"ms": time_ms(lambda: _kernel_flash_bwd_dkv(*dkv_args)),
             "plain_ms": time_ms(lambda: _reference_bwd_dkv(*dkv_args))}
    sdpa_bwd_ms = (time_ms(sdpa_fwd_bwd)
                   - time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True)))
    dq_t["library_ms"] = dkv_t["library_ms"] = sdpa_bwd_ms
    pairs = 8 * 8 * 512 * 513 // 2
    qkv_bytes = q.numel() * 2
    stat_bytes = 64 * 512 * 4
    # dQ reads q, k, v, dO, O and lse and writes dQ and delta (no g_lse
    # here); dK/dV reads q, k, v, dO, lse and delta and writes dK and dV
    dq_bounds = {"bytes": (6 * qkv_bytes + 2 * stat_bytes)
                 / HBM_BYTES_PER_S * 1e3,
                 "operations": 6 * 64 * pairs / BF16_FLOP_PER_S * 1e3}
    dkv_bounds = {"bytes": (6 * qkv_bytes + 2 * stat_bytes)
                  / HBM_BYTES_PER_S * 1e3,
                  "operations": 8 * 64 * pairs / BF16_FLOP_PER_S * 1e3}
    for name, t, bounds in (("flash_bwd_dq", dq_t, dq_bounds),
                            ("flash_bwd_dkv", dkv_t, dkv_bounds)):
        log(f"{name} (8, 512, 8, 64) bf16 causal [wgmma]: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{max(bounds.values()):.4f} ms ({max(bounds, key=bounds.get)}), "
            f"{per_step[name]} launches per step")
    log(f"backward kernels (dQ with delta + dK/dV): "
        f"{dq_t['ms'] + dkv_t['ms']:.4f} ms; sdpa backward (fwd+bwd - fwd): "
        f"{sdpa_bwd_ms:.4f} ms; ratio "
        f"{(dq_t['ms'] + dkv_t['ms']) / sdpa_bwd_ms:.3f}")
    # At (1, 2048, 8, 64) a pass is 256 CTAs, one wave, so it lasts about
    # as long as its longest CTA: 32 tiles in a row (it shares its SM with
    # one other CTA). ms / 32 is one tile of that chain.
    q, k, v, do, out, lse, _ = bwd_inputs(1, 2048, 2048, 8, 64, True,
                                          torch.bfloat16)
    _, delta = _kernel_flash_bwd_dq(q, k, v, do, out, lse, None, True)
    long_dq = time_ms(lambda: _kernel_flash_bwd_dq(q, k, v, do, out, lse,
                                                   None, True))
    long_dkv = time_ms(lambda: _kernel_flash_bwd_dkv(q, k, v, do, lse, delta,
                                                     True))
    log(f"backward at (1, 2048, 8, 64) bf16 causal: dQ {long_dq:.4f} ms, "
        f"dK/dV {long_dkv:.4f} ms; per tile of the longest CTA's chain: "
        f"dQ {long_dq / 32 * 1e3:.3f} us, dK/dV {long_dkv / 32 * 1e3:.3f} us")
    log(f"train step 8x512: {step_ms:.3f} ms host, "
        f"{8 * 512 / step_ms * 1e3:.0f} tokens/s")
    log(f"peak memory on the training path: {train_peak_gib:.3f} GiB")
    del train_model, opt, batches, init_weights
    torch.cuda.empty_cache()

    # -- 11/12. the ring kernel and the MPI world on the card ---------------
    begin_phase(11)
    ring_t, ring_bounds, ring_err = ring_kernel_phase(dev)
    begin_phase(12)
    mpi_launches = mpi_world_phase(dev, _build)
    check(mpi_launches.get("ring_permute", 0) > 0,
          f"MPI phase launched ring_permute "
          f"{mpi_launches.get('ring_permute', 0)} times")

    # -- 13. faabric's own path: planner, worker, executors ---------------
    begin_phase(13)
    faabric_launches = faabric_phase(dev, model, _build)
    # -- 14. dryrun_multichip stages 1-3 and the sharded step -------------
    begin_phase(14)
    mesh_launches = mesh_phase(dev, _build, (step_ms, step_busy))
    # -- 15. the pipeline, GPipe and 1F1B --------------------------------
    begin_phase(15)
    pp_launches = pipeline_phase(dev, _build)
    # -- 16. the MoE family ----------------------------------------------
    begin_phase(16)
    moe_launches = moe_phase(dev, _build)
    # -- 17. faabric's MPI through guests ---------------------------------
    begin_phase(17)
    guest_launches = mpi_guest_phase(dev, _build)
    # -- 18. the mesh half of serving -------------------------------------
    begin_phase(18)
    serving_mesh_launches = sharded_serving_phase(dev, _build)
    # -- 19. the state KV through guests ----------------------------------
    begin_phase(19)
    state_launches = state_phase(dev, _build)
    # -- 20. snapshots through guests -------------------------------------
    begin_phase(20)
    snapshot_launches = snapshot_phase(dev, _build)
    # -- 21. THREADS batches, merged through snapshot diffs; chaining -----
    begin_phase(21)
    threads_launches = threads_phase(dev, _build)
    # -- 22. the gradient across two hosts on each data plane -------------
    begin_phase(22)
    plane_steps: dict = {}
    planes_launches = planes_phase(dev, _build, keep=plane_steps)
    # -- 23. telemetry and fault points on the data-parallel step ---------
    begin_phase(23)
    telemetry_launches = telemetry_phase(dev, _build)
    # -- 24. migration, spot freeze and thaw, recovery, aborts -----------
    begin_phase(24)
    migration_launches = migration_phase(dev, _build)
    # -- 25. a serving batch that outlives a SIGKILLed planner -----------
    begin_phase(25)
    restart_launches = restart_phase(dev, _build)
    # -- 26. phase 22's step with its hosts as processes, and 27. their
    # telemetry surfaces, scraped after each plane's steps ---------------
    begin_phase(26)
    process_launches = processes_phase(dev, _build, plane_steps)
    del plane_steps
    end_phase()
    # Each row's launches: the serving kernels' on the direct serving
    # path (phase 5) and under the executors (13), the backward kernels'
    # on the training path (9), the ring kernel's on the MPI path (12),
    # and every launch of the mesh (14), pipeline (15), MoE (16), guest
    # data-parallel (17), sharded decode and perplexity (18), state (19),
    # snapshot (20), THREADS and chaining (21), data-plane (22),
    # telemetry (23), migration, spot and recovery (24), planner restart
    # (25) and host-process (26, launched in its worker processes) paths
    path_launches = {
        name: sum(p.get(name, 0) for p in paths) + sum(
            p.get(name, 0) for p in (mesh_launches, pp_launches, moe_launches,
                                     guest_launches, serving_mesh_launches,
                                     state_launches, snapshot_launches,
                                     threads_launches, planes_launches,
                                     telemetry_launches, migration_launches,
                                     restart_launches, process_launches))
        for name, paths in (
            ("rms_norm", (launches, faabric_launches)),
            ("flash_attention", (launches, faabric_launches)),
            ("flash_bwd_dq", (train_launches,)),
            ("flash_bwd_dkv", (train_launches,)),
            ("ring_permute", (mpi_launches,)))}

    def row(name, source, replaces, t, bounds, err, path_launches,
            body=None):
        bound_by = max(bounds, key=bounds.get)
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": path_launches.get(name, 0),
             "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": bounds[bound_by], "bound_by": bound_by,
             "library_ms": t["library_ms"]}
        return r if body is None else {**r, "body": body}

    kernels = [
        row("rms_norm", "faabric_tpu_torch/ops/csrc/rms_norm.cu",
            "faabric_tpu/ops/rms_norm.py:26", rms, rms_bounds,
            errs["rms_norm"], path_launches),
        row("flash_attention", "faabric_tpu_torch/ops/csrc/flash_attention.cu",
            "faabric_tpu/ops/flash_attention.py:61", fl, fl_bounds,
            errs["flash_attention"], path_launches, "wgmma"),
        row("flash_bwd_dq", "faabric_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "faabric_tpu/ops/flash_attention.py:125", dq_t, dq_bounds,
            errs["flash_bwd_dq"], path_launches, "wgmma"),
        row("flash_bwd_dkv",
            "faabric_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "faabric_tpu/ops/flash_attention.py:176", dkv_t, dkv_bounds,
            errs["flash_bwd_dkv"], path_launches, "wgmma"),
        row("ring_permute", "faabric_tpu_torch/ops/csrc/ring_permute.cu",
            "faabric_tpu/device_plane/pallas_ring.py:77", ring_t,
            ring_bounds, ring_err, path_launches),
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:
        if _phase["n"] is not None:
            log(f"phase {_phase['n']}: FAILED after "
                f"{time.perf_counter() - _phase['t0']:.1f} s: "
                f"{type(e).__name__}: {e}")
        raise
