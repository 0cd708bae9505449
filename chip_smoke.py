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
``evaluate_perplexity`` of the full-width model laid over dp 2 x tp 4
(8 ranks on the card) against the unsharded model. faabric's state KV
as guests use it: over two hosts, one guest writes the flagship's fp32
weights into a key, four pull them and score, four count under the
global lock and append, and a device state handle passes between two
guests. faabric's snapshots as guests use them: over two hosts, one
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
against the raw and exact paths. For each path
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

    fn()
    torch.cuda.synchronize()
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


def check(ok: bool, what: str) -> None:
    if not ok:
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
    11,338,880 fp32, the flagship's 45,355,520 parameters over 4)."""
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


def start_cluster(hosts: dict, factory, base: int | None = None):
    """A port planner and one started WorkerRuntime per ``hosts`` entry
    (name → slots) on localhost aliases from port offset ``base`` (drawn
    at random by default); returns (planner server, workers)."""
    import random

    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.runner import WorkerRuntime
    from faabric_tpu_torch.transport import register_host_alias

    if base is None:
        # Listener ports stay below the client source ports (30500 up)
        base = random.randint(100, 190) * 100
    register_host_alias("smoke-planner", "127.0.0.1", base)
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
    weights from ``params_to_numpy``'s numpy form, as ``params_from_jax``
    takes them) over dp 2 x tp 4, 8 ranks on the one card. In fp32 the
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

    log("phase 18: tp-sharded decode and perplexity, dp 2 x tp 4, full width")
    t_phase = time.perf_counter()
    cfg = ModelConfig()
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
    """Torch guests over faabric's state KV (``ctx.state()``):
    ``state/write`` puts ``job["model"](device)``'s flat fp32 parameters
    into key smoke/weights (``set_from_device``, ``push_full``), creates
    the counter and the log keys, and keeps its logits on
    ``job["tokens"]``; ``state/read`` pulls the weights, loads a model of
    ``job["cfg"]`` from ``get_device_array(torch.float32)`` and keeps its
    logits; ``state/count`` adds ``job["iters"]`` to the counter under the
    global lock and appends once; ``handle/push`` registers a tensor
    under a device state handle and returns it as a dict, which
    ``handle/pull`` pulls. Each returns JSON with its host and timings;
    the logits and the pushed tensor go to ``job["out"]``."""
    from faabric_tpu_torch.executor import register_function
    from faabric_tpu_torch.models import Transformer, forward
    from faabric_tpu_torch.state import get_device_handle_registry

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def reply(ctx, **fields):
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
        kv = state.get_kv("smoke", "weights", flat.numel() * 4)
        sync(dev)
        t0 = time.perf_counter()
        kv.set_from_device(flat)
        t1 = time.perf_counter()
        kv.push_full()
        t2 = time.perf_counter()
        for key in ("counter", "log"):
            small = state.get_kv("smoke", key, 8)
            small.set(bytes(8))
            small.push_full()
        job["out"]["writer"] = (state.host, score(model, dev))
        return reply(ctx, set_ms=(t1 - t0) * 1e3, push_ms=(t2 - t1) * 1e3,
                     master=kv.is_master, backup=kv.backup_host)

    @register_function("smoke", "state_read")
    def read(ctx):
        # One reader of a host at a time: the first pulls the value
        # (nothing to pull on the master's host) and makes the device
        # view, the second finds both done
        dev, state = ctx.device, ctx.state()
        kv = state.get_kv("smoke", "weights")
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
        return reply(ctx, pull_ms=(t1 - t0) * 1e3, view_ms=(t2 - t1) * 1e3,
                     first=first, cached=cached, ptr=flat.data_ptr(),
                     master=kv.is_master, size=kv.size)

    @register_function("smoke", "state_count")
    def count(ctx):
        state = ctx.state()
        kv = state.get_kv("smoke", "counter")
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
        state.get_kv("smoke", "log").append(
            f"{state.host}/{ctx.message.id}".encode())
        return reply(ctx, ms=ms, master=kv.is_master)

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
              timeout: float = 300.0):
    """Submit ``n`` messages of ``smoke/<function>`` (each with
    ``input_data``) and wait for all of them; returns the results in
    message order and the wall ms."""
    from faabric_tpu_torch.proto import batch_exec_factory

    req = batch_exec_factory("smoke", function, n)
    for m in req.messages:
        m.input_data = input_data
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
                base: int | None = None) -> dict:
    """Phase 19: faabric's state KV through torch guests on two hosts (a
    port planner and two WorkerRuntimes, 2 slots each, ``inmemory`` mode
    with one backup a key). A guest puts the flagship's whole fp32
    parameter vector into a key; four guests over both hosts pull it,
    load a model from ``get_device_array(torch.float32)`` and score a
    (1, 512) batch whose logits must equal the writer's bit for bit;
    four guests add ``iters`` each to a counter under ``lock_global``
    (exact) and append once (every value back); a device state handle
    passed between two guests of one host is the same storage, with no
    counted copy, and ``pull_host`` counts one. Returns the launches of
    the writer's and readers' batches (the phase's main path)."""
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
           "pulled": set(),
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
        writer_host, want = out.pop("writer")
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
    finally:
        stop_cluster(planner_server, workers)
    log(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
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
    ``job["params"]`` and returns JSON: its host, the world's leaders, the
    rungs, step, broadcast and allreduce ms, and the bytes its host's bulk
    client to the other host put on the wire during each allreduce."""
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
        job["params"][rank] = flat_params(model)
        world.barrier(rank)
        rungs = {kind: algo for (r, kind), algo in world.rungs.items()
                 if r == rank}
        return json.dumps({"rank": rank, "host": host, "rungs": rungs,
                           "leaders": list(world.topology().leaders),
                           **out}).encode()


def _metric(snap: dict, name: str, **labels) -> float:
    return sum(row["value"] for row in snap.get(name, {}).get("series", [])
               if all(row["labels"].get(k) == v for k, v in labels.items()))


def plane_bytes() -> dict:
    """Process-wide bytes (and frames) sent on each plane so far: shm
    rings, bulk TCP, the RPC plane's data channel; coded delta frames
    and full-frame escapes."""
    from faabric_tpu_torch.telemetry import get_metrics

    snap = get_metrics().snapshot()
    return {"shm": _metric(snap, "faabric_bulk_tx_bytes_total", path="shm"),
            "tcp": _metric(snap, "faabric_bulk_tx_bytes_total", path="tcp"),
            "rpc": _metric(snap, "faabric_ptp_rpc_bytes_total",
                           channel="data"),
            "rpc_frames": _metric(snap, "faabric_ptp_rpc_frames_total",
                                  channel="data"),
            "delta_frames": _metric(snap, "faabric_codec_frames_total",
                                    codec="delta"),
            "escapes": _metric(snap, "faabric_codec_escapes_total")}


def planes_phase(dev, build, cfg=None, per_rank: int = 2, seq: int = 512,
                 base: int | None = None) -> dict:
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
    the parts' launches."""
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig, Transformer
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
    n, lr = MPI_RANKS, 0.5
    hosts = {"mpi-host-a": 2, "mpi-host-b": 2}
    corpus = np.random.RandomState(22).randint(
        0, cfg.vocab_size, (2, n * per_rank, seq + 1)).astype(np.int64)

    def batch(step, rank, device):
        b = torch.as_tensor(corpus[step % 2, rank * per_rank:
                                   (rank + 1) * per_rank], device=device)
        return b[:, :-1], b[:, 1:]

    params, grads, sums = {}, {}, {}
    job = {"model": lambda device: Transformer(
               cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(22)),
           "batch": batch, "lr": lr, "params": params, "grads": grads,
           "sums": sums}
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
    # (512, 512) and (1, 512): the faabric phase's scoring forward and
    # each of its decode steps; (1024, 512): each DDP rank's 2 x 512 rows
    # in phase 17 (bf16 steps and the fp32 step). Phase 18's sharded
    # decode (dp 2): a
    # rank's 2 rows a step, its (2, 128) whole prefill, its chunked
    # prefill's (2, 48) and (2, 32); the unsharded yardstick's (4, 1)
    # steps and its (4, 512) perplexity batches. Phase 20's steps run
    # (4096, 512) and its scorings (512, 512); phase 21's threads
    # (1024, 512), its scorings (512, 512)
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
    # its scorings (1, 512, 8 heads)
    for b, s_q, s_k, h, causal, dtype, views in [
            (8, 512, 512, 8, True, torch.bfloat16, False),
            (8, 128, 512, 8, True, torch.bfloat16, False),
            (8, 512, 512, 8, False, torch.bfloat16, False),
            (8, 448, 512, 8, True, torch.bfloat16, False),
            (8, 500, 530, 8, False, torch.bfloat16, False),
            (8, 512, 512, 8, True, torch.float32, False),
            (1, 2048, 2048, 8, True, torch.bfloat16, False),
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
    # and each thread's step of phase 21; (8, 512, 8 heads) also phase
    # 20's steps
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
    ring_t, ring_bounds, ring_err = ring_kernel_phase(dev)
    mpi_launches = mpi_world_phase(dev, _build)
    check(mpi_launches.get("ring_permute", 0) > 0,
          f"MPI phase launched ring_permute "
          f"{mpi_launches.get('ring_permute', 0)} times")

    # -- 13. faabric's own path: planner, worker, executors ---------------
    faabric_launches = faabric_phase(dev, model, _build)
    # -- 14. dryrun_multichip stages 1-3 and the sharded step -------------
    mesh_launches = mesh_phase(dev, _build, (step_ms, step_busy))
    # -- 15. the pipeline, GPipe and 1F1B --------------------------------
    pp_launches = pipeline_phase(dev, _build)
    # -- 16. the MoE family ----------------------------------------------
    moe_launches = moe_phase(dev, _build)
    # -- 17. faabric's MPI through guests ---------------------------------
    guest_launches = mpi_guest_phase(dev, _build)
    # -- 18. the mesh half of serving -------------------------------------
    serving_mesh_launches = sharded_serving_phase(dev, _build)
    # -- 19. the state KV through guests ----------------------------------
    state_launches = state_phase(dev, _build)
    # -- 20. snapshots through guests -------------------------------------
    snapshot_launches = snapshot_phase(dev, _build)
    # -- 21. THREADS batches, merged through snapshot diffs; chaining -----
    threads_launches = threads_phase(dev, _build)
    # -- 22. the gradient across two hosts on each data plane -------------
    planes_launches = planes_phase(dev, _build)
    # Each row's launches: the serving kernels' on the direct serving
    # path (phase 5) and under the executors (13), the backward kernels'
    # on the training path (9), the ring kernel's on the MPI path (12),
    # and every launch of the mesh (14), pipeline (15), MoE (16), guest
    # data-parallel (17), sharded decode and perplexity (18), state (19),
    # snapshot (20), THREADS and chaining (21) and data-plane (22) paths
    path_launches = {
        name: sum(p.get(name, 0) for p in paths) + sum(
            p.get(name, 0) for p in (mesh_launches, pp_launches, moe_launches,
                                     guest_launches, serving_mesh_launches,
                                     state_launches, snapshot_launches,
                                     threads_launches, planes_launches))
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
    sys.exit(main())
