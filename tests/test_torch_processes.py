"""The flagship's two-host step with its hosts as OS processes, on the
CPU: ``chip_smoke.py``'s phase 26 (``processes_phase``) at a small width,
with phase 27 (``scrape_phase``), which reads the live cluster through
the planner's REST endpoint, the workers' endpoints and the CLIs after
each plane's steps.

Phase 22 (``planes_phase``) runs first in this process, as in the
script, and hands over where its step started and what it gave on each
plane. Phase 26 then starts the planner through ``python -m
faabric_tpu_torch.runner planner`` and the two worker hosts as child
processes of ``chip_smoke.worker_child``, and holds their ranks'
parameters after the first step bitwise to phase 22's. The width is
chosen so that the gradient takes the flat ring over two hosts, as at
full width, without patching the world's chunk size (the children would
not see a patch). The kernels run only on the card; here the children
count their plain norm and attention calls under the kernels' names, so
that the launch counts they carry back can be checked. The children run
under the lock-order detector and join a 2-process device plane at
boot; phase 29 (``xproc_phase``) runs a gang across them on that plane
(gloo on the CPU), and phase 28 (``kill_phase``) SIGKILLs one of them
under a serving batch of a small model, whose requests the planner
requeues onto the other.
"""

import os
import sys

import pytest
import torch

import chip_smoke  # noqa: E402
from faabric_tpu_torch.models import ModelConfig  # noqa: E402
from faabric_tpu_torch.ops import _build  # noqa: E402
from faabric_tpu_torch.transport.common import STATE_ASYNC_PORT  # noqa: E402
from tests.test_torch_mpi import _hold_ports  # noqa: E402
from tests.test_torch_multiprocess import port_slot  # noqa: E402

SMALL = dict(vocab_size=4096, d_model=256, n_layers=2, n_heads=4, d_ff=512,
             max_seq=64, attention_impl="reference", norm_impl="reference")
SEQ, STEPS = 32, 3
# Phase 28's serving batch: 8 requests of SERVE_LEN tokens, N_NEW more
SERVE_LEN, N_NEW = 16, 4
# Phase 29's fp32 elements a rank
XPROC_ELEMS = 4096

# A worker child whose plain norm and attention count launches under the
# kernels' names (the CPU runs no kernel), on one intra-op thread
COUNTING_CHILD = """
import sys
import torch
import chip_smoke
import faabric_tpu_torch.models.transformer as t
from faabric_tpu_torch.ops import _build

torch.set_num_threads(1)

def counted(fn, name):
    def call(*args, **kwargs):
        _build.count_launch(name)
        return fn(*args, **kwargs)
    return call

t._rms_norm = counted(t._rms_norm, "rms_norm")
t._attention = counted(t._attention, "flash_attention")
sys.exit(chip_smoke.worker_child(sys.argv[1:]))
"""


def _children_of(pid: int) -> set[int]:
    """Live processes whose parent is ``pid`` (from /proc)."""
    out = set()
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.add(int(name))
    return out


def test_chip_smoke_processes_phase_small(monkeypatch):
    """Phase 26 at a small width: on the shm rings across processes and
    on bulk TCP, each host process's ranks' parameters after the first
    step are bitwise equal to phase 22's in-process step from the same
    start, and the four ranks' final parameters to each other; the
    children's launch counts come back and add up; they load nothing of
    JAX or of the JAX package and their lock-order detectors see no
    cycle; phase 28's batch comes back whole across the SIGKILLed
    child; no child outlives the phase. Both phases
    run their CPU arithmetic on one intra-op thread: a CPU reduction's
    order follows the threads that take part, which a loaded machine
    varies between processes (the card's kernels do not vary)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _processes_phase_small(monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _processes_phase_small(monkeypatch):
    cfg = ModelConfig(**SMALL, compute_dtype=torch.float32)
    passed = []
    real_check = chip_smoke.check

    def check(ok, what):
        real_check(ok, what)
        passed.append(what)

    monkeypatch.setattr(chip_smoke, "check", check)
    keep: dict = {}
    before = _children_of(os.getpid())
    chip_smoke.planes_phase(torch.device("cpu"), _build, cfg=cfg, seq=SEQ,
                            base=port_slot(), keep=keep)
    assert {"start", "shm", "tcp", "step_ms"} <= set(keep)
    # The children take seconds to start before they bind the slot's
    # ports: a listening socket on a port of the slot that none of them
    # binds (the planner's offset's state port) keeps other test
    # workers' next_port_base() off the slot meanwhile
    for _ in range(20):
        base = port_slot()
        sentinel = _hold_ports([base + STATE_ASYNC_PORT], listen=True)
        if sentinel:
            break
    assert sentinel, "no free port slot"
    try:
        launches = chip_smoke.processes_phase(
            torch.device("cpu"), _build, keep, cfg=cfg, seq=SEQ, steps=STEPS,
            base=base, child_argv=[sys.executable, "-c", COUNTING_CHILD],
            serve_cfg=cfg, serve_len=SERVE_LEN, n_new=N_NEW,
            xproc_elems=XPROC_ELEMS)
    finally:
        sentinel[0].close()
    assert _children_of(os.getpid()) <= before

    L = cfg.n_layers
    runs = 2 * chip_smoke.MPI_RANKS * STEPS  # planes x ranks x steps
    served = _serving_calls(cfg, monkeypatch)
    assert launches == {
        "rms_norm": runs * (4 * L + 1) + 8 * served["rms_norm"],
        "flash_attention": runs * 2 * L + 8 * served["flash_attention"],
    }, launches
    for plane in ("shm", "tcp"):
        same = [w for w in passed if w.startswith(f"26 ({plane}): rank ")
                and "bitwise equal to phase 22's in-process step" in w]
        assert len(same) == chip_smoke.MPI_RANKS, passed
        assert any(w.startswith(f"26 ({plane}): the 4 ranks' parameters")
                   for w in passed)
    loaded = [w for w in passed
              if "loaded the port and nothing of JAX" in w]
    assert len(loaded) == 2, passed
    # Phase 27 ran its checks on both planes (launch and device checks
    # aside, they run on the CPU as on the card)
    for plane in ("shm", "tcp"):
        scraped = [w for w in passed if w.startswith(f"27 ({plane}): ")]
        for what in ("/metrics parses", "three pids", "/commmatrix's",
                     "the doctor CLI against the live endpoint exits 0",
                     "--dir mode", "flightdump prints", "timeline prints",
                     "/healthz lists both hosts", "/profile has rows"):
            assert any(what in w for w in scraped), (plane, what, scraped)
        # The doctor runs as a subprocess once, on the last plane
        how = "as a subprocess" if plane == "tcp" else "in this process"
        assert any("exits 0 " + how in w for w in scraped), (plane, scraped)
        # Both children ran the plane under the lock-order detector
        clean = [w for w in passed if w.startswith(f"26 ({plane}): ")
                 and "lock-order detector" in w and "saw no cycle" in w]
        assert len(clean) == 2, passed
    # Phase 28: the kill, the requeue and the recovery, all checked
    killed = [w for w in passed if w.startswith("28: ")]
    for what in ("the batch spread 4 + 4", "ran on mpi-host-b before the "
                 "kill", "exited -9 on SIGKILL", "all 8 results SUCCESS",
                 "carry the rqu stamp", "count rose by 1",
                 "detector saw no held-before cycle"):
        assert any(what in w for w in killed), (what, killed)
    assert any(w == "26: the planner process stopped on SIGTERM with 0"
               for w in passed), passed
    # Phase 29: the children joined the plane at boot, and its gang's
    # collectives across them agree with the host ring, numpy, the
    # plain ring and the single-process plane
    joined = [w for w in passed if "device plane at boot" in w]
    assert len(joined) == 2, passed
    across = [w for w in passed if w.startswith("29: ")]
    for what in ("split 2 + 2", "activated on every rank over 2 processes",
                 "int32 allreduce", "int32 allgather", "int32 reduce_scatter",
                 "zero host<->device copies", "zero bytes on rings",
                 "bitwise its plain version",
                 "bitwise equal to the single-process plane's fold"):
        assert any(what in w for w in across), (what, across)


def _serving_calls(cfg, monkeypatch) -> dict:
    """The counted norm and attention calls of one request of phase 28's
    guest (its scores, then its greedy tokens) at ``cfg``."""
    import faabric_tpu_torch.models.transformer as t
    from faabric_tpu_torch.models import Transformer, forward, generate

    calls = {"rms_norm": 0, "flash_attention": 0}

    def counted(fn, name):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(t, "_rms_norm", counted(t._rms_norm, "rms_norm"))
    monkeypatch.setattr(t, "_attention",
                        counted(t._attention, "flash_attention"))
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    prompt = torch.zeros(1, SERVE_LEN, dtype=torch.int64)
    with torch.inference_mode():
        forward(model, prompt)
        generate(model, prompt, N_NEW)
    return calls


@pytest.mark.parametrize("argv", [["--worker-child", "{}"]])
def test_worker_child_needs_a_card(argv):
    """``chip_smoke.py --worker-child`` is dispatched after the CUDA
    check: without a card it exits non-zero and prints no result."""
    import subprocess

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "chip_smoke.py", *argv], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == "", out
    assert "CUDA" in out.stderr
