"""Phases 14 and 15 of ``chip_smoke.py`` (the sharded step with its ring,
GPipe and 1F1B) alone, on two checkouts in turn, on one card: the A/B
comparison of a change against its parent.

    python3 chip_ab.py [--out DIR] A B

``A`` and ``B`` are checkouts of the repo (the parent and the change,
say, each unpacked with ``git archive``). Each run is a fresh process in
its checkout that builds that checkout's kernels (the first run of each
builds, later runs load the build) and runs the two phases with that
checkout's ``chip_smoke.py``, in the order A B B A A B. Phase 14 is
given no phase 10 step, so its line shows nan for it. Each run's whole
log goes to ``DIR/ab<i>_<A|B>.log`` (``build/ab`` by default); the card's name and power limit
and, per run, the lines that carry a wall time, a phase's time or a
failure are printed. Exits 1 if any run failed.
"""

import argparse
import os
import subprocess
import sys

ORDER = "ABBAAB"
RUN_TIMEOUT_S = 600

RUN = """
import os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
from faabric_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
t0 = time.perf_counter()
_build.kernels()
print(f"kernel build seconds: {time.perf_counter() - t0:.1f}", flush=True)
chip_smoke.begin_phase(14)
chip_smoke.mesh_phase(dev, _build, (float("nan"), float("nan")))
chip_smoke.begin_phase(15)
chip_smoke.pipeline_phase(dev, _build)
chip_smoke.end_phase()
"""

KEEP = ("ms wall", ": ok in", "check failed", "Error", "kernel build")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default=os.path.join("build", "ab"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {"A": args.a, "B": args.b}
    rc = 0
    for i, label in enumerate(ORDER):
        log = os.path.join(args.out, f"ab{i + 1}_{label}.log")
        with open(log, "w") as f:
            try:
                got = subprocess.run([sys.executable, "-c", RUN],
                                     cwd=trees[label], stdout=f,
                                     stderr=subprocess.STDOUT,
                                     timeout=RUN_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                got = 124
        rc = rc or int(got != 0)
        print(f"== run {i + 1}: {label} ({trees[label]}), exit {got}",
              flush=True)
        with open(log) as f:
            for line in f:
                if any(k in line for k in KEEP):
                    print("  " + line.rstrip()[:400], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
