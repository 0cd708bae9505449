"""Concurrency conformance gate: guarded-by lint + protocol drift,
ratcheted against a committed baseline.

    python -m faabric_tpu_torch.analysis.concheck
        [--baseline faabric_tpu_torch/analysis/concheck_baseline.txt]
        [--write-baseline] [--verbose]

Counterpart of the reference's ``tools/concheck.py``. Runs the static
passes of this package over ``faabric_tpu_torch/`` and diffs finding
*fingerprints* (path::qualname::rule::subject — no line numbers, so
unrelated edits don't churn the baseline) against the committed
baseline. Exit codes:

- 0: every finding is baselined (entries that no longer fire are
  printed as shrink-the-baseline notes);
- 1: NEW findings — concurrency-contract violations the baseline does
  not carry. Fix them, pragma them with a justification
  (``# concheck: ok(rule)``), or — for known pre-existing debt being
  tracked — add the fingerprint to the baseline.

``--write-baseline`` rewrites the baseline to exactly the current
finding set (the ratchet: run it after fixing entries so the floor
moves down and stays down).
"""

from __future__ import annotations

import argparse
import os
import sys

from faabric_tpu_torch.analysis.guards import Finding, analyze_paths
from faabric_tpu_torch.analysis.protodrift import analyze_package

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
DEFAULT_BASELINE = os.path.join(_HERE, "concheck_baseline.txt")


def collect_findings(root: str = _REPO,
                     subdirs: tuple[str, ...] = ("faabric_tpu_torch",)
                     ) -> list[Finding]:
    findings = analyze_paths(root, subdirs=subdirs)
    findings.extend(analyze_package(root, subdirs=subdirs))
    return findings


def load_baseline(path: str) -> set[str]:
    if not os.path.exists(path):
        return set()
    out = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m faabric_tpu_torch.analysis.concheck")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE)
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline to the current "
                             "finding set (ratchet)")
    parser.add_argument("--verbose", action="store_true",
                        help="print every finding, baselined or not")
    args = parser.parse_args(argv)

    findings = collect_findings()
    by_fp: dict[str, Finding] = {}
    for f in findings:
        by_fp.setdefault(f.fingerprint, f)
    current = set(by_fp)
    baseline = load_baseline(args.baseline)

    if args.write_baseline:
        with open(args.baseline, "w") as f:
            f.write("# concheck baseline: known findings being tracked "
                    "as debt.\n# Fingerprints are path::qualname::rule::"
                    "subject (no line numbers).\n# Delete entries as "
                    "they are fixed — the gate prints candidates.\n")
            for fp in sorted(current):
                f.write(fp + "\n")
        print(f"concheck: baseline rewritten with {len(current)} "
              f"finding(s) -> {args.baseline}")
        return 0

    new = sorted(fp for fp in current if fp not in baseline)
    fixed = sorted(fp for fp in baseline if fp not in current)

    print(f"concheck: {len(current)} finding(s), baseline carries "
          f"{len(baseline)} ({os.path.basename(args.baseline)})")
    for fp in fixed:
        print(f"  fixed: {fp} — no longer firing; delete it from the "
              "baseline to ratchet the floor down")
    if args.verbose:
        for fp in sorted(current - set(new)):
            print(f"  known: {by_fp[fp].render()}")
    for fp in new:
        print(f"  NEW FINDING: {by_fp[fp].render()}")
        print(f"               fingerprint: {fp}")
    if new:
        print(f"concheck: FAILED ({len(new)} new finding(s) vs baseline)")
        return 1
    print("concheck: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
