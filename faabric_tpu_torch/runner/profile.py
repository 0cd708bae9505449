"""Render the cluster CPU profile.

    python -m faabric_tpu_torch.runner.profile [--url BASE | --file DOC.json]
                                               [--top N] [--bottom-up]
                                               [--collapsed [--weight cpu]]
                                               [--diff BEFORE.json AFTER.json]
                                               [--json] [--selftest]

Counterpart of ``faabric_tpu/runner/profile.py``.

Fetches the planner's ``GET /profile`` — every host's stack-sampler
trie merged into ranked per-host × thread-class × collapsed-stack rows
with per-thread CPU weighting and per-process GIL pressure — and
renders it as an aligned table. Views:

* default — top-down hot stacks ranked by CPU;
* ``--bottom-up`` — per leaf-frame self totals ("which function burns
  the CPU"), complementary to the trie view;
* ``--collapsed`` — flamegraph-collapsed lines
  (``host;class;f1;...;fN weight``) feedable straight into
  flamegraph.pl / speedscope; ``--weight cpu`` weighs by cpu_ms
  instead of samples;
* ``--diff A B`` — two saved captures matched by (host, class, stack)
  ranked by CPU growth, for round-over-round regression hunting;
* ``--selftest`` — spin up a real Profiler against planted hot/idle
  threads and assert the attribution end to end.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def fetch_profile(base_url: str, timeout: float = 10.0) -> dict:
    import urllib.request

    url = base_url.rstrip("/") + "/profile"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _as_profile(doc: dict) -> dict:
    """A /profile response has ranked "stacks" rows; a raw telemetry
    dump (host -> {"profile": ...}) or a single-process snapshot is
    aggregated on the fly."""
    from faabric_tpu_torch.telemetry.profiler import aggregate_profile

    if isinstance(doc.get("stacks"), list) and "hosts" in doc:
        return doc
    if "classes" in doc and "interval_ms" in doc:  # bare snapshot
        return aggregate_profile({"local": {"profile": doc}})
    return aggregate_profile(doc)


# ----------------------------------------------------------------------
# selftest

def _selftest_hot_spin(stop: threading.Event) -> None:
    """Distinctive busy-burn frame the selftest hunts for by name."""
    x = 0
    while not stop.is_set():
        for _ in range(1000):
            x = (x * 1103515245 + 12345) & 0x7FFFFFFF


def run_selftest() -> int:
    """Plant a hot spin thread + an idle thread against a real
    Profiler and assert per-class CPU attribution, frame ranking, and
    every render path. Exercises exactly what the dist acceptance test
    checks live, without sockets."""
    from faabric_tpu_torch.telemetry.profiler import (
        Profiler,
        aggregate_profile,
        bottom_up,
        collapsed_lines,
        diff_profiles,
        render_profile,
    )

    stop = threading.Event()
    spin = threading.Thread(target=_selftest_hot_spin, args=(stop,),
                            name="selftest/spin", daemon=True)
    idle = threading.Thread(target=lambda: stop.wait(30),
                            name="selftest/idle", daemon=True)
    spin.start()
    idle.start()
    prof = Profiler(interval_s=0.005)
    prof.start()
    try:
        time.sleep(0.6)
    finally:
        prof.stop()
        stop.set()
        spin.join(timeout=5)
        idle.join(timeout=5)

    snap = prof.snapshot()
    assert snap["samples"] >= 10, f"sampler starved: {snap['samples']}"
    classes = snap["classes"]
    assert "selftest/spin" in classes, sorted(classes)
    assert "selftest/idle" in classes, sorted(classes)
    spin_cpu = classes["selftest/spin"]["cpu_ms"]
    idle_cpu = classes["selftest/idle"]["cpu_ms"]
    assert spin_cpu > 10.0, f"spin burned no CPU: {spin_cpu}"
    assert spin_cpu > 10 * max(idle_cpu, 0.1), (
        f"CPU weighting failed to separate spin ({spin_cpu} ms) from "
        f"idle ({idle_cpu} ms)")

    doc = aggregate_profile({"selfhost": {"profile": snap}})
    top = [r for r in doc["stacks"] if r["class"] == "selftest/spin"]
    assert top, doc["stacks"][:3]
    assert any("_selftest_hot_spin" in f for f in top[0]["frames"]), (
        top[0]["frames"])
    assert doc["stacks"][0]["class"] == "selftest/spin", (
        doc["stacks"][0])
    assert doc["gil"]["selfhost"]["pressure"] >= 0.0

    rendered = render_profile(doc)
    assert "selfhost" in rendered and "selftest/spin" in rendered
    lines = collapsed_lines(doc)
    assert lines and all(l.rsplit(" ", 1)[1].isdigit() for l in lines)
    assert any("selftest/spin" in l for l in lines)
    cpu_lines = collapsed_lines(doc, weight="cpu")
    assert any("selftest/spin" in l for l in cpu_lines)
    bu = bottom_up(doc)
    assert bu and bu[0]["cpu_ms"] > 0
    d = diff_profiles(doc, doc)
    assert d and all(r["cpu_ms_delta"] == 0 for r in d)

    print(f"profile selftest: OK — {snap['samples']} samples, "
          f"spin {spin_cpu:.0f} ms vs idle {idle_cpu:.0f} ms, "
          f"overhead {snap['overhead_pct']}%, "
          f"gil_pressure {doc['gil']['selfhost']['pressure']}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m faabric_tpu_torch.runner.profile",
        description="Render the cluster CPU profile (GET /profile)")
    parser.add_argument("--url", default="http://127.0.0.1:8080",
                        help="planner REST base URL")
    parser.add_argument("--file", default=None, metavar="DOC.json",
                        help="render a saved /profile (or telemetry) "
                             "document instead of fetching")
    parser.add_argument("--top", type=int, default=15,
                        help="stack rows to show (default 15)")
    parser.add_argument("--bottom-up", action="store_true",
                        help="rank leaf frames by self weight")
    parser.add_argument("--collapsed", action="store_true",
                        help="emit flamegraph-collapsed lines")
    parser.add_argument("--weight", choices=("samples", "cpu"),
                        default="samples",
                        help="collapsed-line weight (default samples)")
    parser.add_argument("--diff", nargs=2, default=None,
                        metavar=("BEFORE.json", "AFTER.json"),
                        help="diff two saved captures by CPU growth")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable document")
    parser.add_argument("--selftest", action="store_true",
                        help="run the planted-thread attribution "
                             "selftest and exit")
    args = parser.parse_args(argv)

    if args.selftest:
        try:
            return run_selftest()
        except AssertionError as e:
            print(f"profile selftest: FAILED — {e}", file=sys.stderr)
            return 1

    from faabric_tpu_torch.telemetry.profiler import (
        bottom_up,
        collapsed_lines,
        diff_profiles,
        render_profile,
    )

    if args.diff:
        try:
            with open(args.diff[0]) as f:
                before = _as_profile(json.load(f))
            with open(args.diff[1]) as f:
                after = _as_profile(json.load(f))
        except Exception as e:  # noqa: BLE001 — CLI surface
            print(f"profile: cannot load diff inputs: {e}",
                  file=sys.stderr)
            return 2
        rows = diff_profiles(before, after, top=args.top)
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            print(f"{'cpu_ms Δ':>10}  {'before':>10}  {'after':>10}  "
                  f"host/class · leaf")
            for r in rows:
                leaf = r["frames"][-1] if r["frames"] else "?"
                print(f"{r['cpu_ms_delta']:>10.1f}  "
                      f"{r['cpu_ms_before']:>10.1f}  "
                      f"{r['cpu_ms_after']:>10.1f}  "
                      f"{r['host']}/{r['class']} · {leaf}")
        return 0

    try:
        if args.file:
            with open(args.file) as f:
                doc = _as_profile(json.load(f))
        else:
            doc = _as_profile(fetch_profile(args.url))
    except Exception as e:  # noqa: BLE001 — CLI surface
        src = args.file or args.url
        print(f"profile: cannot load profile from {src}: {e}",
              file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(doc, indent=1))
    elif args.collapsed:
        for line in collapsed_lines(doc, weight=args.weight):
            print(line)
    elif args.bottom_up:
        print(f"{'cpu_ms':>10}  {'smpl':>6}  frame · classes")
        for r in bottom_up(doc, top=args.top):
            print(f"{r['cpu_ms']:>10.1f}  {r['samples']:>6}  "
                  f"{r['frame']} · {', '.join(r['classes'])}")
    else:
        print(render_profile(doc, top=args.top))
    return 0 if doc.get("hosts") else 1


if __name__ == "__main__":
    sys.exit(main())
