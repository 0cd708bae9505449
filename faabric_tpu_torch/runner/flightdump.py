"""Merge and print the flight-recorder dumps of several hosts.

    python -m faabric_tpu_torch.runner.flightdump <dir> [--json] [--last N]
                                                  [--kind K]
    python -m faabric_tpu_torch.runner.flightdump --url http://pl:8080 \
                                                  [--url http://w0:8081] ...

Counterpart of ``faabric_tpu/runner/flightdump.py``, with the same
output over the same dumps.

Each process that hit a dump trigger (MpiWorldAborted, planner requeue,
unhandled executor exception, SIGTERM) left one
``flight-<label>-<pid>-<ns>.json`` file in ``FAABRIC_FLIGHT_DIR``
(telemetry/flight.py). This tool merges their event rings onto one
wall-clock timeline — the black-box readout after a chaos run or a
production incident.

``--url`` (repeatable) reads LIVE rings instead:
every planner/worker HTTP endpoint serves its in-memory ring at
``GET /flight``, so the black box is readable without waiting for a
crash dump. Directory and URL sources merge together.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def load_dumps(directory: str) -> list[dict]:
    """Every parseable ``flight-*.json`` in ``directory`` (unreadable or
    truncated files are skipped with a note on stderr, not fatal — a
    post-mortem tool must tolerate a dump cut short by the crash)."""
    dumps = []
    for path in sorted(glob.glob(os.path.join(directory, "flight-*.json"))):
        try:
            with open(path) as f:
                body = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"skipping {path}: {e}", file=sys.stderr)
            continue
        body["_file"] = os.path.basename(path)
        dumps.append(body)
    return dumps


def fetch_live_rings(urls: list[str], timeout: float = 10.0) -> list[dict]:
    """One pseudo-dump per reachable ``GET /flight`` endpoint (live
    rings have no dump trigger; ``reason`` reads ``live``). Unreachable
    endpoints are skipped with a note — a half-dead cluster is exactly
    when this tool runs."""
    import time
    import urllib.request

    dumps = []
    for url in urls:
        full = url.rstrip("/")
        if not full.endswith("/flight"):
            full += "/flight"
        try:
            with urllib.request.urlopen(full, timeout=timeout) as resp:
                body = json.loads(resp.read().decode())
        except Exception as e:  # noqa: BLE001 — degrade, never die
            print(f"skipping {full}: {e}", file=sys.stderr)
            continue
        body.setdefault("reason", "live")
        body.setdefault("dumped_at", time.time())
        body["_file"] = full
        dumps.append(body)
    return dumps


def merge_dumps(dumps: list[dict]) -> list[dict]:
    """All dumps' events on one timeline: each event gains ``process``/
    ``pid``/``dump_reason`` provenance and the list sorts by wall-clock
    timestamp (hosts share the tracer's wall-anchored convention).

    A process that hit several dump triggers (e.g. group abort then
    SIGTERM) left overlapping ring snapshots; events dedupe on
    (process, pid, ring seq), the NEWEST dump's copy winning, so the
    merged black box reports each real event once."""
    # Newest file last: its copy of a shared (pid, seq) event wins
    dumps = sorted(dumps, key=lambda d: d.get("dumped_at", 0.0))
    by_key: dict[tuple, dict] = {}
    for dump in dumps:
        for e in dump.get("events", []):
            key = (dump.get("process", "?"), dump.get("pid", 0),
                   e.get("seq", -1))
            by_key[key] = {**e,
                           "process": dump.get("process", "?"),
                           "pid": dump.get("pid", 0),
                           "dump_reason": dump.get("reason", "?")}
    events = list(by_key.values())
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return events


def merge(directory: str) -> list[dict]:
    """Directory-mode merge (the entry point that predates live rings,
    kept for callers and tests)."""
    return merge_dumps(load_dumps(directory))


def _fmt_fields(event: dict) -> str:
    skip = ("ts", "seq", "kind", "process", "pid", "dump_reason")
    return " ".join(f"{k}={event[k]}" for k in event if k not in skip)


def render(events: list[dict], last: int | None = None) -> str:
    if last is not None:
        events = events[-last:]
    if not events:
        return "(no flight events)"
    t0 = events[0].get("ts", 0.0)
    lines = []
    for e in events:
        lines.append(
            f"{e.get('ts', 0.0) - t0:+10.3f}s "
            f"{e.get('process', '?'):<22} "
            f"{e.get('kind', '?'):<20} {_fmt_fields(e)}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="faabric_tpu_torch.runner.flightdump",
        description="Merge + pretty-print flight-recorder dumps")
    parser.add_argument("directory", nargs="?", default=None)
    parser.add_argument("--url", action="append", default=[],
                        help="live planner/worker HTTP endpoint(s); "
                        "reads GET /flight instead of (or merged with) "
                        "dump files")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable merged event list")
    parser.add_argument("--last", type=int, default=None,
                        help="only the final N events")
    parser.add_argument("--kind", default=None,
                        help="filter by event kind (e.g. group_abort)")
    args = parser.parse_args(argv)

    directory = args.directory
    if directory is None and not args.url:
        directory = os.environ.get("FAABRIC_FLIGHT_DIR", ".")
    dumps = load_dumps(directory) if directory else []
    dumps += fetch_live_rings(args.url)
    events = merge_dumps(dumps)
    if args.kind:
        events = [e for e in events if e.get("kind") == args.kind]
    if args.json:
        if args.last is not None:
            events = events[-args.last:]
        print(json.dumps(events, indent=1))
    else:
        where = " + ".join(filter(None, [directory] + args.url))
        print(f"{len(dumps)} dump(s)/ring(s), {len(events)} event(s) "
              f"from {where}")
        print(render(events, last=args.last))
    return 0 if events else 1


if __name__ == "__main__":
    sys.exit(main())
