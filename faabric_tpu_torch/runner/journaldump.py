"""Print or verify a planner's write-ahead journal.

    python -m faabric_tpu_torch.runner.journaldump <dir> [--json] [--last N]
                                                   [--kind K] [--verify]

Counterpart of ``faabric_tpu/runner/journaldump.py``, with the same
output over the same directory. It reads the journal directory a
planner wrote (``FAABRIC_PLANNER_JOURNAL_DIR``: ``planner.journal`` and
the compaction snapshot ``planner.snapshot.json``, see
``planner/journal.py``) and prints the snapshot's summary and every
valid record on one timeline. ``--verify`` exits 2 when the journal has
a torn tail or the snapshot cannot be read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from faabric_tpu_torch.planner.journal import load_journal_dir


def _fmt_fields(rec: dict) -> str:
    skip = ("k", "ts")
    out = []
    for key in rec:
        if key in skip:
            continue
        val = rec[key]
        if isinstance(val, dict):
            # Nested payloads (req/decision/msg) render as summaries:
            # the point of the dump is the timeline, not a JSON wall
            n = val.get("messages")
            ident = val.get("app_id", val.get("id", ""))
            size = len(n) if isinstance(n, list) else len(val)
            out.append(f"{key}=<{ident}:{size}>")
        else:
            out.append(f"{key}={val}")
    return " ".join(out)


def render(records: list[dict], last: int | None = None) -> str:
    if last is not None:
        records = records[-last:]
    if not records:
        return "(no journal records)"
    t0 = records[0].get("ts", 0.0)
    lines = []
    for rec in records:
        if rec.get("k") == "group":
            # Group commit: one scheduling tick's records in one
            # on-disk record — render the envelope plus each
            # coalesced sub-record indented under it
            subs = rec.get("recs") or []
            lines.append(f"{rec.get('ts', 0.0) - t0:+10.3f}s "
                         f"{'group':<18} n={len(subs)}")
            for sub in subs:
                lines.append(f"{'':>12} └ {sub.get('k', '?'):<16} "
                             f"{_fmt_fields(sub)}")
            continue
        lines.append(f"{rec.get('ts', 0.0) - t0:+10.3f}s "
                     f"{rec.get('k', '?'):<18} {_fmt_fields(rec)}")
    return "\n".join(lines)


def filter_kind(records: list[dict], kind: str) -> list[dict]:
    """--kind filter that understands group commits: a group record
    matches when its own kind matches, or when any coalesced sub-record
    does (the group is then narrowed to the matching subs)."""
    out = []
    for rec in records:
        if rec.get("k") == kind:
            out.append(rec)
            continue
        if rec.get("k") == "group":
            subs = [s for s in (rec.get("recs") or [])
                    if s.get("k") == kind]
            if subs:
                out.append({**rec, "recs": subs, "n": len(subs)})
    return out


def snapshot_summary(state: dict | None) -> str:
    if state is None:
        return "no snapshot"
    in_flight = state.get("in_flight") or {}
    results = state.get("results") or {}
    return (f"snapshot: {len(in_flight)} in-flight app(s), "
            f"{sum(len(r) for r in results.values())} result(s), "
            f"{len(state.get('state_masters') or {})} state master(s), "
            f"{len(state.get('evicted') or {})} frozen, "
            f"last known hosts {state.get('known_hosts') or []}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="faabric_tpu_torch.runner.journaldump",
        description="Pretty-print / verify a planner write-ahead journal")
    parser.add_argument(
        "directory", nargs="?",
        default=os.environ.get("FAABRIC_PLANNER_JOURNAL_DIR", "."))
    parser.add_argument("--json", action="store_true",
                        help="machine-readable records + snapshot + meta")
    parser.add_argument("--last", type=int, default=None,
                        help="only the final N records")
    parser.add_argument("--kind", default=None,
                        help="filter by record kind (e.g. result)")
    parser.add_argument("--verify", action="store_true",
                        help="exit non-zero on a torn tail or a "
                             "corrupt/unreadable snapshot")
    args = parser.parse_args(argv)

    snapshot, records, meta = load_journal_dir(args.directory)
    if args.kind:
        records = filter_kind(records, args.kind)

    if args.json:
        body = {"meta": meta, "snapshot": snapshot, "records":
                records[-args.last:] if args.last is not None else records}
        print(json.dumps(body, indent=1, default=str))
    else:
        print(f"{len(records)} record(s) from {args.directory} "
              f"(generation {meta.get('generation', '?')})")
        print(snapshot_summary(snapshot))
        if meta.get("skipped_bytes"):
            print(f"skipped {meta['skipped_bytes']} journal byte(s) "
                  "already folded into the snapshot")
        if meta.get("torn"):
            print(f"TORN TAIL: {meta.get('torn_bytes', 0)} trailing "
                  "byte(s) failed length/CRC checks", file=sys.stderr)
        if meta.get("snapshot_error"):
            print(f"SNAPSHOT UNREADABLE: {meta['snapshot_error']}",
                  file=sys.stderr)
        print(render(records, last=args.last))

    if args.verify and (meta.get("torn") or meta.get("snapshot_error")):
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
