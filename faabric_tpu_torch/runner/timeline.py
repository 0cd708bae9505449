"""Render one app's cross-host invocation lifecycle.

    python -m faabric_tpu_torch.runner.timeline <app_id> [--url BASE]
                                                [--trace OUT.json] [--json]

Counterpart of ``faabric_tpu/runner/timeline.py``, with the same text
and Chrome trace for the same ledgers.

Fetches the app's result messages from the planner's REST surface
(EXECUTE_BATCH_STATUS) and renders each message's phase ledger — the
monotonic stamps ``telemetry/lifecycle.py`` wrote at admit, queue exit,
schedule, journal, dispatch, executor queue exit, run start/end, result
push and planner record, across every host the message touched — as an
aligned text timeline plus, with ``--trace``, a Chrome ``trace_event``
file (one row per message; load in chrome://tracing / Perfetto).

Stamps share CLOCK_MONOTONIC on one machine, so messages line up
exactly; on a real multi-host cluster the two wire-crossing phases
absorb the clock offset (documented in docs/telemetry.md).
"""

from __future__ import annotations

import argparse
import json
import sys

from faabric_tpu_torch.telemetry.lifecycle import PHASE_LABELS, ledger_durations

_BAR_WIDTH = 44

# Distinct single-char bar marks per phase: five labels share the
# first letter 'r' (requeue/run_prep/run/result_push/record) — exactly
# the phases this tool exists to tell apart
_BAR_MARKS = {
    "ingress_queue": "q",
    "schedule": "s",
    "journal": "j",
    "dispatch": "d",
    "requeue": "R",
    "executor_queue": "e",
    "run_prep": "p",
    "run": "r",
    "result_push": "u",
    "record": "c",
    "waiter_wake": "w",
}


def fetch_status(base_url: str, app_id: int, timeout: float = 10.0) -> dict:
    """EXECUTE_BATCH_STATUS over the planner REST surface."""
    import urllib.request

    body = json.dumps({
        "http_type": 11,  # HttpMessageType.EXECUTE_BATCH_STATUS
        "payload": json.dumps({"app_id": app_id}),
    }).encode()
    req = urllib.request.Request(
        base_url.rstrip("/"), data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _msg_rows(status: dict) -> list[dict]:
    """Per-message render rows: sorted stamps, durations, span."""
    rows = []
    for m in status.get("messageResults") or []:
        lc = m.get("lc") or {}
        stamps = sorted((int(v), k) for k, v in lc.items()
                        if isinstance(v, (int, float)))
        if not stamps:
            continue
        rows.append({
            "id": m.get("id"),
            "app_idx": m.get("app_idx", 0),
            "host": m.get("executed_host", ""),
            "return_value": m.get("return_value", 0),
            "stamps": stamps,
            "durations": ledger_durations(lc),
            "t0": stamps[0][0],
            "t1": stamps[-1][0],
        })
    rows.sort(key=lambda r: (r["t0"], r["app_idx"]))
    return rows


def render_text(app_id: int, rows: list[dict]) -> str:
    if not rows:
        return (f"app {app_id}: no messages with lifecycle ledgers "
                "(FAABRIC_METRICS=0, or results evicted)")
    t_min = min(r["t0"] for r in rows)
    t_max = max(r["t1"] for r in rows)
    span = max(1, t_max - t_min)
    lines = [f"app {app_id}: {len(rows)} message(s), "
             f"{span / 1e6:.3f} ms wall (ledger span)"]
    for r in rows:
        lines.append(
            f"  msg {r['id']} idx {r['app_idx']} on "
            f"{r['host'] or '?'} rv={r['return_value']} "
            f"({(r['t1'] - r['t0']) / 1e6:.3f} ms)")
        # Bar: each inter-stamp gap as a proportional segment
        bar = [" "] * _BAR_WIDTH
        for i in range(1, len(r["stamps"])):
            a = (r["stamps"][i - 1][0] - t_min) / span
            b = (r["stamps"][i][0] - t_min) / span
            lo = min(_BAR_WIDTH - 1, int(a * _BAR_WIDTH))
            hi = min(_BAR_WIDTH, max(lo + 1, int(b * _BAR_WIDTH)))
            key = r["stamps"][i][1]
            label = PHASE_LABELS.get(key, key)
            mark = _BAR_MARKS.get(label, label[0])
            for j in range(lo, hi):
                bar[j] = mark
        lines.append(f"    [{''.join(bar)}]")
        parts = [f"{label}={secs * 1e3:.3f}ms"
                 for label, secs in sorted(r["durations"].items(),
                                           key=lambda kv: -kv[1])]
        lines.append("    " + "  ".join(parts))
    legend = ", ".join(f"{mark}={label}"
                       for label, mark in _BAR_MARKS.items())
    lines.append(f"  (bar legend: {legend})")
    return "\n".join(lines)


def chrome_trace_events(app_id: int, rows: list[dict]) -> list[dict]:
    """Complete ('X') events per phase, one trace row (tid) per
    message; timestamps are the raw monotonic stamps in µs so multiple
    apps dumped from one cluster line up."""
    events: list[dict] = []
    for r in rows:
        tid = r["app_idx"]
        events.append({"ph": "M", "name": "thread_name", "pid": app_id,
                       "tid": tid,
                       "args": {"name": f"msg {r['id']} "
                                        f"({r['host'] or '?'})"}})
        for i in range(1, len(r["stamps"])):
            t_prev, _ = r["stamps"][i - 1]
            t, key = r["stamps"][i]
            events.append({
                "ph": "X", "pid": app_id, "tid": tid,
                "name": PHASE_LABELS.get(key, key),
                "cat": "lifecycle",
                "ts": t_prev / 1e3,
                "dur": max(0.001, (t - t_prev) / 1e3),
            })
    return events


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m faabric_tpu_torch.runner.timeline",
        description="Render one app's cross-host invocation lifecycle")
    parser.add_argument("app_id", type=int)
    parser.add_argument("--url", default="http://127.0.0.1:8080",
                        help="planner REST base URL")
    parser.add_argument("--trace", default=None, metavar="OUT.json",
                        help="also write a Chrome trace_event file")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable rows")
    args = parser.parse_args(argv)

    try:
        status = fetch_status(args.url, args.app_id)
    except Exception as e:  # noqa: BLE001 — CLI surface
        print(f"timeline: cannot fetch app {args.app_id} from "
              f"{args.url}: {e}", file=sys.stderr)
        return 2
    rows = _msg_rows(status)
    if args.json:
        print(json.dumps({
            "app_id": args.app_id,
            "finished": status.get("finished"),
            "messages": [{k: v for k, v in r.items() if k != "stamps"}
                         for r in rows]}, indent=1))
    else:
        print(render_text(args.app_id, rows))
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump({"traceEvents":
                       chrome_trace_events(args.app_id, rows),
                       "displayTimeUnit": "ms"}, f)
        print(f"chrome trace written to {args.trace}")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
