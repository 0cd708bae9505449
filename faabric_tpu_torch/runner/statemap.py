"""Render the cluster state map.

    python -m faabric_tpu_torch.runner.statemap [--url BASE | --file DOC.json]
                                                [--top N] [--json]

Counterpart of ``faabric_tpu/runner/statemap.py``.

Fetches the planner's ``GET /statemap`` — every host's per-key state
access ledger merged into hot-key-ranked rows (master host, size, byte
totals by origin, locality, pull amplification, lock waits) plus
per-host mastership totals — and renders it as an aligned table.
``--file`` renders a previously saved document instead (either a
``/statemap`` response or a raw ``collect_telemetry`` dump, which is
aggregated on the fly); ``--json`` emits the machine-readable document.
"""

from __future__ import annotations

import argparse
import json
import sys

from faabric_tpu_torch.telemetry.statestats import (
    aggregate_statemap,
    render_statemap,
)


def fetch_statemap(base_url: str, timeout: float = 10.0) -> dict:
    import urllib.request

    url = base_url.rstrip("/") + "/statemap"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _as_statemap(doc: dict) -> dict:
    # A /statemap response has ranked "keys" rows; anything else is
    # treated as a raw telemetry dump and aggregated here
    if isinstance(doc.get("keys"), list):
        return doc
    return aggregate_statemap(doc)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m faabric_tpu_torch.runner.statemap",
        description="Render the cluster state map (GET /statemap)")
    parser.add_argument("--url", default="http://127.0.0.1:8080",
                        help="planner REST base URL")
    parser.add_argument("--file", default=None, metavar="DOC.json",
                        help="render a saved /statemap (or telemetry) "
                             "document instead of fetching")
    parser.add_argument("--top", type=int, default=20,
                        help="key rows to show (default 20)")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable document")
    args = parser.parse_args(argv)

    try:
        if args.file:
            with open(args.file) as f:
                doc = _as_statemap(json.load(f))
        else:
            doc = _as_statemap(fetch_statemap(args.url))
    except Exception as e:  # noqa: BLE001 — CLI surface
        src = args.file or args.url
        print(f"statemap: cannot load state map from {src}: {e}",
              file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(render_statemap(doc, top=args.top))
    return 0 if doc.get("keys") else 1


if __name__ == "__main__":
    sys.exit(main())
