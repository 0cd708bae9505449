"""Cluster doctor: ranked performance/health diagnosis from the
planner's scrape surfaces.

    python -m faabric_tpu_torch.runner.doctor --url http://127.0.0.1:8080
    python -m faabric_tpu_torch.runner.doctor --dir /path/to/dumps
    python -m faabric_tpu_torch.runner.doctor --selftest

Counterpart of ``faabric_tpu/runner/doctor.py``: the same analyzers,
over the port's own telemetry helpers, give the same ranked findings
over the same sources. The admission-shedding, queue-trend and journal
group-commit analyzers read what the planner's ingress reports: its
``ingress`` block on ``/healthz``, its ``ingress_depth`` series on
``/timeseries`` and the journal's group commits.

Ingests ``/perf`` (the rolling performance-profile aggregation),
``/metrics`` (Prometheus text), ``/commmatrix``, ``/healthz`` and
``/topology`` — live over HTTP, or from files dumped earlier
(``perf.json`` / ``perf-cluster.json``, ``metrics.txt``,
``commmatrix.json``, ``healthz.json``, ``topology.json``) so a
post-mortem needs no live cluster — and prints a RANKED diagnosis:

- **slow links** — per-plane, links whose measured bandwidth sits far
  below the cluster median for that plane (the HiCCL "slow rung");
- **straggler ranks** — ranks consistently arriving late at their
  collectives (entry-skew analysis over the merged per-round series,
  annotated with the rank's host via the topology);
- **codec escape storms** — full-frame escapes dwarfing coded frames
  (a link whose delta stream keeps breaking pays for nothing);
- **admission shedding** — the ingress actively 429ing sources;
- **journal fsync pressure** — the group-commit journal's write-behind
  buffer backing up or fsync falling behind its interval;
- **open circuit breakers / keep-alives at risk** — hosts the planner
  is about to give up on;
- **dominant lifecycle phase** — which phase of the
  invocation ledger the p99 end-to-end latency is made of;
- **SLO burn** — declared ``FAABRIC_SLO`` targets burning
  their error budget on every evaluation window;
- **queue growth / capacity exhaustion** — trends from the
  ``/timeseries`` ring: an ingress depth that keeps growing, or free
  slots pinned at zero while a backlog holds;
- **hot-key skew** — one state key's byte traffic dwarfing
  the median of the rest of the ``/statemap``;
- **master hotspot** — one host serving most of the
  cluster's state bytes as master while others sit idle;
- **pull amplification** — a key whose replicas keep
  re-pulling chunks they already pulled clean (total vs first-time
  chunk pulls);
- **lock convoy** — global-lock waits on a key repeatedly
  stalling past ``FAABRIC_STATE_LOCK_STALL_MS``.

``--selftest`` runs the analyzers over a built-in synthetic cluster
with one planted slow link, one planted straggler, an escape storm, a
run-dominated lifecycle tail, a burning latency SLO, a growing
ingress queue, and a state map with a planted hot key, master
hotspot, amplified puller and lock convoy, and exits non-zero unless
all of them rank in the findings.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

# One median, shared with the straggler analysis this tool cross-checks
from faabric_tpu_torch.telemetry.perfprofile import _median

SOURCES = ("perf", "metrics", "commmatrix", "healthz", "topology",
           "timeseries", "statemap", "profile")

# File-name candidates per source for --dir mode (first hit wins)
_FILE_CANDIDATES = {
    "perf": ("perf.json", "perf-cluster.json"),
    "metrics": ("metrics.txt", "metrics.prom", "metrics"),
    "commmatrix": ("commmatrix.json",),
    "healthz": ("healthz.json",),
    "topology": ("topology.json",),
    "timeseries": ("timeseries.json",),
    "statemap": ("statemap.json",),
    "profile": ("profile.json",),
}

# A link must carry this many samples before the doctor will call it
# slow — three frames of noise is not a diagnosis
MIN_LINK_MESSAGES = 5
SLOW_LINK_RATIO = 0.5     # below this × plane median → finding
ESCAPE_STORM_RATIO = 0.05  # escapes / coded frames above this → finding

# State-map analyzers
HOT_KEY_SKEW_RATIO = 8.0      # top key bytes / median of the rest
MIN_HOT_KEY_BYTES = 1 << 20   # noise floor for skew/hotspot calls
MASTER_HOTSPOT_SHARE = 0.7    # one master serving this share of bytes
PULL_AMP_RATIO = 3.0          # total chunk pulls / first-time pulls
MIN_PULL_CHUNKS = 32          # pulls below this are not a pattern
MIN_LOCK_STALLS = 2           # one slow acquire is not a convoy

# State-replication analyzer
REPLICATION_LAG_BYTES = 1 << 20  # acked-but-unforwarded bytes to flag

# CPU-profile analyzers
CPU_HOTSPOT_SHARE = 0.35      # one stack's share of its host's CPU
MIN_HOTSPOT_CPU_MS = 500.0    # noise floor: below this, no hotspot call
GIL_PRESSURE_HIGH = 0.25      # sampler-drift pressure gauge threshold
# Avg runnable threads to call saturation. 0.5, not 1.0: the census
# counts threads that burned >= half a sample window, and one core can
# only sustain ~1 such thread — so on a 1-core host the LIFETIME
# average tops out near the busy fraction and never reaches 1.0.
MIN_GIL_RUNNABLE = 0.5
MIN_PROFILE_SAMPLES = 50      # samples before the profile is evidence
SAMPLER_STARVED_RATIO = 0.6   # samples/expected below this → starved


# ---------------------------------------------------------------------------
# Ingestion
# ---------------------------------------------------------------------------

def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Minimal exposition-format parser: name → [(labels, value)].
    Histogram series keep their _bucket/_sum/_count suffixed names."""
    out: dict[str, list[tuple[dict, float]]] = {}
    label_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    for line in (text or "").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            metric, value_s = line.rsplit(" ", 1)
            value = float(value_s)
        except ValueError:
            continue
        if "{" in metric:
            name, _, rest = metric.partition("{")
            labels = {m.group(1): m.group(2).replace('\\"', '"')
                      for m in label_re.finditer(rest)}
        else:
            name, labels = metric, {}
        out.setdefault(name, []).append((labels, value))
    return out


def fetch_live(base_url: str, timeout: float = 10.0) -> dict:
    """Scrape every source from a live planner endpoint. A failing
    source becomes None (the checks degrade, the doctor still runs)."""
    import urllib.request

    base = base_url.rstrip("/")
    sources: dict = {}
    for name in SOURCES:
        url = f"{base}/{name}"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                body = resp.read().decode()
        except Exception as e:  # noqa: BLE001 — diagnosis must degrade
            print(f"doctor: {url} unavailable ({e})", file=sys.stderr)
            sources[name] = None
            continue
        sources[name] = (parse_prometheus(body) if name == "metrics"
                         else json.loads(body))
    return sources


def load_dir(directory: str) -> dict:
    """Sources from dumped files (missing files → None)."""
    sources: dict = {}
    for name in SOURCES:
        sources[name] = None
        for candidate in _FILE_CANDIDATES[name]:
            path = os.path.join(directory, candidate)
            if not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    body = f.read()
            except OSError as e:
                print(f"doctor: cannot read {path}: {e}", file=sys.stderr)
                continue
            try:
                sources[name] = (parse_prometheus(body)
                                 if name == "metrics"
                                 else json.loads(body))
            except json.JSONDecodeError as e:
                print(f"doctor: bad JSON in {path}: {e}", file=sys.stderr)
            break
    return sources


# ---------------------------------------------------------------------------
# Checks — each returns findings: {"severity", "kind", "subject", "detail"}
# ---------------------------------------------------------------------------



def _link_gibs_rows(perf: dict) -> list[dict]:
    """Per-(src, dst, plane) best bandwidth evidence from the /perf link
    table: collapse codec/size-class cells onto their link, preferring
    the bytes-weighted average rate (the comm-matrix-comparable figure),
    falling back to the EWMA."""
    links: dict[tuple, dict] = {}
    for row in perf.get("links") or []:
        gibs = row.get("gibs_avg") or row.get("gibs_ewma")
        if gibs is None:
            continue
        key = (row.get("src"), row.get("dst"), row.get("plane"))
        cur = links.get(key)
        messages = row.get("messages") or 0
        nbytes = row.get("bytes") or 0
        if cur is None:
            links[key] = {"src": key[0], "dst": key[1], "plane": key[2],
                          "gibs": gibs, "messages": messages,
                          "bytes": nbytes}
        else:
            # Bytes-weighted merge across size classes/codecs
            tot = cur["bytes"] + nbytes
            if tot > 0:
                cur["gibs"] = ((cur["gibs"] * cur["bytes"]
                                + gibs * nbytes) / tot)
            cur["messages"] += messages
            cur["bytes"] = tot
    return list(links.values())


def check_slow_links(perf: dict | None) -> list[dict]:
    if not perf:
        return []
    findings = []
    rows = [r for r in _link_gibs_rows(perf)
            if (r["messages"] or 0) >= MIN_LINK_MESSAGES
            and r["dst"] not in ("mesh",)]
    by_plane: dict[str, list[dict]] = {}
    for r in rows:
        by_plane.setdefault(r["plane"], []).append(r)
    for plane, plane_rows in by_plane.items():
        if len(plane_rows) < 2:
            continue  # nothing to compare against
        med = _median([r["gibs"] for r in plane_rows])
        if med <= 0:
            continue
        for r in plane_rows:
            ratio = r["gibs"] / med
            if ratio < SLOW_LINK_RATIO:
                findings.append({
                    "kind": "slow_link",
                    "severity": min(95.0, 50.0 + 45.0 * (1.0 - ratio)),
                    "subject": f"{r['src']}→{r['dst']} ({plane})",
                    "detail": (f"{r['gibs']:.3f} GiB/s vs plane median "
                               f"{med:.3f} ({ratio:.0%}); "
                               f"{r['messages']} msgs, "
                               f"{r['bytes'] >> 20} MiB"),
                })
    return findings


def _rank_host(topology: dict | None, rank, size=None) -> str | None:
    """Weak topology fallback when the perf row carries no host: only a
    world whose size matches disambiguates (the topology's worlds are
    keyed by app id, every world has ranks 0..n-1, and a bare rank
    number matches all of them — so without a size hint that matches
    exactly one world, no attribution is honest)."""
    candidates = []
    for world in (topology or {}).get("worlds", {}).values():
        if size is not None and world.get("size") != size:
            continue
        for host, ranks in (world.get("hosts") or {}).items():
            if int(rank) in [int(r) for r in ranks]:
                candidates.append(host)
    return candidates[0] if len(candidates) == 1 else None


def check_stragglers(perf: dict | None,
                     topology: dict | None) -> list[dict]:
    if not perf:
        return []
    findings = []
    for s in perf.get("stragglers") or []:
        skew_ms = (s.get("median_skew_s") or 0.0) * 1e3
        # Exact placement rides the /perf row itself (the merge knows
        # which host's telemetry carried each rank); topology is only
        # a weak fallback for older dumps
        host = s.get("host") or _rank_host(topology, s.get("rank"))
        where = f" on {host}" if host else ""
        findings.append({
            "kind": "straggler",
            "severity": min(90.0, 40.0 + 10.0 * min(5.0, skew_ms / 10.0)
                            + 5.0 * min(4, s.get("rounds_flagged", 0))),
            "subject": (f"rank {s.get('rank')}{where} "
                        f"(world {s.get('world')}, "
                        f"{s.get('collective')})"),
            "detail": (f"arrives {skew_ms:.1f} ms late (median skew) in "
                       f"{s.get('rounds_flagged')}/"
                       f"{s.get('rounds_seen')} rounds"),
        })
    return findings


def check_codec_escapes(metrics: dict | None) -> list[dict]:
    if not metrics:
        return []
    escapes = sum(v for _l, v in
                  metrics.get("faabric_codec_escapes_total", []))
    frames = sum(v for _l, v in
                 metrics.get("faabric_codec_frames_total", []))
    if frames < 20 or escapes <= 0:
        return []
    ratio = escapes / frames
    if ratio < ESCAPE_STORM_RATIO:
        return []
    reasons: dict[str, float] = {}
    for labels, v in metrics.get("faabric_codec_escapes_total", []):
        if v > 0:
            key = labels.get("reason", "?")
            reasons[key] = reasons.get(key, 0) + v
    top = sorted(reasons.items(), key=lambda kv: -kv[1])
    return [{
        "kind": "codec_escape_storm",
        "severity": min(85.0, 30.0 + 100.0 * ratio),
        "subject": "wire-codec plane",
        "detail": (f"{int(escapes)} full-frame escapes vs {int(frames)} "
                   f"coded frames ({ratio:.1%}); top reasons: "
                   + ", ".join(f"{k}={int(v)}" for k, v in top[:3])),
    }]


def check_healthz(healthz: dict | None) -> list[dict]:
    if not healthz:
        return []
    findings = []
    ingress = healthz.get("ingress") or {}
    shed = ingress.get("shedTotal") or 0
    admitted = ingress.get("admittedTotal") or 0
    if shed > 0:
        ratio = shed / max(1, shed + admitted)
        findings.append({
            "kind": "admission_shed",
            "severity": min(80.0, 25.0 + 100.0 * ratio),
            "subject": "ingress admission",
            "detail": (f"{shed} invocations shed vs {admitted} admitted "
                       f"({ratio:.1%}); queue "
                       f"{ingress.get('queueDepth')}/"
                       f"{ingress.get('queueMax')}"),
        })
    journal = healthz.get("journal") or {}
    if journal.get("enabled"):
        buffered = journal.get("bufferedRecords") or 0
        age = journal.get("lastFsyncAgeSeconds")
        interval = journal.get("fsyncIntervalSeconds") or 0.05
        pressured = buffered > 256 or (
            journal.get("dirty") and age is not None
            and age > max(1.0, 20 * interval))
        if pressured:
            findings.append({
                "kind": "journal_fsync_pressure",
                "severity": min(75.0, 30.0 + buffered / 32.0),
                "subject": "planner journal",
                "detail": (f"{buffered} buffered records, last fsync "
                           f"{age}s ago (interval {interval}s)"),
            })
    for row in healthz.get("hosts") or []:
        breaker = row.get("breaker") or {}
        if breaker.get("state") == "open":
            findings.append({
                "kind": "breaker_open",
                "severity": 88.0,
                "subject": f"host {row.get('host')}",
                "detail": (f"circuit breaker OPEN after "
                           f"{breaker.get('consecutiveFailures')} "
                           "consecutive failures — dispatches to this "
                           "host fail fast"),
            })
        age = row.get("keepAliveAgeSeconds")
        timeout = row.get("timeoutSeconds")
        if (age is not None and timeout
                and age > 0.8 * timeout):
            findings.append({
                "kind": "keepalive_at_risk",
                "severity": 70.0,
                "subject": f"host {row.get('host')}",
                "detail": (f"last keep-alive {age:.1f}s ago "
                           f"(expiry at {timeout}s) — about to be "
                           "expired and its work requeued"),
            })
    perf_block = healthz.get("perf") or {}
    agg_age = perf_block.get("lastAggregationAgeSeconds")
    if agg_age is not None and agg_age > 600:
        findings.append({
            "kind": "perf_stale",
            "severity": 20.0,
            "subject": "performance profiles",
            "detail": (f"last /perf aggregation {agg_age:.0f}s ago — "
                       "diagnosis below may be stale"),
        })
    return findings


def check_lifecycle(healthz: dict | None) -> list[dict]:
    """Dominant-phase ranking for the p99 end-to-end tail:
    the invocation ledger's per-phase digests, ranked by their own p99
    — in the mostly-serial invocation pipeline the phase with the
    fattest tail is what the e2e p99 is made of. Always reported when
    enough invocations folded (the attribution IS the diagnosis; the
    severity scales with how dominant the leader is)."""
    lifecycle = (healthz or {}).get("lifecycle") or {}
    if (lifecycle.get("count") or 0) < 20:
        return []
    dominant = lifecycle.get("dominant_p99") or []
    e2e = lifecycle.get("e2e") or {}
    if not dominant or not e2e:
        return []
    top = dominant[0]
    share = top.get("share_of_e2e_p99") or 0.0
    runners = ", ".join(
        f"{d.get('phase')}={d.get('p99_ms')}ms" for d in dominant[1:4])
    return [{
        "kind": "dominant_phase",
        "severity": min(65.0, 25.0 + 40.0 * min(1.0, share)),
        "subject": f"lifecycle phase '{top.get('phase')}'",
        "detail": (f"p99 e2e {e2e.get('p99_ms')} ms over "
                   f"{lifecycle.get('count')} invocations; "
                   f"'{top.get('phase')}' p99 {top.get('p99_ms')} ms "
                   f"({share:.0%} of the e2e p99)"
                   + (f"; then {runners}" if runners else "")),
    }]


def check_slo(healthz: dict | None) -> list[dict]:
    """Burning SLO targets: every declared target whose burn
    rate exceeds the threshold on ALL evaluation windows."""
    slo = (healthz or {}).get("slo") or {}
    findings = []
    for t in slo.get("targets") or []:
        windows = t.get("windows") or {}
        if not t.get("burning"):
            continue
        burns = ", ".join(f"{w}×{row.get('burn')}"
                          for w, row in sorted(windows.items()))
        findings.append({
            "kind": "slo_burn",
            "severity": 92.0,
            "subject": f"SLO {t.get('name')}",
            "detail": (f"burning its error budget on every window "
                       f"(burn rates: {burns}; budget "
                       f"{t.get('budget')}"
                       + (f", threshold {t.get('threshold_ms')} ms"
                          if t.get("threshold_ms") else "") + ")"),
        })
    return findings


def _series_points(timeseries: dict | None, host: str,
                   name: str) -> list[list]:
    hosts = (timeseries or {}).get("hosts") or {}
    return ((hosts.get(host) or {}).get("series") or {}).get(name) or []


def _slope_per_s(points: list[list]) -> float:
    """Least-squares slope of [[t, v], ...] (0 with <2 points)."""
    n = len(points)
    if n < 2:
        return 0.0
    ts = [p[0] for p in points]
    vs = [p[1] for p in points]
    mt, mv = sum(ts) / n, sum(vs) / n
    var = sum((t - mt) ** 2 for t in ts)
    if var <= 0:
        return 0.0
    return sum((t - mt) * (v - mv) for t, v in points) / var


def check_queue_trend(timeseries: dict | None) -> list[dict]:
    """Trends the point-in-time counters cannot show: an
    ingress queue that keeps GROWING (backlog outrunning the ticks —
    collapse in progress, not a burst), and free slots pinned at zero
    while a backlog holds (capacity exhaustion)."""
    findings = []
    depth = _series_points(timeseries, "planner", "ingress_depth")
    if len(depth) >= 5:
        head = [v for _t, v in depth[:3]]
        tail = [v for _t, v in depth[-3:]]
        start = sum(head) / len(head)
        end = sum(tail) / len(tail)
        slope = _slope_per_s(depth)
        if end >= 10 and end >= 2 * max(1.0, start) and slope > 0:
            findings.append({
                "kind": "queue_growth",
                "severity": min(90.0, 45.0 + 5.0 * min(8.0, slope)),
                "subject": "ingress admission queue",
                "detail": (f"depth grew {start:.0f} → {end:.0f} over "
                           f"{depth[-1][0] - depth[0][0]:.0f}s "
                           f"({slope:+.1f}/s) — backlog is outrunning "
                           "the scheduling ticks"),
            })
    free = _series_points(timeseries, "planner", "free_slots")
    if len(free) >= 5 and len(depth) >= 1:
        recent = [v for _t, v in free[-5:]]
        backlog = depth[-1][1] if depth else 0
        if max(recent) <= 0 and backlog > 0:
            findings.append({
                "kind": "capacity_exhausted",
                "severity": 78.0,
                "subject": "cluster capacity",
                "detail": (f"free-slot watermark pinned at 0 for the "
                           f"last {len(recent)} samples while "
                           f"{backlog:.0f} messages queue — add "
                           "capacity or shed harder"),
            })
    return findings


def check_profile_matrix_agreement(perf: dict | None,
                                   commmatrix: dict | None) -> list[dict]:
    """Cross-check: per source host, the profile store's bytes-weighted
    bulk rate vs the comm matrix's bytes/latency for the same host's
    outbound bulk rows. Large disagreement points at a broken feed, not
    a slow link — surfaced as its own finding."""
    if not perf or not commmatrix:
        return []
    findings = []
    per_host_rows: dict[str, list[dict]] = {}
    for r in _link_gibs_rows(perf):
        if r["plane"] == "bulk-tcp":
            per_host_rows.setdefault(r["src"], []).append(r)
    for host, rows in per_host_rows.items():
        cells = (commmatrix.get("hosts") or {}).get(host) or []
        # WIRE bytes, not bytes_raw: the profile store observes what
        # crossed the wire, so a compressed link's honest comparison is
        # wire/latency on both sides (raw/latency would differ by the
        # compression ratio and cry wolf on every delta link)
        m_bytes = sum(c.get("bytes", 0)
                      for c in cells if c.get("plane") == "bulk-tcp")
        m_lat = sum(c.get("lat_sum", 0.0) for c in cells
                    if c.get("plane") == "bulk-tcp")
        if m_lat <= 0 or m_bytes <= 0:
            continue
        matrix_gibs = (m_bytes / m_lat) / (1 << 30)
        tot_bytes = sum(r["bytes"] for r in rows)
        if tot_bytes <= 0:
            continue
        profile_gibs = sum(r["gibs"] * r["bytes"]
                           for r in rows) / tot_bytes
        if matrix_gibs <= 0:
            continue
        err = abs(profile_gibs - matrix_gibs) / matrix_gibs
        if err > 0.5:
            findings.append({
                "kind": "profile_matrix_disagreement",
                "severity": 35.0,
                "subject": f"host {host} (bulk-tcp)",
                "detail": (f"profile says {profile_gibs:.2f} GiB/s, "
                           f"comm matrix {matrix_gibs:.2f} "
                           f"({err:.0%} apart) — check the feed points"),
            })
    return findings


def _statemap_keys(statemap: dict | None) -> list[dict]:
    """Ranked key rows minus the cardinality-overflow bucket."""
    return [r for r in (statemap or {}).get("keys") or []
            if r.get("key") != "other"]


def check_hot_key_skew(statemap: dict | None) -> list[dict]:
    """One key's byte traffic dwarfing the median of the rest : the rebuild's replicate-or-repartition candidate. Needs at
    least three keys — skew against nothing is not a diagnosis."""
    rows = [r for r in _statemap_keys(statemap)
            if (r.get("bytes_total") or 0) > 0]
    if len(rows) < 3:
        return []
    top = rows[0]  # aggregate_statemap ranks by -bytes_total
    med = _median([r.get("bytes_total") or 0 for r in rows[1:]])
    if top["bytes_total"] < MIN_HOT_KEY_BYTES or med <= 0:
        return []
    ratio = top["bytes_total"] / med
    if ratio < HOT_KEY_SKEW_RATIO:
        return []
    origins = sorted((top.get("by_origin") or {}).items(),
                     key=lambda kv: -kv[1].get("bytes", 0))
    origin_s = ", ".join(f"{h}={o.get('bytes', 0) >> 20}MiB"
                         for h, o in origins[:3])
    return [{
        "kind": "hot_key_skew",
        "severity": min(82.0, 45.0 + ratio),
        "subject": f"state key {top.get('key')}",
        "detail": (f"{top['bytes_total'] >> 20} MiB of traffic vs "
                   f"{max(1, int(med)) >> 20} MiB median across "
                   f"{len(rows) - 1} other key(s) ({ratio:.0f}×); "
                   f"master {top.get('master') or '?'}"
                   + (f"; by origin: {origin_s}" if origin_s else "")),
    }]


def check_master_hotspot(statemap: dict | None) -> list[dict]:
    """One host serving most of the cluster's state bytes as master
   . Served bytes per master = the traffic of every key it
    masters; only meaningful once a second host participates."""
    rows = _statemap_keys(statemap)
    served: dict[str, int] = {}
    for r in rows:
        master = r.get("master")
        if master:
            served[master] = (served.get(master, 0)
                              + (r.get("bytes_total") or 0))
    hosts = (statemap or {}).get("hosts") or {}
    involved = set(served) | {h for h, row in hosts.items()
                              if (row.get("origin_bytes") or 0) > 0}
    total = sum(served.values())
    if len(involved) < 2 or total < MIN_HOT_KEY_BYTES:
        return []
    top_host, top_bytes = max(served.items(), key=lambda kv: kv[1])
    share = top_bytes / total
    if share < MASTER_HOTSPOT_SHARE:
        return []
    n_keys = sum(1 for r in rows if r.get("master") == top_host)
    return [{
        "kind": "master_hotspot",
        "severity": min(80.0, 40.0 + 40.0 * share),
        "subject": f"host {top_host}",
        "detail": (f"masters {n_keys} key(s) carrying "
                   f"{top_bytes >> 20} MiB of the cluster's "
                   f"{total >> 20} MiB state traffic ({share:.0%}) "
                   f"across {len(involved)} involved host(s) — "
                   "rebalance mastership or replicate the hot keys"),
    }]


def check_pull_amplification(statemap: dict | None) -> list[dict]:
    """Replicas repeatedly re-pulling chunks they already pulled clean
   : total chunk pulls far above first-time pulls means the
    full-image invalidation is throwing away clean chunks a future
    delta-pull path would keep."""
    findings = []
    for r in _statemap_keys(statemap):
        total = r.get("pull_chunks_total") or 0
        fresh = r.get("pull_chunks_fresh") or 0
        if total < MIN_PULL_CHUNKS or fresh <= 0:
            continue
        amp = total / fresh
        if amp < PULL_AMP_RATIO:
            continue
        findings.append({
            "kind": "pull_amplification",
            "severity": min(75.0, 30.0 + amp),
            "subject": f"state key {r.get('key')}",
            "detail": (f"{total} chunk pulls for {fresh} first-time "
                       f"chunks ({amp:.1f}× amplification) — replicas "
                       "keep re-pulling clean chunks; consider "
                       "version-gated or delta pulls"),
        })
    return findings


def check_lock_convoy(statemap: dict | None) -> list[dict]:
    """Global-lock waits on a key repeatedly stalling past
    FAABRIC_STATE_LOCK_STALL_MS: writers convoying on one
    lock serialise the cluster no matter how fast the links are."""
    findings = []
    for r in _statemap_keys(statemap):
        stalls = r.get("lock_stalls") or 0
        waits = r.get("lock_waits") or 0
        if stalls < MIN_LOCK_STALLS:
            continue
        ratio = stalls / max(1, waits)
        findings.append({
            "kind": "lock_convoy",
            "severity": min(85.0, 45.0 + stalls + 40.0 * ratio),
            "subject": f"state key {r.get('key')}",
            "detail": (f"{stalls} of {waits} global-lock waits stalled "
                       f"past the threshold ({ratio:.0%}) — writers are "
                       "convoying; shard the key or batch the locked "
                       "section"),
        })
    return findings


def check_state_unreplicated(statemap: dict | None) -> list[dict]:
    """A fenced key (epoch > 0 means the replication plane placed it)
    running without a live backup, or with a backup lagging the acked
    bytes: one more crash loses acknowledged writes. Epoch-0
    keys are exempt — FAABRIC_STATE_REPLICAS=0 opted them out."""
    findings = []
    for r in _statemap_keys(statemap):
        epoch = r.get("epoch") or 0
        if epoch <= 0:
            continue
        backup = r.get("backup") or ""
        lag = r.get("replication_lag") or 0
        if not backup:
            findings.append({
                "kind": "state_unreplicated",
                "severity": 78.0,
                "subject": f"state key {r.get('key')}",
                "detail": (f"fenced at epoch {epoch} on master "
                           f"{r.get('master') or '?'} with NO backup "
                           "host — acked writes have a single copy; "
                           "one more crash loses them (add hosts or "
                           "check the planner's backup election)"),
            })
        elif lag >= REPLICATION_LAG_BYTES:
            findings.append({
                "kind": "state_unreplicated",
                "severity": 60.0,
                "subject": f"state key {r.get('key')}",
                "detail": (f"backup {backup} lags the master "
                           f"{r.get('master') or '?'} by {lag >> 20} "
                           "MiB of acked bytes (anti-entropy still "
                           "streaming, or forwards failing) — the key "
                           "is not crash-safe until the lag drains"),
            })
    return findings


def check_cpu_hotspot(profile: dict | None) -> list[dict]:
    """One collapsed stack burning an outsized share of its host's
    sampled CPU: the direct evidence the planner-shard /
    native-transport ROADMAP items need — WHICH frames to move, not
    just that the process is busy."""
    findings = []
    if not profile:
        return findings
    per_host: dict[str, list[dict]] = {}
    for row in profile.get("stacks") or []:
        per_host.setdefault(row.get("host", "?"), []).append(row)
    for host, rows in sorted(per_host.items()):
        host_cpu = sum(r.get("cpu_ms") or 0.0 for r in rows)
        if host_cpu < MIN_HOTSPOT_CPU_MS:
            continue
        top = max(rows, key=lambda r: r.get("cpu_ms") or 0.0)
        share = (top.get("cpu_ms") or 0.0) / host_cpu
        if share < CPU_HOTSPOT_SHARE:
            continue
        frames = top.get("frames") or ["?"]
        findings.append({
            "kind": "cpu_hotspot",
            "severity": min(90.0, 50.0 + 40.0 * share),
            "subject": f"{host} thread {top.get('class', '?')}",
            "detail": (f"one stack burns {share:.0%} of the host's "
                       f"{host_cpu:.0f} ms sampled CPU — hot frame "
                       f"{frames[-1]}; move or shard it before adding "
                       "threads (they'd contend, not help)"),
        })
    return findings


def check_gil_saturation(profile: dict | None,
                         metrics: dict | None = None) -> list[dict]:
    """A process whose sampler wakeups drift late while multiple
    threads stay runnable: the threads are serialized on the
    interpreter, so adding more buys queueing, not throughput. Cross-
    checked against the lockcheck hold-time histogram when present — a
    lock convoy shows the same drift but names a lock site instead."""
    findings = []
    if not profile:
        return findings
    # Mean lockcheck hold time, if the metrics source carries it: long
    # holds mean the stall is A lock, not THE lock (the GIL)
    hold_note = ""
    if metrics:
        hold_sum = sum(v for _, v in
                       metrics.get("faabric_lock_hold_seconds_sum", []))
        hold_cnt = sum(v for _, v in
                       metrics.get("faabric_lock_hold_seconds_count",
                                   []))
        if hold_cnt > 0 and hold_sum / hold_cnt > 0.001:
            hold_note = (f" (lockcheck mean hold "
                         f"{1000.0 * hold_sum / hold_cnt:.1f} ms — "
                         "suspect a lock convoy before the GIL)")
    hosts_meta = profile.get("hosts") or {}
    for host, gil in sorted((profile.get("gil") or {}).items()):
        pressure = gil.get("pressure") or 0.0
        runnable = gil.get("runnable_avg") or 0.0
        samples = (hosts_meta.get(host) or {}).get("samples") or 0
        if samples < MIN_PROFILE_SAMPLES:
            continue
        if pressure < GIL_PRESSURE_HIGH or runnable < MIN_GIL_RUNNABLE:
            continue
        findings.append({
            "kind": "gil_saturation",
            "severity": min(88.0, 40.0 + 50.0 * pressure),
            "subject": f"{host} (pid {(hosts_meta.get(host) or {}).get('pid')})",
            "detail": (f"sampler wakeups drift {pressure:.0%} of the "
                       f"interval late with {runnable:.1f} threads "
                       "runnable on average — the process is "
                       "interpreter-bound; shard the work across "
                       f"processes, not threads{hold_note}"),
        })
    return findings


def check_sampler_starved(profile: dict | None) -> list[dict]:
    """The profiler itself missing most of its wakeups:
    every other profile finding from that host is undercounted, so say
    so — low severity, but it gates trust in the rest."""
    findings = []
    if not profile:
        return findings
    for host, meta in sorted((profile.get("hosts") or {}).items()):
        expected = meta.get("expected_samples") or 0
        samples = meta.get("samples") or 0
        if expected < MIN_PROFILE_SAMPLES:
            continue
        ratio = samples / expected
        if ratio >= SAMPLER_STARVED_RATIO:
            continue
        findings.append({
            "kind": "sampler_starved",
            "severity": 25.0,
            "subject": f"{host} profiler",
            "detail": (f"only {samples} of {expected} scheduled "
                       f"samples ran ({ratio:.0%}) — the box is "
                       "saturated enough to starve a 25 ms timer; "
                       "this host's profile UNDERCOUNTS its hotspots"),
        })
    return findings


def diagnose(sources: dict) -> list[dict]:
    """Every check over whatever sources are present, ranked most-severe
    first."""
    findings: list[dict] = []
    findings += check_slow_links(sources.get("perf"))
    findings += check_stragglers(sources.get("perf"),
                                 sources.get("topology"))
    findings += check_codec_escapes(sources.get("metrics"))
    findings += check_healthz(sources.get("healthz"))
    findings += check_lifecycle(sources.get("healthz"))
    findings += check_slo(sources.get("healthz"))
    findings += check_queue_trend(sources.get("timeseries"))
    findings += check_profile_matrix_agreement(sources.get("perf"),
                                               sources.get("commmatrix"))
    findings += check_hot_key_skew(sources.get("statemap"))
    findings += check_master_hotspot(sources.get("statemap"))
    findings += check_pull_amplification(sources.get("statemap"))
    findings += check_lock_convoy(sources.get("statemap"))
    findings += check_state_unreplicated(sources.get("statemap"))
    findings += check_cpu_hotspot(sources.get("profile"))
    findings += check_gil_saturation(sources.get("profile"),
                                     sources.get("metrics"))
    findings += check_sampler_starved(sources.get("profile"))
    findings.sort(key=lambda f: -f["severity"])
    return findings


def render(findings: list[dict], top: int = 0) -> str:
    if not findings:
        return "doctor: no findings — cluster looks healthy"
    rows = findings[:top] if top else findings
    lines = [f"doctor: {len(findings)} finding(s)"
             + (f", top {len(rows)}:" if top and top < len(findings)
                else ":")]
    for i, f in enumerate(rows, 1):
        lines.append(f"{i:3d}. [{f['severity']:5.1f}] "
                     f"{f['kind']:<28} {f['subject']}")
        lines.append(f"      {f['detail']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Selftest fixture
# ---------------------------------------------------------------------------

def selftest_sources() -> dict:
    """A synthetic 3-host cluster with one planted slow link (hA→hC at
    ~1/10 of the plane median), one planted straggler (rank 5 arriving
    ~40 ms late every round), a codec escape storm, a run-dominated
    lifecycle tail, a burning p99 latency SLO, an ingress queue
    growing through the time-series window, and a state map
    with a hot key on a master hotspot, an amplified puller and a lock
    convoy."""
    def link(src, dst, gibs, messages=200, nbytes=512 << 20):
        return {"src": src, "dst": dst, "plane": "bulk-tcp",
                "codec": "raw", "size_class": "1MiB",
                "messages": messages, "bytes": nbytes,
                "gibs_avg": gibs, "gibs_ewma": gibs}

    rounds = {}
    base_ts = 1000.0
    for i in range(8):
        rd = {}
        for rank in range(8):
            # End-aligned synchronous rounds: rank 5 idles 40 ms before
            # entering, everyone else's total absorbs the wait
            late = 0.040 if rank == 5 else 0.0
            rd[str(rank)] = {"enter_ts": base_ts + i * 0.1 + late,
                             "total": 0.055 - late}
        rounds[str(i)] = rd
    from faabric_tpu_torch.telemetry import find_stragglers

    stragglers = [{"world": 900, "collective": "allreduce",
                   "rank": int(r), "host": "hC", **st}
                  for r, st in find_stragglers(rounds).items()]
    perf = {
        "links": [link("hA", "hB", 2.2), link("hB", "hA", 2.0),
                  link("hB", "hC", 2.4), link("hC", "hB", 2.1),
                  link("hC", "hA", 1.9),
                  link("hA", "hC", 0.21)],  # the planted slow link
        "collectives": [{"world": 900, "collective": "allreduce",
                         "completed": 64, "rounds": rounds,
                         "stragglers": {"5": stragglers[0]}
                         if stragglers else {}}],
        "stragglers": stragglers,
        "hosts": ["hA", "hB", "hC"],
    }
    metrics = {
        "faabric_codec_frames_total": [({"codec": "delta"}, 900.0)],
        "faabric_codec_escapes_total": [({"reason": "nack"}, 120.0),
                                        ({"reason": "crc"}, 30.0)],
    }
    def phase(p50, p99):
        return {"p50_ms": p50, "p90_ms": p99 * 0.8, "p99_ms": p99,
                "mean_ms": p50, "count": 4000}

    lifecycle_phases = {
        "ingress_queue": phase(0.4, 2.0),
        "schedule": phase(0.3, 1.1),
        "dispatch": phase(0.2, 0.9),
        "executor_queue": phase(1.0, 4.0),
        "run": phase(20.0, 61.0),  # the planted dominant phase
        "result_push": phase(0.3, 1.5),
        "record": phase(0.5, 2.5),
    }
    e2e = phase(24.0, 68.0)
    dominant = sorted(lifecycle_phases.items(),
                      key=lambda kv: -kv[1]["p99_ms"])
    healthz = {
        "status": "ok",
        "hosts": [{"host": h, "keepAliveAgeSeconds": 1.0,
                   "timeoutSeconds": 30, "breaker": None}
                  for h in ("hA", "hB", "hC")],
        "ingress": {"shedTotal": 0, "admittedTotal": 5000,
                    "queueDepth": 3, "queueMax": 1024},
        "journal": {"enabled": True, "bufferedRecords": 2,
                    "dirty": False, "lastFsyncAgeSeconds": 0.01,
                    "fsyncIntervalSeconds": 0.05},
        "perf": {"lastAggregationAgeSeconds": 5.0},
        "lifecycle": {
            "count": 4000, "failed": 0, "e2e": e2e,
            "phases": lifecycle_phases,
            "dominant_p99": [
                {"phase": label, "p99_ms": row["p99_ms"],
                 "share_of_e2e_p99": round(row["p99_ms"]
                                           / e2e["p99_ms"], 4)}
                for label, row in dominant],
        },
        "slo": {
            "spec": "p99_e2e_ms=50,error_rate=0.001",
            "burnThreshold": 2.0, "windowsSeconds": [60, 600],
            "ignored": [],
            "targets": [
                {"name": "p99_e2e_ms", "kind": "latency",
                 "budget": 0.01, "threshold_ms": 50.0, "burning": True,
                 "windows": {"60s": {"total": 800, "bad": 40,
                                     "burn": 5.0},
                             "600s": {"total": 4000, "bad": 160,
                                      "burn": 4.0}}},
                {"name": "error_rate", "kind": "error", "budget": 0.001,
                 "threshold_ms": None, "burning": False,
                 "windows": {"60s": {"total": 800, "bad": 0,
                                     "burn": 0.0},
                             "600s": {"total": 4000, "bad": 0,
                                      "burn": 0.0}}}],
        },
    }
    # The planted queue growth: depth ramps 2 → 60 across the window
    ts0 = 2000.0
    depth_pts = [[ts0 + i, 2.0 + 2.0 * i] for i in range(30)]
    timeseries = {"hosts": {"planner": {"series": {
        "ingress_depth": depth_pts,
        "free_slots": [[ts0 + i, max(0.0, 8.0 - i)] for i in range(30)],
    }}}}
    topology = {"hosts": {}, "worlds": {
        "900": {"size": 8,
                "hosts": {"hA": [0, 1, 2, 3], "hC": [4, 5, 6, 7]}}}}

    # plants, built through the real merge so the selftest
    # also exercises aggregate_statemap: demo/hot dominates the byte
    # traffic (hot-key skew) and is mastered on hA, which thereby
    # serves ~95% of the cluster's state bytes (master hotspot);
    # demo/amplified re-pulls its chunks 50× (pull amplification);
    # demo/locky stalls 24 of 120 lock waits (lock convoy).
    from faabric_tpu_torch.telemetry import aggregate_statemap

    def krow(key, **kw):
        row = {"key": key, "master": "", "size": 0, "is_master": False,
               "ops_total": 0, "bytes_total": 0,
               "local_reads": 0, "remote_reads": 0,
               "pull_chunks_total": 0, "pull_chunks_fresh": 0,
               "lock_waits": 0, "lock_stalls": 0}
        row.update(kw)
        return row

    def block(*rows):
        return {"statestats": {"keys": list(rows), "snapshots": {},
                               "registry_bytes": 0, "max_keys": 256}}

    # plants: demo/fragile is fenced (epoch 3) but has no
    # backup host (state_unreplicated); demo/hot is fenced AND backed
    # up with zero lag and must NOT be flagged.
    state_tel = {
        "hA": block(
            krow("demo/hot", is_master=True, size=64 << 20,
                 ops_total=5000, bytes_total=1 << 30, local_reads=5000,
                 backup="hB", epoch=1, replication_lag=0),
            krow("demo/fragile", is_master=True, size=4 << 20,
                 ops_total=40, bytes_total=8 << 20, local_reads=40,
                 backup="", epoch=3, replication_lag=4 << 20),
            krow("demo/amplified", is_master=True, size=8 << 20,
                 ops_total=50, bytes_total=32 << 20, local_reads=50)),
        "hB": block(
            krow("demo/hot", master="hA", size=64 << 20, ops_total=3000,
                 bytes_total=1 << 30, remote_reads=3000,
                 pull_chunks_total=600, pull_chunks_fresh=580),
            krow("demo/amplified", master="hA", ops_total=900,
                 bytes_total=200 << 20, remote_reads=900,
                 pull_chunks_total=5000, pull_chunks_fresh=100),
            krow("demo/locky", master="hC", ops_total=120,
                 bytes_total=1 << 20, lock_waits=120, lock_stalls=24)),
        "hC": block(
            krow("demo/locky", is_master=True, size=1 << 20,
                 ops_total=10, bytes_total=1 << 20, local_reads=10),
            krow("demo/cold0", is_master=True, size=1 << 20,
                 ops_total=20, bytes_total=2 << 20, local_reads=20),
            krow("demo/cold1", is_master=True, size=1 << 20,
                 ops_total=20, bytes_total=2 << 20, local_reads=20)),
    }
    statemap = aggregate_statemap(state_tel)

    # plants, built through the real aggregate_profile so the
    # selftest also exercises the profile merge: hA burns ~70% of its
    # CPU in one planner/tick stack (cpu_hotspot) while its sampler
    # drifts 60% late with 3 runnable threads (gil_saturation); hB is
    # idle and must yield ZERO profile findings; hC's sampler ran only
    # 300 of 1000 scheduled wakeups (sampler_starved).
    from faabric_tpu_torch.telemetry import aggregate_profile

    def pstack(cls, frames, samples, cpu_ms):
        return {"class": cls, "frames": frames, "samples": samples,
                "cpu_ms": cpu_ms}

    def psnap(samples, expected, stacks, pressure, runnable_avg,
              pid=100):
        return {
            "enabled": True, "pid": pid, "interval_ms": 25.0,
            "samples": samples, "expected_samples": expected,
            "wall_s": expected * 0.025, "sample_cost_ms": 0.1,
            "overhead_pct": 0.4, "nodes": 64, "max_nodes": 4096,
            "dropped_frames": 0,
            "classes": {s["class"]: {"samples": s["samples"],
                                     "cpu_ms": s["cpu_ms"],
                                     "threads_now": 1}
                        for s in stacks},
            "stacks": stacks,
            "gil": {"pressure": pressure,
                    "drift_ratio_avg": pressure,
                    "drift_ratio_max": pressure * 2,
                    "runnable_now": int(runnable_avg),
                    "runnable_avg": runnable_avg,
                    "late_samples": int(samples * pressure)},
        }

    hot_frames = ["_tick_loop (ingress/tick.py:330)",
                  "call_batch_group (planner/planner.py:700)",
                  "_pack_decision (planner/planner.py:812)"]
    profile_tel = {
        "hA": {"profile": psnap(
            1200, 1250,
            [pstack("planner/tick", hot_frames, 900, 2100.0),
             pstack("transport/worker@planner-server-sync",
                    ["_worker_loop (transport/server.py:160)"],
                    200, 600.0),
             pstack("main", ["serve (runner/runtime.py:40)"],
                    100, 80.0)],
            pressure=0.6, runnable_avg=3.2, pid=101)},
        # Idle host: tiny CPU, calm sampler — must stay finding-free
        "hB": {"profile": psnap(
            1200, 1220,
            [pstack("main", ["wait (threading.py:320)"], 1150, 40.0),
             pstack("telemetry/sampler",
                    ["do_work (telemetry/timeseries.py:200)"],
                    50, 12.0)],
            pressure=0.02, runnable_avg=0.1, pid=102)},
        "hC": {"profile": psnap(
            300, 1000,
            [pstack("executor/pool@e1-0",
                    ["run (executor/executor.py:250)"], 280, 260.0)],
            pressure=0.1, runnable_avg=0.5, pid=103)},
    }
    profile = aggregate_profile(profile_tel)
    return {"perf": perf, "metrics": metrics, "commmatrix": None,
            "healthz": healthz, "topology": topology,
            "timeseries": timeseries, "statemap": statemap,
            "profile": profile}


def run_selftest() -> int:
    findings = diagnose(selftest_sources())
    print(render(findings, top=14))
    top_kinds = [f["kind"] for f in findings[:7]]
    all_kinds = [f["kind"] for f in findings]
    problems = []
    slow = [f for f in findings if f["kind"] == "slow_link"]
    if not slow or "hA→hC" not in slow[0]["subject"]:
        problems.append("planted slow link hA→hC not found")
    stragglers = [f for f in findings if f["kind"] == "straggler"]
    if not stragglers or "rank 5" not in stragglers[0]["subject"]:
        problems.append("planted straggler rank 5 not found")
    if "hC" not in (stragglers[0]["subject"] if stragglers else ""):
        problems.append("straggler not attributed to its host hC")
    if "codec_escape_storm" not in all_kinds:
        problems.append("planted escape storm not found")
    if "slow_link" not in top_kinds or "straggler" not in top_kinds:
        problems.append(f"planted faults not in top findings: {top_kinds}")
    # analyzers: the run-dominated lifecycle tail, the burning
    # latency SLO and the growing ingress queue must all be found
    dominant = [f for f in findings if f["kind"] == "dominant_phase"]
    if not dominant or "'run'" not in dominant[0]["subject"]:
        problems.append("planted dominant phase 'run' not found")
    slo_burns = [f for f in findings if f["kind"] == "slo_burn"]
    if not slo_burns or "p99_e2e_ms" not in slo_burns[0]["subject"]:
        problems.append("planted burning SLO p99_e2e_ms not found")
    if "slo_burn" not in top_kinds:
        problems.append(f"slo_burn not in top findings: {top_kinds}")
    if "queue_growth" not in all_kinds:
        problems.append("planted ingress queue growth not found")
    if "capacity_exhausted" not in all_kinds:
        problems.append("planted capacity exhaustion not found")
    # analyzers: the hot key, its master hotspot, the
    # amplified puller and the lock convoy must all be found
    hot = [f for f in findings if f["kind"] == "hot_key_skew"]
    if not hot or "demo/hot" not in hot[0]["subject"]:
        problems.append("planted hot key demo/hot not found")
    hotspot = [f for f in findings if f["kind"] == "master_hotspot"]
    if not hotspot or "hA" not in hotspot[0]["subject"]:
        problems.append("planted master hotspot hA not found")
    amp = [f for f in findings if f["kind"] == "pull_amplification"]
    if not amp or "demo/amplified" not in amp[0]["subject"]:
        problems.append("planted pull amplification not found")
    convoy = [f for f in findings if f["kind"] == "lock_convoy"]
    if not convoy or "demo/locky" not in convoy[0]["subject"]:
        problems.append("planted lock convoy demo/locky not found")
    # analyzer: the fenced-but-backupless key must be found;
    # the fenced-and-replicated key must not produce a false positive
    unrep = [f for f in findings if f["kind"] == "state_unreplicated"]
    if not unrep or "demo/fragile" not in unrep[0]["subject"]:
        problems.append("planted unreplicated key demo/fragile "
                        "not found")
    if any("demo/hot" in f["subject"] for f in unrep):
        problems.append("replicated key demo/hot wrongly flagged "
                        "as unreplicated")
    # analyzers: the hA tick hotspot, hA's GIL saturation and
    # hC's starved sampler must be found; idle hB must stay clean
    hotspots = [f for f in findings if f["kind"] == "cpu_hotspot"]
    if not hotspots or "hA" not in hotspots[0]["subject"]:
        problems.append("planted cpu hotspot on hA not found")
    elif "planner/tick" not in hotspots[0]["subject"]:
        problems.append("hotspot not attributed to planner/tick: "
                        + hotspots[0]["subject"])
    gil = [f for f in findings if f["kind"] == "gil_saturation"]
    if not gil or "hA" not in gil[0]["subject"]:
        problems.append("planted GIL saturation on hA not found")
    starved = [f for f in findings if f["kind"] == "sampler_starved"]
    if not starved or "hC" not in starved[0]["subject"]:
        problems.append("planted starved sampler on hC not found")
    profile_kinds = ("cpu_hotspot", "gil_saturation", "sampler_starved")
    hb_noise = [f for f in findings
                if f["kind"] in profile_kinds and "hB" in f["subject"]]
    if hb_noise:
        problems.append(f"idle host hB produced profile findings: "
                        f"{[f['kind'] for f in hb_noise]}")
    if problems:
        print("doctor selftest FAILED:", "; ".join(problems))
        return 1
    print("doctor selftest OK")
    return 0


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m faabric_tpu_torch.runner.doctor",
        description="Ranked cluster performance/health diagnosis")
    parser.add_argument("--url", help="live planner endpoint base URL "
                        "(e.g. http://127.0.0.1:8080)")
    parser.add_argument("--dir", help="directory of dumped sources "
                        "(perf.json, metrics.txt, commmatrix.json, "
                        "healthz.json, topology.json)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings")
    parser.add_argument("--top", type=int, default=12,
                        help="show only the top N findings (0 = all)")
    parser.add_argument("--selftest", action="store_true",
                        help="run on the built-in synthetic cluster and "
                        "verify the planted faults are found")
    args = parser.parse_args(argv)

    if args.selftest:
        return run_selftest()
    if args.url:
        sources = fetch_live(args.url)
    elif args.dir:
        sources = load_dir(args.dir)
    else:
        parser.error("one of --url, --dir or --selftest is required")
        return 2
    findings = diagnose(sources)
    if args.json:
        print(json.dumps({"findings": findings}, indent=1))
    else:
        print(render(findings, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
