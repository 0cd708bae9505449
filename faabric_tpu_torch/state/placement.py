"""Consistent-hash placement of a state key's backup host.

Counterpart of ``faabric_tpu/state/placement.py``, whole. The planner
places each key's backup on a consistent-hash ring, so host churn moves
the fewest keys: when a host leaves, only the keys whose backup it was
move (to the next host clockwise); a host that joins takes over only
the arcs its virtual nodes land on. Masters stay first-claimer elected;
the ring decides where the synchronous replica lives.

Ring coordinates come from ``hashlib`` (``hash()`` is salted per
process), so every process and the reference agree on the order.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Sequence

# Virtual nodes per host
VNODES = 64


def _hash(token: str) -> int:
    """Stable 64-bit ring coordinate for a token."""
    digest = hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big")


def ring_order(full_key: str, hosts: Iterable[str]) -> list[str]:
    """Distinct hosts in ring order from the key's point: the key's
    placement preference list, whatever the order of ``hosts``."""
    uniq = sorted(set(hosts))
    if not uniq:
        return []
    points: list[tuple[int, str]] = []
    for h in uniq:
        for v in range(VNODES):
            points.append((_hash(f"{h}#{v}"), h))
    points.sort()
    coords = [p for p, _ in points]
    start = bisect.bisect_right(coords, _hash(full_key))
    order: list[str] = []
    seen: set[str] = set()
    for j in range(len(points)):
        h = points[(start + j) % len(points)][1]
        if h not in seen:
            seen.add(h)
            order.append(h)
            if len(order) == len(uniq):
                break
    return order


def place_backup(full_key: str, hosts: Iterable[str],
                 exclude: Sequence[str] | set[str] = ()) -> str:
    """The key's backup host: the first ring candidate not excluded
    (callers exclude at least the master). "" when no host is eligible:
    the key then runs unreplicated."""
    for h in ring_order(full_key, hosts):
        if h not in exclude:
            return h
    return ""
