"""Process-unique ids.

Counterpart of ``faabric_tpu/util/gids.py``: a per-process random
48-bit base plus a counter, so ids are unique across a cluster with
high probability and increase within a process.
"""

from __future__ import annotations

import itertools
import random
import threading

_lock = threading.Lock()
_base: int | None = None
_counter = itertools.count(1)


def _ensure_base() -> int:
    global _base
    if _base is None:
        with _lock:
            if _base is None:
                _base = random.getrandbits(48) << 20
    return _base


def generate_gid() -> int:
    """A process-unique positive integer id."""
    base = _ensure_base()
    return base + next(_counter)
