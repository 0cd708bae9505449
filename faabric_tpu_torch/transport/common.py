"""Transport constants and host resolution.

The port plan of ``faabric_tpu/transport/common.py``: state 8003/8004,
function calls 8005/8006, snapshots 8007/8008, point-to-point 8009/8010,
planner 8011/8012, the bulk data plane 8014 (``transport/bulk.py``),
MPI data-plane base 8020. Both packages bind the same
ports, so a host of one can talk to a host of the other.

Host aliases run several logical hosts in one process or on one
machine: an alias maps a host name to (ip, port offset), and every
server and client of that host shifts its ports by the offset.
"""

from __future__ import annotations

import os
import threading

STATE_ASYNC_PORT = 8003
STATE_SYNC_PORT = 8004
FUNCTION_CALL_ASYNC_PORT = 8005
FUNCTION_CALL_SYNC_PORT = 8006
SNAPSHOT_ASYNC_PORT = 8007
SNAPSHOT_SYNC_PORT = 8008
POINT_TO_POINT_ASYNC_PORT = 8009
POINT_TO_POINT_SYNC_PORT = 8010
PLANNER_ASYNC_PORT = 8011
PLANNER_SYNC_PORT = 8012

MPI_BASE_PORT = 8020
MPI_PORTS_PER_HOST = 512

DEFAULT_SOCKET_TIMEOUT = 60.0

_aliases: dict[str, tuple[str, int]] = {}
_alias_lock = threading.Lock()
_env_aliases_loaded = False


def register_host_alias(host: str, ip: str = "127.0.0.1",
                        port_offset: int = 0) -> None:
    with _alias_lock:
        _aliases[host] = (ip, port_offset)


def unregister_host_alias(host: str) -> None:
    with _alias_lock:
        _aliases.pop(host, None)


def _load_env_aliases_locked() -> None:
    """Processes of one machine share an alias table through
    FAABRIC_HOST_ALIASES="w1=127.0.0.1+30000,w2=127.0.0.1+31000"."""
    global _env_aliases_loaded
    if _env_aliases_loaded:
        return
    _env_aliases_loaded = True
    spec = os.environ.get("FAABRIC_HOST_ALIASES", "")
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        try:
            name, target = entry.split("=", 1)
            ip, _, offset = target.partition("+")
            _aliases.setdefault(name, (ip or "127.0.0.1", int(offset or 0)))
        except ValueError:
            continue


def resolve_host(host: str, port: int) -> tuple[str, int]:
    """Map a logical host and a plan port to a dialable (ip, port)."""
    with _alias_lock:
        _load_env_aliases_locked()
        if host in _aliases:
            ip, offset = _aliases[host]
            return ip, port + offset
    return host, port


def host_is_local(host: str) -> bool:
    """Whether a logical host resolves to this machine (loopback or the
    primary interface's address): the link class on which the shm rings
    run and the wire-codec governor keeps frames raw."""
    from faabric_tpu_torch.util.network import is_local_ip

    ip, _ = resolve_host(host, 0)
    return is_local_ip(ip)


def get_host_alias_offset(host: str) -> int:
    with _alias_lock:
        _load_env_aliases_locked()
        if host in _aliases:
            return _aliases[host][1]
    return 0


def clear_host_aliases() -> None:
    global _env_aliases_loaded
    with _alias_lock:
        _aliases.clear()
        _env_aliases_loaded = False
