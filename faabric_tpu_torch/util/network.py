"""Network helpers.

Counterpart of ``faabric_tpu/util/network.py``. Client connections pin
their source port above the listener plan: a container's ephemeral
port range may start inside it (16000), and a plain ``connect()`` could
then hold a port that a server of the plan binds later.
"""

from __future__ import annotations

import errno
import random
import socket

LOCALHOST = "127.0.0.1"

# The listener plan spans 8003..~30000 (service ports, the MPI port
# pool, host-alias offsets); client source ports come from above it
SAFE_CLIENT_PORT_MIN = 30500
SAFE_CLIENT_PORT_MAX = 60000


def get_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def safe_create_connection(address: tuple[str, int],
                           timeout: float | None = None) -> socket.socket:
    """``socket.create_connection`` with the local port drawn from
    [SAFE_CLIENT_PORT_MIN, SAFE_CLIENT_PORT_MAX), so that outgoing
    connections never sit on a listener's port. Falls back to a plain
    connect if 20 draws all find their port taken."""
    for _ in range(20):
        port = random.randrange(SAFE_CLIENT_PORT_MIN, SAFE_CLIENT_PORT_MAX)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.settimeout(timeout)
            s.bind(("", port))
            s.connect(address)
            return s
        except OSError as e:
            s.close()
            if e.errno in (errno.EADDRINUSE, errno.EADDRNOTAVAIL):
                continue  # that port is taken: draw again
            raise
    return socket.create_connection(address, timeout)
