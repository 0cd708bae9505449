"""Network helpers.

Counterpart of ``faabric_tpu/util/network.py``. Client connections pin
their source port above the listener plan: a container's ephemeral
port range may start inside it (16000), and a plain ``connect()`` could
then hold a port that a server of the plan binds later.
"""

from __future__ import annotations

import errno
import fcntl
import os
import random
import socket
import struct

LOCALHOST = "127.0.0.1"

_SIOCGIFADDR = 0x8915


def _default_route_interface() -> str | None:
    """The interface of the kernel's IPv4 default route, if any."""
    with open("/proc/net/route") as f:
        for line in f.readlines()[1:]:
            fields = line.split()
            if len(fields) > 1 and fields[1] == "00000000":
                return fields[0]
    return None


def get_primary_ip_for_this_host() -> str:
    """``OVERRIDE_HOST_IP``, else the address of the interface that holds
    the default route, as the reference's route lookup finds it. It is
    read from the kernel's route table and the interface itself, so no
    socket names an address off this machine. LOCALHOST when there is
    none."""
    override = os.environ.get("OVERRIDE_HOST_IP")
    if override:
        return override
    try:
        iface = _default_route_interface()
        if iface is None:
            return LOCALHOST
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            req = struct.pack("256s", iface[:15].encode())
            return socket.inet_ntoa(
                fcntl.ioctl(s.fileno(), _SIOCGIFADDR, req)[20:24])
    except OSError:
        return LOCALHOST


def is_local_ip(ip: str) -> bool:
    """True when ``ip`` names this machine: loopback or the primary
    interface's address. Gates the same-machine algorithm choices."""
    if ip.startswith("127.") or ip == "localhost":
        return True
    try:
        return ip == get_primary_ip_for_this_host()
    except OSError:
        return False

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
