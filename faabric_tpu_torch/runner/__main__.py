"""Deployment entry points: the planner_server and worker binaries.

Counterpart of ``faabric_tpu/runner/__main__.py`` (reference
src/planner/planner_server.cpp:9-43, src/runner/FaabricMain.cpp)::

    python -m faabric_tpu_torch.runner planner [--port-offset N]
        [--http-port P]
    python -m faabric_tpu_torch.runner worker --host NAME [--slots N]
        [--devices N] [--planner-host NAME] [--device cuda|cpu]
    python -m faabric_tpu_torch.runner redis [--port P] [--bind ADDR]

The planner role serves ``PlannerServer`` (its RPC and its snapshot
server) at ``--port-offset`` and, with a nonzero ``--http-port``, the
REST endpoint (``endpoint/http_server.py``) on that port, bound to
loopback unless ``ENDPOINT_INTERFACE`` names another interface. Where
the reference serves ``ENDPOINT_PORT`` (8080) when the flag is 0, 0
leaves the endpoint off here and no ``ENDPOINT_PORT`` is read, so that
planners that share a machine never contend for one default port. The worker role boots a
``WorkerRuntime`` (function-call, point-to-point, snapshot and state
servers, keep-alive registration with the planner, and the worker
endpoint when ``WORKER_HTTP_PORT`` is set) whose torch guests run on
the card; a caller asks for the CPU with ``--device cpu``. The redis
role serves the port's ``MiniRedisServer`` on ``--bind``:``--port``
(default 127.0.0.1:6379), the state authority of ``STATE_MODE=redis``
for workers whose ``REDIS_STATE_HOST`` and ``REDIS_PORT`` name it. Each
role runs until SIGTERM or SIGINT, which record and dump the flight
ring under the signal's own name and then stop the role cleanly (exit
0). With ``FAABRIC_LOCKCHECK=1`` every role runs under the lock-order
detector (``analysis/lockcheck.py``), installed before the roles'
modules load; at the stop it writes its report line to standard error
and exits 1 if it saw a held-before cycle, unless
``FAABRIC_LOCKCHECK_GATE=0``.
"""

from __future__ import annotations

# The lock-order detector goes in first, before any module of the port
# creates a lock (FAABRIC_LOCKCHECK=1; see analysis/lockcheck.py)
from faabric_tpu_torch.analysis import lockcheck as _lockcheck

_lockcheck.install_from_env()

import argparse  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

from faabric_tpu_torch.util.crash import install_crash_handler  # noqa: E402
from faabric_tpu_torch.util.logging import get_logger  # noqa: E402

logger = get_logger("faabric_tpu_torch.runner")

def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="faabric_tpu_torch.runner")
    sub = parser.add_subparsers(dest="role", required=True)

    p_planner = sub.add_parser("planner")
    p_planner.add_argument("--port-offset", type=int, default=0)
    p_planner.add_argument("--http-port", type=int, default=0,
                           help="REST endpoint port (0: no endpoint)")

    p_redis = sub.add_parser("redis")
    p_redis.add_argument("--port", type=int, default=6379)
    p_redis.add_argument("--bind", default="127.0.0.1")

    p_worker = sub.add_parser("worker")
    p_worker.add_argument("--host", default="",
                          help="this worker's identity (default: primary IP)")
    p_worker.add_argument("--slots", type=int, default=None,
                          help="execution slots (default: one per usable "
                               "core; 0 = observer host)")
    p_worker.add_argument("--devices", type=int, default=None,
                          help="devices to register (default: the card "
                               "count for CUDA guests, 0 on the CPU)")
    p_worker.add_argument("--planner-host", default=None)
    p_worker.add_argument("--device", choices=("cuda", "cpu"),
                          default="cuda",
                          help="where guests run (default: the card)")

    args = parser.parse_args(argv)
    if args.role == "worker":
        from faabric_tpu_torch.executor import TorchExecutorFactory

        # Raises without a card unless --device cpu, before anything of
        # the process changes
        factory = TorchExecutorFactory(args.device)
    install_crash_handler()

    stop = threading.Event()

    def _on_signal(signum, _frame):
        # Dump the flight ring while the process state is intact, under
        # the name of the signal that came (a post-mortem must not claim
        # a SIGTERM for an operator's Ctrl-C); the shutdown survives any
        # failure of the dump
        try:
            from faabric_tpu_torch.telemetry import flight_dump, flight_record

            name = signal.Signals(signum).name.lower()
            flight_record(name, role=args.role)
            flight_dump(name)
        except Exception:  # noqa: BLE001 — never lose the shutdown
            pass
        finally:
            stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)

    if args.role == "planner":
        from faabric_tpu_torch.planner import PlannerServer

        server = PlannerServer(port_offset=args.port_offset)
        server.start()
        endpoint = None
        try:
            if args.http_port:
                from faabric_tpu_torch.endpoint import PlannerHttpEndpoint

                endpoint = PlannerHttpEndpoint(port=args.http_port)
                endpoint.start()
            logger.info("Planner up (rpc offset %d, http %s)",
                        args.port_offset,
                        f":{endpoint.port}" if endpoint else "off")
            stop.wait()
        finally:
            if endpoint is not None:
                endpoint.stop()
            server.stop()
    elif args.role == "redis":
        from faabric_tpu_torch.redis import MiniRedisServer

        srv = MiniRedisServer(host=args.bind, port=args.port)
        srv.start()
        logger.info("Mini redis up on %s:%d", args.bind, srv.port)
        stop.wait()
        srv.stop()
    else:
        from faabric_tpu_torch.runner import WorkerRuntime
        from faabric_tpu_torch.util.network import (
            get_primary_ip_for_this_host,
        )

        runtime = WorkerRuntime(host=args.host
                                or get_primary_ip_for_this_host(),
                                slots=args.slots,
                                n_devices=args.devices,
                                factory=factory,
                                planner_host=args.planner_host)
        runtime.start()
        logger.info("Worker %s up (guests on %s)", runtime.host, args.device)
        stop.wait()
        runtime.shutdown()
    logger.info("%s stopped", args.role.capitalize())
    # Under the detector: its report, and a nonzero status for a
    # held-before cycle while FAABRIC_LOCKCHECK_GATE is on
    return _lockcheck.finish()


if __name__ == "__main__":
    sys.exit(main())
