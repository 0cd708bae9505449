"""A worker's HTTP endpoint.

Counterpart of ``faabric_tpu/endpoint/worker_endpoint.py`` (reference
src/endpoint/FaabricEndpointHandler.cpp:16-56): a worker turns every
functional request away (403, naming the planner, whose REST endpoint
takes them) and answers these locally, so that a probe of a worker
never depends on the planner:

- ``GET /healthz``: identity, uptime and executor count;
- ``GET /metrics``: this process's registry as Prometheus text, with
  the ``faabric_process_*`` gauges refreshed;
- ``GET /timeseries``: this process's time-series ring;
- ``GET /flight``: the live flight ring (``flightdump --url`` merges);
- ``GET /profile``: the stack sampler's trie.

``WorkerRuntime`` starts one on ``WORKER_HTTP_PORT`` when that is set.
A port already in use logs a warning and leaves the endpoint off: a
health probe must never keep a worker from starting.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

REJECTION = json.dumps({
    "error": "Workers do not accept direct requests; use the planner's "
             "HTTP endpoint",
}).encode()


class WorkerHttpEndpoint:
    def __init__(self, port: int, runtime=None) -> None:
        self.port = port
        self.runtime = runtime
        self._started_at = time.monotonic()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def healthz(self) -> dict:
        body = {
            "status": "ok",
            "pid": os.getpid(),
            "uptimeSeconds": round(time.monotonic() - self._started_at, 3),
        }
        rt = self.runtime
        if rt is not None:
            body["host"] = rt.host
            body["slots"] = rt.slots
            scheduler = getattr(rt, "scheduler", None)
            if scheduler is not None:
                body["executors"] = scheduler.get_executor_count()
        return body

    @staticmethod
    def metrics_text() -> str:
        from faabric_tpu_torch.telemetry import get_metrics, get_proc_stats

        get_proc_stats().refresh()
        return get_metrics().render_prometheus()

    @staticmethod
    def timeseries_json() -> str:
        from faabric_tpu_torch.telemetry import get_timeseries

        return json.dumps(get_timeseries().snapshot())

    @staticmethod
    def flight_json() -> str:
        from faabric_tpu_torch.telemetry.flight import live_ring_doc

        return json.dumps(live_ring_doc())

    @staticmethod
    def profile_json() -> str:
        from faabric_tpu_torch.telemetry import get_profiler

        return json.dumps(get_profiler().snapshot())

    def start(self) -> None:
        if self._server is not None:
            return
        endpoint = self
        surfaces = {
            "/healthz": lambda: json.dumps(endpoint.healthz()),
            "/metrics": endpoint.metrics_text,
            "/timeseries": endpoint.timeseries_json,
            "/flight": endpoint.flight_json,
            "/profile": endpoint.profile_json,
        }

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, status: int, body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reject(self) -> None:
                self._respond(403, REJECTION)

            def do_GET(self) -> None:  # noqa: N802 — stdlib API
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                build = surfaces.get(path)
                if build is None:
                    self._reject()
                    return
                try:
                    body = build().encode()
                except Exception as e:  # noqa: BLE001 — a scrape error
                    logger.exception("worker-http GET %s failed", path)
                    self._respond(500,
                                  json.dumps({"error": str(e)}).encode())
                    return
                self._respond(200, body)

            do_POST = do_PUT = do_DELETE = _reject

            def log_message(self, fmt, *args):
                logger.debug("worker-http: " + fmt, *args)

        try:
            self._server = ThreadingHTTPServer(("0.0.0.0", self.port),
                                               Handler)
        except OSError as e:
            logger.warning("Worker HTTP endpoint on :%d unavailable (%s); "
                           "continuing without it", self.port, e)
            self._server = None
            return
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="endpoint/worker-http",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None
