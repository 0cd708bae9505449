"""The planner's REST endpoint.

Counterpart of ``faabric_tpu/endpoint/http_server.py`` (reference
src/planner/PlannerEndpointHandler.cpp:15-422 and the HttpMessage
schema, src/planner/planner.proto:33-66), served by a stdlib
``ThreadingHTTPServer`` on a thread of the planner process.

``POST /`` takes ``{"http_type": <int>, "payload": <json string>}`` and
answers JSON: RESET, the three FLUSHes, GET_AVAILABLE_HOSTS, GET_CONFIG,
GET_EXEC_GRAPH, GET_IN_FLIGHT_APPS, EXECUTE_BATCH, EXECUTE_BATCH_STATUS,
PRELOAD_SCHEDULING_DECISION, SET_POLICY, GET_POLICY and
SET_NEXT_EVICTED_VM. EXECUTE_BATCH goes through the planner's ingress
with the request's user as its source and a queue wait of at most 1 s
(each waiting request holds an HTTP thread); a shed answers 429 with
``Retry-After``, the ingress's backlog-scaled hint in whole seconds,
at least 1 (reference :382-440).

``GET`` serves the cluster's telemetry, merged from the planner's own
and every registered worker's blocks (``Planner.collect_telemetry``):
``/metrics`` (Prometheus text under a ``host`` label, with each host's
comm matrix as ``faabric_comm_*`` families), ``/trace`` (one Chrome
trace), ``/commmatrix``, ``/perf``, ``/healthz``, ``/statemap``,
``/profile``, ``/timeseries``, ``/flight`` (the planner's live flight
ring) and ``/topology``. The endpoint binds loopback unless
``ENDPOINT_INTERFACE`` names another interface: its requests include
destructive ones and carry no authentication.
"""

from __future__ import annotations

import enum
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from faabric_tpu_torch.batch_scheduler import reset_batch_scheduler
from faabric_tpu_torch.batch_scheduler.decision import (
    MUST_FREEZE,
    NOT_ENOUGH_SLOTS,
    SchedulingDecision,
)
from faabric_tpu_torch.batch_scheduler.scheduler import (
    get_batch_scheduler_mode,
)
from faabric_tpu_torch.ingress import IngressShedError
from faabric_tpu_torch.planner.planner import Planner, get_planner
from faabric_tpu_torch.proto import (
    BatchExecuteRequest,
    is_batch_exec_request_valid,
)
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.exec_graph import build_exec_graph
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)


class HttpMessageType(enum.IntEnum):
    # planner.proto's HttpMessage.Type
    NO_TYPE = 0
    RESET = 1
    FLUSH_AVAILABLE_HOSTS = 2
    FLUSH_EXECUTORS = 3
    FLUSH_SCHEDULING_STATE = 4
    GET_AVAILABLE_HOSTS = 5
    GET_CONFIG = 6
    GET_EXEC_GRAPH = 7
    GET_IN_FLIGHT_APPS = 8
    EXECUTE_BATCH = 10
    EXECUTE_BATCH_STATUS = 11
    PRELOAD_SCHEDULING_DECISION = 12
    SET_POLICY = 13
    GET_POLICY = 14
    SET_NEXT_EVICTED_VM = 15


class PlannerHttpEndpoint:
    def __init__(self, port: int, planner: Optional[Planner] = None,
                 host: str | None = None) -> None:
        self.port = port
        self.host = (host if host is not None
                     else get_system_config().endpoint_interface
                     or "127.0.0.1")
        self.planner = planner or get_planner()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Bind and serve on a thread; a port in use raises."""
        if self._server is not None:
            return
        endpoint = self
        surfaces = {
            "/metrics": (endpoint.metrics_text, "text/plain; version=0.0.4"),
            "/trace": (endpoint.trace_json, "application/json"),
            "/commmatrix": (endpoint.commmatrix_json, "application/json"),
            "/perf": (endpoint.perf_json, "application/json"),
            "/healthz": (endpoint.healthz_json, "application/json"),
            "/timeseries": (endpoint.timeseries_json, "application/json"),
            "/flight": (endpoint.flight_json, "application/json"),
            "/topology": (endpoint.topology_json, "application/json"),
            "/statemap": (endpoint.statemap_json, "application/json"),
            "/profile": (endpoint.profile_json, "application/json"),
        }

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, status: int, body: bytes, ctype: str,
                         headers: dict | None = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for key, val in (headers or {}).items():
                    self.send_header(key, val)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:  # noqa: N802 — stdlib API
                length = int(self.headers.get("Content-Length", 0))
                status, payload, headers = endpoint.handle(
                    self.rfile.read(length))
                self._respond(status, payload.encode(), "application/json",
                              headers)

            def do_GET(self) -> None:  # noqa: N802
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                build, ctype = surfaces.get(
                    path, (lambda: '{"status": "running"}',
                           "application/json"))
                try:
                    body = build().encode()
                except Exception as e:  # noqa: BLE001 — a scrape error
                    logger.exception("HTTP GET %s failed", path)
                    self._respond(500, json.dumps({"error": str(e)}).encode(),
                                  "application/json")
                    return
                self._respond(200, body, ctype)

            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="endpoint/planner-http",
                                        daemon=True)
        self._thread.start()
        logger.debug("Planner HTTP endpoint on %s:%d", self.host, self.port)

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    # ------------------------------------------------------------------
    # GET surfaces
    # ------------------------------------------------------------------
    def metrics_text(self) -> str:
        """Every host's registry (the planner's too) in one Prometheus
        text under a ``host`` label, each host's comm matrix as
        ``faabric_comm_*`` families with ``src``, ``dst`` and ``plane``
        labels."""
        from faabric_tpu_torch.telemetry import (
            families_from_cells,
            render_snapshots,
        )

        tel = self.planner.collect_telemetry(
            blocks=("metrics", "commmatrix"))
        merged = {}
        for host, t in tel.items():
            snap = dict(t.get("metrics", {}))
            cells = (t.get("commmatrix") or {}).get("cells", [])
            snap.update(families_from_cells(cells))
            merged[host] = snap
        return render_snapshots(merged)

    def commmatrix_json(self) -> str:
        """Each host's (src rank, dst rank, plane) send cells, and their
        sum over hosts (each host reports only what it sent)."""
        from faabric_tpu_torch.telemetry import merge_cell_rows

        tel = self.planner.collect_telemetry(blocks=("commmatrix",))
        per_host = {host: (t.get("commmatrix") or {}).get("cells", [])
                    for host, t in tel.items()}
        return json.dumps({"hosts": per_host,
                           "total": merge_cell_rows(per_host)})

    def perf_json(self) -> str:
        """The cluster's performance profile: every host's link
        estimators and the merged collective series with critical paths
        and stragglers. Each aggregation is noted for the health view and
        written to ``FAABRIC_PERF_PROFILE_DIR`` (best effort)."""
        from faabric_tpu_torch.telemetry import aggregate_perf, persist_cluster

        doc = aggregate_perf(self.planner.collect_telemetry(blocks=("perf",)))
        self.planner.note_perf_aggregation(doc)
        persist_cluster(doc)
        return json.dumps(doc)

    def healthz_json(self) -> str:
        return json.dumps(self.planner.health_summary())

    def statemap_json(self) -> str:
        """Every host's per-key state ledger merged into ranked per-key
        rows, with the planner's placement (master, backup, epoch) laid
        over them: right after a failover the hosts' ledgers lag, the
        planner's placement does not."""
        from faabric_tpu_torch.telemetry import (
            aggregate_statemap,
            merge_placement,
        )

        doc = aggregate_statemap(
            self.planner.collect_telemetry(blocks=("statestats",)))
        merge_placement(doc, self.planner.state_placement())
        return json.dumps(doc)

    def profile_json(self) -> str:
        """Every host's stack-sampler trie merged into ranked per host,
        thread class and stack rows, with each process's GIL pressure."""
        from faabric_tpu_torch.telemetry import aggregate_profile

        return json.dumps(aggregate_profile(
            self.planner.collect_telemetry(blocks=("profile",))))

    def timeseries_json(self) -> str:
        """Every host's time-series ring, keyed by host."""
        tel = self.planner.collect_telemetry(blocks=("timeseries",))
        return json.dumps({
            "generated_at": time.time(),
            "hosts": {host: (t.get("timeseries") or {})
                      for host, t in tel.items()}})

    def flight_json(self) -> str:
        """The planner process's live flight ring (the workers serve
        theirs on their own endpoints; ``flightdump --url`` merges)."""
        from faabric_tpu_torch.telemetry.flight import live_ring_doc

        return json.dumps(live_ring_doc())

    def topology_json(self) -> str:
        """Per-host capacity and every in-flight MPI world's topology,
        with each host's live device planes under ``device_planes``."""
        doc = self.planner.get_cluster_topology()
        tel = self.planner.collect_telemetry(blocks=("device_planes",))
        doc["device_planes"] = {host: t.get("device_planes") or []
                                for host, t in tel.items()
                                if t.get("device_planes")}
        return json.dumps(doc)

    def trace_json(self) -> str:
        """Every host's spans on one Chrome trace. Pids are renumbered
        per (host, pid): processes in containers are often all pid 1,
        and equal pids would put different hosts on one row."""
        tel = self.planner.collect_telemetry(include_trace=True, blocks=())
        events: list = []
        pid_map: dict[tuple[str, int], int] = {}
        for host in sorted(tel):
            for e in tel[host].get("trace") or []:
                pid = pid_map.setdefault((host, e.get("pid", 0)),
                                         len(pid_map) + 1)
                # A copy: the planner's own events are the tracer's state
                events.append({**e, "pid": pid})
        return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})

    # ------------------------------------------------------------------
    # POST requests
    # ------------------------------------------------------------------
    def handle(self, body: bytes) -> tuple[int, str, dict]:
        """(status, response JSON, extra headers) for one HttpMessage."""
        try:
            msg = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return 400, json.dumps({"error": "Bad JSON in request"}), {}
        if not isinstance(msg, dict):
            return (400,
                    json.dumps({"error": "Request body must be an object"}),
                    {})
        http_type = msg.get("http_type", int(HttpMessageType.NO_TYPE))
        payload = msg.get("payload", "")
        try:
            out = self._dispatch(http_type, payload)
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            logger.exception("HTTP handler error (type %s)", http_type)
            return 500, json.dumps({"error": str(e)}), {}
        # A shed carries its Retry-After in a third slot
        return out if len(out) == 3 else (*out, {})

    def _dispatch(self, http_type: int, payload: str) -> tuple:
        planner = self.planner
        t = HttpMessageType(http_type)

        if t == HttpMessageType.RESET:
            planner.reset()
            return 200, json.dumps({"status": "reset"})

        if t == HttpMessageType.FLUSH_AVAILABLE_HOSTS:
            planner.flush_hosts()
            return 200, json.dumps({"status": "flushed hosts"})

        if t == HttpMessageType.FLUSH_EXECUTORS:
            hosts = planner.flush_all_executors()
            return 200, json.dumps({"status": "flushed executors",
                                    "hosts": hosts})

        if t == HttpMessageType.FLUSH_SCHEDULING_STATE:
            planner.flush_scheduling_state()
            return 200, json.dumps({"status": "flushed scheduling state"})

        if t == HttpMessageType.GET_AVAILABLE_HOSTS:
            hosts = [{"ip": h.ip, "slots": h.slots,
                      "usedSlots": h.used_slots, "nDevices": h.n_devices}
                     for h in planner.get_available_hosts()]
            return 200, json.dumps({"hosts": hosts})

        if t == HttpMessageType.GET_CONFIG:
            conf = get_system_config()
            return 200, json.dumps({
                "ip": conf.planner_host,
                "hostTimeout": conf.planner_host_timeout,
                "policy": get_batch_scheduler_mode(),
            })

        if t == HttpMessageType.GET_EXEC_GRAPH:
            req = json.loads(payload) if payload else {}
            app_id = req.get("app_id", 0) or req.get("appId", 0)

            def get_result(aid, mid):
                result = planner.get_message_result(aid, mid)
                if result is None:
                    raise KeyError(f"No result for msg {mid} (app {aid})")
                return result

            return 200, build_exec_graph(get_result, req.get("id", 0),
                                         app_id).to_json()

        if t == HttpMessageType.GET_IN_FLIGHT_APPS:
            return 200, json.dumps(planner.in_flight_summary())

        if t == HttpMessageType.EXECUTE_BATCH:
            req = BatchExecuteRequest.from_dict(json.loads(payload))
            if not is_batch_exec_request_valid(req):
                return 400, json.dumps({"error": "Bad BatchExecRequest"})
            try:
                decision = planner.ingress.submit(
                    req, source=req.user or "rest", timeout=1.0)
            except IngressShedError as e:
                return (429, json.dumps({
                    "error": "Overloaded: invocation shed",
                    "reason": e.reason,
                    "retryAfterSeconds": round(e.retry_after, 3),
                }), {"Retry-After": str(max(1, int(e.retry_after + 0.5)))})
            if decision.app_id == NOT_ENOUGH_SLOTS:
                return 500, json.dumps({"error": "No available hosts"})
            if decision.app_id == MUST_FREEZE:
                return 200, json.dumps({"appId": req.app_id,
                                        "frozen": True})
            return 200, json.dumps({"appId": req.app_id,
                                    "groupId": decision.group_id,
                                    "hosts": decision.hosts,
                                    "messageIds": decision.message_ids})

        if t == HttpMessageType.EXECUTE_BATCH_STATUS:
            req = json.loads(payload) if payload else {}
            app_id = req.get("app_id", 0) or req.get("appId", 0)
            status = planner.get_batch_results(app_id)
            return 200, json.dumps({
                "appId": status.app_id,
                "finished": status.finished,
                "expectedNumMessages": status.expected_num_messages,
                "messageResults": [m.to_dict()
                                   for m in status.message_results],
            })

        if t == HttpMessageType.PRELOAD_SCHEDULING_DECISION:
            decision = SchedulingDecision.from_dict(json.loads(payload))
            planner.preload_scheduling_decision(decision)
            return 200, json.dumps({"status": "preloaded",
                                    "appId": decision.app_id})

        if t == HttpMessageType.SET_POLICY:
            policy = payload.strip().strip('"')
            if policy not in ("bin-pack", "compact", "spot"):
                return 400, json.dumps({"error": f"Unknown policy {policy}"})
            reset_batch_scheduler(policy)
            return 200, json.dumps({"policy": policy})

        if t == HttpMessageType.GET_POLICY:
            return 200, json.dumps({"policy": get_batch_scheduler_mode()})

        if t == HttpMessageType.SET_NEXT_EVICTED_VM:
            ip = payload.strip().strip('"')
            planner.set_next_evicted_host_ips([ip] if ip else [])
            return 200, json.dumps({"nextEvictedVmIps": [ip] if ip else []})

        return 400, json.dumps({"error": f"Unsupported request type {t}"})
