"""The reference's multi-process cases on the port: a planner and two
workers as OS processes.

Counterpart of ``tests/dist/test_multiprocess.py``. Each logical host is
a process running ``tests/test_torch_procs.py`` on aliased loopback
ports; this test process joins as a 0-slot client host, so every RPC
crosses a process boundary. The ports come from
``tests/conftest.py::next_port_base`` and are held by listening sockets
until each child binds them, never from fixed aliases.

The planner serves its REST endpoint, and the telemetry cases (``:241``,
``:341``, ``:401``) read ``/metrics``, ``/trace``, ``/commmatrix`` and
``/healthz`` from it. The device plane across processes (``:618``),
its collectives and its two sharded train steps, is
``tests/test_torch_distributed.py``'s planeworker case on this module's
``ProcCluster``.
"""

import os
import queue
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest

from faabric_tpu_torch.proto import (
    BatchExecuteType,
    ReturnValue,
    batch_exec_factory,
)

ROOT = Path(__file__).resolve().parents[1]
PROCS = Path(__file__).resolve().with_name("test_torch_procs.py")
# tests/dist/test_multiprocess.py binds fixed aliases at +10000, +13000
# and +16000, the bases of three of the conftest's slots: the port's
# process tests keep off those slots
REFERENCE_FIXED_BASES = (10000, 13000, 16000)


def port_slot(timeout: float = 120.0) -> int:
    """A free slot's base from ``tests/conftest.py::next_port_base``, off
    the slots the reference's multi-process fixture takes by fixed
    aliases; waits while other test workers hold every other slot."""
    from tests.conftest import _slot_looks_free, next_port_base

    deadline = time.monotonic() + timeout
    while True:
        base = next_port_base()
        if base not in REFERENCE_FIXED_BASES and _slot_looks_free(base):
            return base
        assert time.monotonic() < deadline, \
            "no free port slot off the reference's fixed aliases"
        time.sleep(0.1)


# A host's HTTP endpoint port past its offset: free in every host's
# range (the services take 8003-8014, MPI worlds 8020 up)
HTTP_PORT = 8016


def _service_ports() -> list[int]:
    from faabric_tpu_torch.transport import common as tc
    from faabric_tpu_torch.transport.bulk import BULK_PORT

    return [*range(tc.STATE_ASYNC_PORT, tc.PLANNER_SYNC_PORT + 1), BULK_PORT,
            HTTP_PORT]


class Child:
    """One host process: ``tests/test_torch_procs.py`` with ``args``,
    started with the listening sockets ``held`` passed on (it closes them
    right before binding), its output read by a thread of this process
    (the last lines kept for failure messages)."""

    def __init__(self, name: str, args: list[str], env: dict, held: list):
        self.name = name
        fds = [s.fileno() for s in held]
        self.proc = subprocess.Popen(
            [sys.executable, str(PROCS), *args], cwd=ROOT,
            env={**env, "PROCS_HELD_FDS": ",".join(map(str, fds))},
            pass_fds=fds, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.tail: deque = deque(maxlen=40)
        threading.Thread(target=self._read, name=f"test/read-{name}",
                         daemon=True).start()

    def _read(self) -> None:
        try:
            for line in self.proc.stdout:
                self.tail.append(line.rstrip())
                self.lines.put(line.rstrip())
        except ValueError:  # the pipe closed under the read
            pass
        finally:
            self.lines.put(None)

    def wait_ready(self, timeout: float = 180.0) -> dict:
        """The JSON line that follows READY; fails if the child exits or
        ``timeout`` passes first."""
        import json

        deadline = time.monotonic() + timeout
        seen_ready = False
        while True:
            try:
                line = self.lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            assert line is not None, (
                f"{self.name} never became ready (exit code "
                f"{self.proc.poll()}): {list(self.tail)}")
            if seen_ready:
                return json.loads(line)
            seen_ready = line == "READY"

    def command(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def stop(self, timeout: float = 30.0) -> None:
        """Close its standard input (a body's signal to shut down) and
        wait; kill it if it does not exit in time."""
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except (OSError, ValueError):
                pass

    def kill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)


class NullFactory:
    """The client host's executor factory: it runs nothing."""

    def create_executor(self, msg):
        raise RuntimeError("client runs nothing")


class ProcCluster:
    """A planner and up to two workers as OS processes on one port slot
    of ``tests/conftest.py`` (planner at the base, workers at +1000 and
    +2000, this process's 0-slot client host at +2500), with
    ``extra_env`` in every process's environment (this one's too, while
    the cluster runs), ``worker_env`` in the workers' alone and
    ``host_env[host]`` in one host's. With ``http`` the planner serves
    its REST endpoint (``http_url``), and each host of ``worker_http``
    its worker endpoint (``worker_url(host)``), each on its own offset
    plus ``HTTP_PORT``. The workers run ``worker_role``'s body of
    ``tests/test_torch_procs.py``, with ``worker_args`` after their
    slots."""

    def __init__(self, tag: str, workers: dict, extra_env: dict | None = None,
                 worker_env: dict | None = None, http: bool = False,
                 host_env: dict | None = None, worker_http=(),
                 worker_role: str = "worker", worker_args=()):
        assert len(workers) <= 2
        self.tag = tag
        self.planner_host = f"{tag}pl"
        self.client_host = f"{tag}cli"
        self.workers = list(workers)
        self.slots = dict(workers)
        self.extra_env = dict(extra_env or {})
        self.worker_env = dict(worker_env or {})
        self.host_env = {h: dict(e) for h, e in (host_env or {}).items()}
        self.http = http
        self.worker_http = set(worker_http)
        self.worker_role = worker_role
        self.worker_args = [str(a) for a in worker_args]
        self.children: dict[str, Child] = {}
        self.ready: dict[str, dict] = {}
        self.me = None
        self._saved_env: dict = {}
        self._saved_factory = None
        self.base = None

    def _offsets(self) -> dict:
        offsets = {self.planner_host: self.base,
                   self.client_host: self.base + 2500}
        for i, w in enumerate(self.workers):
            offsets[w] = self.base + 1000 * (i + 1)
        return offsets

    def _hold_slot(self) -> dict:
        """A slot whose children's ports are free, held by listening
        sockets: ``{host: [sockets]}``."""
        from tests.test_torch_mpi import _hold_ports

        for _ in range(20):
            self.base = port_slot()
            held = {}
            for host, off in self._offsets().items():
                if host == self.client_host:
                    continue
                socks = _hold_ports((off + p for p in _service_ports()),
                                    listen=True)
                if not socks:
                    break
                held[host] = socks
            else:
                return held
            for socks in held.values():
                for s in socks:
                    s.close()
        raise AssertionError("no port slot with its hosts' ports free")

    def env(self, host: str) -> dict:
        aliases = ",".join(f"{h}=127.0.0.1+{o}"
                           for h, o in self._offsets().items())
        env = {**os.environ, "FAABRIC_HOST_ALIASES": aliases,
               **self.extra_env}
        if host in self.workers:
            env.update(self.worker_env)
        env.update(self.host_env.get(host, {}))
        port = self._offsets()[host] + HTTP_PORT
        if host == self.planner_host and self.http:
            env["DIST_HTTP_PORT"] = str(port)
        if host in self.worker_http:
            env["WORKER_HTTP_PORT"] = str(port)
        return env

    @property
    def http_url(self) -> str:
        """The planner's REST endpoint."""
        assert self.http, "this cluster's planner serves no endpoint"
        return f"http://127.0.0.1:{self.base + HTTP_PORT}"

    def worker_url(self, host: str) -> str:
        """A worker's own HTTP endpoint."""
        assert host in self.worker_http, host
        return f"http://127.0.0.1:{self._offsets()[host] + HTTP_PORT}"

    def spawn(self, host: str, held: list) -> Child:
        if host == self.planner_host:
            args = ["planner", str(self.base)]
        else:
            args = [self.worker_role, host, self.planner_host,
                    str(self.slots[host]), *self.worker_args]
        try:
            child = Child(host, args, self.env(host), held)
        finally:
            # The child holds its own copies now
            for s in held:
                s.close()
        self.children[host] = child
        return child

    def start(self) -> "ProcCluster":
        from faabric_tpu_torch.executor import get_executor_factory
        from faabric_tpu_torch.runner import WorkerRuntime
        from faabric_tpu_torch.transport import register_host_alias
        from faabric_tpu_torch.util.config import get_system_config

        held = self._hold_slot()
        try:
            planner = self.spawn(self.planner_host,
                                 held.pop(self.planner_host))
            self.ready[self.planner_host] = planner.wait_ready()
            # The workers register with the planner as they start, so
            # they start once it serves; together, since each takes an
            # interpreter's start-up
            for w in self.workers:
                self.spawn(w, held.pop(w))
            for w in self.workers:
                self.ready[w] = self.children[w].wait_ready()
            for key, val in self.extra_env.items():
                self._saved_env[key] = os.environ.get(key)
                os.environ[key] = val
            get_system_config().reset()
            for host, off in self._offsets().items():
                register_host_alias(host, "127.0.0.1", off)
            # The client host replaces this process's executor factory
            # until the cluster stops
            try:
                self._saved_factory = get_executor_factory()
            except RuntimeError:
                self._saved_factory = None
            self.me = WorkerRuntime(host=self.client_host, slots=0,
                                    factory=NullFactory(),
                                    planner_host=self.planner_host)
            self.me.start()
        except BaseException:
            for socks in held.values():
                for s in socks:
                    s.close()
            self.stop()
            raise
        return self

    def restart_planner(self) -> dict:
        """A fresh planner process on the same port offset (and, through
        the environment, the same journal) after a kill; returns its
        ready line."""
        from tests.test_torch_mpi import _hold_ports

        old = self.children.pop(self.planner_host)
        old.stop()
        held = []
        deadline = time.monotonic() + 60
        while not held:
            held = _hold_ports((self.base + p for p in _service_ports()),
                               listen=True)
            assert held or time.monotonic() < deadline, \
                "the planner's ports never came free"
            time.sleep(0.05)
        child = self.spawn(self.planner_host, held)
        self.ready[self.planner_host] = child.wait_ready()
        return self.ready[self.planner_host]

    def kill(self, host: str) -> float:
        self.children[host].kill()
        return time.monotonic()

    def dump_telemetry(self, directory: Path) -> list[dict]:
        """Every live child's trace events, comm-matrix cells and
        Prometheus text (``dump`` on its standard input)."""
        import json

        paths = {}
        for host, child in self.children.items():
            if child.proc.poll() is None:
                paths[host] = directory / f"telemetry-{host}.json"
                child.command(f"dump {paths[host]}")
        deadline = time.monotonic() + 60
        while not all(p.exists() for p in paths.values()):
            assert time.monotonic() < deadline, "a telemetry dump is missing"
            time.sleep(0.05)
        return [json.loads(p.read_text()) for p in paths.values()]

    def stop(self) -> None:
        from faabric_tpu_torch.executor import set_executor_factory
        from faabric_tpu_torch.transport import clear_host_aliases
        from faabric_tpu_torch.util.config import get_system_config

        try:
            if self.me is not None:
                self.me.shutdown()
                self.me = None
                set_executor_factory(self._saved_factory)
        finally:
            for child in self.children.values():
                child.stop()
            for key, val in self._saved_env.items():
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
            self._saved_env.clear()
            clear_host_aliases()
            get_system_config().reset()


@pytest.fixture(scope="module")
def dist_cluster():
    """A planner and two worker processes (4 slots each); this process is
    the client host. Tracing is on in every process, and the planner
    serves its REST endpoint, so that the telemetry cases scrape
    ``/metrics``, ``/trace`` and ``/commmatrix`` from the workers."""
    cluster = ProcCluster("mp", {"w1": 4, "w2": 4},
                          extra_env={"FAABRIC_TRACING": "1"},
                          http=True).start()
    try:
        yield cluster
    finally:
        cluster.stop()


def wait_batch_finished(me, app_id, timeout=20.0):
    """Poll the planner until every message of the app reported a result."""
    deadline = time.time() + timeout
    status = me.planner_client.get_batch_results(app_id)
    while not status.finished and time.time() < deadline:
        time.sleep(0.2)
        status = me.planner_client.get_batch_results(app_id)
    assert status.finished, f"batch {app_id} never finished"
    return status


def http_text(base: str, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"{base}{path}", timeout=20) as resp:
        assert resp.status == 200
        return resp.read().decode()


def http_json(base: str, path: str):
    import json

    return json.loads(http_text(base, path))


def host_sum(text: str, family: str, host: str) -> float:
    """The sum of ``family``'s samples under ``host="<host>"`` in a
    merged Prometheus text."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(family + "{") and f'host="{host}"' in line)


def test_dist_function_batch(dist_cluster):
    me = dist_cluster.me
    req = batch_exec_factory("dist", "square", 8)
    for i, m in enumerate(req.messages):
        m.input_data = str(i + 2).encode()
    decision = me.planner_client.call_functions(req)
    assert sorted(set(decision.hosts)) == ["w1", "w2"], (
        decision.hosts, me.planner_client.get_available_hosts())
    for i, m in enumerate(req.messages):
        r = me.planner_client.get_message_result(req.app_id, m.id,
                                                 timeout=20.0)
        assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
        assert int(r.output_data.decode()) == (i + 2) ** 2


def test_dist_hosts_import_no_jax_and_no_faabric_tpu(dist_cluster):
    """Every host process names the modules it loaded: the port's, and
    nothing of JAX or of the JAX package."""
    for host, ready in dist_cluster.ready.items():
        mods = set(ready["modules"])
        assert "faabric_tpu_torch" in mods and "torch" in mods, host
        assert not mods & {"jax", "jaxlib", "faabric_tpu"}, (host, mods)


def test_dist_mpi_allreduce(dist_cluster):
    me = dist_cluster.me
    req = batch_exec_factory("dist", "mpi", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=40.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    assert r.output_data == b"r0:28"  # sum of ranks 0..7

    status = wait_batch_finished(me, req.app_id, timeout=20)
    assert status.expected_num_messages == 8
    hosts = {m.executed_host for m in status.message_results}
    assert hosts == {"w1", "w2"}


def test_dist_mpi_chunked_bulk_allreduce(dist_cluster):
    """12 MiB a rank across 2 worker processes: the chunk-pipelined
    collectives and the bulk data plane inside the planner-scheduled
    stack."""
    me = dist_cluster.me
    req = batch_exec_factory("dist", "mpi_big", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=60.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    assert r.output_data == b"r0:ok"

    status = wait_batch_finished(me, req.app_id, timeout=30)
    assert status.expected_num_messages == 8
    for m in status.message_results:
        assert m.return_value == int(ReturnValue.SUCCESS), m.output_data
    assert {m.executed_host for m in status.message_results} == {"w1", "w2"}


def test_dist_chunked_ring_allreduce_over_frame_cap(dist_cluster, tmp_path):
    """A ring allreduce whose per-rank segments exceed one bulk frame, so
    the collectives chunk-pipeline. Asserts (a) bitwise-correct results
    on every rank, (b) the ring algorithm ran (allreduce spans tagged
    algo=ring at this size), (c) ≥90% of remote sends keep their
    cross-process flow links, and (d) the comm matrix's bulk/shm bytes
    stay within 5% of the transport layer's own bulk counters, each
    over the views every host process dumps, merged as the planner's
    endpoint merges them; then (e) the live planner's ``/trace``,
    ``/commmatrix`` and ``/metrics`` agree with those dumped views."""
    from faabric_tpu_torch.telemetry import merge_cell_rows

    cluster = dist_cluster
    me = cluster.me
    req = batch_exec_factory("dist", "mpi_ring_chunked", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=120.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    assert r.output_data == b"r0:ok"
    status = wait_batch_finished(me, req.app_id, timeout=60)
    for m in status.message_results:
        assert m.return_value == int(ReturnValue.SUCCESS), m.output_data
        assert m.output_data.endswith(b":ok"), m.output_data

    dumps = cluster.dump_telemetry(tmp_path)
    events = [e for d in dumps for e in d["trace"]]

    # (b) the 40 MiB-per-rank collective took the ring path
    rings = [e for e in events if e.get("cat") == "mpi"
             and e["name"] == "allreduce"
             and e.get("args", {}).get("bytes", 0) >= (40 << 20)
             and e.get("args", {}).get("algo") == "ring"]
    assert len(rings) >= 8, (
        f"{len(rings)} ring-algo allreduce spans at 40 MiB")

    # (c) flow links pair up across processes
    starts = {e["id"]: e["pid"] for e in events
              if e.get("ph") == "s" and e.get("cat") == "flow"}
    finishes = {}
    for e in events:
        if e.get("ph") == "f" and e.get("cat") == "flow":
            finishes.setdefault(e["id"], set()).add(e["pid"])
    assert starts, "no flow-start events in the merged trace"
    cross = sum(1 for fid, pid in starts.items()
                if any(p != pid for p in finishes.get(fid, ())))
    coverage = cross / len(starts)
    assert coverage >= 0.9, (
        f"only {coverage:.0%} of {len(starts)} remote sends have a "
        "cross-process flow link")

    # (d) the matrix's bulk/shm rows against the bulk plane's tx counters
    matrix = merge_cell_rows({d["process"]: d["cells"] for d in dumps})
    bulk_tx = 0.0
    for d in dumps:
        for line in d["metrics"].splitlines():
            if line.startswith("faabric_bulk_tx_bytes_total{"):
                bulk_tx += float(line.rsplit(" ", 1)[1])
    matrix_bulk_bytes = sum(row["bytes"] for row in matrix
                            if row["plane"] in ("bulk-tcp", "shm"))
    assert bulk_tx > 40 * (1 << 20), bulk_tx
    assert matrix_bulk_bytes == pytest.approx(bulk_tx, rel=0.05), (
        matrix_bulk_bytes, bulk_tx)

    # (e) the live endpoint's views of the same processes
    by_host = {("planner" if d["process"] == "planner"
                else d["process"].removeprefix("worker-")): d for d in dumps}
    live_trace = http_json(cluster.http_url, "/trace")["traceEvents"]

    def ring_spans(evs):
        return sorted((e["tid"], e["ts"], e["dur"]) for e in evs
                      if e.get("cat") == "mpi" and e["name"] == "allreduce"
                      and e.get("args", {}).get("algo") == "ring")

    assert ring_spans(live_trace) == ring_spans(events)
    live_starts = {e["id"] for e in live_trace
                   if e.get("ph") == "s" and e.get("cat") == "flow"}
    assert set(starts) <= live_starts
    live_matrix = http_json(cluster.http_url, "/commmatrix")["hosts"]
    live_text = http_text(cluster.http_url, "/metrics")
    for host, d in by_host.items():
        def bulk_rows(cells):
            return sorted((c["src"], c["dst"], c["plane"], c["bytes"])
                          for c in cells
                          if c["plane"] in ("bulk-tcp", "shm"))

        assert bulk_rows(live_matrix[host]) == bulk_rows(d["cells"]), host
        dumped = sum(float(line.rsplit(" ", 1)[1])
                     for line in d["metrics"].splitlines()
                     if line.startswith("faabric_bulk_tx_bytes_total{"))
        assert host_sum(live_text, "faabric_bulk_tx_bytes_total",
                        host) == dumped, host


def run_rank0(me, function: str, timeout: float = 60.0):
    """Submit rank 0 of an MPI function; wait for the whole world."""
    req = batch_exec_factory("dist", function, 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=timeout)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    return wait_batch_finished(me, req.app_id, timeout=30)


def cluster_rows(cluster, text: str) -> list[str]:
    """The sample lines of the cluster's own processes (its planner and
    workers) in a merged Prometheus text. This test process is a host
    too, but its registry carries what earlier tests of the process
    left in it, while their fixtures reset its comm matrix."""
    hosts = ["planner", *cluster.workers]
    return [line for line in text.splitlines()
            if line and not line.startswith("#")
            and any(f'host="{h}"' in line for h in hosts)]


def test_dist_telemetry_metrics_and_trace(dist_cluster):
    """A multi-process allreduce gives (a) a planner-served /metrics page
    with Prometheus-parseable transport byte and frame counters from
    every host's registry and (b) a Chrome trace whose MPI allreduce
    spans decompose >=90% of the collectives' wall time into named
    phases (``tests/dist/test_multiprocess.py:241``)."""
    import re

    cluster = dist_cluster
    run_rank0(cluster.me, "mpi_telemetry")
    base = cluster.http_url

    text = http_text(base, "/metrics")
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? ([0-9.eE+-]+|\+Inf)$')
    samples = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample_re.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        samples.append((m.group(1), m.group(2) or "", float(m.group(3))
                        if m.group(3) != "+Inf" else float("inf")))
    for host in ("w1", "w2", "planner"):
        tx = [s for s in samples
              if s[0] == "faabric_transport_tx_bytes_total"
              and f'host="{host}"' in s[1]]
        assert tx and sum(v for _, _, v in tx) > 0, (host, text[:2000])
        frames = [s for s in samples
                  if s[0] == "faabric_transport_tx_frames_total"
                  and f'host="{host}"' in s[1]]
        assert frames, (host, text[:2000])
    bulk = [s for s in samples if s[0] in ("faabric_bulk_tx_bytes_total",
                                           "faabric_shm_ring_tx_bytes_total")]
    assert sum(v for _, _, v in bulk) > 8 * (1 << 20), bulk
    coll = [s for s in samples if s[0] == "faabric_mpi_collectives_total"
            and 'op="allreduce"' in s[1]]
    assert sum(v for _, _, v in coll) >= 8, coll

    trace = http_json(base, "/trace")
    events = trace["traceEvents"]
    assert isinstance(events, list) and events
    allreduces = [e for e in events if e.get("cat") == "mpi"
                  and e["name"] == "allreduce"
                  and e.get("args", {}).get("bytes", 0) >= (12 << 20)]
    assert len(allreduces) >= 8, f"{len(allreduces)} allreduce spans"
    phases = [e for e in events if e.get("cat") == "mpi.phase"]
    spans = []  # (wall, covered, phase names) per allreduce
    for ar in allreduces:
        lo, hi = ar["ts"], ar["ts"] + ar["dur"]
        mine = [p for p in phases
                if p["pid"] == ar["pid"] and p["tid"] == ar["tid"]
                and p["ts"] >= lo - 1 and p["ts"] + p["dur"] <= hi + 1]
        assert mine, f"allreduce span with no phases: {ar}"
        spans.append((ar["dur"], sum(p["dur"] for p in mine),
                      [p["name"] for p in mine]))
    # As the reference: the worst quarter of spans are taken as
    # preemption outliers of a loaded machine, the strict floors hold on
    # the rest
    spans.sort(key=lambda s: s[1] / max(s[0], 1e-9))
    kept = spans[len(spans) // 4:]
    for wall, covered, names in kept:
        assert covered >= 0.75 * wall, (
            f"phases cover {covered / max(wall, 1e-9):.0%} "
            f"of allreduce wall: {names}")
    total_wall = sum(s[0] for s in kept)
    total_covered = sum(s[1] for s in kept)
    assert total_covered >= 0.9 * total_wall, (
        f"phases cover {total_covered / total_wall:.0%} of total "
        "allreduce wall time")


def test_dist_trace_cross_host_links(dist_cluster):
    """The merged /trace of a multi-process allreduce is linked across
    hosts: >=90% of remote ptp sends have their flow's finish in another
    process, and RPC handler spans carry their remote caller's trace
    context (``tests/dist/test_multiprocess.py:341``)."""
    cluster = dist_cluster
    run_rank0(cluster.me, "mpi_flow")
    events = http_json(cluster.http_url, "/trace")["traceEvents"]

    sends = [e for e in events if e.get("cat") == "ptp"
             and e.get("name") == "send"
             and e.get("args", {}).get("remote")]
    assert len(sends) >= 8, f"only {len(sends)} remote send spans"
    starts = {}
    for e in events:
        if e.get("ph") == "s" and e.get("cat") == "flow":
            starts[e["id"]] = e["pid"]
    finishes = {}
    for e in events:
        if e.get("ph") == "f" and e.get("cat") == "flow":
            finishes.setdefault(e["id"], set()).add(e["pid"])
    assert starts, "no flow-start events in merged trace"
    cross = sum(1 for fid, pid in starts.items()
                if any(p != pid for p in finishes.get(fid, ())))
    coverage = cross / len(starts)
    assert coverage >= 0.9, (
        f"only {coverage:.0%} of {len(starts)} remote sends have a "
        "cross-process flow link")
    # Handler spans joined their caller's trace, whose parent span lives
    # in another process
    span_home = {}
    for e in events:
        if e.get("ph") == "X" and "span_id" in e.get("args", {}):
            span_home[e["args"]["span_id"]] = e["pid"]
    linked = [e for e in events if e.get("ph") == "X"
              and e.get("args", {}).get("remote_parent")
              and span_home.get(e["args"].get("parent_span_id"),
                                e["pid"]) != e["pid"]]
    assert linked, "no cross-host parent→child span links in /trace"
    # Three processes of the cluster, three distinct rows
    assert len({e["pid"] for e in events}) >= 3


def test_dist_commmatrix_and_healthz(dist_cluster):
    """/commmatrix reports rank-pair bytes within 5% of the transport's
    own bulk counters, and its Prometheus view within 5% of its JSON
    view; /healthz lists the registered hosts with their keep-alive ages
    (``tests/dist/test_multiprocess.py:401``). The sums run over the
    cluster's own processes (``cluster_rows``)."""
    cluster = dist_cluster
    run_rank0(cluster.me, "mpi_matrix")
    base = cluster.http_url

    matrix = http_json(base, "/commmatrix")
    from faabric_tpu_torch.telemetry import merge_cell_rows

    total = merge_cell_rows({h: cells for h, cells in matrix["hosts"].items()
                             if h in ("planner", *cluster.workers)})
    assert total, "empty merged comm matrix after a cross-host allreduce"
    matrix_bytes = sum(row["bytes"] for row in total)
    assert matrix_bytes > 8 * (1 << 20), total[:5]
    assert all(row["plane"] in ("ptp", "bulk-tcp", "shm")
               for row in total), total[:5]

    bulk_tx = comm_bytes_metric = 0.0
    for line in cluster_rows(cluster, http_text(base, "/metrics")):
        if line.startswith("faabric_bulk_tx_bytes_total{"):
            bulk_tx += float(line.rsplit(" ", 1)[1])
        elif line.startswith("faabric_comm_bytes_total{"):
            comm_bytes_metric += float(line.rsplit(" ", 1)[1])
    matrix_bulk_bytes = sum(row["bytes"] for row in total
                            if row["plane"] in ("bulk-tcp", "shm"))
    assert bulk_tx > 0
    assert matrix_bulk_bytes == pytest.approx(bulk_tx, rel=0.05), (
        matrix_bulk_bytes, bulk_tx)
    assert comm_bytes_metric == pytest.approx(matrix_bytes, rel=0.05), (
        comm_bytes_metric, matrix_bytes)

    health = http_json(base, "/healthz")
    assert health["status"] == "ok"
    hosts = {h["host"]: h for h in health["hosts"]}
    assert {"w1", "w2"} <= set(hosts)
    for w in ("w1", "w2"):
        age = hosts[w]["keepAliveAgeSeconds"]
        assert 0 <= age < hosts[w]["timeoutSeconds"]
    assert health["inFlightApps"] >= 0


@pytest.mark.parametrize("behaviour,rank0_out", [
    ("mpi_reduce_many", b"reduce-many-ok"),
    ("mpi_sync_async", b"sent"),
    ("mpi_cartesian", b"cart-ok:0x0"),
    ("mpi_send_many", b"send-many-ok"),
    ("mpi_checks", b"checks:7"),
    ("mpi_typesize", b"typesize-ok"),
    ("mpi_collectives", b"collectives-ok"),
    ("mpi_p2p_suite", b"p2p-suite-ok"),
])
def test_dist_mpi_more_examples(dist_cluster, behaviour, rank0_out):
    """Reference example ports across worker processes: back-to-back
    reduces, interleaved sync and async sends, cartesian topologies,
    send fan-outs, world checks, type sizes, the collectives and the
    point-to-point suite."""
    me = dist_cluster.me
    req = batch_exec_factory("dist", behaviour, 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=60.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    assert r.output_data == rank0_out
    status = wait_batch_finished(me, req.app_id, timeout=30)
    for m in status.message_results:
        assert m.return_value == int(ReturnValue.SUCCESS), m.output_data


def test_dist_mpi_order_example(dist_cluster):
    """mpi_order.cpp: out-of-order receives across per-pair channels."""
    me = dist_cluster.me
    req = batch_exec_factory("dist", "mpi_order", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=40.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    assert r.output_data == b"order-ok"
    status = wait_batch_finished(me, req.app_id)
    assert all(m.return_value == int(ReturnValue.SUCCESS)
               for m in status.message_results)


def test_dist_mpi_status_example(dist_cluster):
    """mpi_status.cpp: probe and the status count of a receive across
    hosts."""
    me = dist_cluster.me
    req = batch_exec_factory("dist", "mpi_status", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=40.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data

    status = wait_batch_finished(me, req.app_id, timeout=20)
    assert status.expected_num_messages == 8
    outs = {m.mpi_rank: m.output_data for m in status.message_results}
    assert outs[1] == b"got:40"
    assert all(m.return_value == int(ReturnValue.SUCCESS)
               for m in status.message_results), outs


def test_dist_mpi_isendrecv_example(dist_cluster):
    """mpi_isendrecv.cpp: an async ring exchange (irecv left, isend
    right, waitall) across hosts."""
    me = dist_cluster.me
    req = batch_exec_factory("dist", "mpi_isendrecv", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=40.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data

    status = wait_batch_finished(me, req.app_id, timeout=20)
    assert status.expected_num_messages == 8
    for m in status.message_results:
        assert m.return_value == int(ReturnValue.SUCCESS), m.output_data
        assert m.output_data.endswith(b"async-ok")


def test_dist_threads_snapshot_merge(dist_cluster):
    from faabric_tpu_torch.snapshot import (
        SnapshotData,
        SnapshotDataType,
        SnapshotMergeOperation,
    )

    me = dist_cluster.me
    base = np.zeros(16384, dtype=np.uint8)
    base[:8].view(np.int64)[0] = 9000
    snap = SnapshotData(base.tobytes())
    snap.add_merge_region(0, 8, SnapshotDataType.LONG,
                          SnapshotMergeOperation.SUM)
    snap.fill_gaps_with_bytewise_regions()

    n = 8
    req = batch_exec_factory("dist", "threads", n)
    req.type = int(BatchExecuteType.THREADS)
    for i, m in enumerate(req.messages):
        m.group_idx = i
    key = f"dist/threads_{req.app_id}"
    req.snapshot_key = key
    me.snapshot_registry.register_snapshot(key, snap)

    me.planner_client.call_functions(req)
    for m in req.messages:
        r = me.planner_client.get_message_result(req.app_id, m.id,
                                                 timeout=20.0)
        assert r.return_value == int(ReturnValue.SUCCESS), r.output_data

    applied = snap.write_queued_diffs()
    assert applied >= 2
    merged = snap.data
    assert merged[:8].view(np.int64)[0] == 9000 + sum(
        i + 1 for i in range(n))
    for i in range(n):
        assert merged[512 * (1 + i)] == 200 + i


def test_dist_state_pull_push(dist_cluster):
    me = dist_cluster.me
    # This (client) process is the state master
    kv = me.state.get_kv("dist", "shared", 4096)
    assert kv.is_master
    kv.set(bytes([7]) * 4096)

    req = batch_exec_factory("dist", "state", 1)
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=20.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    # The remote worker pulled, doubled one chunk and pushed back
    assert kv.get_chunk(0, 4) == bytes([14] * 4)


def test_dist_data_parallel_training(dist_cluster):
    """Data-parallel training across worker processes: gradients
    allreduce through faabric's MPI, so every rank's parameters stay
    identical without a parameter server."""
    me = dist_cluster.me
    req = batch_exec_factory("dist", "train", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r0 = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                              timeout=60.0)
    assert r0.return_value == int(ReturnValue.SUCCESS), r0.output_data

    status = wait_batch_finished(me, req.app_id, timeout=30)
    assert status.expected_num_messages == 6
    checksums = {m.output_data.split(b":")[1] for m in status.message_results}
    assert len(checksums) == 1, status.message_results  # ranks in sync
    hosts = {m.executed_host for m in status.message_results}
    assert hosts == {"w1", "w2"}


def test_dist_worker_crash_fail_dispatch_and_expiry():
    """A worker process is SIGKILLed; a batch that still places on it has
    its stranded messages recovered by the planner (host expiry requeues
    them onto the survivor, so the batch completes fully SUCCESS), and a
    follow-up batch lands entirely on the survivor. A cluster of its own
    (PLANNER_HOST_TIMEOUT=6 so that expiry is observable)."""
    cluster = ProcCluster("crash", {"w5": 4, "w6": 4},
                          extra_env={"PLANNER_HOST_TIMEOUT": "6"}).start()
    try:
        me = cluster.me
        # Healthy cluster: 8 messages spread over both workers
        req = batch_exec_factory("dist", "square", 8)
        for i, m in enumerate(req.messages):
            m.input_data = str(i + 1).encode()
        decision = me.planner_client.call_functions(req)
        assert sorted(set(decision.hosts)) == ["w5", "w6"], (
            decision.hosts, me.planner_client.get_available_hosts())
        status = wait_batch_finished(me, req.app_id, timeout=30)
        assert all(m.return_value == int(ReturnValue.SUCCESS)
                   for m in status.message_results)

        # Kill w6 outright. A batch placed before expiry has its w6
        # messages stranded (an async dispatch onto a dead pooled
        # connection cannot error); expiry must recover them
        cluster.kill("w6")
        req2 = batch_exec_factory("dist", "square", 8)
        for i, m in enumerate(req2.messages):
            m.input_data = str(i + 1).encode()
        d2 = me.planner_client.call_functions(req2)
        # Under heavy load the planner may already have expired w6 (the
        # keep-alive timeout elapsed between the kill and the call); the
        # stranded-messages scenario needs w6 still placed
        stranded = "w6" in d2.hosts
        if not stranded:
            pytest.skip("w6 expired before the batch placed on it "
                        f"(slow machine); d2.hosts={d2.hosts}")

        # The dead host expires off the registry at the keep-alive
        # timeout (polling get_available_hosts drives the lazy expiry)
        deadline = time.time() + 20
        hosts = None
        while time.time() < deadline:
            hosts = {h["ip"] for h in me.planner_client.get_available_hosts()}
            if "w6" not in hosts:
                break
            time.sleep(0.5)
        assert "w6" not in hosts, hosts

        # Expiry recovered the stranded messages: requeued onto the
        # survivor, so the whole batch succeeds, every message on w5
        status2 = wait_batch_finished(me, req2.app_id, timeout=40)
        assert all(r.return_value == int(ReturnValue.SUCCESS)
                   for r in status2.message_results), [
            (r.id, r.return_value, r.output_data)
            for r in status2.message_results]
        assert {r.executed_host for r in status2.message_results} == {"w5"}

        # And the cluster heals: a survivor-sized batch fully succeeds
        req3 = batch_exec_factory("dist", "square", 4)
        for i, m in enumerate(req3.messages):
            m.input_data = str(i + 1).encode()
        d3 = me.planner_client.call_functions(req3)
        assert set(d3.hosts) == {"w5"}, d3.hosts
        status3 = wait_batch_finished(me, req3.app_id, timeout=30)
        assert all(m.return_value == int(ReturnValue.SUCCESS)
                   for m in status3.message_results)
    finally:
        cluster.stop()


def test_dist_mpi_alltoall_sleep(dist_cluster):
    """mpi_alltoall_sleep across worker processes: 100 barrier + alltoall
    rounds with a mid-stream straggler (rank 3 sleeps 2 s)."""
    me = dist_cluster.me
    req = batch_exec_factory("dist", "mpi_alltoall_sleep", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)
    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=90.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    status = wait_batch_finished(me, req.app_id, timeout=30)
    assert status.expected_num_messages == 8
    for m in status.message_results:
        assert m.return_value == int(ReturnValue.SUCCESS), m.output_data
        assert m.output_data.endswith(b"alltoall-sleep-ok")
    assert {m.executed_host for m in status.message_results} == {"w1", "w2"}


def test_dist_mpi_live_migration(dist_cluster):
    """mpi_migration across worker processes: blockers force a 3-rank
    world to spread over both workers; when they finish, the planner
    consolidates, the moved rank vacates mid-loop, re-enters on the
    target worker process, and the world completes its remaining
    all-to-all rounds across the migration."""
    me = dist_cluster.me

    # Hold slots so the MPI world must spread: 2 + 3 blockers on 4 + 4
    blockers = []
    for count in (2, 3):
        b = batch_exec_factory("dist", "sleep", count)
        for m in b.messages:
            m.input_data = b"4.0"
        me.planner_client.call_functions(b)
        blockers.append(b)

    req = batch_exec_factory("dist", "mpi_migrate", 1)
    req.messages[0].mpi_rank = 0
    me.planner_client.call_functions(req)

    r = me.planner_client.get_message_result(req.app_id, req.messages[0].id,
                                             timeout=90.0)
    assert r.return_value == int(ReturnValue.SUCCESS), r.output_data

    status = wait_batch_finished(me, req.app_id, timeout=45)
    assert status.expected_num_messages == 3
    final_hosts = set()
    for m in status.message_results:
        assert m.return_value == int(ReturnValue.SUCCESS), m.output_data
        final_hosts.add(m.output_data.decode().rsplit(":", 1)[1])
    # Consolidated: every rank finished on one worker process
    assert len(final_hosts) == 1, final_hosts
    assert me.planner_client.get_num_migrations() >= 1

    for b in blockers:
        wait_batch_finished(me, b.app_id, timeout=30)
