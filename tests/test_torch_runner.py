"""The port's deployment entry points and crash handler.

Counterparts of the CLI and crash-handler cases of
``tests/unit/test_aux.py``, plus what the port's ``runner/__main__.py``
adds: a planner and a worker started as processes through
``python -m faabric_tpu_torch.runner``, stopped by SIGTERM and SIGINT
into flight dumps named after the signal, the worker's guests on the
card unless ``--device cpu``, the planner's REST endpoint at a nonzero
``--http-port`` (EXECUTE_BATCH through the ingress), and the ``redis``
role serving the port's ``MiniRedisServer``.
"""

import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from faabric_tpu.runner import __main__ as ref_runner

ROOT = Path(__file__).resolve().parents[1]


def runner(*args, env=None, timeout=60):
    return subprocess.run([sys.executable, "-m", "faabric_tpu_torch.runner",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_crash_handler_installs():
    import faulthandler

    from faabric_tpu_torch.util.crash import install_crash_handler

    install_crash_handler()
    install_crash_handler()  # idempotent
    assert faulthandler.is_enabled()


def test_crash_handler_dumps_stacks_on_sigusr1():
    """SIGUSR1 prints every thread's stack and the process lives on."""
    code = ("import os, signal, time\n"
            "from faabric_tpu_torch.util.crash import install_crash_handler\n"
            "install_crash_handler()\n"
            "os.kill(os.getpid(), signal.SIGUSR1)\n"
            "time.sleep(0.2)\n"
            "print('alive')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "alive", out
    assert "Current thread" in out.stderr or "Thread 0x" in out.stderr, \
        out.stderr


def test_runner_cli_help():
    out = runner("--help")
    assert out.returncode == 0
    assert "planner" in out.stdout and "worker" in out.stdout


def test_runner_cli_has_the_reference_roles(monkeypatch):
    """The same roles as the reference's CLI, each with its options."""
    import argparse

    captured = {}

    def grab(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)

    def roles(prog_main):
        with pytest.raises(SystemExit):
            prog_main([])
        sub = next(a for a in captured["parser"]._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {role: sorted(opt for act in p._actions
                             for opt in act.option_strings)
                for role, p in sub.choices.items()}

    from faabric_tpu_torch.runner import __main__ as port_runner

    ref, port = roles(ref_runner.main), roles(port_runner.main)
    assert set(port) == set(ref) == {"planner", "redis", "worker"}
    for role in ref:
        # The port's worker adds --device (guests on the card or the CPU)
        assert set(ref[role]) <= set(port[role]), role
    assert set(port["worker"]) - set(ref["worker"]) == {"--device"}


# The redis role's port past a slot's base: free in every host's range
# (the services take 8003-8014, an HTTP endpoint 8016, MPI worlds 8020 up)
REDIS_PORT = 8017


def test_runner_redis_role_serves_ping():
    """``python -m faabric_tpu_torch.runner redis`` serves the port's
    mini server: it answers PING and a SET/GET, and SIGTERM stops it
    cleanly."""
    from faabric_tpu_torch.redis import RedisClient

    proc, base = start_until(
        lambda b: ["redis", "--port", str(b + REDIS_PORT)],
        lambda b: dict(os.environ), "Mini redis up")
    try:
        assert f"127.0.0.1:{base + REDIS_PORT}" in "".join(proc.log)
        cli = RedisClient("127.0.0.1", base + REDIS_PORT)
        try:
            assert cli.ping()
            cli.set("runner", b"ok")
            assert cli.get("runner") == b"ok"
        finally:
            cli.close()
        assert proc.stop(signal.SIGTERM) == 0, proc.log
    finally:
        proc.kill()


def test_runner_worker_runs_guests_on_the_card_unless_cpu_is_asked():
    """Without a card the worker role refuses to start: its guests would
    run on CUDA. (The test process has no card.)"""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    out = runner("worker", "--host", "nocard", "--slots", "1",
                 "--planner-host", "127.0.0.1")
    assert out.returncode != 0
    assert "CUDA" in out.stderr, out.stderr[-2000:]


class RunnerProc:
    """``python -m faabric_tpu_torch.runner`` with ``args``; its log lines
    read by a thread."""

    def __init__(self, args, env):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "faabric_tpu_torch.runner", *args],
            cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.log: list[str] = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stderr:
            self.log.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, text: str, timeout: float = 120.0) -> bool:
        """True once a log line holds ``text``; False if the process
        exits first."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"no {text!r} in {self.log}")
            if line is None:
                return False
            if text in line:
                return True

    def stop(self, sig) -> int:
        self.proc.send_signal(sig)
        try:
            return self.proc.wait(60)
        finally:
            self.proc.stderr.close()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)
        self.proc.stderr.close()


def start_until(args_of, env, text):
    """Start the role, moving to another port slot when one of its ports
    was taken while the interpreter started."""
    from tests.test_torch_multiprocess import port_slot

    for _ in range(5):
        base = port_slot()
        p = RunnerProc(args_of(base), env(base))
        if p.wait_for(text):
            return p, base
        p.kill()
    raise AssertionError(f"the role never came up: {p.log}")


def test_runner_planner_and_cpu_worker_as_processes_stop_on_signals(tmp_path):
    """A planner and a worker (``--device cpu``) started as processes
    through the port's entry point: the worker registers with the
    planner; SIGTERM stops the planner and SIGINT the worker, each
    cleanly (exit 0) and each leaving a flight dump whose record names
    the signal that came."""
    from faabric_tpu_torch.planner.client import PlannerClient
    from faabric_tpu_torch.runner import flightdump
    from faabric_tpu_torch.transport import (
        clear_host_aliases,
        register_host_alias,
    )

    flight = tmp_path / "flight"

    def env(base):
        return {**os.environ, "FAABRIC_FLIGHT_DIR": str(flight),
                "FAABRIC_HOST_ALIASES":
                    f"rnpl=127.0.0.1+{base},rnw=127.0.0.1+{base + 1000}"}

    planner, base = start_until(
        lambda b: ["planner", "--port-offset", str(b)], env, "Planner up")
    worker = None
    try:
        worker = RunnerProc(["worker", "--host", "rnw", "--slots", "2",
                             "--planner-host", "rnpl", "--device", "cpu"],
                            env(base))
        assert worker.wait_for("Worker rnw up"), worker.log
        register_host_alias("rnpl", "127.0.0.1", base)
        client = PlannerClient("rnobs", "rnpl")
        try:
            hosts = {h["ip"]: h for h in client.get_available_hosts()}
        finally:
            client.close()
        assert hosts["rnw"]["slots"] == 2, hosts
        assert hosts["rnw"].get("n_devices", 0) == 0, hosts

        assert worker.stop(signal.SIGINT) == 0, worker.log
        assert planner.stop(signal.SIGTERM) == 0, planner.log
    finally:
        clear_host_aliases()
        for p in (worker, planner):
            if p is not None:
                p.kill()
    dumps = flightdump.load_dumps(str(flight))
    by_reason = {d["reason"]: d for d in dumps}
    assert set(by_reason) == {"sigterm", "sigint"}, dumps
    assert by_reason["sigterm"]["process"] == "planner"
    assert by_reason["sigint"]["process"] == "worker-rnw"
    for reason, d in by_reason.items():
        kinds = [e["kind"] for e in d["events"]]
        assert reason in kinds, kinds
        rec = next(e for e in d["events"] if e["kind"] == reason)
        assert rec["role"] == ("planner" if reason == "sigterm"
                               else "worker")


def test_runner_planner_serves_rest_endpoint_at_http_port():
    """A nonzero ``--http-port`` starts the planner's REST endpoint: its
    GET surfaces and POST requests answer, an EXECUTE_BATCH to a planner
    with no hosts answers the reference's 500 "No available hosts" (the
    ingress's immediate path), and SIGTERM still stops the planner
    cleanly."""
    import json
    import urllib.error
    import urllib.request

    from tests.test_torch_multiprocess import HTTP_PORT, http_json, http_text

    env = {k: v for k, v in os.environ.items()
           if k != "FAABRIC_FLIGHT_DIR"}
    planner, base = start_until(
        lambda b: ["planner", "--port-offset", str(b), "--http-port",
                   str(b + HTTP_PORT)], lambda b: env, "Planner up")
    try:
        url = f"http://127.0.0.1:{base + HTTP_PORT}"
        assert f"http :{base + HTTP_PORT}" in "".join(planner.log)
        health = http_json(url, "/healthz")
        assert health["status"] == "ok" and health["hosts"] == []
        assert "faabric_planner_in_flight_apps" in http_text(url, "/metrics")

        def post(http_type, payload=""):
            body = json.dumps({"http_type": http_type,
                               "payload": payload}).encode()
            req = urllib.request.Request(f"{url}/", data=body,
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        assert post(14) == (200, {"policy": "bin-pack"})  # GET_POLICY
        from faabric_tpu_torch.proto import batch_exec_factory

        status, out = post(10, json.dumps(
            batch_exec_factory("demo", "echo", 1).to_dict()))
        assert (status, out) == (500, {"error": "No available hosts"})
        health = http_json(url, "/healthz")
        assert health["ingress"]["admittedTotal"] == 1
        assert health["ingress"]["immediateTotal"] == 1
        assert planner.stop(signal.SIGTERM) == 0, planner.log
    finally:
        planner.kill()



def test_runner_roles_run_under_the_lock_order_detector():
    """With ``FAABRIC_LOCKCHECK=1`` the planner and a worker (``--device
    cpu``) run under the port's lock-order detector, installed before
    the port's modules load (their module-level locks are checked too),
    and each writes one ``lockcheck-report:`` line at its stop: no
    held-before cycle, and the stop still exits 0."""
    import ast
    import json

    from faabric_tpu_torch.analysis.lockcheck import REPORT_MARKER

    # Offsets of the slot that no other cluster of the suite binds
    # (tests/test_torch_procs_collectives.py)
    def env(base):
        return {**os.environ, "FAABRIC_LOCKCHECK": "1",
                "FAABRIC_HOST_ALIASES": f"lcpl=127.0.0.1+{base + 300},"
                                        f"lcw=127.0.0.1+{base + 1500}"}

    from tests.test_torch_mpi import _hold_ports
    from tests.test_torch_multiprocess import _service_ports, port_slot

    # Both roles up on one slot, moving to another slot when a port was
    # taken while an interpreter started
    planner = worker = None
    for _ in range(5):
        base = port_slot()
        free = _hold_ports((base + off + p for off in (300, 1500)
                            for p in _service_ports()))
        for sock in free:
            sock.close()
        if not free:
            continue
        planner = RunnerProc(["planner", "--port-offset", str(base + 300)],
                             env(base))
        if planner.wait_for("Planner up"):
            worker = RunnerProc(["worker", "--host", "lcw", "--slots", "2",
                                 "--planner-host", "lcpl", "--device",
                                 "cpu"], env(base))
            if worker.wait_for("Worker lcw up"):
                break
            worker.kill()
        planner.kill()
        planner = worker = None
    assert planner is not None and worker is not None, \
        "the roles never came up on a free slot"
    try:
        reports = {}
        for name, proc, sig in (("worker", worker, signal.SIGINT),
                                ("planner", planner, signal.SIGTERM)):
            proc.proc.send_signal(sig)
            assert proc.proc.wait(60) == 0, proc.log
            while proc.lines.get(timeout=60) is not None:
                pass  # the whole log, up to the end of its stderr
            lines = [ln for ln in proc.log if ln.startswith(REPORT_MARKER)]
            assert len(lines) == 1, proc.log[-20:]
            reports[name] = json.loads(lines[0][len(REPORT_MARKER):])
    finally:
        for p in (worker, planner):
            if p is not None:
                p.kill()
    for name, rep in reports.items():
        assert rep["cycles"] == [], (name, rep)
        assert rep["sites"] > 10 and rep["longest_holds"], (name, rep)

    # Installed before the port loads: the entry point's import checks
    # every module-level lock of the roles' modules (telemetry's leaf
    # locks are exempt by design)
    script = (
        "import sys, faabric_tpu_torch.runner.__main__\n"
        "from faabric_tpu_torch.runner import WorkerRuntime\n"
        "from faabric_tpu_torch.planner import PlannerServer\n"
        "import _thread\n"
        "kinds = (type(_thread.allocate_lock()), type(_thread.RLock()))\n"
        "seen = {f'{n}.{k}': type(v).__name__\n"
        "        for n, m in list(sys.modules.items())\n"
        "        if n.startswith('faabric_tpu_torch.')\n"
        "        and not n.startswith('faabric_tpu_torch.telemetry')\n"
        "        for k, v in vars(m).items()\n"
        "        if isinstance(v, kinds) or type(v).__name__ in\n"
        "        ('_CheckedLock', '_CheckedRLock')}\n"
        "print(sorted(seen.items()))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env={**os.environ, "FAABRIC_LOCKCHECK": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    seen = dict(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert len(seen) > 10 and all(v.startswith("_Checked")
                                  for v in seen.values()), seen
