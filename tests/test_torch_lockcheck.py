"""The port's runtime lock-order / hold-time / blocking detector
(``faabric_tpu_torch/analysis/lockcheck.py``, ``FAABRIC_LOCKCHECK=1``).

Counterpart of ``tests/unit/test_lockcheck.py``. The in-process cases
drive ``CheckedLockFactory`` directly: installation replaces the lock
factories of the whole process for good, so it never happens in a test
worker. Every case that installs the detector runs in a subprocess of
its own, the last one over a port cluster (a planner and two
``WorkerRuntime``s in one process, on a conftest port slot) that runs
an MPI allreduce, ``lock_global`` on a state key and ingress batches,
and must see no held-before cycle.

The cluster body: ``python tests/test_torch_lockcheck.py --cluster
<port base>`` with the repository root on ``PYTHONPATH`` and
``FAABRIC_LOCKCHECK=1``; it prints its results as one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from faabric_tpu_torch.analysis import lockcheck

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_state():
    """Run each test on an empty graph, then restore the state from
    before the test exactly."""
    st = lockcheck._state
    with st.mx:
        saved = (dict(st.edges), dict(st.same_site), list(st.blocking),
                 {k: list(v) for k, v in st.hold_stats.items()})
    lockcheck.reset()
    yield
    with st.mx:
        st.edges.clear()
        st.edges.update(saved[0])
        st.same_site.clear()
        st.same_site.update(saved[1])
        st.blocking[:] = saved[2]
        st.hold_stats.clear()
        st.hold_stats.update(saved[3])


def _locks(n: int, reentrant: bool = False):
    factory = lockcheck.CheckedLockFactory(reentrant)
    return [factory() for _ in range(n)]


def test_factory_wraps_in_scope_creations():
    (lk,) = _locks(1)
    # This file lives under tests/ → in scope → wrapped
    assert type(lk).__name__ == "_CheckedLock"
    with lk:
        assert lk.locked()
    assert not lk.locked()


def test_planted_lock_order_inversion_is_reported():
    factory = lockcheck.CheckedLockFactory(False)
    a = factory()
    b = factory()

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    t1()
    th = threading.Thread(target=t2)
    th.start()
    th.join()

    rep = lockcheck.report()
    assert len(rep["cycles"]) == 1, lockcheck.format_report(rep)
    cycle = rep["cycles"][0]
    # Both acquisition stacks present: each hop names where the holder
    # acquired and the full stack of the closing acquisition
    for hop in cycle:
        assert hop["holder_acquired_at"] != "?"
        assert hop["acquisition_stack"]
    # The exit summary names the cycle's sites
    assert len(lockcheck.exit_summary(rep)["cycles"]) == 1


def test_consistent_order_is_not_a_cycle():
    factory = lockcheck.CheckedLockFactory(False)
    a = factory()
    b = factory()
    for _ in range(3):
        with a:
            with b:
                pass
    rep = lockcheck.report()
    assert rep["cycles"] == []
    assert len(rep["edges"]) == 1


def test_rlock_reentry_is_not_same_site_nesting():
    (r,) = _locks(1, reentrant=True)
    with r:
        with r:
            pass
    rep = lockcheck.report()
    assert rep["same_site_nesting"] == []
    assert rep["cycles"] == []


def test_two_instances_from_one_site_nested_is_reported():
    a, b = _locks(2)  # one creation line → one site, two instances
    with a:
        with b:
            pass
    rep = lockcheck.report()
    # Not a provable cycle (site-keyed graph cannot order instances),
    # but named for an ordering-discipline review
    assert len(rep["same_site_nesting"]) == 1
    assert rep["cycles"] == []


def test_hold_time_histogram_lands_in_telemetry():
    from faabric_tpu_torch.telemetry import get_metrics

    (lk,) = _locks(1)
    with lk:
        pass
    snap = get_metrics().snapshot()
    fam = snap.get("faabric_lock_hold_seconds")
    assert fam is not None and fam["series"], list(snap)
    assert any("test_torch_lockcheck.py" in row["labels"].get("site", "")
               for row in fam["series"])
    # ...and in the exit summary's ranking of hold sites
    holds = lockcheck.exit_summary()["longest_holds"]
    assert any("test_torch_lockcheck.py" in h["site"] for h in holds)


def test_condition_protocol_over_checked_rlock():
    """Condition(wrapped RLock) must fully release the lock around
    wait() — both for correctness and so the held-tracking follows."""
    factory = lockcheck.CheckedLockFactory(True)
    cv = threading.Condition(factory())
    hits = []

    def waiter():
        with cv:
            cv.wait(5.0)
            hits.append(1)

    th = threading.Thread(target=waiter)
    th.start()
    # If wait() failed to release the inner lock this would deadlock
    for _ in range(100):
        with cv:
            cv.notify_all()
        th.join(timeout=0.05)
        if not th.is_alive():
            break
    assert not th.is_alive() and hits == [1]


def test_not_installed_leaves_threading_untouched():
    if lockcheck.installed() or lockcheck.enabled_by_env():
        pytest.skip("running under FAABRIC_LOCKCHECK=1")
    assert threading.Lock is lockcheck._orig_lock
    assert threading.RLock is lockcheck._orig_rlock
    # Not installed: finish() writes nothing and asks for no failure
    assert lockcheck.finish() == 0


@pytest.mark.chaos
@pytest.mark.slow
def test_checked_lock_overhead_is_bounded():
    """Sanity bound, not a benchmark: a checked acquire/release pair
    must stay within interpreter noise — microseconds, not
    milliseconds. It measures time, so it runs outside tier-1."""
    (lk,) = _locks(1)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        with lk:
            pass
    per = (time.perf_counter() - t0) / n
    assert per < 200e-6, f"checked lock cost {per * 1e6:.1f}µs"


def test_full_install_blocking_reports_subprocess():
    """End-to-end: install_from_env() patches the factories and the
    blocking syscalls; planted sleep-under-lock and indefinite-Event.wait-
    under-lock are reported, cv.wait on the lock's own Condition is
    exempt, and the exit report line names them."""
    planted = textwrap.dedent('''
        import threading, time
        lk = threading.Lock()
        with lk:
            time.sleep(0.01)            # planted: blocking under lock
        ev = threading.Event()
        with lk:
            ev.wait(0.01)               # planted: Event.wait under lock
        cv = threading.Condition()
        def waiter():
            with cv:
                cv.wait(1.0)            # exempt: waits on its OWN lock
        t = threading.Thread(target=waiter); t.start()
        time.sleep(0.05)
        with cv:
            cv.notify_all()
        t.join()
    ''')
    script = "\n".join([
        "import json",
        "from faabric_tpu_torch.analysis import lockcheck",
        "assert lockcheck.install_from_env()",
        f"code = compile({planted!r}, 'tests/planted_blocking.py', 'exec')",
        "exec(code, {})",
        "rep = lockcheck.report()",
        "print(json.dumps({"
        "  'calls': sorted({b['call'] for b in rep['blocking_under_lock']}),"
        "  'held': [b['held'] for b in rep['blocking_under_lock']],"
        "  'cycles': len(rep['cycles'])}))",
    ])
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env={**os.environ, "FAABRIC_LOCKCHECK": "1"})
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["calls"] == ["Event.wait", "time.sleep"]
    assert rep["cycles"] == 0
    # Every report names the planted lock's creation site
    assert all(any("planted_blocking" in s for s in held)
               for held in rep["held"])
    # At exit the process wrote its summary line to standard error
    summary = _exit_summary(out.stderr)
    assert summary["cycles"] == []
    assert {b["call"] for b in summary["blocking"]} == {
        "Event.wait", "time.sleep"}
    assert summary["longest_holds"]


def test_gate_turns_a_cycle_into_a_nonzero_status():
    """A process that saw a held-before cycle gets 1 back from
    ``finish()`` with ``FAABRIC_LOCKCHECK_GATE`` on, 0 with it off."""
    script = textwrap.dedent('''
        import sys, threading
        from faabric_tpu_torch.analysis import lockcheck
        lockcheck.install_from_env()
        a = lockcheck.CheckedLockFactory(False, force_site="t/a:1")()
        b = lockcheck.CheckedLockFactory(False, force_site="t/b:1")()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        sys.exit(lockcheck.finish())
    ''')
    rcs = {}
    for gate in ("1", "0"):
        out = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=120, cwd=ROOT,
            env={**os.environ, "FAABRIC_LOCKCHECK": "1",
                 "FAABRIC_LOCKCHECK_GATE": gate})
        rcs[gate] = out.returncode
        summary = _exit_summary(out.stderr)
        assert sorted(summary["cycles"][0]) == ["t/a:1", "t/b:1"], summary
    assert rcs == {"1": 1, "0": 0}


def _exit_summary(stderr: str) -> dict:
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith(lockcheck.REPORT_MARKER)]
    assert len(lines) == 1, stderr[-2000:]
    return json.loads(lines[0][len(lockcheck.REPORT_MARKER):])


# ---------------------------------------------------------------------------
# The detector over a port cluster
# ---------------------------------------------------------------------------

CLUSTER_HOSTS = ("lc-host-a", "lc-host-b")
# The planner's and the hosts' offsets in a port slot: offsets no other
# cluster of the suite binds (tests/test_torch_procs_collectives.py)
CLUSTER_OFFSETS = (300, 1500, 1700)
MPI_SIZE = 6
COUNT_ITERS = 20


def _wait_results(client, app_id: int, n: int, timeout: float = 120.0):
    deadline = time.monotonic() + timeout
    while True:
        status = client.get_batch_results(app_id)
        if status.finished and len(status.message_results) == n:
            return sorted(status.message_results, key=lambda m: m.app_idx)
        assert time.monotonic() < deadline, (app_id, n)
        time.sleep(0.01)


def _cluster_case(base: int) -> dict:
    """A planner and two runtimes (4 slots each) of the port in this
    process, under the detector: a 6-rank MPI allreduce over both
    hosts, two guests adding under ``lock_global``, concurrent ingress
    submissions and one ``submit_functions_many``."""
    assert lockcheck.install_from_env(), "FAABRIC_LOCKCHECK is not set"

    import numpy as np

    from faabric_tpu_torch.executor import (
        TorchExecutorFactory,
        register_function,
    )
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
    from faabric_tpu_torch.runner import WorkerRuntime
    from faabric_tpu_torch.transport import register_host_alias
    from tests.test_torch_procs import _release_held_ports

    @register_function("lc", "allreduce")
    def allreduce(ctx):
        world = ctx.mpi_world()
        rank = ctx.message.mpi_rank
        out = world.allreduce(rank, np.full(4096, rank + 1, np.int64),
                              MpiOp.SUM)
        world.barrier(rank)
        return str(int(out[0])).encode()

    @register_function("lc", "count")
    def count(ctx):
        kv = ctx.state().get_kv("lc", "counter", 8)
        for _ in range(COUNT_ITERS):
            kv.lock_global()
            try:
                kv.pull()
                value = int.from_bytes(kv.get_chunk(0, 8), "little")
                kv.set_chunk(0, (value + 1).to_bytes(8, "little"))
                kv.push_partial()
            finally:
                kv.unlock_global()
        return b"ok"

    @register_function("lc", "read")
    def read(ctx):
        kv = ctx.state().get_kv("lc", "counter", 8)
        kv.pull()
        return str(int.from_bytes(kv.get_chunk(0, 8), "little")).encode()

    @register_function("lc", "square")
    def square(ctx):
        x = int(ctx.message.input_data or b"0")
        return str(x * x).encode()

    out: dict = {}
    planner_off, *host_offs = (base + o for o in CLUSTER_OFFSETS)
    register_host_alias("lc-planner", "127.0.0.1", planner_off)
    for h, off in zip(CLUSTER_HOSTS, host_offs):
        register_host_alias(h, "127.0.0.1", off)
    get_planner().reset()
    server = PlannerServer(port_offset=planner_off)
    factory = TorchExecutorFactory(device="cpu")
    workers = [WorkerRuntime(host=h, slots=4, factory=factory,
                             planner_host="lc-planner")
               for h in CLUSTER_HOSTS]
    _release_held_ports()
    server.start()
    try:
        for w in workers:
            w.start()
        client = workers[0].planner_client

        def ok(results):
            return all(m.return_value == int(ReturnValue.SUCCESS)
                       for m in results)

        # MPI: rank 0 chains the other ranks through the planner
        req = batch_exec_factory("lc", "allreduce", 1)
        req.messages[0].mpi_world_size = MPI_SIZE
        client.call_functions(req)
        res = _wait_results(client, req.app_id, MPI_SIZE)
        out["mpi"] = {"ok": ok(res),
                      "values": sorted({m.output_data.decode()
                                        for m in res}),
                      "hosts": sorted({m.executed_host for m in res})}

        # State: two guests, one a host, under the global lock
        req = batch_exec_factory("lc", "count", 2)
        client.call_functions(req)
        res = _wait_results(client, req.app_id, 2)
        reader = batch_exec_factory("lc", "read", 1)
        client.call_functions(reader)
        (total,) = _wait_results(client, reader.app_id, 1)
        out["state"] = {"ok": ok(res) and ok([total]),
                        "hosts": sorted({m.executed_host for m in res}),
                        "total": int(total.output_data)}

        # Ingress: concurrent submissions share ticks, then one
        # SUBMIT_BATCH of three apps; each wave fits the 8 slots
        reqs = [batch_exec_factory("lc", "square", 2) for _ in range(6)]
        for r in reqs:
            for i, m in enumerate(r.messages):
                m.input_data = str(i + 2).encode()
        threads = [threading.Thread(target=client.call_functions, args=(r,))
                   for r in reqs[:3]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        outputs = [_wait_results(client, r.app_id, 2) for r in reqs[:3]]
        client.submit_functions_many(reqs[3:])
        outputs += [_wait_results(client, r.app_id, 2) for r in reqs[3:]]
        out["ingress"] = [(ok(res), [m.output_data.decode() for m in res])
                          for res in outputs]
    finally:
        for w in workers:
            w.shutdown()
        server.stop()
        get_planner().reset()
    rep = lockcheck.report()
    out["lockcheck"] = {
        "sites": rep["sites"], "edges": len(rep["edges"]),
        "cycles": lockcheck.exit_summary(rep)["cycles"],
        "format": lockcheck.format_report(rep)[-4000:]}
    return out


def test_port_cluster_under_the_detector_has_no_lock_order_cycle():
    """The port's planner, two runtimes, their MPI world, a state key's
    global lock and the ingress all run in one process under the
    detector: no held-before cycle among the port's lock sites (the
    reference's session gate, ``tests/conftest.py:131-147``)."""
    from tests.test_torch_mpi import _hold_ports
    from tests.test_torch_multiprocess import _service_ports, port_slot

    for _ in range(20):
        base = port_slot()
        held = _hold_ports((base + off + p for off in CLUSTER_OFFSETS
                            for p in _service_ports()), listen=True)
        if held:
            break
    else:
        raise AssertionError("no port slot with its hosts' ports free")
    fds = [s.fileno() for s in held]
    try:
        env = {**os.environ, "FAABRIC_LOCKCHECK": "1",
               "PYTHONPATH": os.pathsep.join(
                   filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])),
               "PROCS_HELD_FDS": ",".join(map(str, fds))}
        proc = subprocess.Popen(
            [sys.executable, __file__, "--cluster", str(base)], cwd=ROOT,
            env=env, pass_fds=fds, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    finally:
        # The child holds its own copies until its servers bind
        for s in held:
            s.close()
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert proc.returncode == 0, (stdout[-2000:], stderr[-4000:])
    res = json.loads(stdout.strip().splitlines()[-1])
    mpi, state = res["mpi"], res["state"]
    total = MPI_SIZE * (MPI_SIZE + 1) // 2
    assert mpi["ok"] and mpi["values"] == [str(total)], mpi
    assert mpi["hosts"] == sorted(CLUSTER_HOSTS), mpi
    assert state["ok"] and state["total"] == 2 * COUNT_ITERS, state
    assert len(res["ingress"]) == 6, res["ingress"]
    for ok, outputs in res["ingress"]:
        assert ok and outputs == ["4", "9"], res["ingress"]
    lc = res["lockcheck"]
    # The detector saw the port's locks, and no cycle among them
    assert lc["sites"] > 20 and lc["edges"] > 0, lc
    assert lc["cycles"] == [], lc["format"]
    assert _exit_summary(stderr)["cycles"] == []


if __name__ == "__main__":
    if "--cluster" in sys.argv:
        print(json.dumps(_cluster_case(
            int(sys.argv[sys.argv.index("--cluster") + 1]))), flush=True)
