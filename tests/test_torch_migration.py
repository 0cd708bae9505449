"""Live migration and spot freeze and thaw: the port against the JAX
package on the same programs.

Counterparts of ``tests/unit/test_endpoint_and_migration.py``'s live
migration (:137), no-op check (:189) and spot freeze and thaw (:392)
cases, each run on a planner and two worker runtimes of each package in
one process, with the reference test's guests and assertions: both runs
must report the same decisions' hosts, group-id changes, migration
count, frozen apps, slots and results. Then
``tests/unit/test_planner_concurrency.py``'s accounting property test
under spot (:35; mock mode, both packages, without the preloaded
decisions the port has not ported) and its failed thaw (:206); an
in-process port of ``tests/dist/procs.py``'s ``fn_mpi_migrate``
(:709-786), a 3-rank world over two runtimes that migrates at iteration
3, whose every all-to-all round must equal the reference world's; and
``chip_smoke.py``'s phase 24 (a) and (b) at a small width on the CPU.
"""

import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

REF, PORT = "faabric_tpu", "faabric_tpu_torch"
RESULT_TIMEOUT = 30.0


def pkg(name: str) -> types.SimpleNamespace:
    """One package's modules under the same names."""
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in {
        "executor": "executor", "executor_mod": "executor.executor",
        "planner": "planner", "runner": "runner", "proto": "proto",
        "common": "transport.common", "batch_scheduler": "batch_scheduler",
        "decision": "batch_scheduler.decision", "testing": "util.testing",
        "config": "util.config", "mpi": "mpi"}.items()}
    return types.SimpleNamespace(name=name, **mods)


REF_PK, PORT_PK = pkg(REF), pkg(PORT)


def free_base() -> int:
    from tests.conftest import next_port_base

    return next_port_base()


@pytest.fixture(autouse=True)
def _isolate():
    yield
    for pk in (REF_PK, PORT_PK):
        pk.testing.set_mock_mode(False)
        pk.common.clear_host_aliases()
        pk.planner.get_planner().reset()
        pk.executor.set_executor_factory(None)
        pk.batch_scheduler.reset_batch_scheduler()
        pk.config.get_system_config().reset()
    wait_for_recovery_threads()


def wait_for_recovery_threads(timeout: float = 10.0) -> None:
    """Recovery runs on daemon threads with backoff: let them end before
    the next case, so that none writes into its planner."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(t.name.startswith("planner/recover@")
                   for t in threading.enumerate()):
            return
        time.sleep(0.02)


class Cluster:
    """A planner and two worker runtimes of one package (4 slots, 4
    devices each) on aliased port ranges from ``base``: the reference
    test's cluster fixture."""

    def __init__(self, pk, base: int, factory) -> None:
        self.pk = pk
        pk.common.register_host_alias("planner", "127.0.0.1", base)
        pk.planner.get_planner().reset()
        self.planner_server = pk.planner.PlannerServer(port_offset=base)
        self.workers = {}
        try:
            self.planner_server.start()
            pk.executor.set_executor_factory(factory)
            for i, name in enumerate(("hostA", "hostB")):
                pk.common.register_host_alias(name, "127.0.0.1",
                                              base + 1000 * (i + 1))
                w = pk.runner.WorkerRuntime(host=name, slots=4, n_devices=4,
                                            planner_host="planner")
                self.workers[name] = w
                w.start()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        pk = self.pk
        try:
            for w in self.workers.values():
                w.shutdown()
        finally:
            self.planner_server.stop()
            pk.planner.get_planner().reset()
            pk.executor.set_executor_factory(None)
            pk.common.clear_host_aliases()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def factory_of(pk, executor_cls):
    class Factory(pk.executor.ExecutorFactory):
        def create_executor(self, msg):
            return executor_cls(msg)

    return Factory()


# ---------------------------------------------------------------------------
# The reference test's guests (tests/unit/test_endpoint_and_migration.py)
# ---------------------------------------------------------------------------

def gate_executor(pk):
    """echo completes at once; blocker holds its slot until released;
    gated waits for the gate, then reads the planner's decision: a moved
    placement raises the migration exception, an app gone from the
    in-flight set the frozen one (the reference's guests, §3.5)."""
    rv = pk.proto.ReturnValue

    class GateExecutor(pk.executor.Executor):
        gate = threading.Event()
        blocker_gate = threading.Event()
        runs: list = []
        _runs_lock = threading.Lock()

        def execute_task(self, pool_idx, msg_idx, req):
            msg = req.messages[msg_idx]
            cls = type(self)
            if msg.function == "echo":
                msg.output_data = msg.input_data[::-1]
                return int(rv.SUCCESS)
            if msg.function == "blocker":
                assert cls.blocker_gate.wait(20.0)
                return int(rv.SUCCESS)
            my_host = self.scheduler.host
            if req.type == int(pk.proto.BatchExecuteType.MIGRATION):
                self.scheduler.ptp_broker.post_migration_hook(
                    msg.group_id, msg.group_idx)
                with cls._runs_lock:
                    cls.runs.append(("migrated-run", msg.app_idx, my_host))
                msg.output_data = f"migrated:{my_host}".encode()
                return int(rv.SUCCESS)
            with cls._runs_lock:
                cls.runs.append(("first-run", msg.app_idx, my_host))
            assert cls.gate.wait(20.0)
            decision = self.scheduler.planner_client.get_scheduling_decision(
                msg.app_id)
            if decision is None:
                with cls._runs_lock:
                    cls.runs.append(("frozen", msg.app_idx, my_host))
                raise pk.executor_mod.FunctionFrozenException()
            if msg.app_idx in decision.app_idxs:
                i = decision.app_idxs.index(msg.app_idx)
                if decision.hosts[i] != my_host:
                    raise pk.executor_mod.FunctionMigratedException()
                if decision.group_id != msg.group_id:
                    self.scheduler.ptp_broker.post_migration_hook(
                        decision.group_id, decision.group_idxs[i])
            msg.output_data = f"stayed:{my_host}".encode()
            return int(rv.SUCCESS)

    return GateExecutor


def results_of(worker, app_id, msg_ids, timeout=RESULT_TIMEOUT):
    return [worker.planner_client.get_message_result(app_id, mid,
                                                     timeout=timeout)
            for mid in msg_ids]


def batch_results(worker, app_id, n, timeout=RESULT_TIMEOUT):
    """Poll the batch's results until all ``n`` are in. Unlike
    ``get_message_result`` this registers no waiter, which the reference
    planner would hand a MIGRATED or FROZEN report that lands after it
    (the port keeps a waiter for the real result)."""
    deadline = time.monotonic() + timeout
    while True:
        status = worker.planner_client.get_batch_results(app_id)
        if status.finished and len(status.message_results) == n:
            return status.message_results
        assert time.monotonic() < deadline, f"{app_id}: results missing"
        time.sleep(0.02)


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def live_migration_flow(pk) -> dict:
    """``test_live_migration_improves_locality`` on one package."""
    ex = gate_executor(pk)
    with Cluster(pk, free_base(), factory_of(pk, ex)) as c:
        w = c.workers["hostA"]
        planner = pk.planner.get_planner()
        factory = pk.proto.batch_exec_factory
        blocker1 = factory("demo", "blocker", 2)
        d_b1 = w.planner_client.call_functions(blocker1)
        blocker2 = factory("demo", "blocker", 3)
        d_b2 = w.planner_client.call_functions(blocker2)
        gated = factory("demo", "gated", 3)
        d1 = w.planner_client.call_functions(gated)
        assert len(set(d1.hosts)) == 2, d1.hosts
        assert wait_until(lambda: sum(
            1 for r in ex.runs if r[0] == "first-run") >= 3)
        ex.blocker_gate.set()
        for req in (blocker1, blocker2):
            results_of(w, req.app_id, [m.id for m in req.messages])
        decision = planner.check_migration(gated.app_id)
        assert decision is not None
        assert len(set(decision.hosts)) == 1
        migrations = planner.get_num_migrations()
        ex.gate.set()
        results = batch_results(w, gated.app_id, 3)
        assert all(r.return_value == int(pk.proto.ReturnValue.SUCCESS)
                   for r in results), [r.output_data for r in results]
        final_hosts = {r.output_data.decode().split(":")[1] for r in results}
        assert final_hosts == set(decision.hosts)
        again = planner.check_migration(gated.app_id)
        assert again is None
    return {"blockers": [sorted(d_b1.hosts), sorted(d_b2.hosts)],
            "first_hosts": sorted(d1.hosts),
            "new_hosts": sorted(decision.hosts),
            "group_changed": decision.group_id != d1.group_id,
            "migrations": migrations,
            "results": sorted((r.return_value, r.output_data)
                              for r in results),
            "runs": sorted(ex.runs), "second_check": again}


def no_op_flow(pk) -> dict:
    """``test_check_migration_no_op_when_placement_optimal``."""
    ex = gate_executor(pk)
    with Cluster(pk, free_base(), factory_of(pk, ex)) as c:
        w = c.workers["hostA"]
        req = pk.proto.batch_exec_factory("demo", "echo", 2)
        input_data = [b"ab", b"cd"]
        for m, data in zip(req.messages, input_data):
            m.input_data = data
        d = w.planner_client.call_functions(req)
        check = pk.planner.get_planner().check_migration(req.app_id)
        results = results_of(w, req.app_id, [m.id for m in req.messages])
        migrations = pk.planner.get_planner().get_num_migrations()
    assert check is None
    return {"hosts": sorted(d.hosts), "check": check,
            "migrations": migrations,
            "results": sorted((r.return_value, r.output_data)
                              for r in results)}


def spot_flow(pk) -> dict:
    """``test_spot_freeze_and_thaw``."""
    ex = gate_executor(pk)
    with Cluster(pk, free_base(), factory_of(pk, ex)) as c:
        w = c.workers["hostA"]
        planner = pk.planner.get_planner()
        pk.batch_scheduler.reset_batch_scheduler("spot")
        gated = pk.proto.batch_exec_factory("demo", "gated", 8)
        d = w.planner_client.call_functions(gated)
        assert len(set(d.hosts)) == 2
        planner.set_next_evicted_host_ips(["hostB"])
        decision = planner.check_migration(gated.app_id)
        assert decision is not None
        assert decision.app_id == pk.decision.MUST_FREEZE
        frozen = planner.get_frozen_apps()
        assert gated.app_id in frozen
        used = sorted((h.ip, h.used_slots)
                      for h in planner.get_available_hosts())
        assert all(n == 0 for _, n in used)
        ex.gate.set()
        assert wait_until(lambda: sum(
            1 for r in ex.runs if r[0] == "frozen") >= 8)
        n_frozen = sum(1 for r in ex.runs if r[0] == "frozen")
        planner.set_next_evicted_host_ips([])
        thaw = pk.proto.batch_exec_factory("demo", "gated", 1)
        thaw.app_id = gated.app_id
        d2 = w.planner_client.call_functions(thaw)
        assert d2.n_messages == 8
        after = planner.get_frozen_apps()
        results = batch_results(w, gated.app_id, 8)
        assert all(r.return_value == int(pk.proto.ReturnValue.SUCCESS)
                   for r in results)
    return {"hosts": sorted(d.hosts), "freeze": decision.app_id,
            "frozen": [a == gated.app_id for a in frozen], "used": used,
            "n_frozen": n_frozen, "thaw_n": d2.n_messages,
            "thaw_ids": sorted(d2.message_ids) == sorted(
                m.id for m in gated.messages),
            "after": after, "thaw_hosts": sorted(d2.hosts),
            "results": sorted((r.return_value, r.output_data)
                              for r in results)}


@pytest.mark.parametrize("flow", [live_migration_flow, no_op_flow, spot_flow],
                         ids=["live_migration", "no_op_check",
                              "spot_freeze_and_thaw"])
def test_migration_flows_match_reference(flow):
    ref = flow(REF_PK)
    port = flow(PORT_PK)
    assert port == ref


# ---------------------------------------------------------------------------
# tests/unit/test_planner_concurrency.py, both packages in mock mode
# ---------------------------------------------------------------------------

HOSTS = [("p1", 6, 4), ("p2", 8, 8), ("p3", 4, 2), ("p4", 10, 4)]


def _finish(pk, planner, messages):
    for m in messages:
        m.return_value = int(pk.proto.ReturnValue.SUCCESS)
        planner.set_message_result(m)


def accounting_flow(pk) -> dict:
    """``test_planner_accounting_full_lifecycle_concurrent`` under spot:
    8 threads drive random app lifecycles (NEW, scale changes, migration
    checks, evictions that freeze and thaws, THREADS shapes through the
    decision cache, host churn) while an observer holds the capacity
    invariant; afterwards every slot, port and device is back. The
    reference's preloaded decisions are not in the port, so scenario 4
    runs as a plain NEW batch on both."""
    dec = pk.decision
    factory = pk.proto.batch_exec_factory
    planner = pk.planner.get_planner()
    planner.reset()
    pk.config.get_system_config().planner_requeue_backoff = 0.01
    pk.batch_scheduler.reset_batch_scheduler("spot")
    pk.testing.set_mock_mode(True)
    try:
        for ip, slots, devs in HOSTS:
            planner.register_host(ip, slots, devs)
        capacity = {ip: slots for ip, slots, _ in HOSTS}
        errors: list = []
        stop_observer = threading.Event()

        def observer():
            while not stop_observer.is_set():
                try:
                    for h in planner.get_available_hosts():
                        assert 0 <= h.used_slots <= capacity[h.ip], (
                            f"{h.ip}: used {h.used_slots}/{capacity[h.ip]}")
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return
                time.sleep(0.001)

        def self_thaw(app_id):
            thaw = factory("prop", "thaw", 1)
            thaw.app_id = app_id
            deadline = time.time() + 20
            while time.time() < deadline:
                d = planner.call_batch(thaw)
                if d.app_id not in (dec.NOT_ENOUGH_SLOTS, dec.DO_NOT_MIGRATE):
                    return
                time.sleep(0.01)
            raise TimeoutError(f"could not thaw app {app_id}")

        def lifecycle(seed):
            rng = np.random.RandomState(seed)
            try:
                for it in range(25):
                    scenario = rng.randint(0, 7)
                    req = factory("prop", f"fn{seed}", int(rng.randint(1, 5)))
                    if scenario == 4:
                        rng.randint(len(HOSTS))  # the preload's host draw
                    if scenario == 5:
                        req.type = int(pk.proto.BatchExecuteType.THREADS)
                    decision = planner.call_batch(req)
                    if decision.app_id == dec.NOT_ENOUGH_SLOTS:
                        continue
                    messages = list(req.messages)
                    if scenario == 6 and it % 5 == 0:
                        tmp = f"tmp{seed}"
                        capacity[tmp] = 4
                        planner.register_host(tmp, 4, 2)
                        chaos = factory("prop", f"chaos{seed}",
                                        int(rng.randint(1, 4)))
                        d2 = planner.call_batch(chaos)
                        with planner._lock:
                            h = planner._hosts.get(tmp)
                            if h is not None:
                                h.register_ts -= 10_000
                        planner.expire_hosts()
                        if d2.app_id != dec.NOT_ENOUGH_SLOTS:
                            _finish(pk, planner, list(chaos.messages))
                    if scenario == 1:
                        grow = factory("prop", f"fn{seed}",
                                       int(rng.randint(1, 4)))
                        grow.app_id = req.app_id
                        d2 = planner.call_batch(grow)
                        if d2.app_id != dec.NOT_ENOUGH_SLOTS:
                            messages += list(grow.messages)
                    elif scenario == 2:
                        d2 = planner.check_migration(req.app_id)
                        if d2 is not None and d2.app_id == dec.MUST_FREEZE:
                            self_thaw(req.app_id)
                    elif scenario == 3 and it % 5 == 0:
                        victim = HOSTS[rng.randint(len(HOSTS))][0]
                        planner.set_next_evicted_host_ips([victim])
                        d2 = planner.check_migration(req.app_id)
                        planner.set_next_evicted_host_ips([])
                        if d2 is not None and d2.app_id == dec.MUST_FREEZE:
                            self_thaw(req.app_id)
                    time.sleep(rng.rand() * 0.001)
                    _finish(pk, planner, messages)
                    if scenario == 2:
                        stale = factory("prop", f"fn{seed}", 1)
                        stale.app_id = req.app_id
                        stale.type = int(pk.proto.BatchExecuteType.MIGRATION)
                        d3 = planner.call_batch(stale)
                        assert d3.app_id in (dec.DO_NOT_MIGRATE,
                                             dec.NOT_ENOUGH_SLOTS), d3.app_id
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        obs = threading.Thread(target=observer)
        obs.start()
        threads = [threading.Thread(target=lifecycle, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop_observer.set()
        obs.join(timeout=5)
        hung = any(t.is_alive() for t in threads)
        wait_for_recovery_threads()
        with planner._lock:
            in_flight = len(planner._in_flight)
            ports = sorted(ip for ip, h in planner._hosts.items()
                           if h.used_mpi_ports)
            devices = sorted(ip for ip, h in planner._hosts.items()
                             if any(h.device_load))
        return {"hung": hung, "errors": [repr(e) for e in errors[:3]],
                "used": sorted((h.ip, h.used_slots)
                               for h in planner.get_available_hosts()
                               if h.ip in dict((x, 0) for x, _, _ in HOSTS)),
                "frozen": planner.get_frozen_apps(), "in_flight": in_flight,
                "ports": ports, "devices": devices}
    finally:
        pk.testing.set_mock_mode(False)
        pk.batch_scheduler.reset_batch_scheduler("bin-pack")
        planner.reset()


def test_planner_accounting_under_spot_matches_reference():
    """Under a shortened switch interval, so that the threads interleave
    inside the planner's compound updates."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ref = accounting_flow(REF_PK)
        port = accounting_flow(PORT_PK)
    finally:
        sys.setswitchinterval(interval)
    assert ref["used"] == [(ip, 0) for ip in sorted(x for x, _, _ in HOSTS)]
    assert port == ref
    assert not port["hung"] and not port["errors"]
    assert port["frozen"] == [] and port["in_flight"] == 0


def failed_thaw_flow(pk) -> dict:
    """``test_failed_thaw_reparks_frozen_app``."""
    dec = pk.decision
    factory = pk.proto.batch_exec_factory
    planner = pk.planner.get_planner()
    planner.reset()
    pk.batch_scheduler.reset_batch_scheduler("spot")
    pk.testing.set_mock_mode(True)
    out = {}
    try:
        planner.register_host("t1", 2, 2)
        planner.register_host("t2", 2, 2)
        app = factory("prop", "victim", 4)
        d = planner.call_batch(app)
        out["placed"] = sorted(d.hosts)
        planner.set_next_evicted_host_ips(["t1", "t2"])
        d2 = planner.check_migration(app.app_id)
        out["freeze"] = d2.app_id
        out["frozen1"] = app.app_id in planner.get_frozen_apps()
        planner.set_next_evicted_host_ips([])
        blocker = factory("prop", "blocker", 4)
        out["blocker"] = planner.call_batch(blocker).app_id != \
            dec.NOT_ENOUGH_SLOTS
        thaw = factory("prop", "thaw", 1)
        thaw.app_id = app.app_id
        out["thaw1"] = planner.call_batch(thaw).app_id
        out["frozen2"] = app.app_id in planner.get_frozen_apps()
        _finish(pk, planner, list(blocker.messages))
        thaw2 = factory("prop", "thaw", 1)
        thaw2.app_id = app.app_id
        d3 = planner.call_batch(thaw2)
        out["thaw2_ok"] = d3.app_id not in (dec.NOT_ENOUGH_SLOTS,
                                            dec.MUST_FREEZE)
        out["thaw2_n"] = d3.n_messages
        out["thaw2_hosts"] = sorted(d3.hosts)
        out["frozen3"] = app.app_id in planner.get_frozen_apps()
        _finish(pk, planner, list(app.messages))
        out["used"] = sorted((h.ip, h.used_slots)
                             for h in planner.get_available_hosts())
    finally:
        pk.testing.set_mock_mode(False)
        pk.batch_scheduler.reset_batch_scheduler("bin-pack")
        planner.reset()
    return out


def test_failed_thaw_reparks_frozen_app_matches_reference():
    ref = failed_thaw_flow(REF_PK)
    port = failed_thaw_flow(PORT_PK)
    assert ref["freeze"] == REF_PK.decision.MUST_FREEZE
    assert ref["thaw1"] == REF_PK.decision.NOT_ENOUGH_SLOTS
    assert ref["frozen2"] and ref["thaw2_n"] == 4 and not ref["frozen3"]
    assert port == ref


# ---------------------------------------------------------------------------
# fn_mpi_migrate (tests/dist/procs.py:709-786) over two in-process runtimes
# ---------------------------------------------------------------------------

LOOPS, CHECK = 8, 3


def mpi_migrate_executor(pk):
    """A 3-rank world loops barrier + all-to-all; at iteration ``CHECK``
    rank 0 asks the planner for a migration (once the test says the
    blockers' results are in), the ranks read the new decision, prepare
    the world and the moved ones vacate; re-entered as a MIGRATION
    batch they join the stayed ranks' post-migration barrier, and the
    world finishes its loops. Each rank's all-to-all rounds are kept.
    Two changes to the reference's guest, for ranks that share a host's
    world object: the old group id is read before the barrier, and a
    barrier precedes ``prepare_migration``."""
    rv = pk.proto.ReturnValue

    class MigrateExecutor(pk.executor.Executor):
        blocker_gate = threading.Event()
        at_check = threading.Event()
        blockers_done = threading.Event()
        rounds: dict = {}

        def execute_task(self, pool_idx, msg_idx, req):
            msg = req.messages[msg_idx]
            cls = type(self)
            if msg.function == "block":
                assert cls.blocker_gate.wait(60.0)
                return int(rv.SUCCESS)
            ctx = pk.mpi.get_mpi_context()
            if msg.mpi_rank == 0 and not msg.is_mpi:
                msg.is_mpi = True
                msg.mpi_world_id = msg.app_id % 1_000_000
                msg.mpi_world_size = 3
                world = ctx.create_world(msg)
            else:
                world = ctx.join_world(msg)
            rank = msg.mpi_rank
            world.refresh_rank_hosts()
            my_host = self.scheduler.host
            pc = self.scheduler.planner_client
            migrated_entry = req.type == int(
                pk.proto.BatchExecuteType.MIGRATION)
            start = CHECK + 1 if migrated_entry else 0
            if migrated_entry:
                self.scheduler.ptp_broker.post_migration_hook(
                    msg.group_id, msg.group_idx)
                world.refresh_rank_hosts()
            for i in range(start, LOOPS):
                world.barrier(rank)
                size = world.size
                rows = np.array([rank * 1000 + r * 10 + i
                                 for r in range(size)], np.int64)
                out = np.asarray(world.alltoall(rank, rows)).reshape(size)
                cls.rounds[(rank, i)] = out.tolist()
                if i != CHECK or migrated_entry:
                    continue
                old_gid = world.group_id
                world.barrier(rank)
                if rank == 0:
                    cls.at_check.set()
                    assert cls.blockers_done.wait(60.0)
                    dec = pc.check_migration(msg.app_id)
                    flag = np.array([1 if dec is not None else 0], np.int64)
                    world.broadcast(0, 0, flag)
                else:
                    flag = world.broadcast(0, rank, np.zeros(1, np.int64))
                if int(np.asarray(flag)[0]) == 0:
                    msg.output_data = f"r{rank}:no-migration".encode()
                    return int(rv.FAILED)
                dec = pc.get_scheduling_decision(msg.app_id)
                deadline = time.time() + 10
                while (dec is None or dec.group_id == old_gid) \
                        and time.time() < deadline:
                    time.sleep(0.05)
                    dec = pc.get_scheduling_decision(msg.app_id)
                idx = dec.app_idxs.index(msg.app_idx)
                world.barrier(rank)
                world.prepare_migration(rank, dec.group_id)
                if dec.hosts[idx] != my_host:
                    raise pk.executor_mod.FunctionMigratedException()
                self.scheduler.ptp_broker.post_migration_hook(
                    dec.group_id, dec.group_idxs[idx])
                world.refresh_rank_hosts()
            world.barrier(rank)
            msg.output_data = f"r{rank}:migrate-ok:{my_host}".encode()
            return int(rv.SUCCESS)

    return MigrateExecutor


def mpi_migrate_flow(pk) -> dict:
    ex = mpi_migrate_executor(pk)
    with Cluster(pk, free_base(), factory_of(pk, ex)) as c:
        me = c.workers["hostA"].planner_client
        factory = pk.proto.batch_exec_factory
        blockers, blocker_hosts = [], []
        for count in (2, 3):
            b = factory("dist", "block", count)
            blocker_hosts.append(sorted(me.call_functions(b).hosts))
            blockers.append(b)
        req = factory("dist", "mpi_migrate", 1)
        req.messages[0].mpi_rank = 0
        me.call_functions(req)
        assert ex.at_check.wait(60.0)
        ex.blocker_gate.set()
        for b in blockers:
            results_of(c.workers["hostA"], b.app_id,
                       [m.id for m in b.messages])
        ex.blockers_done.set()
        deadline = time.monotonic() + 60
        while True:
            status = me.get_batch_results(req.app_id)
            if status.finished and len(status.message_results) == 3:
                break
            assert time.monotonic() < deadline, "the world never finished"
            time.sleep(0.05)
        migrations = me.get_num_migrations()
    results = sorted((m.mpi_rank, m.return_value, m.output_data)
                     for m in status.message_results)
    assert all(rv == int(pk.proto.ReturnValue.SUCCESS)
               for _, rv, _ in results), results
    assert len({out.decode().rsplit(":", 1)[1]
                for _, _, out in results}) == 1
    return {"blockers": blocker_hosts, "results": results,
            "migrations": migrations, "rounds": dict(sorted(
                ex.rounds.items()))}


def test_mpi_migrate_world_matches_reference():
    """A 3-rank world spread 2 + 1 by the blockers consolidates at
    iteration 3: one migration, every rank SUCCESS on one host, and every
    rank's eight all-to-all rounds equal to the reference world's."""
    ref = mpi_migrate_flow(REF_PK)
    port = mpi_migrate_flow(PORT_PK)
    assert ref["migrations"] == 1
    assert len(ref["rounds"]) == 3 * LOOPS
    assert port == ref


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 24 (a) and (b) at a small width on the CPU
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=1, d_ff=256,
             max_seq=64, attention_impl="reference", norm_impl="reference")


def test_chip_smoke_migration_phase_gang_and_spot_small():
    """Phase 24 (a) at 2 layers and d_model 64 in fp32: a 4-rank gang
    spread 2 + 2 migrates after step 2 of 6; its final parameters are
    bitwise equal on every rank and within 1e-6 relative L2 of an
    unmigrated run's. Not bitwise: before the migration the 2-host
    world's tree sums the gradients as (r0 + r1) + (r2 + r3), the
    device plane of the unmigrated one-host world as ((r0 + r1) + r2) +
    r3 (this run's distance: 4.2e-8). In bf16 compute such one-ulp sums
    can grow through a small model's later steps to 4e-4, so the case
    runs in fp32. (b): a spot-frozen guest's image thaws on the other
    host and its logits are bitwise unchanged."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.ops import _build
    from tests.conftest import next_port_base

    cfg = ModelConfig(**SMALL, compute_dtype=torch.float32)
    launches = chip_smoke.migration_phase(
        torch.device("cpu"), _build, cfg=cfg, seq=32, prompt_len=64,
        serve_len=16, n_new=4, base=next_port_base(), parts="ab", tol=1e-6)
    assert launches == {}  # the plain versions run on the CPU


@pytest.mark.parametrize("pk", [REF_PK, PORT_PK], ids=["reference", "port"])
def test_update_host_for_idx_remaps_one_rank(pk):
    """A post-migration remap moves one rank's mapping and no other."""
    ptp = importlib.import_module(f"{pk.name}.transport.point_to_point")
    broker = ptp.PointToPointBroker("hA")
    decision = pk.decision.SchedulingDecision(1, 55)
    for idx, host in enumerate(("hA", "hB", "hB")):
        decision.add_message(host, 100 + idx, idx, idx)
    broker.set_up_local_mappings_from_decision(decision)
    broker.update_host_for_idx(55, 2, "hA")
    assert [broker.get_host_for_receiver(55, i) for i in range(3)] == [
        "hA", "hB", "hA"]
    assert broker.get_idxs_registered_for_host(55, "hA") == {0, 2}
