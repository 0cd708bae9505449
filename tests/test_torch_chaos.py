"""The reference's chaos cases on the port: worker and planner processes
SIGKILLed mid-batch.

Counterpart of ``tests/dist/test_chaos.py``: with a worker killed
mid-batch the planner requeues the dead host's messages onto the
survivor and the batch completes within the retry budget; a collective
on the broken MPI world raises MpiWorldAborted in bounded time; the
survivors leave flight dumps; an expired but live worker rejoins; a
SIGKILLed planner restarts from its journal and the batch completes.
Then the planned disruptions of ``tests/dist/test_lifecycle.py`` (``:41``,
``:109``, ``:248``): an MPI world migrated under traffic, read back
through the planner's ``/commmatrix``, a spot freeze whose thaw restores
the parked image on the other worker, the eviction sent through the
REST endpoint, and a directed partition of one worker pair by fault
rules, which every rank survives with a bounded abort.

Every case stands up its own cluster of ``tests/test_torch_procs.py``
processes on a port slot of ``tests/conftest.py`` (the kill leaves no
reusable fixture behind). The kill cases are chaos and slow, as the
reference's; tier-1 runs the worker kill of
``tests/test_torch_multiprocess.py``.

The ingress's cases: ``:479``, a worker SIGKILLed while 600 one-message
apps stream in through ``submit_functions_many`` (every app ends with
exactly one SUCCESS, the journal's group commits intact, the requeue in
the flight dumps), and ``tests/dist/test_lifecycle.py:202``, two elastic
fork waves that grow onto the main host's free slots. Then the state
plane's failover cases of ``tests/dist/test_state_failover.py`` (``:81``
a SIGKILLed master loses no acknowledged write, ``:190`` a revived
stale master cannot ack), with each key's master pinned by a preloaded
decision. The reference runs those on three workers; a port slot holds
two (``ProcCluster``), so the keys' backups are the other worker.
"""

import signal
import threading
import time

import pytest

from faabric_tpu_torch.batch_scheduler import SchedulingDecision
from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
from tests.test_torch_multiprocess import ProcCluster

pytestmark = pytest.mark.chaos


class ChaosCluster(ProcCluster):
    """A planner and two workers as OS processes on a private port range,
    named after ``tag``; the test process joins as a 0-slot client
    host."""

    def __init__(self, tag: str, slots=(4, 4), extra_env: dict | None = None,
                 worker_env: dict | None = None, http: bool = False):
        super().__init__(tag, {f"{tag}w{i}": s for i, s in enumerate(slots)},
                         extra_env=extra_env, worker_env=worker_env,
                         http=http)


def wait_finished(me, app_id, timeout):
    deadline = time.time() + timeout
    status = me.planner_client.get_batch_results(app_id)
    while not status.finished and time.time() < deadline:
        time.sleep(0.2)
        status = me.planner_client.get_batch_results(app_id)
    assert status.finished, (
        f"batch {app_id} never finished: "
        f"{len(status.message_results)}/{status.expected_num_messages}")
    return status


def wait_world_spread(me, app_id):
    """The decision of an 8-rank world once every rank is placed over
    both workers."""
    deadline = time.time() + 30
    live = None
    while time.time() < deadline:
        live = me.planner_client.get_scheduling_decision(app_id)
        if live is not None and live.n_messages == 8 \
                and len(set(live.hosts)) == 2:
            break
        time.sleep(0.2)
    assert live is not None and live.n_messages == 8, live
    return live


@pytest.mark.slow
def test_chaos_kill_worker_mid_batch_requeues_and_completes():
    """SIGKILL a worker holding live messages mid-batch: the planner's
    expiry → requeue-with-backoff recovery moves them to the survivor
    and the batch completes fully SUCCESS within the retry budget."""
    cluster = ChaosCluster(
        "ckA", slots=(8, 4),
        extra_env={"PLANNER_HOST_TIMEOUT": "3",
                   "PLANNER_REQUEUE_BACKOFF": "0.3",
                   "PLANNER_MAX_REQUEUES": "5"}).start()
    try:
        me = cluster.me
        wa, wb = cluster.workers
        # 12 × 2.5 s sleeps over 8 + 4 slots: 8 land on the big worker,
        # 4 on the one about to be killed
        req = batch_exec_factory("dist", "sleep", 12)
        for m in req.messages:
            m.input_data = b"2.5"
        decision = me.planner_client.call_functions(req)
        placed = {}
        for h in decision.hosts:
            placed[h] = placed.get(h, 0) + 1
        assert placed.get(wb), f"nothing placed on {wb}: {placed}"

        time.sleep(0.5)  # the batch is genuinely mid-flight
        t_kill = cluster.kill(wb)

        status = wait_finished(me, req.app_id, timeout=60)
        recovery_s = time.monotonic() - t_kill
        assert status.expected_num_messages == 12
        assert len(status.message_results) == 12
        bad = [(m.id, m.return_value, m.output_data)
               for m in status.message_results
               if m.return_value != int(ReturnValue.SUCCESS)]
        assert not bad, f"requeued batch had failures: {bad}"
        # The killed worker's messages re-ran on the survivor
        by_host = {m.executed_host for m in status.message_results}
        assert by_host == {wa}, by_host
        # Recovery: inside expiry (3 s) + the backoff budget, nowhere
        # near the 60 s socket timeout
        assert recovery_s < 45, f"recovery took {recovery_s:.1f}s"
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_requeued_invocations_carry_spanning_ledger():
    """SIGKILL a worker mid-batch: the requeued invocations' lifecycle
    ledgers span both attempts (admit on the original submission, a
    ``requeue`` stamp at the recovery boundary, the second attempt's run
    and result stamps after it)."""
    from faabric_tpu_torch.telemetry.lifecycle import (
        PHASE_ADMIT,
        PHASE_RECORDED,
        PHASE_REQUEUE,
        PHASE_RUN_START,
        ledger_durations,
    )

    cluster = ChaosCluster(
        "ckL", slots=(8, 4),
        extra_env={"PLANNER_HOST_TIMEOUT": "3",
                   "PLANNER_REQUEUE_BACKOFF": "0.3",
                   "PLANNER_MAX_REQUEUES": "5"}).start()
    try:
        me = cluster.me
        wa, wb = cluster.workers
        req = batch_exec_factory("dist", "sleep", 12)
        for m in req.messages:
            m.input_data = b"2.5"
        decision = me.planner_client.call_functions(req)
        victims = {decision.message_ids[i]
                   for i, h in enumerate(decision.hosts) if h == wb}
        assert victims, f"nothing placed on {wb}"

        time.sleep(0.5)  # genuinely mid-flight
        cluster.kill(wb)

        status = wait_finished(me, req.app_id, timeout=60)
        assert len(status.message_results) == 12
        requeued = [m for m in status.message_results if m.id in victims]
        assert requeued
        for m in status.message_results:
            assert m.return_value == int(ReturnValue.SUCCESS), \
                m.output_data
            assert PHASE_ADMIT in m.lc and PHASE_RECORDED in m.lc, \
                sorted(m.lc)
        for m in requeued:
            lc = m.lc
            # The requeue boundary is visible and ordered
            assert PHASE_REQUEUE in lc, sorted(lc)
            assert lc[PHASE_ADMIT] < lc[PHASE_REQUEUE], lc
            assert lc[PHASE_REQUEUE] < lc[PHASE_RUN_START], lc
            assert lc[PHASE_RUN_START] < lc[PHASE_RECORDED], lc
            d = ledger_durations(lc)
            # Detection (3 s expiry) + backoff dominates the requeue phase
            assert d["requeue"] > 0.5, d
            assert m.executed_host == wa
        # The survivors' ledgers carry no requeue boundary
        untouched = [m for m in status.message_results
                     if m.id not in victims]
        assert untouched
        assert all(PHASE_REQUEUE not in m.lc for m in untouched)
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_mpi_world_abort_is_bounded():
    """SIGKILL a worker hosting half an MPI world mid-collective: the
    surviving ranks raise MpiWorldAborted within the liveness-check
    bound instead of hanging to the 60 s socket timeout; the dead ranks'
    messages are failed by expiry (MPI is never requeued), so the batch
    still completes."""
    cluster = ChaosCluster(
        "ckB", extra_env={"PLANNER_HOST_TIMEOUT": "3",
                          "MPI_ABORT_CHECK_SECONDS": "1"}).start()
    try:
        me = cluster.me
        req = batch_exec_factory("dist", "mpi_abort", 1)
        req.messages[0].mpi_rank = 0
        me.planner_client.call_functions(req)
        live = wait_world_spread(me, req.app_id)
        # Kill the worker not hosting rank 0, so that the root rank's
        # result reports the abort
        rank0_host = live.hosts[live.group_idxs.index(0)]
        victim = next(w for w in cluster.workers if w != rank0_host)
        time.sleep(1.0)  # let the collective loop get going
        cluster.kill(victim)

        status = wait_finished(me, req.app_id, timeout=90)
        aborted, dead = [], []
        for m in status.message_results:
            if m.return_value == int(ReturnValue.SUCCESS):
                assert m.output_data.startswith(b"aborted:"), m.output_data
                aborted.append(float(m.output_data.split(b":")[1]))
            else:
                dead.append(m)
        # Every survivor rank aborted, in bounded time
        assert len(aborted) == 4, (aborted, dead)
        assert max(aborted) < 15.0, f"abort took {max(aborted):.1f}s"
        # The killed ranks were failed (MPI is terminal)
        assert len(dead) == 4
        assert all(b"expired" in m.output_data or b"failed" in
                   m.output_data.lower() for m in dead), dead
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_sigkill_leaves_flight_recorder_dumps(tmp_path):
    """SIGKILL a worker hosting half an MPI world: every surviving
    process leaves a flight dump in FAABRIC_FLIGHT_DIR (the surviving
    worker on the MpiWorldAborted transition, the planner on its
    recovery pass), and the merged ring holds the injected fault
    firings and the group-abort transition, read back through the
    port's ``runner/flightdump.py``."""
    from faabric_tpu_torch.runner import flightdump

    flight_dir = str(tmp_path / "flight")
    cluster = ChaosCluster(
        "ckF", extra_env={"PLANNER_HOST_TIMEOUT": "3",
                          "MPI_ABORT_CHECK_SECONDS": "1",
                          "FAABRIC_FLIGHT_DIR": flight_dir},
        # Harmless injected delays on the collective path: chaos runs
        # must be distinguishable from real faults in the black box
        worker_env={"FAABRIC_FAULTS": "mpi.collective=delay:1ms@times=3"},
    ).start()
    try:
        me = cluster.me
        req = batch_exec_factory("dist", "mpi_abort", 1)
        req.messages[0].mpi_rank = 0
        me.planner_client.call_functions(req)
        live = wait_world_spread(me, req.app_id)
        rank0_host = live.hosts[live.group_idxs.index(0)]
        victim = next(w for w in cluster.workers if w != rank0_host)
        survivor = next(w for w in cluster.workers if w != victim)
        time.sleep(1.0)  # collective rounds (and fault firings) underway
        cluster.kill(victim)

        wait_finished(me, req.app_id, timeout=90)

        # Give the planner's recovery thread a beat to write its dump
        deadline = time.time() + 15
        dumps = []
        while time.time() < deadline:
            dumps = flightdump.load_dumps(flight_dir)
            if len({d["process"] for d in dumps}) >= 2:
                break
            time.sleep(0.5)

        processes = {d["process"] for d in dumps}
        # Every surviving stateful host dumped
        assert any(survivor in p for p in processes), (processes, dumps)
        assert any(p == "planner" for p in processes), processes

        merged = flightdump.merge(flight_dir)
        assert merged, "merged flight ring is empty"
        kinds = {e["kind"] for e in merged}
        assert "fault_fired" in kinds, kinds
        assert "group_abort" in kinds, kinds
        fault = next(e for e in merged if e["kind"] == "fault_fired")
        assert fault["point"] == "mpi.collective"
        assert fault["action"] == "delay"
        abort = next(e for e in merged if e["kind"] == "group_abort")
        assert "reason" in abort and abort["group"]
        text = flightdump.render(merged, last=20)
        assert "group_abort" in text
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_suppressed_keepalives_expire_then_rejoin():
    """FAABRIC_FAULTS=keepalive=suppress@times=N on a worker: the planner
    expires the live worker; when its keep-alives resume, the 'known:
    False' response triggers an overwrite re-register and the worker
    rejoins the pool, with no restart."""
    cluster = ChaosCluster(
        "ckC", extra_env={"PLANNER_HOST_TIMEOUT": "2"},
        worker_env={"FAABRIC_FAULTS": "keepalive=suppress@times=4@host=ckCw1"},
    ).start()
    try:
        me = cluster.me
        w0, w1 = cluster.workers

        def hosts():
            return {h["ip"] for h in me.planner_client.get_available_hosts()}

        # w1's first ~4 keep-alives are suppressed: it drops off...
        deadline = time.time() + 20
        gone = False
        while time.time() < deadline:
            if w1 not in hosts():
                gone = True
                break
            time.sleep(0.25)
        assert gone, f"{w1} never expired: {hosts()}"
        assert w0 in hosts()

        # ...and once the suppression budget is spent, rejoins on its own
        deadline = time.time() + 20
        back = False
        while time.time() < deadline:
            if w1 in hosts():
                back = True
                break
            time.sleep(0.25)
        assert back, f"{w1} never rejoined: {hosts()}"

        # And it takes work again
        req = batch_exec_factory("dist", "square", 8)
        for i, m in enumerate(req.messages):
            m.input_data = str(i + 1).encode()
        d = me.planner_client.call_functions(req)
        assert set(d.hosts) == {w0, w1}, d.hosts
        status = wait_finished(me, req.app_id, timeout=30)
        assert all(m.return_value == int(ReturnValue.SUCCESS)
                   for m in status.message_results)
    finally:
        cluster.stop()


def wait_finished_tolerant(me, app_id, timeout):
    """wait_finished where the planner itself goes away mid-poll: an
    RpcError (connection refused, open breaker) is part of the
    scenario."""
    deadline = time.time() + timeout
    status = None
    while time.time() < deadline:
        try:
            status = me.planner_client.get_batch_results(app_id)
            if status.finished:
                return status
        except Exception:  # noqa: BLE001 — planner down is expected
            pass
        time.sleep(0.25)
    raise AssertionError(f"batch {app_id} never finished: {status}")


@pytest.mark.slow
def test_chaos_planner_sigkill_restart_recovers(tmp_path):
    """SIGKILL the planner mid-batch. The restarted planner replays its
    write-ahead journal (pre-crash results intact, the in-flight
    decision restored), workers rejoin through the known:false
    keep-alive path and flush the results they buffered during the
    outage, and the batch completes with every message SUCCESS. The
    reference reads the replay from ``/healthz``; the port's planner
    process prints it in its ready line, and the test waits for the
    planner through a planner RPC."""
    from faabric_tpu_torch.runner import flightdump, journaldump

    journal_dir = str(tmp_path / "journal")
    flight_dir = str(tmp_path / "flight")
    cluster = ChaosCluster(
        "ckP", slots=(8, 4),
        extra_env={"PLANNER_HOST_TIMEOUT": "3",
                   "PLANNER_REQUEUE_BACKOFF": "0.3",
                   "PLANNER_MAX_REQUEUES": "5",
                   "FAABRIC_PLANNER_JOURNAL_DIR": journal_dir,
                   "FAABRIC_PLANNER_RECONCILE_GRACE": "5",
                   "FAABRIC_FLIGHT_DIR": flight_dir}).start()
    try:
        me = cluster.me
        # 12 tasks over 8 + 4 slots: four quick ones finish (and journal
        # their results) before the kill; the 4 s stragglers finish
        # during the outage and buffer worker-side
        req = batch_exec_factory("dist", "sleep", 12)
        for i, m in enumerate(req.messages):
            m.input_data = b"0.5" if i < 4 else b"4"
        me.planner_client.call_functions(req)

        # Wait until pre-crash results are recorded at the planner
        deadline = time.time() + 20
        pre_crash = set()
        while time.time() < deadline:
            status = me.planner_client.get_batch_results(req.app_id)
            pre_crash = {m.id for m in status.message_results}
            if len(pre_crash) >= 2:
                break
            time.sleep(0.2)
        assert len(pre_crash) >= 2, "no results recorded before the kill"

        t_kill = cluster.kill(cluster.planner_host)
        time.sleep(1.0)  # outage window: stragglers complete and buffer

        # Restart on the same journal directory, and wait for the
        # planner through its RPC
        ready = cluster.restart_planner()
        deadline = time.time() + 60
        while True:
            try:
                me.planner_client.get_available_hosts()
                break
            except Exception:  # noqa: BLE001 — not serving yet
                assert time.time() < deadline, "the planner never served"
                time.sleep(0.25)

        status = wait_finished_tolerant(me, req.app_id, timeout=60)
        recovery_s = time.monotonic() - t_kill
        assert status.expected_num_messages == 12
        assert len(status.message_results) == 12
        bad = [(m.id, m.return_value, m.output_data)
               for m in status.message_results
               if m.return_value != int(ReturnValue.SUCCESS)]
        assert not bad, f"batch had failures after planner restart: {bad}"
        # Pre-crash results rode the journal through the restart
        post = {m.id for m in status.message_results}
        assert pre_crash <= post
        assert recovery_s < 45, f"recovery took {recovery_s:.1f}s"

        # The restarted planner's replay
        journal = ready["journal"]
        assert journal["enabled"]
        replay = ready["lastReplay"]
        assert replay["records"] + (
            1 if replay["snapshot"] else 0) >= 1
        assert replay["inFlightApps"] >= 1
        # Both workers (and the client host) re-registered
        assert len(me.planner_client.get_available_hosts()) >= 3

        # The flight recorder kept the black box: the restarted planner
        # dumped on replay
        deadline = time.time() + 10
        merged = []
        while time.time() < deadline:
            merged = flightdump.merge(flight_dir)
            if any(e["kind"] == "journal_replayed" for e in merged):
                break
            time.sleep(0.5)
        kinds = {e["kind"] for e in merged}
        assert "journal_replayed" in kinds, kinds

        # And journaldump can verify and render the journal directory
        snapshot, records, meta = journaldump.load_journal_dir(journal_dir)
        assert not meta.get("torn")
        assert snapshot is not None or records
    finally:
        cluster.stop()


def _rest(base: str, http_type, payload=""):
    import json
    import urllib.request

    body = json.dumps({"http_type": int(http_type),
                       "payload": payload}).encode()
    req = urllib.request.Request(f"{base}/", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.slow
def test_chaos_live_migration_under_traffic():
    """A 3-rank world spread over both workers streams barrier and
    all-to-all rounds; once the blockers drain, the planner consolidates
    it onto one worker mid-stream. Every staying rank's pause is
    bounded, no round is lost or corrupted, and the comm matrix kept
    the cross-host links the migration removed
    (``tests/dist/test_lifecycle.py:41``)."""
    from tests.test_torch_multiprocess import http_json

    cluster = ChaosCluster("ckM", http=True)
    cluster.start()
    try:
        me = cluster.me
        blockers = []
        for count in (2, 3):
            b = batch_exec_factory("dist", "sleep", count)
            for m in b.messages:
                m.input_data = b"4.0"
            me.planner_client.call_functions(b)
            blockers.append(b)

        req = batch_exec_factory("dist", "mpi_migrate_traffic", 1)
        req.messages[0].mpi_rank = 0
        me.planner_client.call_functions(req)
        r = me.planner_client.get_message_result(
            req.app_id, req.messages[0].id, timeout=90.0)
        assert r.return_value == int(ReturnValue.SUCCESS), r.output_data

        status = wait_finished(me, req.app_id, timeout=45)
        assert status.expected_num_messages == 3
        final_hosts, pauses = set(), []
        for m in status.message_results:
            assert m.return_value == int(ReturnValue.SUCCESS), m.output_data
            parts = m.output_data.decode().split(":")
            assert parts[1] == "migrate-traffic-ok", m.output_data
            final_hosts.add(parts[2])
            if float(parts[3]) >= 0:  # the stayers timed the pause
                pauses.append(float(parts[3]))
        assert len(final_hosts) == 1, final_hosts
        assert me.planner_client.get_num_migrations() >= 1
        assert pauses, "no staying rank measured a migration pause"
        assert max(pauses) < 10_000, f"migration pause {max(pauses)}ms"

        matrix = http_json(cluster.http_url, "/commmatrix")
        planes = {row["plane"] for row in matrix["total"]}
        assert planes & {"ptp", "bulk-tcp", "shm"}, matrix["total"][:5]
        assert sum(row["messages"] for row in matrix["total"]) > 0

        for b in blockers:
            wait_finished(me, b.app_id, timeout=30)
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_spot_freeze_thaw_restores_on_other_host():
    """Spot eviction of the host running a THREADS app: the guests park
    the live image on the planner and vacate; the thaw, with the evicted
    host still tainted, lands on the other worker, restores the parked
    image there and completes (``tests/dist/test_lifecycle.py:109``)."""
    import numpy as np

    from faabric_tpu_torch.endpoint import HttpMessageType
    from faabric_tpu_torch.proto import BatchExecuteType
    from faabric_tpu_torch.snapshot import SnapshotData

    cluster = ChaosCluster("ckS", extra_env={"BATCH_SCHEDULER_MODE": "spot"},
                           http=True)
    cluster.start()
    try:
        me = cluster.me
        req = batch_exec_factory("dist", "spot", 2)
        req.type = int(BatchExecuteType.THREADS)
        for i, m in enumerate(req.messages):
            m.group_idx = i
        key = f"dist/spot_{req.app_id}"
        req.snapshot_key = key
        me.snapshot_registry.register_snapshot(
            key, SnapshotData(np.zeros(16384, np.uint8).tobytes()))

        decision = me.planner_client.call_functions(req)
        exec_hosts = set(decision.hosts)
        assert len(exec_hosts) == 1, decision.hosts  # bin-packed
        victim = exec_hosts.pop()
        other = next(w for w in cluster.workers if w != victim)
        time.sleep(1.0)  # the guests run and marked their memory

        # Fill the other worker, so that the eviction cannot move the
        # app: spot with spare capacity migrates, with none it freezes
        blockers = batch_exec_factory("dist", "sleep", 4)
        for m in blockers.messages:
            m.input_data = b"6"
        db = me.planner_client.call_functions(blockers)
        assert set(db.hosts) == {other}, db.hosts

        _rest(cluster.http_url, HttpMessageType.SET_NEXT_EVICTED_VM, victim)
        me.planner_client.check_migration(req.app_id)

        deadline = time.time() + 20
        frozen = False
        while time.time() < deadline:
            if me.planner_client.get_scheduling_decision(req.app_id) is None:
                frozen = True
                break
            time.sleep(0.2)
        assert frozen, "app never left the in-flight set after eviction"
        time.sleep(1.0)  # the vacate and the parked image land

        wait_finished(me, blockers.app_id, timeout=30)

        # Thaw: a new request of the app resumes the parked batch on the
        # untainted worker, where the planner pushes the parked image
        thaw = batch_exec_factory("dist", "spot", 1)
        thaw.app_id = req.app_id
        t_thaw = time.monotonic()
        d2 = me.planner_client.call_functions(thaw)
        assert d2.n_messages == 2, d2.n_messages
        assert set(d2.hosts) == {other}, d2.hosts

        first = me.planner_client.get_message_result(
            req.app_id, d2.message_ids[0], timeout=30.0)
        thaw_s = time.monotonic() - t_thaw
        assert first.return_value == int(ReturnValue.SUCCESS), \
            first.output_data
        assert first.output_data == f"thawed:{other}".encode(), \
            first.output_data

        status = wait_finished(me, req.app_id, timeout=30)
        assert len(status.message_results) == 2
        for m in status.message_results:
            assert m.return_value == int(ReturnValue.SUCCESS), m.output_data
            assert m.output_data == f"thawed:{other}".encode()
        assert thaw_s < 20, f"thaw to first result took {thaw_s:.1f}s"
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_worker_sigkill_at_full_qps_recovers(tmp_path):
    """A worker SIGKILLed while one-message no-op apps stream through
    SUBMIT_BATCH, the scheduling ticks and the pipelined dispatch: the
    requeue moves the dead worker's messages to the survivor, every app
    ends with exactly one SUCCESS result, the journal stays intact with
    its group commits, and the flight dumps show the recovery."""
    import json
    import urllib.request

    from faabric_tpu_torch.runner import flightdump, journaldump

    journal_dir = str(tmp_path / "journal")
    flight_dir = str(tmp_path / "flight")
    cluster = ChaosCluster(
        "ckQ", slots=(16, 16), http=True,
        extra_env={"PLANNER_HOST_TIMEOUT": "2",
                   "PLANNER_REQUEUE_BACKOFF": "0.2",
                   "PLANNER_MAX_REQUEUES": "5",
                   "FAABRIC_PLANNER_JOURNAL_DIR": journal_dir,
                   "FAABRIC_FLIGHT_DIR": flight_dir}).start()
    try:
        me = cluster.me
        total, bulk = 600, 25

        def results_total() -> int:
            with urllib.request.urlopen(f"{cluster.http_url}/healthz",
                                        timeout=5) as r:
                return json.loads(r.read()).get("resultsTotal", 0)

        app_ids: list[int] = []
        submit_errs: list[str] = []

        def pump() -> None:
            try:
                left = total
                while left > 0:
                    n = min(bulk, left)
                    reqs = [batch_exec_factory("dist", "noop", 1)
                            for _ in range(n)]
                    while True:
                        ok, retry_after = \
                            me.planner_client.submit_functions_many(reqs)
                        if ok:
                            break
                        time.sleep(retry_after)
                    app_ids.extend(r.app_id for r in reqs)
                    left -= n
            except Exception as e:  # noqa: BLE001
                submit_errs.append(str(e))

        pumper = threading.Thread(target=pump, name="qps-pump")
        pumper.start()
        # The stream at full rate, then a worker killed mid-flight
        deadline = time.time() + 30
        while results_total() < 120 and time.time() < deadline:
            time.sleep(0.1)
        assert results_total() >= 120, "the stream never reached its rate"
        t_kill = cluster.kill(cluster.workers[1])
        pumper.join(timeout=60)
        assert not submit_errs, submit_errs

        deadline = time.time() + 90
        done = 0
        while time.time() < deadline:
            done = results_total()
            if done >= total:
                break
            time.sleep(0.25)
        recovery_s = time.monotonic() - t_kill
        assert done >= total, f"only {done}/{total} completed"
        assert recovery_s < 75, f"recovery took {recovery_s:.1f}s"

        # No lost and no duplicated results
        bad = []
        for app_id in app_ids:
            status = me.planner_client.get_batch_results(app_id)
            if (not status.finished or len(status.message_results) != 1
                    or status.message_results[0].return_value
                    != int(ReturnValue.SUCCESS)):
                bad.append((app_id, status.finished,
                            [(m.return_value, m.output_data)
                             for m in status.message_results]))
        assert not bad, f"{len(bad)} bad apps, e.g. {bad[:3]}"

        # The journal intact, its tick group commits in the log or
        # folded into a compaction snapshot
        snapshot, records, meta = journaldump.load_journal_dir(journal_dir)
        assert not meta.get("torn") and not meta.get("snapshot_error")
        assert (any(r.get("k") == "group" for r in records)
                or snapshot is not None)

        deadline = time.time() + 15
        kinds: set = set()
        while time.time() < deadline:
            kinds = {e["kind"] for e in flightdump.merge(flight_dir)}
            if "planner_requeued" in kinds:
                break
            time.sleep(0.5)
        assert "planner_recovery" in kinds or "planner_requeued" in kinds, \
            kinds
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_elastic_scale_up_down_mid_app():
    """Two elastic fork waves of a long-running parent grow onto its
    main host's free slots, drain (the scale-down frees the slots) and
    grow again, and every message of every wave reports once."""
    cluster = ChaosCluster("ckE", slots=(4, 4)).start()
    try:
        me = cluster.me
        parent = batch_exec_factory("dist", "sleep", 1)
        parent.messages[0].input_data = b"12"
        d = me.planner_client.call_functions(parent)
        main_host = d.hosts[0]

        wave_sizes = []
        for wave in range(2):
            scale = batch_exec_factory("dist", "square", 1)
            scale.app_id = parent.app_id
            scale.elastic_scale_hint = True
            scale.messages[0].input_data = b"7"
            scale.messages[0].main_host = main_host
            ds = me.planner_client.call_functions(scale)
            assert ds.n_messages >= 3, (wave, ds.n_messages)  # grew
            assert set(ds.hosts) == {main_host}, ds.hosts
            wave_sizes.append(ds.n_messages)
            for mid in ds.message_ids:
                r = me.planner_client.get_message_result(
                    parent.app_id, mid, timeout=20.0)
                assert r.return_value == int(ReturnValue.SUCCESS), \
                    r.output_data
                assert r.output_data == b"49"
        # Both waves filled the same freed room: no slot leaked
        assert wave_sizes[0] == wave_sizes[1], wave_sizes

        status = wait_finished(me, parent.app_id, timeout=40)
        assert status.expected_num_messages == 1 + sum(wave_sizes)
        assert len(status.message_results) == 1 + sum(wave_sizes)
        assert all(m.return_value == int(ReturnValue.SUCCESS)
                   for m in status.message_results)
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_host_pair_partition_heals_bounded():
    """A DIRECTED partition of one worker pair by fault rules
    (``tests/dist/test_lifecycle.py:248``): w1 -> w0 dead on the RPC and
    bulk planes through src/dest ctx matchers in ONE cluster-wide spec;
    w0 -> w1 and every planner link alive. The sending side aborts its
    MPI world in bounded time, and — since its direct abort broadcast
    rides the very link that died — the far side can only learn through
    the planner's out-of-band relay. Every rank reports a bounded abort
    instead of hanging to the 60 s socket timeout."""
    w0, w1 = "ckNw0", "ckNw1"
    partition = ";".join([
        # The RPC plane armed from boot: the abort broadcast must find
        # the link already dead
        f"transport.send=kill_conn@src={w1}@host={w0}@times=400",
        # The bulk and shm data plane, from some rounds in
        f"transport.bulk=kill_conn@src={w1}@dest={w0}@after=200@times=400",
    ])
    cluster = ChaosCluster(
        "ckN", slots=(4, 4),
        extra_env={"MPI_ABORT_CHECK_SECONDS": "1",
                   "PLANNER_HOST_TIMEOUT": "30"},
        worker_env={"FAABRIC_FAULTS": partition}).start()
    try:
        me = cluster.me
        req = batch_exec_factory("dist", "mpi_partition", 1)
        req.messages[0].mpi_rank = 0
        me.planner_client.call_functions(req)

        status = wait_finished(me, req.app_id, timeout=90)
        assert status.expected_num_messages == 8
        aborted = []
        for m in status.message_results:
            assert m.return_value == int(ReturnValue.SUCCESS), \
                (m.mpi_rank, m.output_data)
            assert m.output_data.startswith(b"aborted:"), m.output_data
            aborted.append(float(m.output_data.split(b":")[1]))
        # EVERY rank aborted, the side whose direct broadcast the
        # partition swallowed too (the planner's relay)
        assert len(aborted) == 8, aborted
        # Under the 60 s socket timeout with margin: the check interval
        # is 1 s and the relay one RPC hop
        assert max(aborted) < 20.0, f"partition heal took {max(aborted)}s"
    finally:
        cluster.stop()


# ---------------------------------------------------------------------------
# The state plane's failover (tests/dist/test_state_failover.py)
# ---------------------------------------------------------------------------
def _payload(key: str, seq: int) -> bytes:
    from faabric_tpu_torch.state import STATE_CHUNK_SIZE

    pat = f"{key}:{seq}|".encode()
    return (pat * (STATE_CHUNK_SIZE // len(pat) + 1))[:STATE_CHUNK_SIZE]


def _pick_keys(n: int, masters: list, workers: list, all_hosts: list,
               prefix: str = "k") -> dict:
    """key -> its master, round robin over ``masters``, keeping the keys
    whose consistent-hash backup is a worker process."""
    from faabric_tpu_torch.state import place_backup

    chosen: dict = {}
    j = 0
    while len(chosen) < n:
        key, j = f"{prefix}{j}", j + 1
        master = masters[len(chosen) % len(masters)]
        others = [h for h in all_hosts if h != master]
        if place_backup(f"chaos/{key}", others) in workers:
            chosen[key] = master
    return chosen


def _claim_on(me, owner: dict) -> None:
    """``fn_state_claim`` for each key on its master, placed by a
    preloaded decision (the first writer is the master)."""
    req = batch_exec_factory("dist", "state_claim", len(owner))
    pre = SchedulingDecision(app_id=req.app_id, group_id=0)
    for i, (key, host) in enumerate(owner.items()):
        req.messages[i].input_data = key.encode()
        pre.add_message(host, 0, req.messages[i].app_idx, i)
    me.planner_client.preload_scheduling_decision(pre)
    decision = me.planner_client.call_functions(req)
    assert list(decision.hosts) == list(owner.values()), \
        f"preload not honoured: {decision.hosts}"
    status = wait_finished(me, req.app_id, timeout=30)
    got = {m.output_data.decode() for m in status.message_results}
    assert got == {f"{k}@{h}" for k, h in owner.items()}, got


@pytest.mark.slow
def test_chaos_sigkill_state_master_loses_zero_acked_writes():
    """SIGKILL the hottest master mid-stream: every acknowledged write
    stays readable byte for byte through the promoted backup, and the
    failover is bounded."""
    from faabric_tpu_torch.state import STATE_CHUNK_SIZE as CHUNK
    from faabric_tpu_torch.state import place_backup

    cluster = ChaosCluster("ckS", slots=(4, 4),
                           extra_env={"PLANNER_HOST_TIMEOUT": "3"}).start()
    try:
        me = cluster.me
        workers = cluster.workers
        all_hosts = workers + [cluster.client_host]
        owner = _pick_keys(6, workers, workers, all_hosts)
        keys = list(owner)
        _claim_on(me, owner)

        # The planner's election agrees with the pure placement function
        placed0 = {k: me.planner_client.claim_state_master("chaos", k)
                   for k in keys}
        for k, (m, b, e) in placed0.items():
            assert m == owner[k], (k, m)
            assert b == place_backup(
                f"chaos/{k}", [h for h in all_hosts if h != m]), (k, b)
            assert e >= 1, (k, e)

        kvs = {k: me.state.get_kv("chaos", k, 4 * CHUNK) for k in keys}
        acked: dict = {}
        by_master: dict = {}
        seq = 0

        def write(k: str) -> None:
            nonlocal seq
            p = _payload(k, seq)
            seq += 1
            kvs[k].set_chunk(CHUNK, p)
            kvs[k].push_partial()  # its return is the ack
            acked[k] = p
            by_master[owner[k]] = by_master.get(owner[k], 0) + 1

        for _ in range(4):
            for k in keys:
                write(k)
        hot = [k for k in keys if owner[k] == workers[0]]
        for _ in range(4):
            for k in hot:
                write(k)
        victim = max(by_master, key=by_master.get)
        assert victim == workers[0], by_master

        # Dirty, unacknowledged chunks on the victim's keys as it dies
        for k in hot:
            kvs[k].set_chunk(CHUNK, b"\x00" * CHUNK)
        t_kill = cluster.kill(victim)

        # Writes to the victim's keys resume once expiry reaps it and
        # its backups are promoted
        failover_s = None
        deadline = time.time() + 60
        for k in hot:
            while True:
                try:
                    write(k)
                    break
                except Exception:  # noqa: BLE001
                    assert time.time() < deadline, \
                        f"no failover for {k} within budget"
                    try:  # ticks the planner's expiry
                        me.planner_client.get_available_hosts()
                    except Exception:  # noqa: BLE001
                        pass
                    time.sleep(0.25)
            if failover_s is None:
                failover_s = time.monotonic() - t_kill

        for _ in range(2):
            for k in keys:
                write(k)

        # The backup was promoted, the epoch moved on, and the dead host
        # is nowhere in the new placement
        for k in hot:
            m0, b0, e0 = placed0[k]
            m1, b1, e1 = me.planner_client.claim_state_master("chaos", k)
            assert m1 == b0, (k, m1, b0)
            assert e1 == e0 + 1, (k, e0, e1)
            assert victim not in (m1, b1), (k, m1, b1)

        # No acknowledged write lost
        for k in keys:
            kvs[k].pull()
            assert kvs[k].get_chunk(CHUNK, CHUNK) == acked[k], \
                f"acked write to {k} lost or corrupt after failover"
        assert failover_s is not None and failover_s < 30.0, failover_s
    finally:
        cluster.stop()


@pytest.mark.slow
def test_chaos_revived_stale_master_cannot_ack():
    """SIGSTOP a master past its keep-alive expiry (its master KV stays
    in memory), fail over, SIGCONT it: the revived ex-master's write is
    refused by the epoch fence, and its bytes never reach the
    authoritative copy."""
    from faabric_tpu_torch.state import STATE_CHUNK_SIZE as CHUNK

    cluster = ChaosCluster("ckT", slots=(2, 2),
                           extra_env={"PLANNER_HOST_TIMEOUT": "2"}).start()
    stopped = None
    try:
        me = cluster.me
        w0 = cluster.workers[0]
        all_hosts = cluster.workers + [cluster.client_host]
        owner = _pick_keys(1, [w0], cluster.workers, all_hosts,
                           prefix="fence")
        (key,) = owner
        _claim_on(me, owner)
        m0, b0, e0 = me.planner_client.claim_state_master("chaos", key)
        assert m0 == w0 and b0 in cluster.workers, (m0, b0)

        # An acked write through the doomed master; then the client's
        # KV goes, so that no later op targets the stopped process
        kv = me.state.get_kv("chaos", key, 4 * CHUNK)
        kv.set_chunk(CHUNK, _payload(key, 0))
        kv.push_partial()
        me.state.delete_kv("chaos", key)

        stopped = cluster.children[w0].proc
        stopped.send_signal(signal.SIGSTOP)
        deadline = time.time() + 30
        while True:
            try:
                me.planner_client.get_available_hosts()
                m1, b1, e1 = me.planner_client.claim_state_master(
                    "chaos", key)
                if m1 != w0 and e1 > e0:
                    break
            except Exception:  # noqa: BLE001
                pass
            assert time.time() < deadline, "failover never happened"
            time.sleep(0.25)
        assert m1 == b0 and e1 == e0 + 1, (m1, b0, e0, e1)

        # An acked write through the new master
        kv2 = me.state.get_kv("chaos", key, 4 * CHUNK)
        post = _payload(key, 1)
        deadline = time.time() + 30
        while True:
            try:
                kv2.set_chunk(CHUNK, post)
                kv2.push_partial()
                break
            except Exception:  # noqa: BLE001
                assert time.time() < deadline, "new master never acked"
                time.sleep(0.25)

        # The revived host rejoins, still holding its old master KV
        stopped.send_signal(signal.SIGCONT)
        stopped = None
        deadline = time.time() + 30
        while True:
            hosts = {h["ip"] for h in me.planner_client.get_available_hosts()}
            if w0 in hosts:
                break
            assert time.time() < deadline, f"{w0} never rejoined: {hosts}"
            time.sleep(0.25)

        # The probe runs on the revived host, placed there by a preloaded
        # decision: its stale master KV cannot ack
        req = batch_exec_factory("dist", "state_stale_probe", 1)
        req.messages[0].input_data = key.encode()
        pre = SchedulingDecision(app_id=req.app_id, group_id=0)
        pre.add_message(w0, 0, req.messages[0].app_idx, 0)
        me.planner_client.preload_scheduling_decision(pre)
        me.planner_client.call_functions(req)
        status = wait_finished(me, req.app_id, timeout=30)
        (probe,) = status.message_results
        assert probe.return_value == int(ReturnValue.SUCCESS), probe
        assert probe.output_data == b"fenced:StaleStateEpoch", \
            probe.output_data

        # The authoritative copy never saw the refused bytes
        kv2.pull()
        assert kv2.get_chunk(0, CHUNK) == bytes([7]) * CHUNK
        assert kv2.get_chunk(CHUNK, CHUNK) == post
    finally:
        if stopped is not None:
            stopped.send_signal(signal.SIGCONT)
        cluster.stop()
