"""Worker and planner process bodies of the port's multi-process tests.

Counterpart of ``tests/dist/procs.py``: each logical host is an OS
process of its own on aliased loopback ports (``FAABRIC_HOST_ALIASES``),
started by ``tests/test_torch_multiprocess.py`` and
``tests/test_torch_chaos.py``. It imports the port and nothing of the
JAX package. Run as a script::

    python tests/test_torch_procs.py planner [port_offset]
    python tests/test_torch_procs.py worker <host> [planner_host] [slots]
    python tests/test_torch_procs.py planeworker <host> <planner_host> \
        <slots> <n_procs> [device]

A body prints ``READY`` once it serves, then one JSON line: its role and
host, the top-level modules it loaded (so a test can show that no
``jax`` and no ``faabric_tpu`` is among them) and, for a planner, its
journal and the stats of its boot-time replay. It exits when its
standard input closes, and at the latest after ``DIST_PROC_TTL``
seconds (600 by default), so an aborted run leaves no process holding a
port. A line ``dump <path>`` on its standard input writes the process's
trace events, comm-matrix cells and Prometheus text to ``path`` as JSON
(the process's own share of what the planner merges behind ``GET
/trace``, ``/commmatrix`` and ``/metrics``). With ``DIST_HTTP_PORT`` set
a planner serves its REST endpoint on that port, and with
``WORKER_HTTP_PORT`` set a worker serves its own endpoint.

``PROCS_HELD_FDS`` names listening sockets the parent held on this
host's ports while the interpreter started; the body closes them right
before its servers bind. SIGTERM dumps the flight ring
(``FAABRIC_FLIGHT_DIR``) and then kills the process as the default
action would; SIGUSR1 prints every thread's stack.

Ported behaviours (``fn_*``) are those the port's multi-process and chaos
cases run; ``ROADMAP.md`` (#10) lists the ones left out and the cases
that wait for them.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from faabric_tpu_torch.executor import Executor, ExecutorFactory  # noqa: E402
from faabric_tpu_torch.proto import ReturnValue  # noqa: E402


class DistExecutor(Executor):
    """Behaviour registry keyed by function name, with a 16 KiB memory
    image (the reference's DistTestExecutor callback pattern,
    tests/dist/DistTestExecutor.cpp)."""

    MEM = 16384

    def __init__(self, msg):
        super().__init__(msg)
        self.memory = np.zeros(self.MEM, dtype=np.uint8)

    def get_memory_view(self):
        return self.memory

    def set_memory_size(self, size):
        if size > self.memory.size:
            self.memory = np.concatenate(
                [self.memory, np.zeros(size - self.memory.size, np.uint8)])

    def execute_task(self, pool_idx, msg_idx, req):
        msg = req.messages[msg_idx]
        fn = getattr(self, f"fn_{msg.function}", None)
        if fn is None:
            msg.output_data = f"unknown function {msg.function}".encode()
            return int(ReturnValue.FAILED)
        return fn(msg, req)

    @staticmethod
    def _world(msg, world_id: int, size: int = 8):
        """Rank 0 of a fresh batch creates world ``world_id``; every other
        rank, chained by it, joins."""
        from faabric_tpu_torch.mpi import get_mpi_context

        ctx = get_mpi_context()
        if msg.mpi_rank == 0 and not msg.is_mpi:
            msg.is_mpi = True
            msg.mpi_world_id = world_id
            msg.mpi_world_size = size
            world = ctx.create_world(msg)
        else:
            world = ctx.join_world(msg)
        world.refresh_rank_hosts()
        return world, msg.mpi_rank

    # ------------------------------------------------------------------
    def fn_noop(self, msg, req):
        """The cheapest invocation: the lifecycle cases measure the path,
        not the task."""
        msg.output_data = b"ok"
        return int(ReturnValue.SUCCESS)

    def fn_square(self, msg, req):
        n = int(msg.input_data.decode())
        msg.output_data = str(n * n).encode()
        return int(ReturnValue.SUCCESS)

    def fn_sleep(self, msg, req):
        """Slot blocker: hold a scheduler slot for input_data seconds."""
        time.sleep(float(msg.input_data.decode() or "1"))
        msg.output_data = b"slept"
        return int(ReturnValue.SUCCESS)

    def fn_mpi(self, msg, req):
        from faabric_tpu_torch.mpi import MpiOp

        world, rank = self._world(msg, 7100)
        out = world.allreduce(rank, np.full(65536, float(rank),
                                            dtype=np.float32), MpiOp.SUM)
        world.barrier(rank)
        msg.output_data = f"r{rank}:{int(out[0])}".encode()
        return int(ReturnValue.SUCCESS)

    def fn_mpi_big(self, msg, req):
        """12 MiB-per-rank allreduce: the chunk-pipelined leader trees and
        the bulk data plane in a planner-scheduled world across worker
        processes."""
        return self._allreduce_workload(msg, 7500, 12 << 20)

    def _allreduce_workload(self, msg, world_id: int, nbytes: int,
                            rounds: int = 1):
        """``rounds`` allreduces of ``nbytes`` of int32 a rank on world
        ``world_id``; every element must equal sum(1..size)."""
        from faabric_tpu_torch.mpi import MpiOp

        world, rank = self._world(msg, world_id)
        out = None
        for _ in range(rounds):
            out = world.allreduce(rank, np.full(nbytes // 4, rank + 1,
                                                np.int32), MpiOp.SUM)
        world.barrier(rank)
        ok = bool((out == world.size * (world.size + 1) // 2).all())
        msg.output_data = f"r{rank}:{'ok' if ok else int(out[0])}".encode()
        return int(ReturnValue.SUCCESS if ok else ReturnValue.FAILED)

    def fn_mpi_telemetry(self, msg, req):
        """The 12 MiB-a-rank allreduce on a world of its own, for the
        endpoint's /metrics and /trace case."""
        return self._allreduce_workload(msg, 7510, 12 << 20)

    def fn_mpi_flow(self, msg, req):
        """A few 1 MiB allreduces on a world of their own: fresh remote
        send and receive flow pairs for the /trace links case."""
        return self._allreduce_workload(msg, 7520, 1 << 20, rounds=3)

    def fn_mpi_matrix(self, msg, req):
        """The 12 MiB-a-rank allreduce on a world of its own: fresh bulk
        bytes for the /commmatrix case."""
        return self._allreduce_workload(msg, 7530, 12 << 20)

    def fn_mpi_perf(self, msg, req):
        """Allreduce rounds with one planted straggler: the rank named by
        ``MPI_PERF_SLOW_RANK`` sleeps ``MPI_PERF_SLOW_S`` before entering
        each collective, so every other rank waits on it while only its
        entry stamp reads late (the doctor's case, with a slow link
        planted by a fault rule on one worker)."""
        from faabric_tpu_torch.mpi import MpiOp

        slow_rank = int(os.environ.get("MPI_PERF_SLOW_RANK", "-1"))
        slow_s = float(os.environ.get("MPI_PERF_SLOW_S", "0.08"))
        rounds = int(os.environ.get("MPI_PERF_ROUNDS", "8"))
        nbytes = int(os.environ.get("MPI_PERF_NBYTES", str(16 << 20)))
        world, rank = self._world(msg, 7600)
        out = None
        for _ in range(rounds):
            if rank == slow_rank:
                time.sleep(slow_s)
            out = world.allreduce(rank, np.full(nbytes // 4, rank + 1,
                                                np.int32), MpiOp.SUM)
        world.barrier(rank)
        ok = bool((out == world.size * (world.size + 1) // 2).all())
        msg.output_data = f"r{rank}:{'ok' if ok else int(out[0])}".encode()
        return int(ReturnValue.SUCCESS if ok else ReturnValue.FAILED)

    def fn_mpi_ring_chunked(self, msg, req):
        """A ring allreduce whose per-rank segments exceed one bulk frame
        (``RING_CHUNK_BYTES``), so the ring chunk-pipelines; integer
        results must be bitwise exact across processes."""
        from faabric_tpu_torch.mpi import MpiOp
        from faabric_tpu_torch.mpi.world import RING_CHUNK_BYTES

        world, rank = self._world(msg, 7540)
        # The flat chunked ring (algo=ring), pinned identically on every
        # process of the world so that algorithm choice cannot desync
        world.hier_enabled = False
        n = 10 << 20  # 40 MiB int32 a rank → ~5 MiB ring segments
        seg_bytes = (n * 4) // world.size
        base = np.arange(n, dtype=np.int32) % 1000
        out = world.allreduce(rank, base + rank, MpiOp.SUM)
        world.barrier(rank)
        expected = base * world.size + world.size * (world.size - 1) // 2
        ok = bool((out == expected).all())
        chunked = seg_bytes > RING_CHUNK_BYTES
        verdict = "ok" if ok and chunked else (
            "unchunked" if ok else "wrong")
        msg.output_data = f"r{rank}:{verdict}".encode()
        return int(ReturnValue.SUCCESS if ok and chunked
                   else ReturnValue.FAILED)

    def fn_mpi_reduce_many(self, msg, req):
        """mpi_reduce_many.cpp: 100 back-to-back reduces of a 3-vector."""
        from faabric_tpu_torch.mpi import MpiOp

        world, rank = self._world(msg, 7700)
        size = world.size
        expected = np.array([sum(range(size)), 10 * sum(range(size)),
                             100 * sum(range(size))], np.int64)
        mine = np.array([rank, 10 * rank, 100 * rank], np.int64)
        for _ in range(100):
            res = world.reduce(rank, 0, mine, MpiOp.SUM)
            if rank == 0 and not np.array_equal(res, expected):
                msg.output_data = f"bad:{res.tolist()}".encode()
                return int(ReturnValue.FAILED)
        world.barrier(rank)
        msg.output_data = b"reduce-many-ok"
        return int(ReturnValue.SUCCESS)

    def fn_mpi_sync_async(self, msg, req):
        """mpi_send_sync_async.cpp: rank 0 interleaves an isend and a
        blocking send to every rank; receivers wait out of order."""
        world, rank = self._world(msg, 7800)
        if rank == 0:
            for r in range(1, world.size):
                rid = world.isend(0, r, np.array([r], np.int32))
                world.send(0, r, np.array([r], np.int32))
                world.await_async(0, rid)
            msg.output_data = b"sent"
        else:
            r1 = world.irecv(0, rank)
            r2 = world.irecv(0, rank)
            v2 = world.await_async(rank, r2)  # out of order
            v1 = world.await_async(rank, r1)
            ok = int(v1[0][0]) == rank and int(v2[0][0]) == rank
            msg.output_data = (b"sync-async-ok" if ok
                               else f"got:{v1[0][0]},{v2[0][0]}".encode())
            if not ok:
                return int(ReturnValue.FAILED)
        world.barrier(rank)
        return int(ReturnValue.SUCCESS)

    def fn_mpi_collectives(self, msg, req):
        """mpi_allgather, mpi_bcast (root 2), mpi_gather (root 2),
        mpi_scatter, mpi_scan, mpi_reduce and mpi_helloworld's sanity in
        one cross-process world."""
        from faabric_tpu_torch.mpi import MpiOp

        world, rank = self._world(msg, 8300)
        size = world.size
        if rank < 0 or size <= 1:
            return int(ReturnValue.FAILED)

        def fail(tag, got):
            msg.output_data = f"{tag}:{got}".encode()
            return int(ReturnValue.FAILED)

        n_per = 4
        got = world.allgather(rank, np.arange(
            rank * n_per, (rank + 1) * n_per, dtype=np.int32))
        if not np.array_equal(got, np.arange(size * n_per, dtype=np.int32)):
            return fail("allgather", got[:8].tolist())
        expected = np.array([0, 1, 2, 3], np.int32)
        out = world.broadcast(2, rank,
                              expected if rank == 2 else np.empty(0))
        if not np.array_equal(out, expected):
            return fail("bcast", out.tolist())
        got = world.gather(rank, 2, np.arange(
            rank * n_per, (rank + 1) * n_per, dtype=np.int32))
        if rank == 2 and not np.array_equal(
                got, np.arange(size * n_per, dtype=np.int32)):
            return fail("gather", got[:8].tolist())
        all_data = np.arange(size * n_per, dtype=np.int32) \
            if rank == 0 else np.empty(0, np.int32)
        mine = world.scatter(0, rank, all_data, n_per)
        if not np.array_equal(mine, np.arange(
                rank * n_per, (rank + 1) * n_per, dtype=np.int32)):
            return fail("scatter", mine.tolist())
        got = world.scan(rank, np.array(
            [rank * 10 + i for i in range(3)], np.int64), MpiOp.SUM)
        expected = np.array(
            [sum(r * 10 + i for r in range(rank + 1)) for i in range(3)],
            np.int64)
        if not np.array_equal(got, expected):
            return fail("scan", got.tolist())
        got = world.reduce(rank, 3, np.full(5, rank, np.int64), MpiOp.SUM)
        if rank == 3 and not np.array_equal(
                got, np.full(5, sum(range(size)), np.int64)):
            return fail("reduce", got.tolist())
        world.barrier(rank)
        msg.output_data = b"collectives-ok"
        return int(ReturnValue.SUCCESS)

    def fn_mpi_p2p_suite(self, msg, req):
        """mpi_send, mpi_sendrecv, mpi_barrier (barrier + alltoall rounds)
        and mpi_cart_create across worker processes."""
        world, rank = self._world(msg, 8400)
        size = world.size

        def fail(tag, got):
            msg.output_data = f"{tag}:{got}".encode()
            return int(ReturnValue.FAILED)

        if rank == 0:
            world.send(0, 1, np.array([42], np.int32))
        elif rank == 1:
            got, _ = world.recv(0, 1)
            if int(got[0]) != 42:
                return fail("send", int(got[0]))
        right, left = (rank + 1) % size, (rank - 1) % size
        got, _ = world.sendrecv(np.array([rank], np.int32), rank,
                                right, left, rank)
        if int(got[0]) != left:
            return fail("sendrecv", int(got[0]))
        # The reference example does 100 rounds; 10 still interleave
        for i in range(10):
            world.barrier(rank)
            contrib = np.full(size, rank * 100 + i, np.int32)
            mixed = world.alltoall(rank, contrib)
            expected = np.array([r * 100 + i for r in range(size)],
                                np.int32)
            if not np.array_equal(mixed, expected):
                return fail("alltoall", mixed.tolist())
        d1 = world.cart_create(world.cart_dims())
        d2 = world.cart_create(world.cart_dims())
        if d1 != d2 or world.cart_rank(world.cart_coords(rank)) != rank:
            return fail("cart_create", (d1, d2))
        world.barrier(rank)
        msg.output_data = b"p2p-suite-ok"
        return int(ReturnValue.SUCCESS)

    def fn_mpi_send_many(self, msg, req):
        """mpi_send_many.cpp: 100 rounds of rank 0 fanning one int to every
        rank and collecting one response each."""
        world, rank = self._world(msg, 8100)
        if rank == 0:
            for _ in range(100):
                for dest in range(1, world.size):
                    world.send(0, dest, np.array([100 + dest], np.int32))
                for r in range(1, world.size):
                    got, _ = world.recv(r, 0)
                    if int(got[0]) != 100 - r:
                        msg.output_data = f"bad:{r}:{got[0]}".encode()
                        return int(ReturnValue.FAILED)
        else:
            for _ in range(100):
                got, _ = world.recv(0, rank)
                if int(got[0]) != 100 + rank:
                    msg.output_data = f"bad:{got[0]}".encode()
                    return int(ReturnValue.FAILED)
                world.send(rank, 0, np.array([100 - rank], np.int32))
        msg.output_data = b"send-many-ok"
        world.barrier(rank)
        return int(ReturnValue.SUCCESS)

    def fn_mpi_checks(self, msg, req):
        """mpi_checks.cpp: world sanity, one fan-out of -100-rank,
        responses counted at rank 0."""
        world, rank = self._world(msg, 8200)
        if rank < 0 or world.size <= 1:
            return int(ReturnValue.FAILED)
        if rank == 0:
            for dest in range(1, world.size):
                world.send(0, dest, np.array([-100 - dest], np.int32))
            responses = 0
            for r in range(1, world.size):
                got, _ = world.recv(r, 0)
                if int(got[0]) == r:
                    responses += 1
            msg.output_data = f"checks:{responses}".encode()
            if responses != world.size - 1:
                return int(ReturnValue.FAILED)
        else:
            got, _ = world.recv(0, rank)
            if int(got[0]) != -100 - rank:
                msg.output_data = f"bad:{got[0]}".encode()
                return int(ReturnValue.FAILED)
            world.send(rank, 0, np.array([rank], np.int32))
            msg.output_data = b"checks-ok"
        world.barrier(rank)
        return int(ReturnValue.SUCCESS)

    def fn_mpi_typesize(self, msg, req):
        """mpi_typesize.cpp: MPI_Type_size over the datatype enum matches
        the C sizes."""
        from faabric_tpu_torch.mpi.api import mpi_type_size
        from faabric_tpu_torch.mpi.types import MpiDataType

        expected = {
            MpiDataType.INT: 4, MpiDataType.LONG: 8,
            MpiDataType.LONG_LONG: 8, MpiDataType.LONG_LONG_INT: 8,
            MpiDataType.DOUBLE: 8, MpiDataType.DOUBLE_INT: 12,
            MpiDataType.FLOAT: 4, MpiDataType.CHAR: 1,
        }
        for dt, size in expected.items():
            if mpi_type_size(dt) != size:
                msg.output_data = f"bad:{dt.name}".encode()
                return int(ReturnValue.FAILED)
        msg.output_data = b"typesize-ok"
        return int(ReturnValue.SUCCESS)

    def fn_mpi_cartesian(self, msg, req):
        """mpi_cartesian.cpp: cart_create, coords round-trip and a
        periodic shift."""
        world, rank = self._world(msg, 7900)
        world.cart_create(world.cart_dims())
        coords = world.cart_coords(rank)
        if world.cart_rank(coords) != rank:
            msg.output_data = f"roundtrip:{coords}".encode()
            return int(ReturnValue.FAILED)
        src, dst = world.cart_shift(rank, 0, 1)
        if dst != world.cart_rank((coords[0] + 1, coords[1])) or \
                src != world.cart_rank((coords[0] - 1, coords[1])):
            msg.output_data = f"shift:{src},{dst}".encode()
            return int(ReturnValue.FAILED)
        world.barrier(rank)
        msg.output_data = f"cart-ok:{coords[0]}x{coords[1]}".encode()
        return int(ReturnValue.SUCCESS)

    def fn_mpi_order(self, msg, req):
        """mpi_order.cpp: rank 0 sends to 1, 2 and 3 and receives their
        echoes out of order (3, 1, 2)."""
        world, rank = self._world(msg, 7600)
        if rank == 0:
            out = {1: 111, 2: 222, 3: 333}
            for dst, v in out.items():
                world.send(0, dst, np.array([v], np.int32))
            got = {}
            for src in (3, 1, 2):  # deliberately out of order
                arr, _ = world.recv(src, 0)
                got[src] = int(arr[0])
            if got != out:
                msg.output_data = f"mismatch:{got}".encode()
                return int(ReturnValue.FAILED)
            msg.output_data = b"order-ok"
        elif rank <= 3:
            arr, _ = world.recv(0, rank)
            world.send(rank, 0, arr)
            msg.output_data = f"echoed:{int(arr[0])}".encode()
        else:
            msg.output_data = b"idle"
        world.barrier(rank)
        return int(ReturnValue.SUCCESS)

    def fn_mpi_status(self, msg, req):
        """mpi_status.cpp: rank 1 probes, receives, and MPI_Get_count
        reports the count sent, not the buffer's capacity."""
        from faabric_tpu_torch.mpi.api import mpi_get_count

        world, rank = self._world(msg, 7300)
        actual_count = 40
        if rank == 0:
            world.send(0, 1, np.arange(actual_count, dtype=np.int32))
            msg.output_data = f"sent:{actual_count}".encode()
        elif rank == 1:
            st = world.probe(0, 1, timeout=20.0)
            if mpi_get_count(st) != actual_count:
                msg.output_data = f"probe:{st.count}".encode()
                return int(ReturnValue.FAILED)
            arr, st2 = world.recv(0, 1)
            if mpi_get_count(st2) != actual_count or arr.size != actual_count:
                msg.output_data = f"recv:{st2.count}".encode()
                return int(ReturnValue.FAILED)
            msg.output_data = f"got:{st2.count}".encode()
        else:
            msg.output_data = b"idle"
        world.barrier(rank)
        return int(ReturnValue.SUCCESS)

    def fn_mpi_isendrecv(self, msg, req):
        """mpi_isendrecv.cpp: irecv from the left, isend to the right,
        waitall."""
        world, rank = self._world(msg, 7400)
        right = (rank + 1) % world.size
        left = (rank - 1) % world.size
        recv_req = world.irecv(left, rank)
        send_req = world.isend(rank, right, np.array([rank], np.int32))
        results = world.waitall(rank, [recv_req, send_req])
        got = int(results[0][0][0])
        world.barrier(rank)
        if got != left:
            msg.output_data = f"r{rank}:got{got}wanted{left}".encode()
            return int(ReturnValue.FAILED)
        msg.output_data = f"r{rank}:async-ok".encode()
        return int(ReturnValue.SUCCESS)

    def fn_mpi_abort(self, msg, req):
        """Loops small allreduces with think-time. When a peer worker is
        SIGKILLed mid-loop, the surviving ranks' collective must raise
        MpiWorldAborted within the configured bound; reports
        ``aborted:<seconds from entering the failing collective>``."""
        from faabric_tpu_torch.mpi import MpiOp, MpiWorldAborted

        world, rank = self._world(msg, 9100)
        data = np.ones(1024, np.float32)
        t0 = time.monotonic()
        for _ in range(600):  # ≤30 s of rounds; the test kills a peer early
            t_round = time.monotonic()
            try:
                world.allreduce(rank, data, MpiOp.SUM)
            except MpiWorldAborted:
                elapsed = time.monotonic() - t_round
                msg.output_data = f"aborted:{elapsed:.2f}".encode()
                return int(ReturnValue.SUCCESS)
            time.sleep(0.05)
        msg.output_data = f"done:{time.monotonic() - t0:.1f}".encode()
        return int(ReturnValue.SUCCESS)

    def fn_mpi_partition(self, msg, req):
        """A network partition between a host pair (the reference's
        ``tests/dist/procs.py:928``): loops small allreduces; when the
        fault registry partitions this world's hosts (transport.send and
        transport.bulk ``kill_conn`` with src/dest ctx matchers), the
        abort machinery must surface MpiWorldAborted in bounded time,
        reported as ``aborted:<seconds>`` on world 9200."""
        from faabric_tpu_torch.mpi import MpiOp, MpiWorldAborted

        world, rank = self._world(msg, 9200)
        data = np.ones(1024, np.float32)
        for _ in range(600):
            t_round = time.monotonic()
            try:
                world.allreduce(rank, data, MpiOp.SUM)
            except MpiWorldAborted:
                elapsed = time.monotonic() - t_round
                msg.output_data = f"aborted:{elapsed:.2f}".encode()
                return int(ReturnValue.SUCCESS)
            time.sleep(0.05)
        msg.output_data = b"never-partitioned"
        return int(ReturnValue.FAILED)

    @staticmethod
    def _all_to_all_round(world, rank, i) -> bool:
        """The reference's doAllToAll (tests/dist/mpi/mpi_native.cpp):
        every rank exchanges a distinct row with every rank and checks
        the full matrix."""
        size = world.size
        rows = np.array([rank * 1000 + r * 10 + i for r in range(size)],
                        np.int64)
        out = np.asarray(world.alltoall(rank, rows)).reshape(size)
        want = np.array([r * 1000 + rank * 10 + i for r in range(size)],
                        np.int64)
        return bool((out == want).all())

    def fn_mpi_migrate(self, msg, req):
        """mpi_migration.cpp across worker processes: a world spread over
        both workers loops barrier + all-to-all; at the check iteration
        rank 0 asks the planner for a migration, moved ranks prepare the
        world and vacate with FunctionMigratedException, re-enter on the
        target host, and the world finishes its loops. Two changes to the
        reference's guest, for ranks that share a host's world object:
        the old group id is read before the migration point's barrier,
        and a barrier precedes ``prepare_migration`` (the first rank to
        prepare changes the shared group id)."""
        from faabric_tpu_torch.executor.executor import (
            FunctionMigratedException,
        )
        from faabric_tpu_torch.proto import BatchExecuteType

        world, rank = self._world(msg, 7950, size=3)
        my_host = self.scheduler.host
        pc = self.scheduler.planner_client
        loops, check = 8, 3
        migrated_entry = req.type == int(BatchExecuteType.MIGRATION)
        start = check + 1 if migrated_entry else 0
        if migrated_entry:
            # Complete the group's post-migration barrier: the stayed
            # ranks wait in theirs for every member, this one included
            self.scheduler.ptp_broker.post_migration_hook(
                msg.group_id, msg.group_idx)
            world.refresh_rank_hosts()
        for i in range(start, loops):
            world.barrier(rank)
            if not self._all_to_all_round(world, rank, i):
                msg.output_data = f"r{rank}:bad-alltoall@{i}".encode()
                return int(ReturnValue.FAILED)
            if i != check or migrated_entry:
                continue
            old_gid = world.group_id
            world.barrier(rank)
            if rank == 0:
                deadline = time.time() + 20
                dec = None
                while dec is None and time.time() < deadline:
                    dec = pc.check_migration(msg.app_id)
                    if dec is None:
                        time.sleep(0.25)
                flag = np.array([1 if dec is not None else 0], np.int64)
                world.broadcast(0, 0, flag)
            else:
                flag = world.broadcast(0, rank, np.zeros(1, np.int64))
            if int(np.asarray(flag)[0]) == 0:
                msg.output_data = f"r{rank}:no-migration".encode()
                return int(ReturnValue.FAILED)
            dec = pc.get_scheduling_decision(msg.app_id)
            deadline = time.time() + 10
            while (dec is None or dec.group_id == old_gid) \
                    and time.time() < deadline:
                time.sleep(0.1)
                dec = pc.get_scheduling_decision(msg.app_id)
            idx = dec.app_idxs.index(msg.app_idx)
            target = dec.hosts[idx]
            world.barrier(rank)
            world.prepare_migration(rank, dec.group_id)
            if target != my_host:
                raise FunctionMigratedException()
            self.scheduler.ptp_broker.post_migration_hook(
                dec.group_id, dec.group_idxs[idx])
            world.refresh_rank_hosts()
        world.barrier(rank)
        msg.output_data = f"r{rank}:migrate-ok:{my_host}".encode()
        return int(ReturnValue.SUCCESS)

    def fn_mpi_migrate_traffic(self, msg, req):
        """A world that migrates under traffic: the migration of
        :meth:`fn_mpi_migrate` while the world streams barrier and
        all-to-all rounds, every staying rank timing its pause from the
        migration point to its first round after it. Reports
        ``r<rank>:migrate-traffic-ok:<host>:<pause_ms>`` (-1 for the
        moved rank, whose wall time spans two executions). The same two
        changes to the reference's guest as :meth:`fn_mpi_migrate`."""
        from faabric_tpu_torch.executor.executor import (
            FunctionMigratedException,
        )
        from faabric_tpu_torch.proto import BatchExecuteType

        world, rank = self._world(msg, 7970, size=3)
        my_host = self.scheduler.host
        pc = self.scheduler.planner_client
        loops, check = 24, 6
        migrated_entry = req.type == int(BatchExecuteType.MIGRATION)
        start = check + 1 if migrated_entry else 0
        pause_ms = -1.0
        if migrated_entry:
            self.scheduler.ptp_broker.post_migration_hook(
                msg.group_id, msg.group_idx)
            world.refresh_rank_hosts()
            # The stayers' pause-measuring round
            world.barrier(rank)
            if not self._all_to_all_round(world, rank, 1000 + check):
                msg.output_data = f"r{rank}:bad-postmig".encode()
                return int(ReturnValue.FAILED)
        for i in range(start, loops):
            world.barrier(rank)
            if not self._all_to_all_round(world, rank, i):
                msg.output_data = f"r{rank}:bad-alltoall@{i}".encode()
                return int(ReturnValue.FAILED)
            if i != check or migrated_entry:
                continue
            t_pause = time.monotonic()
            old_gid = world.group_id
            world.barrier(rank)
            if rank == 0:
                deadline = time.time() + 20
                dec = None
                while dec is None and time.time() < deadline:
                    dec = pc.check_migration(msg.app_id)
                    if dec is None:
                        time.sleep(0.25)
                flag = np.array([1 if dec is not None else 0], np.int64)
                world.broadcast(0, 0, flag)
            else:
                flag = world.broadcast(0, rank, np.zeros(1, np.int64))
            if int(np.asarray(flag)[0]) == 0:
                msg.output_data = f"r{rank}:no-migration".encode()
                return int(ReturnValue.FAILED)
            dec = pc.get_scheduling_decision(msg.app_id)
            deadline = time.time() + 10
            while (dec is None or dec.group_id == old_gid) \
                    and time.time() < deadline:
                time.sleep(0.1)
                dec = pc.get_scheduling_decision(msg.app_id)
            idx = dec.app_idxs.index(msg.app_idx)
            target = dec.hosts[idx]
            world.barrier(rank)
            world.prepare_migration(rank, dec.group_id)
            if target != my_host:
                raise FunctionMigratedException()
            self.scheduler.ptp_broker.post_migration_hook(
                dec.group_id, dec.group_idxs[idx])
            world.refresh_rank_hosts()
            # The pause ends when the rewired world completes a round
            world.barrier(rank)
            if not self._all_to_all_round(world, rank, 1000 + i):
                msg.output_data = f"r{rank}:bad-postmig".encode()
                return int(ReturnValue.FAILED)
            pause_ms = (time.monotonic() - t_pause) * 1000.0
        world.barrier(rank)
        msg.output_data = (f"r{rank}:migrate-traffic-ok:{my_host}:"
                           f"{pause_ms:.0f}").encode()
        return int(ReturnValue.SUCCESS)

    def fn_spot(self, msg, req):
        """Spot freeze, then thaw on another host: the first entry stamps
        a marker into the executor's memory and waits to be frozen; once
        its app leaves the in-flight set it parks the live image on the
        planner's snapshot registry under the batch's key and vacates
        with FunctionFrozenException. The thawed entry, wherever it
        lands, finds the restored marker and reports its host."""
        from faabric_tpu_torch.executor.executor import (
            FunctionFrozenException,
        )
        from faabric_tpu_torch.snapshot import SnapshotData
        from faabric_tpu_torch.snapshot.remote import SnapshotClient

        pc = self.scheduler.planner_client
        # A marker slot a task: the batch's tasks share this memory
        off = 64 * (1 + msg.group_idx)
        marker = self.memory[off:off + 8].view(np.int64)
        if marker[0] == 4242:
            msg.output_data = f"thawed:{self.scheduler.host}".encode()
            return int(ReturnValue.SUCCESS)
        marker[0] = 4242
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                dec = pc.get_scheduling_decision(msg.app_id)
            except Exception:  # noqa: BLE001 — a planner blip: wait on
                dec = object()
            if dec is None:
                snap = SnapshotData(self.memory.tobytes())
                with self._batch_lock:
                    try:
                        SnapshotClient(pc.host).push_snapshot(
                            req.snapshot_key, snap)
                    except Exception:  # noqa: BLE001 — report, not wedge
                        msg.output_data = b"snapshot-park-failed"
                        return int(ReturnValue.FAILED)
                raise FunctionFrozenException()
            time.sleep(0.1)
        msg.output_data = b"never-frozen"
        return int(ReturnValue.FAILED)

    def fn_mpi_alltoall_sleep(self, msg, req):
        """mpi_alltoall_sleep.cpp: barrier + all-to-all rounds with a
        straggler (rank 3 sleeps 2 s) between two streams of rounds."""
        world, rank = self._world(msg, 7960)
        rounds = 50
        for i in range(rounds):
            world.barrier(rank)
            if not self._all_to_all_round(world, rank, i):
                msg.output_data = f"r{rank}:bad@{i}".encode()
                return int(ReturnValue.FAILED)
        if rank == 3:
            time.sleep(2.0)  # the straggler
        for i in range(rounds):
            world.barrier(rank)
            if not self._all_to_all_round(world, rank, rounds + i):
                msg.output_data = f"r{rank}:bad@{rounds + i}".encode()
                return int(ReturnValue.FAILED)
        world.barrier(rank)
        msg.output_data = f"r{rank}:alltoall-sleep-ok".encode()
        return int(ReturnValue.SUCCESS)

    def fn_threads(self, msg, req):
        counter = self.memory[:8].view(np.int64)
        # One executor runs all local threads; serialise the shared add
        with self._batch_lock:
            counter[0] += msg.group_idx + 1
        self.memory[512 * (1 + msg.group_idx)] = 200 + msg.group_idx
        return int(ReturnValue.SUCCESS)

    def fn_train(self, msg, req):
        """Data-parallel training: each rank takes the gradient of its own
        shard and allreduces it through faabric's MPI before the update,
        so every rank's parameters stay bit-identical. The reference's
        guest differentiates the JAX model; this one the port's, on the
        CPU."""
        import torch

        from faabric_tpu_torch.models import ModelConfig, Transformer, loss_fn
        from faabric_tpu_torch.mpi import MpiOp

        world, rank = self._world(msg, 7200, size=6)
        size = world.size
        cfg = ModelConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2,
                          d_ff=32, max_seq=16, compute_dtype=torch.float32,
                          remat=False)
        # Same seed everywhere → identical initial parameters
        model = Transformer(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        data_rng = np.random.RandomState(100 + rank)  # rank-local shard
        lr = 0.5
        for _ in range(3):
            tokens = torch.as_tensor(data_rng.randint(0, 64, (2, 8)))
            targets = torch.as_tensor(data_rng.randint(0, 64, (2, 8)))
            model.zero_grad(set_to_none=True)
            loss_fn(model, tokens, targets).backward()
            flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
            summed = world.allreduce(rank, flat.numpy().astype(np.float32),
                                     MpiOp.SUM) / size
            with torch.no_grad():
                off = 0
                for p in model.parameters():
                    n = p.numel()
                    p -= lr * torch.as_tensor(
                        np.asarray(summed[off:off + n])).view_as(p)
                    off += n
        # The parameter checksum agrees across ranks (synchronous training)
        checksum = float(sum(p.detach().abs().sum().item()
                             for p in model.parameters()))
        world.barrier(rank)
        msg.output_data = f"r{rank}:{checksum:.6f}".encode()
        return int(ReturnValue.SUCCESS)

    def fn_state(self, msg, req):
        """A non-master host pulls a shared value, doubles one chunk and
        pushes it back."""
        kv = self.scheduler.state.get_kv("dist", "shared")
        data = np.frombuffer(kv.get_chunk(0, 1024), dtype=np.uint8)
        kv.set_chunk(0, (data * 2).astype(np.uint8).tobytes())
        kv.push_partial()
        msg.output_data = b"state-ok"
        return int(ReturnValue.SUCCESS)

    def fn_state_claim(self, msg, req):
        """Claim the key named in input_data on this host (its first
        writer is its master) and seed a recognisable first chunk, so
        that a failover case knows which worker masters which key."""
        from faabric_tpu_torch.state import STATE_CHUNK_SIZE

        key = msg.input_data.decode()
        state = self.scheduler.state
        kv = state.get_kv("chaos", key, 4 * STATE_CHUNK_SIZE)
        kv.set_chunk(0, bytes([7]) * STATE_CHUNK_SIZE)
        kv.push_partial()
        msg.output_data = f"{key}@{state.host}".encode()
        return int(ReturnValue.SUCCESS)

    def fn_state_stale_probe(self, msg, req):
        """Try an acked write through the master KV this revived host
        still holds from before a failover promoted its backup; reports
        what happened (the epoch fence must refuse the ack)."""
        from faabric_tpu_torch.state import STATE_CHUNK_SIZE, StaleStateEpoch

        key = msg.input_data.decode()
        kv = self.scheduler.state.try_get_kv("chaos", key)
        if kv is None or not kv.is_master:
            msg.output_data = b"no-master-kv"
            return int(ReturnValue.SUCCESS)
        kv.set_chunk(0, b"\xee" * STATE_CHUNK_SIZE)
        try:
            kv.push_partial()
        except StaleStateEpoch:
            msg.output_data = b"fenced:StaleStateEpoch"
        except Exception as e:  # noqa: BLE001 — report, never ack
            msg.output_data = f"error:{type(e).__name__}".encode()
        else:
            msg.output_data = b"ACKED"
        return int(ReturnValue.SUCCESS)

    def fn_state_hot(self, msg, req):
        """Hammer the planted hot key from this (non-master) host: three
        full pulls and a two-chunk dirty push; reports the wire bytes it
        moved, which the statemap case holds against the ledger and the
        ``plane=state`` comm-matrix rows."""
        from faabric_tpu_torch.state import STATE_CHUNK_SIZE

        kv = self.scheduler.state.get_kv("dist", "hot")
        wire = 0
        for _ in range(3):
            kv.pull()
            wire += kv.size
        kv.set_chunk(0, b"\x09" * STATE_CHUNK_SIZE)
        kv.set_chunk(2 * STATE_CHUNK_SIZE, b"\x09" * STATE_CHUNK_SIZE)
        wire += kv.n_dirty_chunks() * STATE_CHUNK_SIZE
        kv.push_partial()
        msg.output_data = f"wire={wire}".encode()
        return int(ReturnValue.SUCCESS)

    def fn_profile_spin(self, msg, req):
        """Burn this executor thread in a distinctly named frame for
        input_data seconds, with two lock-convoy threads beside it: the
        hotspot and GIL pressure the merged /profile and the doctor must
        pin on this host and the ``executor/pool`` thread class."""
        dur = float(msg.input_data.decode() or "4")
        stop = threading.Event()
        lock = threading.Lock()

        def convoy():
            x = 0
            while not stop.is_set():
                with lock:
                    for _ in range(2_000):
                        x = (x * 48271) % 2147483647
                stop.wait(0.002)

        helpers = [threading.Thread(target=convoy, name=f"test/convoy@{i}",
                                    daemon=True) for i in range(2)]
        for t in helpers:
            t.start()
        try:
            _planted_profile_burn(dur)
        finally:
            stop.set()
            for t in helpers:
                t.join(timeout=5)
        msg.output_data = b"spun"
        return int(ReturnValue.SUCCESS)


def _planted_profile_burn(dur: float) -> None:
    """The frame the profile case looks for in the merged /profile: its
    name must stay unique in the tree."""
    end = time.monotonic() + dur
    x = 0
    while time.monotonic() < end:
        for _ in range(5_000):
            x = (x * 1103515245 + 12345) & 0x7FFFFFFF


class DistFactory(ExecutorFactory):
    def create_executor(self, msg):
        return DistExecutor(msg)


def _release_held_ports() -> None:
    """Close the listening sockets the parent held on this host's ports
    while the interpreter started: its servers bind them next."""
    for fd in filter(None, os.environ.pop("PROCS_HELD_FDS", "").split(",")):
        os.close(int(fd))


def _loaded_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules})


def _dump_telemetry(path: str) -> None:
    """This process's trace events, comm-matrix cells and Prometheus
    text, written to ``path`` (through a rename, so a reader never sees
    a partial file)."""
    from faabric_tpu_torch.telemetry import (
        get_comm_matrix,
        get_metrics,
        get_tracer,
        trace_events,
    )

    doc = {"process": get_tracer().process_label, "pid": os.getpid(),
           "trace": trace_events(),
           "cells": get_comm_matrix().snapshot().get("cells", []),
           "metrics": get_metrics().render_prometheus()}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def _serve_until_stdin_closes(ready: dict) -> None:
    """Print READY and the ready line, then serve ``dump`` commands from
    standard input until it closes or ``DIST_PROC_TTL`` passes."""
    ready["modules"] = _loaded_modules()
    print("READY", flush=True)
    print(json.dumps(ready), flush=True)
    closed = threading.Event()

    def read_commands():
        try:
            for line in sys.stdin:
                cmd, _, arg = line.strip().partition(" ")
                if cmd == "dump":
                    _dump_telemetry(arg)
        finally:
            closed.set()

    threading.Thread(target=read_commands, name="procs/stdin",
                     daemon=True).start()
    closed.wait(float(os.environ.get("DIST_PROC_TTL", "600")))


def run_planner(port_offset: int = 0) -> None:
    from faabric_tpu_torch.planner import PlannerServer, get_planner

    planner = get_planner()
    server = PlannerServer(port_offset=port_offset)
    _release_held_ports()
    server.start()
    endpoint = None
    http_port = int(os.environ.get("DIST_HTTP_PORT", "0"))
    try:
        if http_port:
            from faabric_tpu_torch.endpoint import PlannerHttpEndpoint

            endpoint = PlannerHttpEndpoint(port=http_port)
            endpoint.start()
        _serve_until_stdin_closes({
            "role": "planner", "boot": planner.boot_id,
            "journal": planner._journal.stats(),
            "lastReplay": planner._journal_replay_stats,
            "http": endpoint.port if endpoint else 0})
    finally:
        if endpoint is not None:
            endpoint.stop()
        server.stop()


def run_worker(host: str, planner_host: str = "127.0.0.1",
               slots: int = 4) -> None:
    from faabric_tpu_torch.runner import WorkerRuntime

    w = WorkerRuntime(host=host, slots=slots, n_devices=4,
                      factory=DistFactory(), planner_host=planner_host)
    _release_held_ports()
    w.start()
    try:
        _serve_until_stdin_closes({"role": "worker", "host": host})
    finally:
        w.shutdown()


# The reference planeworker's model (tests/dist/procs.py), fp32, remat
# off; attention and norm plain, as "auto" resolves them on the CPU (the
# flash kernels take no head dim 8)
STEP_CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq=16, remat=False, attention_impl="reference",
                norm_impl="reference")
# The reference's pipeline order: every pp partner pair spans the two
# processes; and an order in which every tp pair does
PP_ORDER = (0, 1, 4, 5, 2, 3, 6, 7)
TP_CROSS_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)
# Runs of plane_step_runs: the mesh's device order and axes, the pipeline
# schedule (None: the dense step), steps, remat, clip norm, accumulation
# steps, and the batches' RandomState seed (None continues the previous
# run's draws, as the reference's pipeline step continues its dense
# step's)
STEP_RUNS = {
    "dense": dict(order=tuple(range(8)), axes={"tp": 2}, steps=2, seed=0),
    "pp": dict(order=PP_ORDER, axes={"tp": 2, "pp": 2}, schedule="1f1b",
               steps=1),
    "tp_cross": dict(order=TP_CROSS_ORDER, axes={"tp": 2}, steps=2,
                     remat=True, seed=1),
    "clip": dict(order=tuple(range(8)), axes={"tp": 2}, steps=2, clip=0.05,
                 seed=2),
    # Each process holds half of each stage: the hops stay inside a
    # process, the stacked slabs' gradients cross over dp
    "pp_split": dict(order=tuple(range(8)), axes={"tp": 2, "pp": 2},
                     schedule="1f1b", steps=2, remat=True, seed=3),
    "accum": dict(order=tuple(range(8)), axes={"tp": 2}, steps=2, accum=2,
                  seed=4),
    # The forms across processes: GPipe on its explicit backward
    # schedule (every pp hop crossing, remat on), the ring over sp, the
    # MoE step with ep crossing, and MoE stages under both schedules
    # with every pp hop crossing
    "gpipe": dict(order=PP_ORDER, axes={"tp": 2, "pp": 2}, schedule="gpipe",
                  steps=2, remat=True, seed=5),
    "ring": dict(order=PP_ORDER, axes={"sp": 2, "tp": 2}, steps=2,
                 attention="ring", pair="sp", seed=6),
    "moe": dict(order=PP_ORDER, axes={"tp": 2, "ep": 2}, family="moe",
                steps=1, pair="ep", seed=7),
    "moe_1f1b": dict(order=PP_ORDER, axes={"pp": 2, "ep": 2}, family="moe",
                     schedule="1f1b", steps=1, seed=8),
    "moe_gpipe": dict(order=PP_ORDER, axes={"pp": 2, "ep": 2}, family="moe",
                      schedule="gpipe", steps=1, seed=9),
    # make_pp_loss's copies backpropagated with backward_copies (no
    # update), every pp hop crossing: its backward rounds follow the
    # GPipe schedule's, seeded at global rank 0 alone
    "pp_loss": dict(order=PP_ORDER, axes={"tp": 2, "pp": 2},
                    schedule="gpipe", loss=True, steps=1, seed=12),
    # Two more layouts: GPipe with each process holding half of each
    # stage (the hops inside a process, the stages' dp groups across),
    # and a ring of 4 with two positions in each process (three
    # rotations, one crossing the processes each way), both under remat
    "gpipe_split": dict(order=tuple(range(8)), axes={"tp": 2, "pp": 2},
                        schedule="gpipe", steps=2, remat=True, seed=10),
    "ring_sp4": dict(order=PP_ORDER, axes={"sp": 4}, steps=2, remat=True,
                     attention="ring", pair="sp", seed=11),
}
# The forms' runs of STEP_RUNS, in the reference's pipeline order, and
# the other layouts
FORM_RUNS = ("gpipe", "ring", "moe", "moe_1f1b", "moe_gpipe", "pp_loss")
FORM_LAYOUTS = ("gpipe_split", "ring_sp4")
# The MoE runs' family: STEP_CFG's widths with 4 experts
MOE_STEP_CFG = dict(n_experts=4)


def step_config(**changes):
    import torch

    from faabric_tpu_torch.models import ModelConfig

    return ModelConfig(**{**STEP_CFG, **changes}, compute_dtype=torch.float32)


def moe_step_config(**changes):
    import torch

    from faabric_tpu_torch.models import MoEConfig

    return MoEConfig(**{**STEP_CFG, **MOE_STEP_CFG, **changes},
                     compute_dtype=torch.float32)


def moe_step_params() -> dict:
    """The MoE runs' weights, the same in every process: a
    ``MoETransformer``'s draw from a CPU generator's seed 0, as the JAX
    package's pytree of numpy arrays."""
    import torch

    from faabric_tpu_torch.models import MoETransformer, params_to_numpy

    return params_to_numpy(MoETransformer(
        moe_step_config(), device="cpu",
        generator=torch.Generator().manual_seed(0)))


def plane_step_runs(devices, params, runs=("dense", "pp")) -> dict:
    """The sharded train steps of ``STEP_RUNS`` over the 8 entries of
    ``devices`` (the plane's global devices, or 8 entries of one device
    for the single-process mesh), from the JAX-layout pytree ``params``
    and ``RandomState`` batches. Returns, per run: the step losses of
    this process's first rank (every local rank's copy checked equal to
    it), the ranks this process holds, whether every pp (or tp) pair
    crosses processes, and the whole weights after the last step
    (``gathered()``, in every process), by leaf name. A ``loss`` run
    backpropagates ``make_pp_loss``'s copies with ``backward_copies``
    in place of a step, and leaves the weights as they were."""
    import numpy as np

    from faabric_tpu_torch.models import (
        data_sharding,
        make_moe_train_step,
        make_optimizer,
        make_train_step,
        params_from_jax,
    )
    from faabric_tpu_torch.models.train import backward_copies
    from faabric_tpu_torch.models.transformer import _leaves
    from faabric_tpu_torch.parallel import MeshConfig, build_mesh
    from faabric_tpu_torch.parallel.pipeline import (
        make_pp_loss,
        make_pp_train_step,
        microbatch,
        pp_data_sharding,
    )

    out = {}
    rng = None
    for name in runs:
        run = STEP_RUNS[name]
        schedule = run.get("schedule")
        moe = run.get("family") == "moe"
        if moe:
            cfg = moe_step_config(remat=run.get("remat", False))
        else:
            cfg = step_config(remat=run.get("remat", False),
                              attention_impl=run.get("attention",
                                                     "reference"))
        mesh = build_mesh([devices[i] for i in run["order"]],
                          MeshConfig(**run["axes"]))
        spec = make_optimizer(clip_norm=run.get("clip"))
        model = params_from_jax(moe_step_params() if moe else params, cfg,
                                mesh=mesh)
        opt = spec.init(model)
        if run.get("seed") is not None:
            rng = np.random.RandomState(run["seed"])
        pair = run.get("pair", "pp" if schedule else "tp")
        crossing = all(len({mesh.rank_process[r] for r in g}) == 2
                       for g in mesh.groups(pair))
        if run.get("loss"):
            pp_loss = make_pp_loss(cfg, mesh)

            def step(model, opt, tok, tgt):
                shard = pp_data_sharding(mesh).shard
                model.zero_grad(set_to_none=True)
                copies = pp_loss(model, shard(microbatch(tok, 2)),
                                 shard(microbatch(tgt, 2)))
                backward_copies(copies)
                model.allreduce_grads()
                return [None if c is None else c.detach() for c in copies]
        elif schedule:
            step = make_pp_train_step(cfg, spec, n_microbatches=2,
                                      schedule_name=schedule)
        elif moe:
            step = make_moe_train_step(cfg, spec)
        else:
            step = make_train_step(cfg, spec,
                                   accum_steps=run.get("accum", 1))
        losses = []
        for _ in range(run["steps"]):
            tok, tgt = (rng.randint(0, cfg.vocab_size, (8, 16))
                        .astype(np.int32) for _ in range(2))
            if not schedule:
                shard = data_sharding(mesh).shard
                tok, tgt = shard(tok), shard(tgt)
            loss = step(model, opt, tok, tgt)
            mine = [float(x) for x in loss if x is not None]
            assert len(set(mine)) == 1, mine
            losses.append(mine[0])
        grads = {k: spec.gather([None if p is None else p.grad
                                 for p in model.copies(k)])
                 for k, spec in model.specs.items()}
        out[name] = {"losses": losses, "ranks": mesh.local_ranks,
                     "crossing": crossing,
                     "params": {k: v.cpu().numpy() for k, v in
                                _leaves(model.gathered())},
                     "grads": {k: v.cpu().numpy() for k, v in grads.items()}}
    return out


# The collectives across processes: form → (method, keyword arguments;
# an op by its MpiOp name). Every one but allreduce_loop is
# backpropagated
COLLECTIVE_FORMS = {
    "alltoall": ("alltoall", {}),
    "scan_sum": ("scan", {"op": "SUM"}),
    "scan_prod": ("scan", {"op": "PROD"}),
    "scan_max": ("scan", {"op": "MAX"}),
    "scan_min": ("scan", {"op": "MIN"}),
    "broadcast": ("broadcast", {"root": 5}),
    "allreduce_max": ("allreduce", {"op": "MAX"}),
    "allreduce_min": ("allreduce", {"op": "MIN"}),
    "allreduce_prod": ("allreduce", {"op": "PROD"}),
    "allreduce_loop_sum": ("allreduce_loop", {"n": 3, "op": "SUM"}),
    "allreduce_loop_max": ("allreduce_loop", {"n": 3, "op": "MAX"}),
}
# Ring attention's blocks: (B, S, H, D) over (dp 2, sp 2, tp 2) in
# PP_ORDER, every sp ring crossing the processes
RING_SHAPE = (2, 32, 2, 16)


def collective_inputs(n: int = 8):
    """Every rank's (n, 6) fp32 buffer and cotangent (RandomState(40 + r)
    and (60 + r)), and ring attention's whole q, k, v and output
    cotangent (RandomState(80))."""
    import numpy as np

    bufs = [np.random.RandomState(40 + r).uniform(0.5, 1.5, (n, 6))
            .astype(np.float32) for r in range(n)]
    cots = [np.random.RandomState(60 + r).uniform(-1.0, 1.0, (n, 6))
            .astype(np.float32) for r in range(n)]
    rng = np.random.RandomState(80)
    ring = [rng.randn(*RING_SHAPE).astype(np.float32) for _ in range(4)]
    return bufs, cots, ring


def plane_collective_runs(devices) -> dict:
    """``COLLECTIVE_FORMS`` over ``DeviceCollectives`` of the 8 entries
    of ``devices`` (the plane's global devices, or 8 entries of one
    device), each rank's input :func:`collective_inputs`' buffer as a
    leaf, backpropagated (but ``allreduce_loop``) with its cotangent;
    and ``ring_attention`` over (dp 2, sp 2, tp 2) in ``PP_ORDER`` on
    each rank's sequence block of q, k and v, backpropagated with its
    block of the output cotangent. Returns {form: {"out": {rank: array},
    "grad": {rank: array}}} for this process's ranks (a rank whose input
    takes no gradient has none; ring attention's gradient stacks q's,
    k's and v's)."""
    import numpy as np
    import torch

    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.parallel import (
        DeviceCollectives,
        MeshConfig,
        ShardSpec,
        build_mesh,
        ring_attention,
    )

    bufs, cots, ring = collective_inputs()
    col = DeviceCollectives(devices)
    mine = col.local_ranks
    out = {}

    def record(ys, leaves):
        return {"out": {r: ys[r].detach().numpy() for r in mine},
                "grad": {r: leaves[r].grad.numpy() for r in mine
                         if leaves[r].grad is not None}}

    for form, (method, kw) in COLLECTIVE_FORMS.items():
        kw = {k: MpiOp[v] if k == "op" else v for k, v in kw.items()}
        xs = [torch.tensor(bufs[r], requires_grad=True) if r in mine
              else None for r in range(col.n)]
        if method == "allreduce_loop":
            with torch.no_grad():
                ys = getattr(col, method)(xs, **kw)
        else:
            ys = getattr(col, method)(xs, **kw)
            torch.autograd.backward([ys[r] for r in mine],
                                    [torch.tensor(cots[r]) for r in mine])
        out[form] = record(ys, xs)
    mesh = build_mesh([devices[i] for i in PP_ORDER],
                      MeshConfig(sp=2, tp=2))
    spec = ShardSpec(mesh, (None, "sp"))
    q, k, v, dout = (spec.shard(a) for a in ring)
    for t in (*q, *k, *v):
        if t is not None:
            t.requires_grad_()
    ys = ring_attention(q, k, v, mesh)
    mine = mesh.local_ranks
    torch.autograd.backward([ys[r] for r in mine], [dout[r] for r in mine])
    out["ring_attention"] = {
        "out": {r: ys[r].detach().numpy() for r in mine},
        "grad": {r: np.stack([t[r].grad.numpy() for t in (q, k, v)])
                 for r in mine}}
    return out


def changed_input_error(devices) -> str:
    """An allreduce MAX over ``DeviceCollectives`` of the 8 entries of
    ``devices`` whose local inputs change in place between its forward
    and its backward: the error the backward raises ("" where none).
    Across processes the replayed backward keeps the local inputs under
    autograd's version check, so each process raises before its round."""
    import torch

    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.parallel import DeviceCollectives

    bufs, cots, _ = collective_inputs()
    col = DeviceCollectives(devices)
    mine = col.local_ranks
    leaves = [torch.tensor(bufs[r], requires_grad=True) if r in mine
              else None for r in range(col.n)]
    xs = [None if x is None else x * 1 for x in leaves]
    ys = col.allreduce(xs, op=MpiOp.MAX)
    with torch.no_grad():
        for r in mine:
            xs[r].add_(1)
    try:
        torch.autograd.backward([ys[r] for r in mine],
                                [torch.tensor(cots[r]) for r in mine])
    except RuntimeError as e:
        return str(e)
    return ""


def save_collective_runs(path: str, runs: dict) -> None:
    """:func:`plane_collective_runs`' results as an ``.npz``."""
    import numpy as np

    np.savez(path, **{f"{form}/{kind}/{r}": a
                      for form, got in runs.items()
                      for kind, by_rank in got.items()
                      for r, a in by_rank.items()})


def load_collective_runs(path: str) -> dict:
    """The inverse of :func:`save_collective_runs`."""
    import numpy as np

    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            form, kind, r = key.split("/")
            got = out.setdefault(form, {"out": {}, "grad": {}})
            got[kind][int(r)] = f[key]
    return out


def save_step_runs(path: str, runs: dict) -> None:
    """:func:`plane_step_runs`' results as an ``.npz``: per run its
    losses, weights and last step's gradients."""
    import numpy as np

    np.savez(path, **{f"{run}/{k}": v for run, got in runs.items()
                      for k, v in [("losses", np.array(got["losses"])),
                                   *got["params"].items(),
                                   *((f"grad/{g}", a) for g, a in
                                     got["grads"].items())]})


def load_step_runs(path: str) -> dict:
    """The inverse of :func:`save_step_runs`."""
    import numpy as np

    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            run, _, name = key.partition("/")
            got = out.setdefault(run, {"params": {}, "grads": {}})
            if name == "losses":
                got["losses"] = list(f[key])
            elif name.startswith("grad/"):
                got["grads"][name[len("grad/"):]] = f[key]
            else:
                got["params"][name] = f[key]
    return out


def _step_weights(path: str) -> dict:
    """The weights an ``.npz`` holds by leaf name (the JAX package's
    ``init_params``), as the pytree."""
    import numpy as np

    from faabric_tpu_torch.models.transformer import _tree

    with np.load(path) as f:
        return _tree({k: f[k] for k in f.files})


def _collective_backwards(col, mine) -> bool:
    """``DeviceCollectives``' backward across processes, against closed
    forms: each process backpropagates its own ranks' outputs with
    cotangent ``c_r = r + 1`` on rank r (allgather's weighted by the
    position), and checks its ranks' input gradients."""
    import torch

    n = col.n
    dev = col.devices[mine[0]]

    def leaves(k):
        return [torch.full((k,), float(r + 1), device=dev,
                           requires_grad=True) if r in mine else None
                for r in range(n)]

    def back(outs, weight):
        roots = [(o, weight(r, o)) for r, o in enumerate(outs)
                 if o is not None]
        torch.autograd.backward([o for o, _ in roots], [g for _, g in roots])

    c = sum(range(1, n + 1))
    ok = True
    # allreduce SUM: every input's gradient is the sum of every c_r
    xs = leaves(4)
    back(col.allreduce(xs), lambda r, o: torch.full_like(o, r + 1.0))
    ok = ok and all(bool((xs[r].grad == c).all()) for r in mine)
    # allgather: a piece's gradient is its positions' weights summed
    # over every rank's output
    xs = leaves(2)
    w = torch.arange(2 * n, dtype=torch.float32, device=dev)
    back(col.allgather(xs), lambda r, o: w * (r + 1))
    ok = ok and all(torch.equal(xs[r].grad.cpu(),
                                (w[2 * r:2 * r + 2] * c).cpu())
                    for r in mine)
    # shift by 1 (a ring hop) and a pair swap, each one permute round:
    # the sender's value lands (zeros where nothing does), and the
    # inverse permutation brings the receiver's c back
    xs = leaves(3)
    outs = col.shift(xs, 1)
    ok = ok and all(bool((outs[r] == (r - 1) % n + 1).all()) for r in mine)
    back(outs, lambda r, o: torch.full_like(o, r + 1.0))
    ok = ok and all(bool((xs[r].grad == (r + 1) % n + 1).all())
                    for r in mine)
    xs = leaves(3)
    outs = col.permute(xs, [(0, n - 1), (n - 1, 0)])
    want = {0: n, n - 1: 1}
    ok = ok and all(bool((outs[r] == want.get(r, 0)).all()) for r in mine)
    back(outs, lambda r, o: torch.full_like(o, r + 1.0))
    ok = ok and all(bool((xs[r].grad == want.get(r, 0)).all()) for r in mine)
    return ok


def run_plane_worker(host: str, planner_host: str, slots: int,
                     n_procs: int, device: str = "cpu") -> None:
    """One process of a multi-process device plane (counterpart of
    ``tests/dist/procs.py::run_plane_worker``): a ``WorkerRuntime`` that
    joins an ``n_procs``-process plane through the planner at boot with
    four entries of ``device`` (``cpu``: gloo; ``cuda:0``: CUDA IPC
    windows on one card), then an allreduce, an allgather, a
    reduce_scatter and a broadcast over ``shard_stacked_addressable``
    whose shards live in every process, each process checking its own
    with ``addressable_shard``, and the backward of allreduce,
    allgather, a shift and a swap across the processes. Then the
    reference's two train steps over the plane's 8 devices: 2 steps over
    (dp 4, tp 2), and one 1F1B step over (dp 2, tp 2, pp 2) in the
    reference's interleaved order, where every pp hop crosses the
    processes, both at ``STEP_CFG`` from the weights of the ``.npz``
    named by ``PLANE_WEIGHTS`` (the JAX package's ``init_params``;
    without it, a torch generator's seed 0). With ``PLANE_OUT`` set it
    writes its losses and the whole weights after each run to
    ``<PLANE_OUT>/<host>.npz``. Prints one ``PLANE-OK``/``PLANE-FAIL``
    line with the global and local device counts, its ranks and the
    losses (the ready line carries it too)."""
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.parallel import (
        DeviceCollectives,
        global_devices,
        plane_summary,
    )
    from faabric_tpu_torch.runner import WorkerRuntime

    w = WorkerRuntime(host=host, slots=slots, n_devices=4,
                      factory=DistFactory(), planner_host=planner_host,
                      device_plane_size=n_procs,
                      plane_devices=[device] * 4)
    _release_held_ports()
    try:
        w.start()
        s = plane_summary()
        col = DeviceCollectives(global_devices())
        mine = col.local_ranks
        x = col.shard_stacked_addressable(
            {r: np.full(4096, float(r + 1), np.float32) for r in mine},
            (4096,), np.float32)
        out = col.allreduce(x, MpiOp.SUM)
        expected = col.n * (col.n + 1) / 2
        ok = all(bool((col.addressable_shard(out, r) == expected).all())
                 for r in mine)
        g = col.allgather(col.shard_stacked_addressable(
            {r: np.full(8, float(r), np.float32) for r in mine}, (8,),
            np.float32))
        got = col.addressable_shard(g, mine[0]).reshape(col.n, 8)
        ok = ok and all(bool((got[r] == r).all()) for r in range(col.n))
        # The other two forms: rank r gets segment r of the sum, and the
        # last rank's buffer reaches every rank
        rs = col.reduce_scatter(col.shard_stacked_addressable(
            {r: np.arange(4 * col.n) * (r + 1) for r in mine},
            (4 * col.n,), np.int64))
        total = np.arange(4 * col.n) * sum(range(1, col.n + 1))
        ok = ok and all(np.array_equal(
            col.addressable_shard(rs, r).cpu().numpy(),
            total[4 * r:4 * (r + 1)])
                        for r in mine)
        b = col.broadcast(x, root=col.n - 1)
        ok = ok and all(bool((col.addressable_shard(b, r) == col.n).all())
                        for r in mine)
        ok = ok and _collective_backwards(col, mine)
        # The reference's train steps across the processes
        import torch

        weights = os.environ.get("PLANE_WEIGHTS")
        if weights:
            params = _step_weights(weights)
        else:
            from faabric_tpu_torch.models import Transformer
            from faabric_tpu_torch.models.transformer import _param_tree

            params = _param_tree(Transformer(
                step_config(), device="cpu",
                generator=torch.Generator().manual_seed(0)))
        # One intra-op thread, as the single-process mesh it is held
        # against: a CPU reduction's order follows its threads
        torch.set_num_threads(1)
        runs = plane_step_runs(global_devices(), params)
        ok = ok and runs["pp"]["crossing"]
        if os.environ.get("PLANE_OUT"):
            save_step_runs(os.path.join(os.environ["PLANE_OUT"],
                                        f"{host}.npz"), runs)
        loss, pp_loss = runs["dense"]["losses"][-1], runs["pp"]["losses"][-1]
        line = (f"PLANE-{'OK' if ok else 'FAIL'} "
                f"gdev={s['global_devices']} ldev={s['local_devices']} "
                f"pp_loss={pp_loss:.6f} loss={loss:.6f} ranks={mine}")
    except Exception as e:  # noqa: BLE001 — reported on the line
        line = f"PLANE-FAIL err={e!r}"
    print(line, flush=True)
    try:
        _serve_until_stdin_closes({"role": "planeworker", "host": host,
                                   "plane": line})
    finally:
        w.shutdown()


if __name__ == "__main__":
    from faabric_tpu_torch.telemetry.flight import install_signal_dump
    from faabric_tpu_torch.util.crash import install_crash_handler

    install_crash_handler()
    install_signal_dump()
    role = sys.argv[1]
    if role == "planner":
        run_planner(int(sys.argv[2]) if len(sys.argv) > 2 else 0)
    elif role == "planeworker":
        run_plane_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                         int(sys.argv[5]), *sys.argv[6:7])
    else:
        run_worker(sys.argv[2],
                   sys.argv[3] if len(sys.argv) > 3 else "127.0.0.1",
                   int(sys.argv[4]) if len(sys.argv) > 4 else 4)
