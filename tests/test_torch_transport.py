"""The port's transport: framed TCP RPC and point-to-point groups.

Mirrors the RPC subset of ``tests/unit/test_transport.py`` and the group
cases of ``tests/unit/test_point_to_point.py`` on the port: frames,
sync and async sends, errors across the wire, the request latch, a
server restart under a kept-alive connection, host aliases; then two
brokers on aliased hosts with live point-to-point servers: local and
remote sends, sequence order restored on arrival, barriers, the
distributed lock, notify, mock recording. Every wait carries a timeout.
"""

import random
import socket
import threading
import time

import pytest

from faabric_tpu_torch.batch_scheduler import SchedulingDecision
from faabric_tpu_torch.transport.client import MessageEndpointClient, RpcError
from faabric_tpu_torch.transport.common import (
    clear_host_aliases,
    register_host_alias,
    resolve_host,
)
from faabric_tpu_torch.transport.message import (
    HEADER_FMT,
    MAGIC,
    MessageResponseCode,
    TransportError,
    TransportMessage,
    recv_frame,
    send_frame,
)
from faabric_tpu_torch.transport.point_to_point import PointToPointBroker
from faabric_tpu_torch.transport.ptp_remote import (
    PointToPointCall,
    PointToPointClient,
    PointToPointServer,
    clear_sent_ptp,
    get_lock_ops,
    get_sent_mappings,
    get_sent_ptp_messages,
    send_mappings_from_decision,
)
from faabric_tpu_torch.transport.server import (
    MessageEndpointServer,
    handler_response,
)
from faabric_tpu_torch.util.network import (
    SAFE_CLIENT_PORT_MIN,
    get_free_port,
)
from faabric_tpu_torch.util.queues import Queue
from faabric_tpu_torch.util.retry import CircuitBreaker, RetryPolicy
from faabric_tpu_torch.util.testing import set_mock_mode

WAIT = 10.0


@pytest.fixture(autouse=True)
def _reset_port_globals():
    yield
    set_mock_mode(False)
    clear_host_aliases()
    clear_sent_ptp()


class EchoServer(MessageEndpointServer):
    """Echoes sync requests; records async ones."""

    def __init__(self, async_port, sync_port):
        super().__init__(async_port, sync_port, label="echo", n_threads=2)
        self.async_received: Queue[TransportMessage] = Queue()

    def do_async_recv(self, msg):
        self.async_received.enqueue(msg)

    def do_sync_recv(self, msg):
        return TransportMessage(
            code=msg.code,
            header={"echo": msg.header, "len": len(msg.payload)},
            payload=msg.payload)


@pytest.fixture
def echo_server():
    async_port, sync_port = get_free_port(), get_free_port()
    server = EchoServer(async_port, sync_port)
    server.start()
    client = MessageEndpointClient("127.0.0.1", async_port, sync_port,
                                   timeout=5.0)
    try:
        yield server, client
    finally:
        client.close()
        server.stop()


def test_frame_roundtrip():
    a, b = socket.socketpair()
    try:
        send_frame(a, TransportMessage(code=7, header={"x": 1},
                                       payload=b"abc", seqnum=42))
        got = recv_frame(b)
    finally:
        a.close()
        b.close()
    assert (got.code, got.header, got.payload, got.seqnum) == (
        7, {"x": 1}, b"abc", 42)


def test_frame_large_payload():
    a, b = socket.socketpair()
    payload = bytes(range(256)) * 4096  # 1 MiB, over the one-send limit
    results = []
    t = threading.Thread(target=lambda: results.append(recv_frame(b)))
    t.start()
    try:
        send_frame(a, TransportMessage(code=1, payload=payload))
        t.join(timeout=WAIT)
    finally:
        a.close()
        b.close()
    assert not t.is_alive()
    assert results[0].payload == payload


def test_recv_frame_rejects_oversized_frames():
    """A corrupt frame with valid magic must not allocate gigabytes."""
    import struct

    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(HEADER_FMT, MAGIC, 1, 0, -1, 10, 2**48))
        with pytest.raises(TransportError, match="size bounds"):
            recv_frame(b)
    finally:
        a.close()
        b.close()


def test_sync_and_async_send(echo_server):
    server, client = echo_server
    resp = client.sync_send(5, header={"hello": "world"}, payload=b"data")
    assert resp.header == {"echo": {"hello": "world"}, "len": 4}
    assert resp.payload == b"data"
    assert resp.response_code == int(MessageResponseCode.SUCCESS)
    client.async_send(9, header={"n": 1}, payload=b"x")
    got = server.async_received.dequeue(timeout=WAIT)
    assert (got.code, got.header, got.payload) == (9, {"n": 1}, b"x")
    for i in range(50):
        assert client.sync_send(1, header={"i": i}).header["echo"]["i"] == i


def test_concurrent_clients(echo_server):
    server, _ = echo_server
    errors = []

    def worker(n):
        c = MessageEndpointClient("127.0.0.1", server.async_port,
                                  server.sync_port, timeout=5.0)
        try:
            for i in range(20):
                resp = c.sync_send(1, header={"w": n, "i": i})
                assert resp.header["echo"] == {"w": n, "i": i}
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(n,)) for n in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_error_propagation(echo_server):
    server, client = echo_server

    def boom(msg):
        raise ValueError("deliberate")

    server.do_sync_recv = boom
    with pytest.raises(RpcError, match="deliberate"):
        client.sync_send(1)
    server.do_sync_recv = lambda msg: handler_response(header={"ok": 1})
    assert client.sync_send(1).header == {"ok": 1}  # the connection lives


def test_request_latch(echo_server):
    server, client = echo_server
    server.set_request_latch()
    client.async_send(2, header={})
    server.await_request_latch()
    assert server.async_received.size() == 1


def test_client_source_ports_stay_above_the_listener_plan(echo_server):
    _, client = echo_server
    client.sync_send(1)
    assert client._socks["sync"].getsockname()[1] >= SAFE_CLIENT_PORT_MIN


def test_sync_send_retries_a_stale_connection_only_when_idempotent():
    """A server restarted between calls leaves the client a dead kept-
    alive connection: an idempotent call retries on a fresh dial, any
    other call surfaces the error (at most once)."""
    class Srv(MessageEndpointServer):
        def do_sync_recv(self, msg):
            return handler_response(header={"pong": True})

        def do_async_recv(self, msg):
            pass

    ap, sp = get_free_port(), get_free_port()
    srv = Srv(ap, sp)
    srv.start()
    cli = MessageEndpointClient("127.0.0.1", ap, sp, timeout=3.0)
    try:
        assert cli.sync_send(1, idempotent=True).header["pong"]
        srv.stop()
        srv = Srv(ap, sp)
        srv.start()
        assert cli.sync_send(1, idempotent=True).header["pong"]
        srv.stop()
        srv = Srv(ap, sp)
        srv.start()
        with pytest.raises(RpcError):
            cli.sync_send(1)
    finally:
        cli.close()
        srv.stop()


def test_breaker_opens_after_consecutive_failures():
    now = [0.0]
    b = CircuitBreaker(threshold=2, reset_after=5.0, clock=lambda: now[0])
    assert b.allow()
    b.record_failure()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    now[0] = 6.0
    assert b.allow() and not b.allow()  # one half-open trial
    b.record_success()
    assert b.state == "closed"
    policy = RetryPolicy(backoff=0.1, jitter=0.0)
    assert [policy.delay(i) for i in range(3)] == [0.1, 0.2, 0.4]
    port = get_free_port()  # nothing listens here
    cli = MessageEndpointClient("127.0.0.1", port, port, timeout=1.0,
                                retry_policy=RetryPolicy(
                                    max_attempts=1, breaker_threshold=1,
                                    breaker_reset=60.0))
    with pytest.raises(RpcError, match="failed"):
        cli.sync_send(1)
    with pytest.raises(RpcError, match="circuit open"):
        cli.sync_send(1)


def test_host_alias():
    register_host_alias("fake-host", "127.0.0.1", 100)
    assert resolve_host("fake-host", 8005) == ("127.0.0.1", 8105)
    assert resolve_host("other", 8005) == ("other", 8005)
    clear_host_aliases()
    assert resolve_host("fake-host", 8005) == ("fake-host", 8005)


# ---------------------------------------------------------------------------
# Point-to-point groups across two aliased hosts
# ---------------------------------------------------------------------------

def make_decision(group_id, placements):
    """placements: list of (host, group_idx)"""
    d = SchedulingDecision(app_id=group_id, group_id=group_id)
    for host, idx in placements:
        d.add_message(host, 1000 + idx, idx, idx)
    return d


@pytest.fixture
def two_host_ptp():
    """Two brokers with live PTP servers on aliased ports."""
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("ptpA", "127.0.0.1", base)
    register_host_alias("ptpB", "127.0.0.1", base + 1000)
    brokers = {h: PointToPointBroker(h) for h in ("ptpA", "ptpB")}
    servers = []
    try:
        for b in brokers.values():
            servers.append(PointToPointServer(b))
            servers[-1].start()
        yield brokers
    finally:
        for s in servers:
            s.stop()
        for b in brokers.values():
            b.clear()


def install(brokers, decision):
    for b in brokers.values():
        b.set_up_local_mappings_from_decision(decision)


def run_threads(fns, timeout=30.0):
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        return run

    ts = [threading.Thread(target=wrap(fn)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "thread hung"
    assert not errors, errors


def test_local_send_recv(two_host_ptp):
    d = make_decision(7, [("ptpA", 0), ("ptpA", 1)])
    install(two_host_ptp, d)
    a = two_host_ptp["ptpA"]
    a.send_message(7, 0, 1, b"hello")
    assert a.recv_message(7, 0, 1, timeout=WAIT) == b"hello"


def test_cross_host_send_recv(two_host_ptp):
    brokers = two_host_ptp
    install(brokers, make_decision(8, [("ptpA", 0), ("ptpB", 1)]))
    brokers["ptpA"].send_message(8, 0, 1, b"over-the-wire")
    assert brokers["ptpB"].recv_message(8, 0, 1, timeout=WAIT) == \
        b"over-the-wire"
    brokers["ptpB"].send_message(8, 1, 0, b"reply")
    assert brokers["ptpA"].recv_message(8, 1, 0, timeout=WAIT) == b"reply"
    with pytest.raises(TypeError, match="must be bytes"):
        brokers["ptpA"].send_message(8, 0, 1, object())


def test_arrivals_are_put_back_in_send_order(two_host_ptp):
    """Remote messages may reach the broker out of order (the server's
    worker threads race): their sequence numbers restore it."""
    brokers = two_host_ptp
    install(brokers, make_decision(9, [("ptpA", 0), ("ptpA", 1)]))
    a = brokers["ptpA"]
    payloads = [f"m{i}".encode() for i in range(10)]
    order = list(range(10))
    random.Random(9).shuffle(order)
    for seq in order:
        a.deliver(9, 0, 1, payloads[seq], seq)
    a.deliver(9, 0, 1, b"dup", 3)  # an already delivered number
    assert [a.recv_message(9, 0, 1, timeout=WAIT) for _ in range(10)] == \
        payloads
    with pytest.raises(TimeoutError):
        a.recv_message(9, 0, 1, timeout=0.05)


def test_remote_sends_keep_their_order(two_host_ptp):
    brokers = two_host_ptp
    install(brokers, make_decision(10, [("ptpA", 0), ("ptpB", 1)]))
    for i in range(40):
        brokers["ptpA"].send_message(10, 0, 1, f"x{i}".encode())
    got = [brokers["ptpB"].recv_message(10, 0, 1, timeout=WAIT)
           for _ in range(40)]
    assert got == [f"x{i}".encode() for i in range(40)]


def test_barrier_across_hosts(two_host_ptp):
    brokers = two_host_ptp
    install(brokers, make_decision(11, [("ptpA", 0), ("ptpB", 1),
                                        ("ptpB", 2)]))
    passed, hits = [], []

    def worker(broker, idx):
        def run():
            group = broker.get_group(11)
            for round_num in range(3):
                hits.append((idx, round_num))
                group.barrier(idx, timeout=WAIT)
                passed.append((idx, round_num))
        return run

    run_threads([worker(brokers["ptpA"], 0), worker(brokers["ptpB"], 1),
                 worker(brokers["ptpB"], 2)])
    # Nobody passes barrier N before everyone hit barrier N
    for idx, round_num in passed:
        assert {i for i, r in hits if r == round_num} == {0, 1, 2}
    assert len(passed) == 9


def test_single_host_barrier_times_out():
    broker = PointToPointBroker("solo")
    broker.set_up_local_mappings_from_decision(
        make_decision(12, [("solo", 0), ("solo", 1)]))
    with pytest.raises(TimeoutError, match="barrier"):
        broker.get_group(12).barrier(0, timeout=0.05)


def test_distributed_lock_mutual_exclusion(two_host_ptp):
    brokers = two_host_ptp
    install(brokers, make_decision(13, [("ptpA", 0), ("ptpB", 1),
                                        ("ptpB", 2)]))
    counter = {"v": 0, "max": 0, "in": 0}
    guard = threading.Lock()

    def worker(broker, idx):
        def run():
            group = broker.get_group(13)
            for _ in range(5):
                group.lock(idx)
                with guard:
                    counter["in"] += 1
                    counter["max"] = max(counter["max"], counter["in"])
                v = counter["v"]
                time.sleep(0.002)
                counter["v"] = v + 1
                with guard:
                    counter["in"] -= 1
                group.unlock(idx)
        return run

    run_threads([worker(brokers["ptpA"], 0), worker(brokers["ptpB"], 1),
                 worker(brokers["ptpB"], 2)])
    assert counter["max"] == 1
    assert counter["v"] == 15  # no lost updates


def test_recursive_and_plain_locks_exclude_each_other(two_host_ptp):
    brokers = two_host_ptp
    install(brokers, make_decision(14, [("ptpA", 0), ("ptpA", 1)]))
    group = brokers["ptpA"].get_group(14)
    group.lock(0, recursive=True)
    group.lock(0, recursive=True)  # re-entrant
    assert group.get_lock_owner(recursive=True) == 0
    acquired = threading.Event()

    def plain_locker():
        group.lock(1)
        acquired.set()

    t = threading.Thread(target=plain_locker)
    t.start()
    time.sleep(0.1)
    assert not acquired.is_set()
    group.unlock(0, recursive=True)
    assert not acquired.is_set()  # still held once
    group.unlock(0, recursive=True)
    assert acquired.wait(WAIT)
    assert group.get_lock_owner() == 1
    assert group.get_lock_owner(recursive=True) == -1
    group.unlock(1)
    assert group.get_lock_owner() == -1
    t.join(timeout=WAIT)
    assert not t.is_alive()


def test_notify(two_host_ptp):
    brokers = two_host_ptp
    install(brokers, make_decision(15, [("ptpA", 0), ("ptpB", 1),
                                        ("ptpB", 2)]))
    done = threading.Event()

    def main_waiter():
        brokers["ptpA"].get_group(15).notify(0, timeout=WAIT)
        done.set()

    t = threading.Thread(target=main_waiter)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()  # the main waits for both
    brokers["ptpB"].get_group(15).notify(1)
    brokers["ptpB"].get_group(15).notify(2)
    assert done.wait(WAIT)
    t.join(timeout=WAIT)
    assert not t.is_alive()


def test_mappings_and_clear_over_the_wire(two_host_ptp):
    """The planner's path: mappings pushed to each host's server carry
    the device ids and MPI ports; a clear drops the group."""
    brokers = two_host_ptp
    d = SchedulingDecision(app_id=16, group_id=16)
    d.add_message("ptpA", 1, 0, 0, mpi_port=8020, device_id=2)
    d.add_message("ptpB", 2, 1, 1, mpi_port=8021, device_id=3)
    send_mappings_from_decision(d)
    for b in brokers.values():
        b.wait_for_mappings(16, timeout=WAIT)
        assert b.group_size(16) == 2
        assert b.get_device_for_idx(16, 0) == 2
        assert b.get_device_for_idx(16, 1) == 3
        assert b.get_mpi_port_for_receiver(16, 1) == 8021
    assert brokers["ptpA"].get_idxs_registered_for_host(16, "ptpA") == {0}
    client = PointToPointClient("ptpB")
    try:
        client.clear_groups([16])
    finally:
        client.close()
    deadline = time.monotonic() + WAIT
    while brokers["ptpB"].group_exists(16) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not brokers["ptpB"].group_exists(16)
    assert brokers["ptpA"].group_exists(16)


def test_mock_mode_records_ptp():
    set_mock_mode(True)
    cli = PointToPointClient("phantom")
    cli.send_message(77, 0, 1, b"recorded")
    cli.group_lock(1, 77, 2)
    cli.group_unlock(1, 77, 2, recursive=True)
    send_mappings_from_decision(make_decision(77, [("phantom", 0)]))
    assert get_sent_ptp_messages() == [("phantom", 77, 0, 1, b"recorded")]
    assert get_sent_mappings()[0][0] == "phantom"
    assert get_sent_mappings()[0][1].group_id == 77
    assert get_lock_ops() == [
        (int(PointToPointCall.LOCK_GROUP), "phantom", 77, 2),
        (int(PointToPointCall.UNLOCK_GROUP_RECURSIVE), "phantom", 77, 2)]


@pytest.mark.parametrize("watched", [True, False])
def test_failed_send_to_a_watched_peer_aborts_the_group(watched):
    """A send whose RPC fails for good (retries and breaker spent) aborts
    a watched group — an MPI world — with one typed GroupAbortedError
    that names the dead link and goes to the peers; an unwatched group
    sees the transport error itself. (The port raised the RpcError in
    both cases, so a directed partition left the far side of an MPI
    world waiting on a sender that had given up.)"""
    from faabric_tpu_torch.transport import GroupAbortedError
    from faabric_tpu_torch.transport.client import RpcError

    broker = PointToPointBroker("near")
    broker.set_up_local_mappings_from_decision(
        make_decision(19, [("near", 0), ("far", 1)]))
    if watched:
        broker.watch_group(19)
    calls = []

    class DeadLink:
        def send_message(self, *args):
            calls.append(("send", args[:3]))
            raise RpcError("async send to far:8009 failed: refused")

        def abort_group(self, group_id, reason):
            calls.append(("abort", group_id))

    broker._shm_peer = lambda host: False  # the RPC plane, no dial
    broker._get_client = lambda host: DeadLink()
    want = GroupAbortedError if watched else RpcError
    with pytest.raises(want) as err:
        broker.send_message(19, 0, 1, b"x" * 64)
    if watched:
        assert err.value.reason == ("send to far failed: async send to "
                                    "far:8009 failed: refused")
        assert broker.group_aborted(19) == err.value.reason
        assert calls == [("send", (19, 0, 1)), ("abort", 19)]
    else:
        assert broker.group_aborted(19) is None
        assert calls == [("send", (19, 0, 1))]


def test_abort_wakes_blocked_receivers():
    broker = PointToPointBroker("solo")
    broker.set_up_local_mappings_from_decision(
        make_decision(18, [("solo", 0), ("solo", 1)]))
    from faabric_tpu_torch.transport import GroupAbortedError

    got = []

    def recv():
        try:
            broker.recv_message(18, 0, 1, timeout=WAIT)
        except GroupAbortedError as e:
            got.append(e.reason)

    t = threading.Thread(target=recv)
    t.start()
    time.sleep(0.05)
    broker.abort_group(18, "peer died")
    t.join(timeout=WAIT)
    assert not t.is_alive() and got == ["peer died"]
