"""The port's Redis layer and ``STATE_MODE=redis`` against the JAX
package's.

The 12 cases of ``tests/unit/test_redis.py`` on the port: the RESP
client against the port's ``MiniRedisServer`` (strings, ranges,
counters, expiry, sets, lists, BLPOP, WRONGTYPE, pipelines, the
compare-and-delete script, garbage input), then ``STATE_MODE=redis``
through the port's ``State``. Where the reference case sleeps, the
port's moves the server's clock (``miniserver._now``) or waits on an
event that the blocked call sets. Every server binds port 0.

Then both packages: one command script, errors included, gives the same
replies through each package's client against the other's server; a
key written through one package's ``RedisAuthority`` reads back byte
for byte through the other's over one server; and a KV's device view
over a Redis-backed key, and a device state handle made from its value,
hold the bytes the in-memory KV's do.
"""

import socket
import threading

import numpy as np
import pytest
import torch

from faabric_tpu_torch.redis import (
    MiniRedisServer,
    RedisClient,
    RedisError,
    clear_thread_clients,
)
from faabric_tpu_torch.redis import miniserver as mini_mod


@pytest.fixture()
def server():
    srv = MiniRedisServer()
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def client(server):
    cli = RedisClient("127.0.0.1", server.port)
    yield cli
    cli.close()


def test_strings_ranges_counters(client):
    assert client.ping()
    assert client.get("missing") is None
    client.set("k", b"hello world")
    assert client.get("k") == b"hello world"
    assert client.strlen("k") == 11
    assert client.getrange("k", 0, 4) == b"hello"
    assert client.getrange("k", -5, -1) == b"world"
    client.setrange("k", 6, b"redis")
    assert client.get("k") == b"hello redis"
    # A setrange past the end zero-fills
    client.setrange("k2", 4, b"xy")
    assert client.get("k2") == b"\x00\x00\x00\x00xy"
    assert client.append("k2", b"z") == 7
    assert client.incr("n") == 1
    assert client.incrby("n", 10) == 11
    assert client.decr("n") == 10
    assert client.exists("k")
    assert client.delete("k", "n") == 2
    assert not client.exists("k")


def test_set_nx_px_and_expiry(client, monkeypatch):
    now = [100.0]
    monkeypatch.setattr(mini_mod, "_now", lambda: now[0])
    assert client.set_nx_px("lock", b"tok1", 100)
    assert not client.set_nx_px("lock", b"tok2", 100)
    now[0] += 0.15
    # The TTL passed: the key is gone and NX succeeds again
    assert client.set_nx_px("lock", b"tok3", 10_000)
    assert client.get("lock") == b"tok3"
    assert client.del_if_eq("lock", b"wrong") is False
    assert client.del_if_eq("lock", b"tok3") is True
    assert client.get("lock") is None


def test_sets_and_lists(client):
    assert client.sadd("s", b"a", b"b") == 2
    assert client.sadd("s", b"a") == 0
    assert client.smembers("s") == {b"a", b"b"}
    assert client.sismember("s", b"a")
    assert client.scard("s") == 2
    assert client.srem("s", b"a") == 1

    client.rpush("q", b"1", b"2")
    client.lpush("q", b"0")
    assert client.llen("q") == 3
    assert client.lrange("q", 0, -1) == [b"0", b"1", b"2"]
    assert client.lpop("q") == b"0"
    assert client.rpop("q") == b"2"


def test_blpop_blocks_until_push(server, client):
    """The consumer is inside the server's BLPOP wait before the push."""
    waiting = threading.Event()
    cond = server.store.push_cond
    real_wait = cond.wait

    def wait(timeout=None):
        waiting.set()
        return real_wait(timeout)

    cond.wait = wait
    other = RedisClient("127.0.0.1", server.port)
    got = {}

    def consumer():
        got["v"] = client.blpop("bq", timeout_s=30)

    t = threading.Thread(target=consumer)
    t.start()
    assert waiting.wait(30)
    other.rpush("bq", b"payload")
    t.join(30)
    assert not t.is_alive()
    assert got["v"] == b"payload"
    assert other.blpop("bq", timeout_s=0.1) is None
    other.close()


def test_wrongtype_and_unknown_command(client):
    client.set("str", b"x")
    with pytest.raises(RedisError):
        client.rpush("str", b"y")
    with pytest.raises(RedisError):
        client.execute("NOSUCHCMD")
    # The connection is still usable after the errors
    assert client.ping()


def test_pipeline(client):
    replies = client.pipeline([("SET", "p", b"abcdef"),
                               ("GETRANGE", "p", 1, 3),
                               ("STRLEN", "p")])
    assert replies[1] == b"bcd"
    assert replies[2] == 6
    client.setrange_pipeline("p", [(0, b"XY"), (4, b"ZW")])
    assert client.get("p") == b"XYcdZW"


def test_pipeline_error_keeps_stream_in_sync(client):
    client.set("pstr", b"x")
    # The middle command errors (WRONGTYPE); every reply is still read,
    # so the connection stays usable and in sync
    with pytest.raises(RedisError):
        client.pipeline([("SET", "pk", b"1"),
                         ("RPUSH", "pstr", b"y"),
                         ("SET", "pk2", b"2")])
    assert client.get("pk") == b"1"
    assert client.get("pk2") == b"2"
    assert client.ping()


def test_eval_delifeq_and_unsupported_script(client):
    client.set("lk", b"tok")
    assert client.del_if_eq("lk", b"tok") is True
    assert client.get("lk") is None
    assert client.del_if_eq("lk", b"tok") is False
    with pytest.raises(RedisError):
        client.execute("EVAL", "return 1", 0)


def test_server_survives_garbage(server, client):
    s = socket.create_connection(("127.0.0.1", server.port))
    s.sendall(b"not resp at all\r\n")
    s.close()
    # A truncated frame: the header promises a bulk string, and the
    # sender goes away
    s2 = socket.create_connection(("127.0.0.1", server.port))
    s2.sendall(b"*2\r\n$3\r\nGET\r\n$100\r\nshort")
    s2.close()
    assert client.ping()


def _redis_env(monkeypatch, port: int) -> None:
    """``STATE_MODE=redis`` on ``port`` for both packages."""
    from faabric_tpu.util.config import get_system_config as ref_config

    from faabric_tpu_torch.util.config import get_system_config

    monkeypatch.setenv("STATE_MODE", "redis")
    monkeypatch.setenv("REDIS_STATE_HOST", "127.0.0.1")
    monkeypatch.setenv("REDIS_PORT", str(port))
    get_system_config().reset()
    ref_config().reset()


@pytest.fixture()
def redis_state_env(server, monkeypatch):
    _redis_env(monkeypatch, server.port)
    yield server
    monkeypatch.undo()
    from faabric_tpu.redis import clear_thread_clients as ref_clear
    from faabric_tpu.util.config import get_system_config as ref_config

    from faabric_tpu_torch.util.config import get_system_config

    get_system_config().reset()
    ref_config().reset()
    clear_thread_clients()
    ref_clear()


def test_state_mode_redis_end_to_end(redis_state_env):
    from faabric_tpu_torch.state import RedisAuthority, State

    # Two hosts (two State objects) over one Redis authority
    a = State("hostA", device=torch.device("cpu"))
    b = State("hostB", device=torch.device("cpu"))

    kv_a = a.get_kv("user", "key", 10_000)
    assert isinstance(kv_a.authority, RedisAuthority)
    data = (bytes(range(256)) * 40)[:10_000]
    kv_a.set(data)
    kv_a.push_full()

    kv_b = b.get_kv("user", "key")  # its size read from Redis
    assert kv_b.size == 10_000
    assert kv_b.get() == data

    # B's partial push shows in a fresh pull on A
    kv_b.set_chunk(5000, b"HELLO")
    kv_b.push_partial()
    kv_a.pull()
    assert kv_a.get_chunk(5000, 5) == b"HELLO"

    # Appends go through the list key
    kv_a.append(b"one")
    kv_b.append(b"two")
    assert kv_a.get_appended(2) == [b"one", b"two"]
    assert kv_a.get_appended(0) == []  # not "the whole list"
    kv_b.clear_appended()
    with pytest.raises(ValueError):
        kv_a.get_appended(1)

    a.clear()
    b.clear()


def test_state_redis_global_lock_mutual_exclusion(redis_state_env,
                                                  monkeypatch):
    """B waits on A's token: it has tried and failed before A lets go."""
    from faabric_tpu_torch.state import State

    st = State("hostA", device=torch.device("cpu"))
    kv = st.get_kv("user", "locked", 64)
    order = []
    refused = threading.Event()
    real_set_nx_px = RedisClient.set_nx_px

    def set_nx_px(self, key, value, px_ms):
        ok = real_set_nx_px(self, key, value, px_ms)
        if not ok:
            refused.set()
        return ok

    monkeypatch.setattr(RedisClient, "set_nx_px", set_nx_px)

    def contender():
        kv2 = State("hostB", device=torch.device("cpu")).get_kv(
            "user", "locked")
        kv2.lock_global()
        order.append("B")
        kv2.unlock_global()

    kv.lock_global()
    order.append("A")
    t = threading.Thread(target=contender)
    t.start()
    assert refused.wait(30)
    assert order == ["A"]  # B still waits on the token
    kv.unlock_global()
    t.join(30)
    assert order == ["A", "B"]


def test_redis_authority_creation_needs_size(redis_state_env):
    from faabric_tpu_torch.state import State

    with pytest.raises(ValueError, match="explicit size"):
        State("hostA", device=torch.device("cpu")).get_kv("user",
                                                         "never-created")


# ---------------------------------------------------------------------------
# Both packages
# ---------------------------------------------------------------------------
SCRIPT = [
    ("PING",),
    ("GET", "missing"),
    ("SET", "k", b"hello world"),
    ("GETRANGE", "k", 0, 4),
    ("GETRANGE", "k", -5, -1),
    ("SETRANGE", "k", 6, b"redis"),
    ("SETRANGE", "z", 3, b"\x00\xffq"),
    ("GET", "z"),
    ("STRLEN", "k"),
    ("APPEND", "k", b"!"),
    ("SETNX", "k", b"no"),
    ("SET", "nx", b"1", "NX", "PX", 60_000),
    ("SET", "nx", b"2", "NX", "PX", 60_000),
    ("INCR", "n"), ("INCRBY", "n", 41), ("DECR", "n"),
    ("INCR", "k"),
    ("SADD", "s", b"b", b"a", b"c"), ("SREM", "s", b"c"),
    ("SMEMBERS", "s"), ("SISMEMBER", "s", b"a"), ("SCARD", "s"),
    ("RPUSH", "q", b"1", b"2"), ("LPUSH", "q", b"0"), ("LLEN", "q"),
    ("LRANGE", "q", 0, -1), ("LRANGE", "q", -2, -1), ("LPOP", "q"),
    ("RPOP", "q"), ("BLPOP", "q", 1), ("BLPOP", "empty", 0.01),
    ("RPUSH", "k", b"x"), ("SADD", "q", b"x"), ("GET", "s"),
    ("EXISTS", "k", "s", "missing"), ("EXPIRE", "missing", 10),
    ("KEYS", "*"), ("KEYS", "n*"),
    ("EVAL", "return 1", 0),
    ("NOSUCHCMD", "x"),
    ("DEL", "k", "n", "missing"),
    ("FLUSHALL",), ("KEYS", "*"),
]


def _run_script(client_cls, port: int) -> list:
    cli = client_cls("127.0.0.1", port)
    out = []
    try:
        cli.execute("FLUSHALL")
        for cmd in SCRIPT:
            try:
                reply = cli.execute(*cmd)
            except Exception as e:  # noqa: BLE001 — errors are replies
                reply = ("error", type(e).__name__, str(e))
            out.append(reply)
        out.append(cli.del_if_eq("nothing", b"t"))
        out.append(cli.pipeline([("SET", "p", b"abc"), ("GETRANGE", "p",
                                                        1, 2)]))
    finally:
        cli.close()
    return out


def test_command_script_replies_equal_across_client_and_server():
    """Each package's client against each package's server: four runs
    of one script, replies and errors alike."""
    from faabric_tpu.redis import MiniRedisServer as RefServer
    from faabric_tpu.redis import RedisClient as RefClient

    replies = {}
    for sname, server_cls in (("ref", RefServer), ("port", MiniRedisServer)):
        srv = server_cls()
        srv.start()
        try:
            for cname, client_cls in (("ref", RefClient),
                                      ("port", RedisClient)):
                replies[(cname, sname)] = _run_script(client_cls, srv.port)
        finally:
            srv.stop()
    want = replies[("ref", "ref")]
    assert ("error", "RedisError") in {r[:2] for r in want
                                       if isinstance(r, tuple)}
    for pair, got in replies.items():
        assert got == want, pair


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_redis_authority_bytes_equal_across_packages(writer, server,
                                                     monkeypatch):
    """A key written and appended to through one package's
    ``RedisAuthority`` reads back byte for byte through the other's, and
    the two share its global lock."""
    from faabric_tpu.redis import clear_thread_clients as ref_clear
    from faabric_tpu.state.backend import RedisAuthority as RefAuthority

    from faabric_tpu_torch.state.backend import RedisAuthority

    _redis_env(monkeypatch, server.port)
    try:
        w_cls, r_cls = ((RefAuthority, RedisAuthority) if writer == "ref"
                        else (RedisAuthority, RefAuthority))
        data = np.random.RandomState(7).bytes(3 * 65536 + 11)
        w = w_cls("u", f"shared-{writer}", len(data))
        w.push_chunks([(0, data[:65536]), (65536, data[65536:])])
        w.append(b"first")
        w.append(b"second")
        r = r_cls("u", f"shared-{writer}", 0)
        assert r.size == len(data)
        assert r.pull_chunk(0, len(data)) == data
        assert r.get_appended(2) == [b"first", b"second"]
        w.lock()
        cli = RedisClient("127.0.0.1", server.port)
        try:
            assert not cli.set_nx_px(
                f"fstate:u/shared-{writer}:lock".encode(), b"x", 1000)
        finally:
            cli.close()
        w.unlock()
        r.lock()
        r.unlock()
        r.delete_keys()
        with pytest.raises(ValueError, match="explicit size"):
            w_cls("u", f"shared-{writer}", 0)
    finally:
        monkeypatch.undo()
        clear_thread_clients()
        ref_clear()
        from faabric_tpu.util.config import get_system_config as ref_config

        from faabric_tpu_torch.util.config import get_system_config

        get_system_config().reset()
        ref_config().reset()


def test_device_view_over_redis_key_equals_inmemory(redis_state_env,
                                                    monkeypatch):
    """A tensor written with ``set_from_device`` into a Redis-backed key
    comes back on another host's device view with the bytes that the
    in-memory KV's device view holds, and a device state handle made
    from either key's host value moves the same bytes with the same
    counted copies."""
    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )
    from faabric_tpu_torch.state import DeviceHandleRegistry, State
    from faabric_tpu_torch.util.config import get_system_config

    cpu = torch.device("cpu")
    t = torch.randn(4096, generator=torch.Generator().manual_seed(11))
    writer = State("hostA", device=cpu).get_kv("u", "dev", t.numel() * 4)
    writer.set_from_device(t)
    writer.push_full()
    reader = State("hostB", device=cpu).get_kv("u", "dev")
    reader.pull()
    over_redis = reader.get_device_array(torch.float32)

    monkeypatch.setenv("STATE_MODE", "inmemory")
    get_system_config().reset()
    local = State("hostC", device=cpu).get_kv("u", "dev", t.numel() * 4)
    local.set_from_device(t)
    in_memory = local.get_device_array(torch.float32)
    assert torch.equal(over_redis, t)
    assert over_redis.numpy().tobytes() == in_memory.numpy().tobytes()

    moved = {}
    for name, kv in (("redis", reader), ("inmemory", local)):
        reg = DeviceHandleRegistry()
        reset_device_copy_totals()
        host = np.frombuffer(kv.get(), dtype=np.float32).copy()
        handle = reg.push_from_host(0, 0, name, host, cpu)
        out = reg.pull_host(handle.to_dict())
        moved[name] = (out.numpy().tobytes(), device_copy_totals())
    assert moved["redis"] == moved["inmemory"]
    assert moved["redis"][0] == t.numpy().tobytes()
