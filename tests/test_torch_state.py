"""The port's state KV against the JAX package's, on the same inputs.

Counterparts of ``tests/unit/test_state.py`` (every case),
``tests/unit/test_state_replication.py`` (every case) and the
device-handle cases of ``tests/unit/test_device_resident.py``. Each scenario runs once on
each package (``REF``, ``PORT``) with the same bytes and keeps the
reference test's own assertions; the two runs' observations must then
be equal. Two-host scenarios stand up a planner and two worker runtimes
of each package on one port slot (``tests/conftest.py::next_port_base``),
the reference's at offsets 0, 500 and 1000 and the port's at 1500, 2000
and 2500. The cross-wire cases drive a port ``StateClient`` against a
reference ``StateServer`` and the reverse; the file-mode case shares one
key between a port process and a reference process. A guest's
``ctx.state()`` runs ``chip_smoke.py``'s phase 19 on a two-host port
runtime at a small width.

Isolation: ``STATE_DIR`` is the test's ``tmp_path``; the port's
device-handle registry, mock state requests, planner, config, mock mode
and host aliases are reset after every test (the suite's conftest resets
the reference's); nothing here sets ``os.environ`` at import.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import faabric_tpu.planner as ref_planner  # noqa: E402
import faabric_tpu.runner as ref_runner  # noqa: E402
import faabric_tpu.state as ref_state  # noqa: E402
import faabric_tpu.state.remote as ref_remote  # noqa: E402
import faabric_tpu.transport.common as ref_common  # noqa: E402
import faabric_tpu.util.config as ref_config  # noqa: E402
import faabric_tpu.util.testing as ref_testing  # noqa: E402

import faabric_tpu_torch.planner as port_planner  # noqa: E402
import faabric_tpu_torch.runner as port_runner  # noqa: E402
import faabric_tpu_torch.state as port_state  # noqa: E402
import faabric_tpu_torch.state.device_handle as port_handles  # noqa: E402
import faabric_tpu_torch.state.remote as port_remote  # noqa: E402
import faabric_tpu_torch.transport.common as port_common  # noqa: E402
import faabric_tpu_torch.util.config as port_config  # noqa: E402
import faabric_tpu_torch.util.testing as port_testing  # noqa: E402
from faabric_tpu_torch.executor import TorchExecutorFactory  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Pkg:
    """One package's state names, so one scenario runs on either."""
    name: str
    state: types.ModuleType
    remote: types.ModuleType
    planner: types.ModuleType
    runner: types.ModuleType
    common: types.ModuleType
    config: types.ModuleType
    testing: types.ModuleType

    def __repr__(self) -> str:
        return self.name

    def factory(self):
        return ({} if self is REF
                else {"factory": TorchExecutorFactory(device="cpu")})


REF = Pkg("faabric_tpu", ref_state, ref_remote, ref_planner, ref_runner,
          ref_common, ref_config, ref_testing)
PORT = Pkg("faabric_tpu_torch", port_state, port_remote, port_planner,
           port_runner, port_common, port_config, port_testing)


def both(scenario, *args):
    """Run ``scenario(pk, *args)`` on the reference, then on the port;
    their observations must be equal. Returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want, (got, want)
    return got


@pytest.fixture(autouse=True)
def _isolate(tmp_path, monkeypatch):
    monkeypatch.setenv("STATE_DIR", str(tmp_path / "state"))
    for pk in (REF, PORT):
        pk.config.get_system_config().reset()
    yield
    for pk in (REF, PORT):
        pk.testing.set_mock_mode(False)
        pk.state.reset_device_handles()
        pk.remote.clear_mock_state_requests()
    port_planner.get_planner().reset()
    port_common.clear_host_aliases()
    monkeypatch.undo()
    for pk in (REF, PORT):
        pk.config.get_system_config().reset()
    # Replication records "state" rows in each package's comm matrix: a
    # later test in the worker (the reference's process cases among
    # them) must not read them
    from tests.test_torch_mpi_world import reset_reference_links

    reset_reference_links()


def set_env(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for pk in (REF, PORT):
        pk.config.get_system_config().reset()


# ---------------------------------------------------------------------------
# Local (master-only) behaviour
# ---------------------------------------------------------------------------

def _master_roundtrip(pk):
    state = pk.state.State("hostX")
    kv = state.get_kv("demo", "k1", 256)
    assert kv.is_master
    data = bytes(range(256))
    kv.set(data)
    assert kv.get() == data
    chunk = kv.get_chunk(10, 20)
    kv.set_chunk(0, b"\xff" * 4)
    assert state.get_kv("demo", "k1") is kv
    return chunk, kv.get(), state.get_kv_count(), kv.n_dirty_chunks()


def test_master_kv_basic_roundtrip():
    chunk, image, count, dirty = both(_master_roundtrip)
    assert chunk == bytes(range(10, 30)) and image[:4] == b"\xff" * 4
    assert count == 1 and dirty == 1


def _master_appends(pk):
    kv = pk.state.State("hostX").get_kv("demo", "app", 8)
    kv.append(b"one")
    kv.append(b"two")
    got = kv.get_appended(2)
    with pytest.raises(ValueError):
        kv.get_appended(3)
    kv.clear_appended()
    with pytest.raises(ValueError):
        kv.get_appended(1)
    return got


def test_master_appends():
    assert both(_master_appends) == [b"one", b"two"]


def _bounds_and_sizes(pk):
    state = pk.state.State("hostX")
    kv = state.get_kv("demo", "b", 100)
    errors = []
    for call in (lambda: kv.get_chunk(90, 20),
                 lambda: kv.set_chunk(99, b"1234"),
                 lambda: kv.set(b"short"),
                 lambda: state.get_kv("demo", "nosize")):
        with pytest.raises(ValueError) as e:
            call()
        errors.append(type(e.value).__name__)
    return errors


def test_chunk_bounds_and_master_needs_size():
    assert both(_bounds_and_sizes) == ["ValueError"] * 4


def test_redis_mode_is_not_ported(monkeypatch):
    """``STATE_MODE=redis`` is served now (``tests/test_torch_redis.py``
    holds it against the reference): with no server to reach, both
    packages fail alike, with their ``RedisConnectionError``; an unknown
    mode is refused alike. (The test keeps the name it had while the port
    refused the mode, so that its runs stay comparable.)"""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # nothing listens there once closed
    set_env(monkeypatch, STATE_MODE="redis", REDIS_STATE_HOST="127.0.0.1",
            REDIS_PORT=str(port))
    for pk in (REF, PORT):
        with pytest.raises(ConnectionError, match="Cannot reach redis") as e:
            pk.state.State("hostX").get_kv("demo", "r", 8)
        assert type(e.value).__name__ == "RedisConnectionError"
    set_env(monkeypatch, STATE_MODE="bogus")
    for pk in (REF, PORT):
        with pytest.raises(ValueError, match="Unknown STATE_MODE"):
            pk.state.State("hostX").get_kv("demo", "r", 8)


# ---------------------------------------------------------------------------
# Two hosts: a planner and two worker runtimes of each package
# ---------------------------------------------------------------------------

class Cluster:
    def __init__(self, pk: Pkg, base: int) -> None:
        self.pk = pk
        reg = pk.common.register_host_alias
        reg("planner", "127.0.0.1", base)
        reg("stateA", "127.0.0.1", base + 500)
        reg("stateB", "127.0.0.1", base + 1000)
        self.planner = pk.planner.get_planner()
        self.planner.reset()
        self.server = pk.planner.PlannerServer(port_offset=base)
        self.server.start()
        self.workers = []
        try:
            for h in ("stateA", "stateB"):
                w = pk.runner.WorkerRuntime(host=h, slots=1,
                                            planner_host="planner",
                                            **pk.factory())
                self.workers.append(w)
                w.start()
        except BaseException:
            self.close()
            raise

    @property
    def states(self):
        return [w.state for w in self.workers]

    def close(self) -> None:
        for w in self.workers:
            w.shutdown()
        self.server.stop()
        self.planner.reset()
        self.pk.common.clear_host_aliases()


@pytest.fixture
def clusters():
    """``{REF: Cluster, PORT: Cluster}`` on one port slot."""
    from tests.conftest import next_port_base

    base = next_port_base()
    ref = Cluster(REF, base)
    try:
        port = Cluster(PORT, base + 1500)
    except BaseException:
        ref.close()
        raise
    yield {REF.name: ref, PORT.name: port}
    port.close()
    ref.close()


def on_clusters(clusters, scenario):
    """``scenario(pk, cluster)`` on each package's cluster; equal
    observations. Returns the port's."""
    return both(lambda pk: scenario(pk, clusters[pk.name]))


def _two_host_pull_push(pk, cl):
    master_state, replica_state = cl.states
    size = pk.state.STATE_CHUNK_SIZE * 3 + 100
    kv_m = master_state.get_kv("demo", "shared", size)
    assert kv_m.is_master
    content = np.arange(size, dtype=np.uint8)  # wraps mod 256
    kv_m.set(content.tobytes())
    kv_r = replica_state.get_kv("demo", "shared")
    assert not kv_r.is_master and kv_r.size == size
    part = kv_r.get_chunk(pk.state.STATE_CHUNK_SIZE, 10)
    pulled = int(kv_r._pulled.sum())
    whole = kv_r.get()
    kv_r.set_chunk(pk.state.STATE_CHUNK_SIZE * 2, b"\xab" * 16)
    dirty = kv_r.n_dirty_chunks()
    kv_r.push_partial()
    return (part, pulled, whole == content.tobytes(), dirty,
            kv_r.n_dirty_chunks(),
            kv_m.get_chunk(pk.state.STATE_CHUNK_SIZE * 2, 16))


def test_two_host_pull_push(clusters):
    size = 4096
    part, pulled, whole, dirty, after, seen = on_clusters(
        clusters, _two_host_pull_push)
    want = np.arange(size, size + 10) % 256
    assert part == want.astype(np.uint8).tobytes()
    assert (pulled, whole, dirty, after) == (1, True, 1, 0)
    assert seen == b"\xab" * 16


def _two_host_appends_and_locks(pk, cl):
    master_state, replica_state = cl.states
    kv_m = master_state.get_kv("demo", "applog", 8)
    kv_r = replica_state.get_kv("demo", "applog")
    kv_r.append(b"from-replica")
    kv_m.append(b"from-master")
    got = kv_r.get_appended(2)
    kv_r.clear_appended()
    with pytest.raises(Exception):
        kv_m.get_appended(1)
    kv_r.lock_global()
    kv_r.unlock_global()
    return got


def test_two_host_appends_and_locks(clusters):
    assert on_clusters(clusters, _two_host_appends_and_locks) == [
        b"from-replica", b"from-master"]


def _push_full_and_repull(pk, cl):
    master_state, replica_state = cl.states
    kv_m = master_state.get_kv("demo", "full", 64)
    kv_m.set(b"\x01" * 64)
    kv_r = replica_state.get_kv("demo", "full")
    first = kv_r.get()
    kv_r.set(b"\x02" * 64)
    kv_r.push_full()
    pushed = kv_m.get()
    kv_m.set(b"\x03" * 64)
    kv_r.pull()
    return first, pushed, kv_r.get()


def test_push_full_and_repull(clusters):
    assert on_clusters(clusters, _push_full_and_repull) == (
        b"\x01" * 64, b"\x02" * 64, b"\x03" * 64)


def test_large_values_travel_in_ranges(clusters, monkeypatch):
    """A value of several ranges (12 MiB + 5 bytes) crosses hosts in
    ``RANGE_BYTES`` frames: the reference pulls it a 4 KiB chunk an RPC,
    the port a range an RPC, and both give the same bytes, as do the
    pushes back (the port's ``push_full`` also in ranges)."""
    from faabric_tpu_torch.state.kv import RANGE_BYTES

    size = 3 * RANGE_BYTES + 5
    data = np.random.default_rng(3).integers(0, 256, size, np.uint8)
    calls = {"pull": 0, "push": 0}
    pull, push = port_remote.StateClient.pull_chunk, \
        port_remote.StateClient.push_chunk

    def count(kind, fn):
        def wrapped(self, *a, **kw):
            calls[kind] += 1
            return fn(self, *a, **kw)
        return wrapped

    monkeypatch.setattr(port_remote.StateClient, "pull_chunk",
                        count("pull", pull))
    monkeypatch.setattr(port_remote.StateClient, "push_chunk",
                        count("push", push))

    def scenario(pk, cl):
        master_state, replica_state = cl.states
        kv_m = master_state.get_kv("demo", "big", size)
        kv_m.set(data.tobytes())
        kv_r = replica_state.get_kv("demo", "big")
        got = kv_r.get() == data.tobytes()
        flipped = (255 - data).tobytes()
        kv_r.set(flipped)
        kv_r.push_full()
        kv_r.set_chunk(RANGE_BYTES - 3, b"\x07" * 8)
        kv_r.push_partial()
        return got, kv_m.get() == kv_r.get(), kv_m.get()[:16]

    got = on_clusters(clusters, scenario)
    assert got[:2] == (True, True)
    assert calls == {"pull": 4, "push": 4 + 1}


# ---------------------------------------------------------------------------
# The file authority: one key through STATE_DIR, whichever package
# ---------------------------------------------------------------------------

@pytest.fixture
def file_mode(monkeypatch, tmp_path):
    set_env(monkeypatch, STATE_MODE="file", STATE_DIR=str(tmp_path / "f"))
    return str(tmp_path / "f")


def _file_chunked_pull_push(pk):
    a, b = pk.state.State("fhostA"), pk.state.State("fhostB")
    size = pk.state.STATE_CHUNK_SIZE * 3 + 10
    kv_a = a.get_kv("demo", f"fkv-{pk.name}", size)
    kv_a.set(b"\x07" * size)
    kv_a.push_full()
    kv_b = b.get_kv("demo", f"fkv-{pk.name}")
    part = kv_b.get_chunk(pk.state.STATE_CHUNK_SIZE, 16)
    kv_b.set_chunk(0, b"\xee" * 8)
    dirty = kv_b.n_dirty_chunks()
    kv_b.push_partial()
    kv_a.pull()
    return kv_b.size, part, dirty, kv_a.get_chunk(0, 8)


def test_file_backend_chunked_pull_push(file_mode):
    size, part, dirty, seen = both(_file_chunked_pull_push)
    assert (size, part, dirty, seen) == (4096 * 3 + 10, b"\x07" * 16, 1,
                                         b"\xee" * 8)


def _file_appends_and_locks(pk):
    a, b = pk.state.State("fhostA"), pk.state.State("fhostB")
    kv_a = a.get_kv("demo", f"flog-{pk.name}", 8)
    kv_b = b.get_kv("demo", f"flog-{pk.name}", 8)
    kv_a.append(b"one")
    kv_b.append(b"two-longer")
    got = kv_b.get_appended(2)
    kv_a.clear_appended()
    with pytest.raises(ValueError):
        kv_b.get_appended(1)
    kv_a.lock_global()
    kv_a.unlock_global()
    with pytest.raises(ValueError, match="explicit size"):
        a.get_kv("demo", f"absent-{pk.name}")
    return got


def test_file_backend_appends_locks_and_missing_key(file_mode):
    assert both(_file_appends_and_locks) == [b"one", b"two-longer"]


_CHILD = """
import sys
sys.path.insert(0, {root!r})
from {pkg}.state.state import State
kv = State("child").get_kv("demo", "xproc")
assert kv.get_chunk(0, 5) == b"hello", kv.get_chunk(0, 5)
kv.set_chunk(5, b"world")
kv.push_partial()
kv.append(b"from-{pkg}")
print("OK")
"""


@pytest.mark.parametrize("parent,child", [(PORT, PORT), (PORT, REF),
                                          (REF, PORT)],
                         ids=["port-port", "port-reference",
                              "reference-port"])
def test_file_backend_cross_process(file_mode, parent, child):
    """Two OS processes share a key through the file authority with no
    server at all, whichever package each runs: the on-disk layout is
    the reference's."""
    kv = parent.state.State("parent").get_kv("demo", "xproc", 16)
    kv.set_chunk(0, b"hello")
    kv.push_partial()
    code = _CHILD.format(root=str(ROOT), pkg=child.name)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "STATE_MODE": "file",
                          "STATE_DIR": file_mode, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip().endswith("OK"), out.stderr[-2000:]
    kv.pull()
    assert kv.get_chunk(0, 10) == b"helloworld"
    assert kv.get_appended(1) == [f"from-{child.name}".encode()]


# ---------------------------------------------------------------------------
# The device view
# ---------------------------------------------------------------------------

def test_device_array_view_caches_and_invalidates():
    """The value as a tensor: cached until the host image changes, each
    refresh one counted H2D copy, writes back through set_from_device as
    one counted D2H copy; the same bytes as the reference's jax view."""
    import jax

    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )

    ref = ref_state.StateKeyValue("demo", "dev", 64, True, "h")
    kv = port_state.StateKeyValue("demo", "dev", 64, True, "h",
                                  device="cpu")
    init = np.arange(64, dtype=np.uint8).tobytes()
    ref.set(init)
    kv.set(init)
    reset_device_copy_totals()

    a = kv.get_device_array(dtype=torch.float32)
    assert kv.get_device_array(dtype=np.float32) is a  # one cache entry
    want = np.asarray(ref.get_device_array(dtype=np.float32))
    np.testing.assert_array_equal(a.numpy(), want)
    assert a.dtype == torch.float32 and a.shape == (16,)
    assert kv.get_device_array().dtype == torch.uint8  # bytes: a new entry
    assert device_copy_totals()["by_reason"] == {
        "h2d.state": {"count": 2, "bytes": 128}}

    for k in (ref, kv):
        k.set_chunk(0, b"\xff")
    c = kv.get_device_array(dtype=torch.float32)
    assert c is not a
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(ref.get_device_array(dtype=np.float32)))

    ref.set_from_device(jax.numpy.asarray(np.asarray(c)) * 0 + 1.0)
    kv.set_from_device(c * 0 + 1.0)
    assert kv.get() == ref.get()
    np.testing.assert_array_equal(np.frombuffer(kv.get(), np.float32),
                                  np.ones(16, np.float32))
    tot = device_copy_totals()["by_reason"]
    assert tot["h2d.state"] == {"count": 3, "bytes": 192}
    assert tot["d2h.state"] == {"count": 1, "bytes": 64}
    with pytest.raises(ValueError, match="bytes"):
        kv.set_from_device(torch.ones(3))
    bf = kv.get_device_array(torch.bfloat16)
    assert bf.shape == (32,)
    kv.set_from_device(bf)  # any dtype's bytes
    assert kv.get() == ref.get()


def test_device_view_defaults_to_the_card(monkeypatch):
    """A KV made without a device views on the card, and raises where
    there is none: no silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kv = port_state.State("hostX").get_kv("demo", "card", 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv.get_device_array(torch.float32)
    assert kv.get_device_array(torch.float32, device="cpu").shape == (4,)


# ---------------------------------------------------------------------------
# Consistent-hash placement (pure functions)
# ---------------------------------------------------------------------------

def test_ring_order_is_the_references():
    """Every key's ring order over several host sets is the reference's
    (the same keys and hosts give the same order), deterministic and
    blind to the hosts' order and repeats."""
    for n_hosts in (1, 2, 5, 9):
        hosts = [f"h{i}" for i in range(n_hosts)]
        for i in range(40):
            key = f"u/key{i}"
            order = port_state.ring_order(key, hosts)
            assert order == ref_state.ring_order(key, hosts)
            assert sorted(order) == sorted(hosts)
            assert order == port_state.ring_order(key, list(reversed(hosts)))
            assert order == port_state.ring_order(key, hosts + hosts[:2])
    assert port_state.ring_order("u/k", []) == []


def _placement(pk):
    hosts = [f"h{i}" for i in range(4)]
    picks = [pk.state.place_backup(f"u/key{i}", hosts, exclude=("h0",))
             for i in range(64)]
    assert all(b in hosts and b != "h0" for b in picks)
    return (picks, pk.state.place_backup("u/k", ["only"], exclude=("only",)),
            pk.state.place_backup("u/k", []))


def test_place_backup_excludes_and_spreads():
    picks, only, empty = both(_placement)
    assert len(set(picks)) == 3 and only == "" and empty == ""


def test_minimal_reshuffle_on_host_loss():
    hosts = [f"h{i}" for i in range(6)]
    keys = [f"u/key{i}" for i in range(200)]
    before = {k: port_state.place_backup(k, hosts) for k in keys}
    survivors = [h for h in hosts if h != "h3"]
    after = {k: port_state.place_backup(k, survivors) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert moved and all(before[k] == "h3" for k in moved)
    assert after == {k: ref_state.place_backup(k, survivors) for k in keys}


# ---------------------------------------------------------------------------
# The planner's placement: claim triples, failover, epochs
# ---------------------------------------------------------------------------

def _planner(pk, *hosts):
    p = pk.planner.Planner()
    for h in hosts:
        p.register_host(h, 2, 0)
    return p


def _claims(pk):
    pk.testing.set_mock_mode(True)
    p = _planner(pk, "h1", "h2", "h3")
    triple = p.claim_state_master("u", "k", "h1")
    assert triple[0] == "h1" and triple[2] == 1
    assert triple[1] == pk.state.place_backup("u/k", ["h2", "h3"])
    assert p.claim_state_master("u", "k", "h2") == triple
    return triple, p.state_placement()


def test_claim_triple_elects_consistent_hash_backup():
    triple, placement = both(_claims)
    assert placement == {"u/k": dict(zip(("master", "backup", "epoch"),
                                         triple))}


def test_replicas_zero_keeps_legacy_semantics(monkeypatch):
    set_env(monkeypatch, FAABRIC_STATE_REPLICAS="0")

    def scenario(pk):
        pk.testing.set_mock_mode(True)
        p = _planner(pk, "h1", "h2")
        return (p.claim_state_master("u", "k", "h1"),
                pk.remote._with_epoch({"user": "u"}, 0),
                pk.remote._with_epoch({"user": "u"}, 3))

    assert both(scenario) == (("h1", "", 0), {"user": "u"},
                              {"user": "u", "epoch": 3})


def _failover(pk):
    pk.testing.set_mock_mode(True)
    p = _planner(pk, "h1", "h2", "h3")
    master, backup, epoch = p.claim_state_master("u", "k", "h1")
    p.remove_host(master)
    m2, b2, e2 = p.claim_state_master("u", "k", "h3")
    assert m2 == backup and e2 == epoch + 1 and b2 and b2 != m2
    p.register_host(master, 2, 0)
    assert p.claim_state_master("u", "k", master)[0] == m2
    # An expired master fails over the same way
    p2 = _planner(pk, "h1", "h2", "h3")
    first = p2.claim_state_master("u", "x", "h2")
    p2._hosts[first[0]].register_ts -= 10 * \
        pk.config.get_system_config().planner_host_timeout
    p2.expire_hosts()
    return ((m2, b2, e2), p.state_placement(), first,
            p2.state_placement())


def test_failover_promotes_backup_bumps_epoch_and_fences_corpse():
    _, placement, first, expired = both(_failover)
    assert placement["u/k"]["epoch"] == 2
    assert expired["u/x"]["master"] == first[1]
    assert expired["u/x"]["epoch"] == 2


def test_journal_replays_failover_placement(monkeypatch, tmp_path):
    """A restarted planner knows the promoted owner and the fencing
    epoch: a revived former master cannot win an ack race against a
    journal that outlives the crash."""

    def scenario(pk):
        set_env(monkeypatch,
                FAABRIC_PLANNER_JOURNAL_DIR=str(tmp_path / pk.name),
                FAABRIC_PLANNER_RECONCILE_GRACE="30")
        pk.testing.set_mock_mode(True)
        p = _planner(pk, "h1", "h2", "h3")
        p.claim_state_master("u", "k", "h1")
        p.remove_host("h1")
        placement = p.state_placement()
        assert placement["u/k"]["epoch"] == 2
        p.flush_journal()
        p2 = pk.planner.Planner()
        try:
            assert p2.state_placement() == placement
        finally:
            p.close_journal()
            p2.close_journal()
        return placement

    both(scenario)


def _dead_backup(pk):
    pk.testing.set_mock_mode(True)
    p = _planner(pk, "h1", "h2", "h3")
    master, backup, epoch = p.claim_state_master("u", "k", "h1")
    p.remove_host(backup)
    m2, b2, e2 = p.claim_state_master("u", "k", "h1")
    assert (m2, e2) == (master, epoch) and b2 not in ("", backup)
    # Master and backup both gone: the key drops, its epoch stays
    p.remove_host(b2)
    p.remove_host(master)
    dropped = p.state_placement()
    p.register_host("h9", 2, 0)
    return (m2, b2, e2), dropped, p.claim_state_master("u", "k", "h9")


def test_dead_backup_is_replaced_without_epoch_bump():
    _, dropped, reclaimed = both(_dead_backup)
    assert dropped == {} and reclaimed == ("h9", "", 2)


# ---------------------------------------------------------------------------
# Replicas and promotion (one process, no RPC)
# ---------------------------------------------------------------------------

def _replica(pk):
    size = 2 * pk.state.STATE_CHUNK_SIZE
    rep = pk.state.StateReplica("u", "k", size, epoch=2)
    rep.apply_chunks(2, size, [(0, b"\x07" * 16)])
    rep.apply_append(2, size, [b"a", b"b"])
    with pytest.raises(pk.state.StaleStateEpoch):
        rep.apply_chunks(1, size, [(0, b"\xff" * 4)])
    with pytest.raises(ValueError):
        rep.apply_chunks(2, size, [(size - 2, b"1234")])
    rep.apply_append(3, size, [b"only"], replace=True)
    rep.apply_chunks(3, size + 8, [(size, b"grown!!!")])
    return rep.snapshot(), rep.size, rep.epoch


def test_replica_applies_fences_and_replaces():
    (image, appended, epoch), size, _ = both(_replica)
    assert image[:16] == b"\x07" * 16 and image[-8:] == b"grown!!!"
    assert (appended, epoch, size) == ([b"only"], 3, 8200)


def _self_promotion(pk):
    state = pk.state.State("hostX")
    data = bytes(range(256)) * 16
    state.apply_replica_chunks("u", "rk", 1, len(data), [(0, data)])
    state.apply_replica_append("u", "rk", 1, len(data), [b"v1"])
    assert state.replica_count() == 1
    assert state.maybe_self_promote("u", "rk", 1) is None
    kv = state.maybe_self_promote("u", "rk", 2)
    assert kv is not None and kv.is_master and kv.epoch == 2
    assert kv.get() == data
    return (kv.get_appended(1), state.replica_count(),
            state.promote_replica("u", "rk", 2, ""),
            state.promote_replica("u", "ghost", 5, ""))


def test_self_promotion_converts_replica_to_master():
    assert both(_self_promotion) == ([b"v1"], 0, True, False)


def _demotion(pk):
    state = pk.state.State("hostX")
    kv = state.get_kv("u", "dk", 128)
    kv.set(b"\x01" * 128)
    kv.append(b"kept")
    with pytest.raises(pk.state.StaleStateEpoch):
        state.apply_replica_chunks("u", "dk", 0, 128, [(0, b"\x02" * 8)])
    state.apply_replica_chunks("u", "dk", 1, 128, [(0, b"\x03" * 8)])
    assert state.try_get_kv("u", "dk") is None and kv._stale
    with pytest.raises(pk.state.StaleStateEpoch):
        kv.check_epoch(1)
    return state.replica_count(), state._replicas["u/dk"].snapshot()


def test_higher_epoch_replicate_demotes_stale_master():
    count, (image, appended, epoch) = both(_demotion)
    assert count == 1 and image == b"\x03" * 8 + b"\x01" * 120
    assert appended == [b"kept"] and epoch == 1


# ---------------------------------------------------------------------------
# Two hosts over RPC: forwards, failover, fencing
# ---------------------------------------------------------------------------

def _forwards(pk, cl):
    wa, wb = cl.workers
    size = pk.state.STATE_CHUNK_SIZE * 2
    kv = wa.state.get_kv("demo", "rep", size)
    assert kv.is_master and kv.backup_host == "stateB" and kv.epoch == 1
    data = np.arange(size, dtype=np.uint8).tobytes()
    kv.set(data)
    kv.push_partial()  # the master-local ack forwards the dirty chunks
    kv.append(b"journal-rec")
    image, appended, epoch = wb.state._replicas["demo/rep"].snapshot()
    return image == data, appended, epoch


def test_master_forwards_acked_writes_to_backup(clusters):
    assert on_clusters(clusters, _forwards) == (True, [b"journal-rec"], 1)


def _failover_over_rpc(pk, cl):
    wa, wb = cl.workers
    size = pk.state.STATE_CHUNK_SIZE * 3
    kv_a = wa.state.get_kv("demo", "fo", size)
    data = bytes([i % 251 for i in range(size)])
    kv_a.set(data)
    kv_a.push_partial()
    cl.planner.remove_host("stateA")
    deadline = time.time() + 10
    kv_b = None
    while time.time() < deadline:
        kv_b = wb.state.try_get_kv("demo", "fo")
        if kv_b is not None and kv_b.is_master:
            break
        time.sleep(0.05)
    assert kv_b is not None and kv_b.is_master, "backup never promoted"
    promoted = (kv_b.epoch, kv_b.get() == data)
    kv_a.set_chunk(0, b"\xee" * 8)
    with pytest.raises(pk.state.StaleStateEpoch):
        kv_a.push_partial()
    return promoted, kv_a._stale, kv_b.get_chunk(0, 8) == b"\xee" * 8


def test_failover_zero_loss_and_stale_master_cannot_ack(clusters):
    assert on_clusters(clusters, _failover_over_rpc) == ((2, True), True,
                                                         False)


def _anti_entropy(pk, cl):
    wa, wb = cl.workers
    size = pk.state.STATE_CHUNK_SIZE * 5 + 37
    kv = wa.state.get_kv("demo", "ae", size)
    data = np.random.default_rng(7).integers(0, 256, size,
                                             dtype=np.uint8).tobytes()
    kv.set(data)
    kv.append(b"a1")
    kv.append(b"a2")
    wb.state._replicas.pop("demo/ae", None)
    kv.full_sync_backup()
    image, appended, _ = wb.state._replicas["demo/ae"].snapshot()
    return image == data, appended


def test_anti_entropy_full_sync_is_byte_exact(clusters):
    assert on_clusters(clusters, _anti_entropy) == (True, [b"a1", b"a2"])


def test_remote_op_reresolves_after_failover(clusters):
    """A non-master KV whose cached master died re-claims through the
    planner and retries on the promoted backup, at the new epoch."""
    def scenario(pk, cl):
        wa, wb = cl.workers
        kv_b = wb.state.get_kv("demo", "rr", 64)
        kv_b.set(b"\x05" * 64)
        kv_b.push_full()
        kv_a = wa.state.get_kv("demo", "rr")
        assert kv_a.get() == b"\x05" * 64 and kv_a.master_host == "stateB"
        # stateB's backup is stateA: B leaves, A promotes its replica
        cl.planner.remove_host("stateB")
        deadline = time.time() + 10
        while time.time() < deadline:
            promoted = wa.state.try_get_kv("demo", "rr")
            if promoted is not None and promoted.is_master:
                break
            time.sleep(0.05)
        return promoted.is_master, promoted.epoch, promoted.get()

    assert on_clusters(clusters, scenario) == (True, 2, b"\x05" * 64)


# ---------------------------------------------------------------------------
# The wire: a client of one package against a server of the other
# ---------------------------------------------------------------------------

@pytest.fixture
def cross_servers():
    """A reference State and StateServer on host "xref" and a port one on
    "xport", both aliases known to both packages."""
    from tests.conftest import next_port_base

    base = next_port_base()
    for pk in (REF, PORT):
        pk.common.register_host_alias("xref", "127.0.0.1", base)
        pk.common.register_host_alias("xport", "127.0.0.1", base + 1000)
    servers = {}
    for pk, host in ((REF, "xref"), (PORT, "xport")):
        state = pk.state.State(host)
        server = pk.remote.StateServer(state, host)
        server.start()
        servers[pk.name] = (state, server)
    yield servers
    for state, server in servers.values():
        server.stop()
        state.clear()
    for pk in (REF, PORT):
        pk.common.clear_host_aliases()


def _over_the_wire(client_pk, server_state, host):
    size = 3 * 4096 + 11
    data = np.random.default_rng(5).integers(0, 256, size, np.uint8)
    kv = server_state.get_kv("u", "wire", size)
    kv.set(data.tobytes())
    c = client_pk.remote.StateClient(host)
    try:
        seen = [c.state_size("u", "wire"),
                c.pull_chunk("u", "wire", 4090, 100) == data[4090:4190].tobytes()]
        c.push_chunk("u", "wire", 8192, b"\x11" * 50)
        seen.append(kv.get_chunk(8192, 50) == b"\x11" * 50)
        c.append("u", "wire", b"v-one")
        c.append("u", "wire", b"v-two!")
        seen.append(c.pull_appended("u", "wire", 2))
        c.clear_appended("u", "wire")
        with pytest.raises(Exception, match="appended values"):
            c.pull_appended("u", "wire", 1)
        c.lock("u", "wire")
        c.unlock("u", "wire")
        # Fencing: an epoch older than the master's is refused by name
        kv.check_epoch(4)
        with pytest.raises(Exception, match="StaleStateEpoch"):
            c.pull_chunk("u", "wire", 0, 8, epoch=3)
        seen.append(c.pull_chunk("u", "wire", 0, 4, epoch=4)
                    == data[:4].tobytes())
        with pytest.raises(Exception, match="not master"):
            c.pull_chunk("u", "elsewhere", 0, 8)
        # Replication into the server host's replica, then its promotion
        c.replicate_chunks("u", "rep", 1, 64, [(0, b"\x01" * 32),
                                               (32, b"\x02" * 32)])
        c.replicate_append("u", "rep", 1, 64, [b"r1", b"r22"])
        seen.append(c.promote("u", "rep", 2, ""))
        promoted = server_state.try_get_kv("u", "rep")
        seen += [promoted.get(), promoted.get_appended(2), promoted.epoch,
                 c.promote("u", "ghost", 2, "")]
        c.delete("u", "wire")
        seen.append(server_state.try_get_kv("u", "wire") is None)
    finally:
        c.close()
    return seen


@pytest.mark.parametrize("client,server", [(PORT, REF), (REF, PORT)],
                         ids=["port-client-reference-server",
                              "reference-client-port-server"])
def test_state_calls_cross_the_wire(cross_servers, client, server):
    """Every state call, replication and promotion included, between the
    packages: the call numbers, header fields and binary tails are the
    reference's. The result equals the same package's own round trip."""
    host = "xref" if server is REF else "xport"
    state = cross_servers[server.name][0]
    got = _over_the_wire(client, state, host)
    state.clear()
    assert got == _over_the_wire(server, state, host)
    assert got[:3] == [3 * 4096 + 11, True, True]
    assert got[3] == [b"v-one", b"v-two!"]
    assert got[5:] == [True, b"\x01" * 32 + b"\x02" * 32, [b"r1", b"r22"],
                       2, False, True]


def test_a_port_kv_pulls_in_ranges_from_a_reference_master(cross_servers):
    """A port replica KV whose master is a reference host: the ranged
    pulls and pushes of a multi-range value are served by the reference
    server unchanged."""
    from faabric_tpu_torch.state.kv import RANGE_BYTES

    ref_state_obj = cross_servers[REF.name][0]
    size = 2 * RANGE_BYTES + 100
    data = np.random.default_rng(9).integers(0, 256, size, np.uint8)
    master = ref_state_obj.get_kv("u", "ranged", size)
    master.set(data.tobytes())
    client = port_remote.StateClient("xref")
    try:
        kv = port_state.StateKeyValue(
            "u", "ranged", size, False, "xref",
            client_factory=lambda host: client, local_host="portside",
            device="cpu")
        view = kv.get_device_array(torch.uint8)
        assert view.numpy().tobytes() == data.tobytes()
        kv.set_chunk(RANGE_BYTES + 1, b"\x42" * 10)
        kv.push_partial()
        kv.set((255 - data).tobytes())
        kv.push_full()
    finally:
        client.close()
    assert master.get() == (255 - data).tobytes()


# ---------------------------------------------------------------------------
# Device state handles
# ---------------------------------------------------------------------------

def test_device_handle_push_pull_by_reference():
    """The reference's case with a CPU tensor: push copies nothing, pull
    is the same tensor object, handles travel as dicts, pull_host is the
    one counted D2H copy; numpy arrays and bytes are refused. The
    handle's fields are the reference's for the same array."""
    import jax

    from faabric_tpu_torch.device_plane.copies import (
        device_copy_totals,
        reset_device_copy_totals,
    )

    values = np.arange(256, dtype=np.float32)
    ref_reg = ref_state.get_device_handle_registry()
    ref_h = ref_reg.push(7, 1, "weights",
                         jax.device_put(values, jax.local_devices()[0]))
    reg = port_state.get_device_handle_registry()
    tensor = torch.from_numpy(values.copy())
    reset_device_copy_totals()
    h = reg.push(7, 1, "weights", tensor)
    assert device_copy_totals()["count"] == 0
    want = {**ref_h.to_dict(), "device_id": -1}
    assert h.to_dict() == want and h.nbytes == ref_h.nbytes == 1024
    assert reg.pull(h) is tensor
    wire = h.to_dict()
    assert reg.pull(port_state.DeviceStateHandle.from_dict(wire)) is tensor
    assert reg.pull(wire) is tensor
    assert device_copy_totals()["count"] == 0

    host = reg.pull_host(h)
    assert host is not tensor and torch.equal(host, tensor)
    np.testing.assert_array_equal(host.numpy(), ref_reg.pull_host(ref_h))
    assert device_copy_totals()["by_reason"] == {
        "d2h.state": {"count": 1, "bytes": 1024}}
    for bad in (np.ones(4, np.float32), b"\x00" * 16):
        with pytest.raises(port_state.DeviceHandleError):
            reg.push(7, 0, "bad", bad)
    # snapshot_of tracks the handle's live tensor on its device
    snap = reg.snapshot_of(h)
    assert snap.shape == (256,) and snap.dtype == torch.float32
    assert not snap.dirty_pages(tensor).any()

    h2 = reg.push_from_host(7, 2, "placed", values, "cpu")
    assert torch.equal(reg.pull(h2), tensor)
    assert device_copy_totals()["by_reason"]["h2d.state"] == {
        "count": 1, "bytes": 1024}
    assert reg.summary()["count"] == 2 and reg.drop(h2)
    bf = reg.push(7, 3, "bf", torch.zeros(8, 4, dtype=torch.bfloat16))
    assert (bf.dtype, bf.nbytes, bf.shape) == ("bfloat16", 64, (8, 4))


def test_device_handle_migration_invalidation():
    def scenario(pk, arr):
        reg = pk.state.get_device_handle_registry()
        h9 = reg.push(9, 0, "acts", arr)
        h8 = reg.push(8, 0, "other", arr)
        dropped = reg.invalidate_world(9)
        for pull in (reg.pull, reg.pull_host):
            with pytest.raises(pk.state.StaleDeviceHandle):
                pull(h9)
        assert reg.pull(h8) is arr
        h9b = reg.push(9, 0, "acts", arr)
        assert reg.pull(h9b) is arr
        handles = importlib.import_module(pk.state.__name__
                                          + ".device_handle")
        return dropped, h9b.gen - h9.gen, reg.world_generation(9), \
            handles.invalidate_world(9)

    import jax

    values = np.ones(64, np.int32)
    want = scenario(REF, jax.device_put(values, jax.local_devices()[0]))
    assert scenario(PORT, torch.from_numpy(values)) == want == (1, 1, 1, 1)


def test_registry_cap_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv("FAABRIC_DEVICE_HANDLES_MAX", "3")
    port_state.reset_device_handles()
    reg = port_state.get_device_handle_registry()
    assert reg.max_handles == 3
    handles = [reg.push(1, 0, f"t{i}", torch.zeros(2)) for i in range(3)]
    with pytest.raises(port_state.DeviceHandleError, match="capacity"):
        reg.push(1, 0, "t3", torch.zeros(2))
    reg.drop(handles[0])
    reg.push(1, 0, "t3", torch.zeros(2))
    port_state.reset_device_handles()
    # No registry: nothing to invalidate, and none is made
    assert port_handles.invalidate_world(1) == 0
    monkeypatch.delenv("FAABRIC_DEVICE_HANDLES_MAX")
    assert port_state.get_device_handle_registry().max_handles == 256


def test_prepare_migration_invalidates_handles():
    """``MpiWorld.prepare_migration`` drops the world's handles, as the
    reference's does; other worlds' handles stay."""
    from faabric_tpu_torch.batch_scheduler import SchedulingDecision
    from faabric_tpu_torch.mpi import MpiWorld
    from faabric_tpu_torch.transport import PointToPointBroker

    broker = PointToPointBroker("dres")
    d = SchedulingDecision(app_id=823, group_id=823)
    for r in range(4):
        d.add_message("dres", 8230 + r, r, r, device_id=r)
    broker.set_up_local_mappings_from_decision(d)
    world = MpiWorld(broker, 823, 4, 823)
    world.refresh_rank_hosts()
    try:
        reg = port_state.get_device_handle_registry()
        h = reg.push(world.id, 0, "resid-state", torch.ones(128))
        other = reg.push(world.id + 1, 0, "other", torch.ones(4))
        world.prepare_migration(0)
        with pytest.raises(port_state.StaleDeviceHandle):
            reg.pull(h)
        assert reg.pull(other).shape == (4,)
        assert reg.world_generation(world.id) == 1
    finally:
        broker.clear()


# ---------------------------------------------------------------------------
# Guests: ctx.state() on a two-host port runtime
# ---------------------------------------------------------------------------

def test_guests_share_state_over_two_hosts():
    """``chip_smoke.py``'s phase 19 at a small width on the CPU: a guest
    writes the weights, four guests over both hosts pull them and score
    bit for bit as the writer, four add to a counter under the global
    lock (exact) and append once, and a device state handle passes
    between two guests of one host with no counted copy; then 19r, the
    same path on a Redis authority (a mini server of the test process,
    two readers placed one a host by a preloaded decision)."""
    import chip_smoke
    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.ops import _build
    from tests.conftest import next_port_base

    cfg = ModelConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=2,
                      d_ff=128, max_seq=512)
    launches = chip_smoke.state_phase(torch.device("cpu"), _build, cfg=cfg,
                                      iters=40, hosts=("sgA", "sgB"),
                                      base=next_port_base(), redis_iters=40)
    assert launches == {}  # CPU tensors take the kernels' plain versions
