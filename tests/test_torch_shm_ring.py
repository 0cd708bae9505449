"""The port's shared-memory ring against the JAX package's.

Counterpart of ``tests/unit/test_shm_ring.py``: its 7 cases on the
port's ``ShmRing`` (``transport/shm.py`` over ``util/csrc/shm_ring.cpp``),
then a ring created by one package and drained by the other, both ways,
bitwise: the file name, header and frame layout are the reference's.
Every blocking wait is bounded, so a broken ring fails a case rather
than hanging the worker.
"""

import os
import threading
import time

import numpy as np
import pytest

from faabric_tpu_torch.transport import shm
from faabric_tpu_torch.transport.shm import (
    DEFAULT_RING_BYTES,
    ShmRing,
    gc_stale_rings,
    shm_available,
)

pytestmark = pytest.mark.skipif(not shm_available(),
                                reason="no /dev/shm or native build")


def _pop(ring, timeout=5.0):
    """The next frame, waiting at most ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        frame = ring.try_pop()
        if frame is not None:
            return frame
        if time.monotonic() > deadline:
            raise TimeoutError(f"no frame on {ring.name}")
        ring.wait_data(20_000)


def test_push_pop_roundtrip_and_fifo():
    r = ShmRing.create("t1", 1 << 16)
    try:
        c = ShmRing.attach(r.name)
        assert c.try_pop() is None and c.peek() == -1
        r.try_push([b"alpha ", b"beta"])
        r.try_push([np.arange(100, dtype=np.uint8)])
        assert c.peek() == 10
        assert bytes(c.try_pop()) == b"alpha beta"
        np.testing.assert_array_equal(c.try_pop(),
                                      np.arange(100, dtype=np.uint8))
        c.close()
    finally:
        r.close()
    assert not os.path.exists("/dev/shm/" + r.name)


def test_wraparound_many_frames():
    r = ShmRing.create("t2", 1 << 14)
    c = ShmRing.attach(r.name)
    try:
        rng = np.random.RandomState(0)
        for i in range(200):
            frame = rng.randint(0, 256, rng.randint(1, 5000),
                                dtype=np.uint8).astype(np.uint8)
            assert r.try_push([frame])
            np.testing.assert_array_equal(c.try_pop(), frame, err_msg=str(i))
    finally:
        c.close()
        r.close()


def test_full_ring_rejects_then_drains():
    r = ShmRing.create("t3", 1 << 12)
    c = ShmRing.attach(r.name)
    try:
        pushed = 0
        while r.try_push([b"z" * 100]):
            pushed += 1
        assert pushed > 0
        assert not r.try_push([b"z" * 100])
        assert r.free_space() < 108
        drained = 0
        while c.try_pop() is not None:
            drained += 1
        assert drained == pushed
        assert r.try_push([b"z" * 100])
        # A blocking push on a full ring gives up at its timeout
        while r.try_push([b"z" * 100]):
            pass
        t0 = time.monotonic()
        assert not r.push([b"z" * 100], timeout=0.2)
        assert time.monotonic() - t0 < 2.0
    finally:
        c.close()
        r.close()


def test_oversize_frame_raises():
    r = ShmRing.create("t4", 1 << 12)
    try:
        with pytest.raises(ValueError, match="larger than ring"):
            r.try_push([b"x" * (1 << 13)])
    finally:
        r.close()


def test_attach_rejects_garbage_file():
    name = f"faabric-ring-garbage-torch-{os.getpid()}"
    path = os.path.join(shm.SHM_DIR, name)
    with open(path, "wb") as f:
        f.write(b"\x00" * 4096)
    try:
        with pytest.raises(ValueError, match="not a valid ring"):
            ShmRing.attach(name)
    finally:
        os.unlink(path)
    with pytest.raises(ValueError, match="bad ring name"):
        ShmRing.attach("../etc/passwd")


def test_concurrent_producer_consumer_threads():
    r = ShmRing.create("t5", 1 << 16)
    c = ShmRing.attach(r.name)
    n_frames, got = 500, []
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, rng.randint(1, 2000), dtype=np.uint8)
              .astype(np.uint8) for _ in range(n_frames)]
    errors = []

    def produce():
        for f in frames:
            if not r.push([f], timeout=10.0):
                errors.append("push timed out")
                return

    def consume():
        try:
            while len(got) < n_frames:
                got.append(_pop(c, timeout=10.0))
        except TimeoutError as e:
            errors.append(str(e))

    try:
        tp = threading.Thread(target=produce)
        tc = threading.Thread(target=consume)
        tp.start()
        tc.start()
        tp.join(15)
        tc.join(15)
        assert not tp.is_alive() and not tc.is_alive()
        assert not errors, errors
        assert len(got) == n_frames
        for a, b in zip(got, frames):
            np.testing.assert_array_equal(a, b)
    finally:
        c.close()
        r.close()


def test_default_capacity_is_power_of_two():
    assert DEFAULT_RING_BYTES & (DEFAULT_RING_BYTES - 1) == 0
    with pytest.raises(ValueError, match="power of two"):
        ShmRing.create("t6", 1000)


def test_gc_sweeps_rings_of_dead_creators():
    """A ring whose creator pid is gone is unlinked; a live one stays."""
    live = ShmRing.create("gc-live", 1 << 12)
    dead = os.path.join(shm.SHM_DIR, "faabric-ring-gc-dead-999999999-1")
    with open(dead, "wb") as f:
        f.write(b"\x00" * 64)
    try:
        assert gc_stale_rings() >= 1
        assert not os.path.exists(dead)
        assert os.path.exists(os.path.join(shm.SHM_DIR, live.name))
    finally:
        live.close()
        if os.path.exists(dead):
            os.unlink(dead)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("creator", ["port", "ref"])
def test_ring_shared_across_packages(creator):
    """One package creates and pushes (single frames, gathered frames,
    a batch of small ones, wrapping past the end), the other attaches
    and pops them bitwise, singly and in batches."""
    pytest.importorskip("jax")
    import ctypes

    from faabric_tpu.transport.shm import ShmRing as RefRing

    Producer, Consumer = ((ShmRing, RefRing) if creator == "port"
                          else (RefRing, ShmRing))
    prod = Producer.create("xpkg", 1 << 16)
    cons = Consumer.attach(prod.name)
    try:
        assert cons.capacity == prod.capacity == 1 << 16
        assert prod.name.startswith("faabric-ring-xpkg-")
        rng = np.random.default_rng(3)
        frames = [rng.integers(0, 256, rng.integers(1, 20_000),
                               dtype=np.uint8) for _ in range(40)]
        for i, f in enumerate(frames):
            split = f.size // 3
            assert prod.push([f[:split], f[split:]], timeout=5.0)
            got = _pop(cons)
            assert got.tobytes() == f.tobytes(), i
        small = [bytes([i]) * (i + 1) for i in range(20)]
        for f in small:
            assert prod.try_push([f])
        out = np.empty(4096, np.uint8)
        lens = (ctypes.c_uint64 * 64)()
        n = cons.pop_batch(out, lens, 64)
        assert n == len(small)
        off = 0
        for i in range(n):
            assert out[off:off + lens[i]].tobytes() == small[i]
            off += lens[i]
        assert cons.peek() == -1
    finally:
        cons.close()
        prod.close()
    assert not os.path.exists(os.path.join(shm.SHM_DIR, prod.name))
