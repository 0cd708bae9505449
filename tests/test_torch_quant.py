"""The port's int8 leader-ring link against the JAX package's.

Counterpart of the quant cases of ``tests/unit/test_mpi.py`` (:563-674)
and ``tests/unit/test_wire_codec.py``. ``Int8ChunkCodec``'s wire bytes
must equal the reference's, quantised and in the raw form, and
``leader_ring_codec`` must give the same verdicts. Then a 3 + 3 world of
each package on live servers in one port slot (the fixture of
``test_torch_mpi_world.py``), hier forced and int8 on: the port's
allreduce of the reference test's 120,000-element fp32 inputs must equal
the reference's bit for bit and agree across ranks; NaN propagates, int64
stays exact, and ``reduce_scatter`` stays unquantised. The knobs read at
import (``FAABRIC_ALLREDUCE_QUANT``, ``FAABRIC_WIRE_CODEC``,
``BULK_STRIPES``) are tested in a subprocess.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from faabric_tpu.mpi import quant as ref_quant  # noqa: E402
from faabric_tpu.transport import codec as ref_codec  # noqa: E402

from faabric_tpu_torch.mpi import quant as port_quant  # noqa: E402
from faabric_tpu_torch.transport import codec as port_codec  # noqa: E402
from tests.test_torch_mpi_world import TWO_HOSTS, Pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_governors():
    port_codec.reset_wire_governor()
    ref_codec.reset_wire_governor()
    yield
    port_codec.reset_wire_governor()
    ref_codec.reset_wire_governor()


def _chunks():
    rng = np.random.default_rng(5)
    return {
        "random": rng.uniform(-37.0, 37.0, 10_000).astype(np.float32),
        "tiny": (rng.standard_normal(4096) * 1e-30).astype(np.float32),
        "constant": np.full(64, 3.5, np.float32),
        "negative": np.full(64, -2.0, np.float32),
        "zero": np.zeros(64, np.float32),
        "empty": np.zeros(0, np.float32),
        "nan": np.array([1.0, np.nan, 2.0, 3.0], np.float32),
        "inf": np.array([1.0, np.inf, 2.0, -np.inf], np.float32),
        "float64": rng.standard_normal(100),
    }


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("case", list(_chunks()))
def test_int8_codec_bytes_equal_reference(case, quantize):
    chunk = _chunks()[case]
    port, ref = port_quant.Int8ChunkCodec(), ref_quant.Int8ChunkCodec()
    wire = port.encode(chunk, quantize=quantize)
    want = ref.encode(chunk, quantize=quantize)
    assert wire.dtype == want.dtype == np.uint8
    assert wire.tobytes() == want.tobytes()
    back, ref_back = port.decode(wire), ref.decode(want)
    assert back.dtype == np.float32 and back.flags.writeable
    assert back.tobytes() == ref_back.tobytes()
    # Each package decodes the other's wire
    assert ref.decode(wire).tobytes() == back.tobytes()
    if not quantize or case in ("nan", "inf"):
        # The raw passthrough form: bitwise, NaN and Inf kept
        np.testing.assert_array_equal(back, chunk.astype(np.float32))
    elif case == "random":
        scale = float(np.max(np.abs(chunk))) / 127.0
        assert float(np.max(np.abs(back - chunk))) <= scale / 2 + 1e-6
    elif case in ("constant", "negative", "zero"):
        np.testing.assert_array_equal(back, chunk)


def test_leader_ring_codec_verdicts_equal_reference():
    from faabric_tpu.mpi import MpiOp as RefOp
    from faabric_tpu.mpi import UserOp as RefUserOp

    from faabric_tpu_torch.mpi import MpiOp, UserOp

    for mode in ("int8", "", "INT8", "fp8"):
        for dtype in (np.float32, np.float64, np.int64, np.float16):
            for op in ("SUM", "MAX", "MIN", "PROD"):
                got = port_quant.leader_ring_codec(mode, dtype,
                                                   getattr(MpiOp, op))
                want = ref_quant.leader_ring_codec(mode, dtype,
                                                   getattr(RefOp, op))
                assert (got is None) == (want is None), (mode, dtype, op)
    assert port_quant.leader_ring_codec(
        "int8", np.float32, UserOp(lambda a, b: a + b, commute=True)) is None
    assert ref_quant.leader_ring_codec(
        "int8", np.float32, RefUserOp(lambda a, b: a + b,
                                      commute=True)) is None
    for knob in ("", "int8"):
        for spec in ("auto", "auto,quant", "delta,quant", "raw"):
            port_codec.set_wire_codec(spec)
            ref_codec.set_wire_codec(spec)
            assert port_quant.resolve_quant_mode(knob) == \
                ref_quant.resolve_quant_mode(knob), (knob, spec)


# ---------------------------------------------------------------------------
# A 3 + 3 world of each package, hier forced, int8 on
# ---------------------------------------------------------------------------

@pytest.fixture
def pair():
    p = Pair(TWO_HOSTS)
    p.set(hier_enabled="force", CHUNK_BYTES=64 * 1024)
    yield p
    p.close()


def _datas(seed=31, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int64:
        return {r: rng.integers(-9999, 9999, 120_000).astype(np.int64)
                for r in range(6)}
    return {r: rng.uniform(-1000, 1000, 120_000).astype(np.float32)
            for r in range(6)}


def test_hier_allreduce_int8_bitwise_equals_reference(pair):
    datas = _datas()
    exact = sum(datas.values())

    def fn(world, rank, pk):
        return world.allreduce(rank, datas[rank].copy(), pk.MpiOp.SUM)

    pair.set(allreduce_quant="int8")
    quant = pair.both(fn)  # rank by rank, bitwise against the reference
    for r in range(6):
        assert pair.port.world(r).rungs[(r, "allreduce")] == "hier"
        np.testing.assert_array_equal(quant[r], quant[0])
        assert quant[r].flags.writeable
    err = float(np.max(np.abs(quant[0] - exact)))
    assert 0 < err < 100, err
    # Off again: the exact hier path, bitwise against the reference too
    pair.set(allreduce_quant="")
    hier = pair.both(fn)
    assert not np.array_equal(hier[0], quant[0])


def test_hier_allreduce_int8_per_chunk_bound(pair):
    """With 2 leaders each element is quantised once, on the fold leg:
    within max|chunk| / 254 of the exact hier result, chunk by chunk,
    where the chunk is the sending leader's host-reduced one."""
    from faabric_tpu_torch.mpi.world import MpiWorld

    datas = _datas(seed=7)

    def fn(world, rank, pk):
        return world.allreduce(rank, datas[rank].copy(), pk.MpiOp.SUM)

    pair.port.set(allreduce_quant="int8")
    quant = pair.port.run(fn)
    pair.port.set(allreduce_quant="")
    exact = pair.port.run(fn)
    world = pair.port.world(0)
    topo = world.topology()
    leaders = list(topo.leaders)
    host_acc = [sum(datas[r] for r in topo.ranks_on_host(topo.host_of(ld)))
                for ld in leaders]
    seg = world._ring_segments(120_000, len(leaders))
    eps = np.finfo(np.float32).eps
    for s, (lo, hi) in enumerate(seg):
        for clo, chi in MpiWorld._ring_chunks(lo, hi, 4):
            peak = float(np.max(np.abs(host_acc[s][clo:chi])))
            err = float(np.max(np.abs(quant[0][clo:chi] - exact[0][clo:chi])))
            bound = peak / 254 + 4 * eps * (peak + float(
                np.max(np.abs(exact[0][clo:chi]))))
            assert err <= bound, (s, clo, err, bound)


def test_hier_allreduce_int8_nan_and_int64(pair):
    poisoned = _datas()
    poisoned[2][12345] = np.nan
    pair.set(allreduce_quant="int8")

    def fn(world, rank, pk):
        return world.allreduce(rank, poisoned[rank].copy(), pk.MpiOp.SUM)

    want, got = pair.ref.run(fn), pair.port.run(fn)
    for r in range(6):
        assert np.isnan(got[r][12345]), r
        assert np.array_equal(got[r], want[r], equal_nan=True), r
    idatas = _datas(dtype=np.int64)
    iout = pair.both(lambda w, r, pk: w.allreduce(
        r, idatas[r].copy(), pk.MpiOp.SUM))
    for r in range(6):
        np.testing.assert_array_equal(iout[r], sum(idatas.values()))


def test_quant_knob_never_touches_reduce_scatter(pair):
    datas = _datas(seed=33)

    def fn(world, rank, pk):
        return world.reduce_scatter(rank, datas[rank].copy(), pk.MpiOp.SUM)

    exact = pair.both(fn)
    pair.set(allreduce_quant="int8")
    quant = pair.both(fn)
    for r in range(6):
        np.testing.assert_array_equal(quant[r], exact[r])


def test_governor_quant_token_quantises_cross_machine_hops_only(pair):
    """No world knob, the governor's ``auto,quant``: both hosts are this
    machine, so every hop ships the raw form and the result is the exact
    one; ``delta,quant`` quantises every hop, like the knob."""
    datas = _datas(seed=9)

    def fn(world, rank, pk):
        return world.allreduce(rank, datas[rank].copy(), pk.MpiOp.SUM)

    exact = pair.both(fn)
    for spec in ("auto,quant", "delta,quant"):
        port_codec.set_wire_codec(spec)
        ref_codec.set_wire_codec(spec)
        got = pair.both(fn)
        same = np.array_equal(got[0], exact[0])
        assert same is (spec == "auto,quant"), spec


# ---------------------------------------------------------------------------
# Knobs read at import
# ---------------------------------------------------------------------------

_KNOB_PROGRAM = """
import json
from faabric_tpu.mpi import quant as rq
from faabric_tpu.transport import bulk as rb, codec as rc
from faabric_tpu_torch.mpi import quant as pq
from faabric_tpu_torch.mpi.world import MpiWorld
from faabric_tpu_torch.transport import bulk as pb, codec as pc
world = MpiWorld(None, 1, 1, 1)
print(json.dumps({
    "quant": [rq.ALLREDUCE_QUANT, pq.ALLREDUCE_QUANT, world.allreduce_quant],
    "codec": [sorted(rc.get_wire_governor().mode),
              sorted(pc.get_wire_governor().mode)],
    "stripes": [rb.BULK_STRIPES, pb.BULK_STRIPES],
}))
"""


@pytest.mark.parametrize("env", [
    {},
    {"FAABRIC_ALLREDUCE_QUANT": " INT8 ", "FAABRIC_WIRE_CODEC": "delta,quant",
     "BULK_STRIPES": "3"},
    {"FAABRIC_WIRE_CODEC": "zlib", "BULK_STRIPES": "0"},
])
def test_knobs_read_at_import(env):
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("FAABRIC_ALLREDUCE_QUANT", "FAABRIC_WIRE_CODEC",
                              "BULK_STRIPES")}
    child_env.update(env, JAX_PLATFORMS="cpu",
                     PYTHONPATH=REPO + os.pathsep + child_env.get(
                         "PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _KNOB_PROGRAM],
                          env=child_env, capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ref_q, port_q, world_q = out["quant"]
    assert ref_q == port_q == world_q == (
        "int8" if "FAABRIC_ALLREDUCE_QUANT" in env else "")
    assert out["codec"][0] == out["codec"][1]
    want_codec = env.get("FAABRIC_WIRE_CODEC", "auto")
    assert out["codec"][1] == sorted(want_codec.split(","))
    ref_s, port_s = out["stripes"]
    assert ref_s == port_s
    if "BULK_STRIPES" in env:
        assert port_s == int(env["BULK_STRIPES"])
    else:
        assert port_s == max(1, min(4, (os.cpu_count() or 2) // 2))
