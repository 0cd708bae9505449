"""int8 wire quantisation of the leader ring's fold (EQuARX style).

Counterpart of ``faabric_tpu/mpi/quant.py``. Opt in with
``FAABRIC_ALLREDUCE_QUANT=int8`` (read at import) or a world's
``MpiWorld.allreduce_quant``; like ``hier_enabled`` it must agree across
every host's world, or the ring's peers disagree on the wire format.
Then the hierarchical allreduce's LEADER ring, the only leg that crosses
machines, sends each pipeline chunk as int8 with one fp32 scale a chunk
instead of fp32: a quarter of the bytes.

Scope, as the reference's:
- allreduce only: the hierarchical reduce_scatter's leader ring stays
  exact;
- the fold (reduce-scatter) leg only: the allgather circulates the same
  folded buffers, so every rank holds the same (lossy) result;
- ``MpiOp.SUM`` over float32 only: other ops and dtypes keep the fp32
  wire;
- intra-host phases never quantise.

Error model: one quantisation bounds an element's error by scale / 2 =
max|chunk| / 254; a chunk is quantised again at each fold hop of the
leader ring, so with H leaders the bound grows with H - 1.

Wire format: one uint8 buffer a chunk, a 4-byte little-endian fp32
scale and then the int8 payload. A NaN scale marks the raw fp32 form,
for non-finite chunks (divergence must propagate) and for hops the
governor leaves unquantised. Each chunk describes itself, so the ring
needs no side channel.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# The module default; MpiWorld.allreduce_quant overrides it a world.
# "" (off) or "int8".
ALLREDUCE_QUANT = os.environ.get("FAABRIC_ALLREDUCE_QUANT", "").strip().lower()

_SCALE_FMT = "<f"
_SCALE_BYTES = struct.calcsize(_SCALE_FMT)


class Int8ChunkCodec:
    """Per-chunk max-abs int8 quantiser. Stateless; shared freely."""

    name = "int8"
    wire_dtype = np.uint8

    def encode(self, chunk: np.ndarray,
               quantize: bool = True) -> np.ndarray:
        """float32 chunk → a new uint8 buffer [scale | int8 payload],
        which the caller may hand to the transport without a copy.
        ``quantize=False``, and any non-finite chunk (a NaN would decode
        to 0, one Inf would flood the chunk with NaN), ships the raw
        fp32 form under a NaN scale."""
        chunk = np.ascontiguousarray(chunk, dtype=np.float32)
        peak = float(np.max(np.abs(chunk))) if chunk.size else 0.0
        if not quantize or not np.isfinite(peak):
            out = np.empty(_SCALE_BYTES + chunk.nbytes, dtype=np.uint8)
            out[:_SCALE_BYTES] = np.frombuffer(
                struct.pack(_SCALE_FMT, float("nan")), dtype=np.uint8)
            out[_SCALE_BYTES:] = chunk.view(np.uint8)
            return out
        scale = peak / 127.0 if peak > 0.0 else 1.0
        q = np.rint(chunk * (1.0 / scale))
        np.clip(q, -127, 127, out=q)
        out = np.empty(_SCALE_BYTES + chunk.size, dtype=np.uint8)
        out[:_SCALE_BYTES] = np.frombuffer(
            struct.pack(_SCALE_FMT, scale), dtype=np.uint8)
        out[_SCALE_BYTES:] = q.astype(np.int8).view(np.uint8)
        return out

    def decode(self, buf: np.ndarray) -> np.ndarray:
        """uint8 wire buffer → a new writable float32 chunk (the
        receiver folds into it in place)."""
        buf = buf.view(np.uint8).reshape(-1)
        (scale,) = struct.unpack(_SCALE_FMT, buf[:_SCALE_BYTES].tobytes())
        if np.isnan(scale):
            return buf[_SCALE_BYTES:].view(np.float32).copy()
        out = buf[_SCALE_BYTES:].view(np.int8).astype(np.float32)
        out *= scale
        return out


_INT8 = Int8ChunkCodec()


def resolve_quant_mode(world_knob: str) -> str:
    """A world's effective quant mode: its knob wins, else the wire-codec
    governor's ``quant`` token enables it. The same on every host: both
    inputs are configuration."""
    from faabric_tpu_torch.transport.codec import get_wire_governor

    return get_wire_governor().quant_mode(world_knob)


def leader_ring_codec(mode, dtype, op) -> Int8ChunkCodec | None:
    """The codec the leader ring applies for (mode, dtype, op), or None
    for the fp32 wire. Every leader derives the same verdict from the
    world's knob and the collective's own payload."""
    from faabric_tpu_torch.mpi.types import MpiOp

    if mode != "int8":
        return None
    if np.dtype(dtype) != np.float32:
        return None
    if op != MpiOp.SUM:
        return None
    return _INT8
