"""MPI datatypes, reduce ops, message types and the wire form.

Counterpart of ``faabric_tpu/mpi/types.py``, whole: ``MpiDataType``
with ``np_dtype_for`` / ``mpi_dtype_for`` (:21-92), ``MpiOp`` (:94),
``UserOp`` (:137), ``apply_op`` and ``apply_op_inplace`` (:158-183),
``MpiMessageType`` (:186) and the wire form of a payload bound for
another host (:224-271): a 20-byte header (type u8, dtype u8, pad u16,
count u64, request id i64) and the array's bytes, packed byte for byte
as the reference packs them. ``apply_op`` folds numpy arrays with
numpy's ufuncs and tensors with torch's, so one schedule step serves
the host ladder and a device payload alike.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np
import torch


class MpiDataType(enum.IntEnum):
    # mirror of faabric_datatype_t (mpi.h)
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT = 4
    INT64 = 5
    UINT8 = 6
    UINT16 = 7
    UINT32 = 8
    UINT = 9
    UINT64 = 10
    LONG = 11
    LONG_LONG = 12
    LONG_LONG_INT = 13
    FLOAT = 14
    DOUBLE = 15
    DOUBLE_INT = 16
    CHAR = 17
    C_BOOL = 18
    BYTE = 19


# MPI_DOUBLE_INT: (value, index) pairs for MINLOC/MAXLOC
DOUBLE_INT_DTYPE = np.dtype([("val", "<f8"), ("loc", "<i4")])

_NP_DTYPES: dict[int, np.dtype] = {
    MpiDataType.INT8: np.dtype(np.int8),
    MpiDataType.INT16: np.dtype(np.int16),
    MpiDataType.INT32: np.dtype(np.int32),
    MpiDataType.INT: np.dtype(np.int32),
    MpiDataType.INT64: np.dtype(np.int64),
    MpiDataType.UINT8: np.dtype(np.uint8),
    MpiDataType.UINT16: np.dtype(np.uint16),
    MpiDataType.UINT32: np.dtype(np.uint32),
    MpiDataType.UINT: np.dtype(np.uint32),
    MpiDataType.UINT64: np.dtype(np.uint64),
    MpiDataType.LONG: np.dtype(np.int64),
    MpiDataType.LONG_LONG: np.dtype(np.int64),
    MpiDataType.LONG_LONG_INT: np.dtype(np.int64),
    MpiDataType.FLOAT: np.dtype(np.float32),
    MpiDataType.DOUBLE: np.dtype(np.float64),
    MpiDataType.DOUBLE_INT: DOUBLE_INT_DTYPE,
    MpiDataType.CHAR: np.dtype(np.uint8),
    MpiDataType.C_BOOL: np.dtype(np.uint8),
    MpiDataType.BYTE: np.dtype(np.uint8),
}


def np_dtype_for(dtype: MpiDataType) -> np.dtype:
    return _NP_DTYPES[dtype]


# Reverse lookup: the first code of each numpy dtype wins, so aliases
# (INT32 and INT, ...) resolve to the canonical code
_MPI_FOR_NP: dict[np.dtype, MpiDataType] = {}
for _mpi_t, _np_t in _NP_DTYPES.items():
    _MPI_FOR_NP.setdefault(_np_t, MpiDataType(_mpi_t))


def mpi_dtype_for(np_dtype) -> MpiDataType:
    try:
        return _MPI_FOR_NP[np_dtype]
    except (KeyError, TypeError):
        pass
    mpi_t = _MPI_FOR_NP.get(np.dtype(np_dtype))
    if mpi_t is None:
        raise ValueError(f"No MPI datatype for numpy {np_dtype}")
    return mpi_t


class MpiOp(enum.IntEnum):
    # mirror of faabric_op_t
    MAX = 1
    MIN = 2
    SUM = 3
    PROD = 4
    LAND = 5
    LOR = 6
    BAND = 7
    BOR = 8
    MAXLOC = 9
    MINLOC = 10


_NP_OPS = {
    MpiOp.MAX: np.maximum,
    MpiOp.MIN: np.minimum,
    MpiOp.SUM: np.add,
    MpiOp.PROD: np.multiply,
    MpiOp.LAND: np.logical_and,
    MpiOp.LOR: np.logical_or,
    MpiOp.BAND: np.bitwise_and,
    MpiOp.BOR: np.bitwise_or,
}

_TORCH_OPS = {
    MpiOp.MAX: torch.maximum,
    MpiOp.MIN: torch.minimum,
    MpiOp.SUM: torch.add,
    MpiOp.PROD: torch.mul,
    MpiOp.LAND: torch.logical_and,
    MpiOp.LOR: torch.logical_or,
    MpiOp.BAND: torch.bitwise_and,
    MpiOp.BOR: torch.bitwise_or,
}


def _minmaxloc(op: MpiOp, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """MINLOC/MAXLOC over (val, loc) structured pairs: pick the extreme
    value; ties resolve to the lower index (MPI semantics)."""
    if a.dtype.names != ("val", "loc"):
        raise TypeError(
            f"{op.name} needs DOUBLE_INT (val, loc) pairs, got {a.dtype}")
    if op == MpiOp.MINLOC:
        pick_b = (b["val"] < a["val"]) | \
            ((b["val"] == a["val"]) & (b["loc"] < a["loc"]))
    else:
        pick_b = (b["val"] > a["val"]) | \
            ((b["val"] == a["val"]) & (b["loc"] < a["loc"]))
    out = a.copy()
    out[pick_b] = b[pick_b]
    return out


class UserOp:
    """User-defined reduction (MPI_Op_create): ``fn(a, b) -> array``
    plugs into every host-path collective. ``commute=False`` is
    recorded; the tree reduction applies contributions in rank order."""

    __slots__ = ("fn", "commute", "name")

    def __init__(self, fn, commute: bool = True,
                 name: str = "user_op") -> None:
        self.fn = fn
        self.commute = commute
        self.name = name


def apply_op(op, a, b):
    """``op(a, b)`` in ``a``'s dtype: numpy ufuncs for arrays, torch ops
    for tensors."""
    if isinstance(a, torch.Tensor):
        if isinstance(op, UserOp):
            return torch.as_tensor(op.fn(a, b)).to(a.dtype)
        fn = _TORCH_OPS.get(op)
        if fn is None:
            raise NotImplementedError(f"MPI op {op} not supported on tensors")
        return fn(a, b).to(a.dtype)
    if isinstance(op, UserOp):
        return np.asarray(op.fn(a, b)).astype(a.dtype, copy=False)
    if op in (MpiOp.MINLOC, MpiOp.MAXLOC):
        return _minmaxloc(op, a, b)
    fn = _NP_OPS.get(op)
    if fn is None:
        raise NotImplementedError(f"MPI op {op} not supported")
    return fn(a, b).astype(a.dtype, copy=False)


def apply_op_inplace(op, acc: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Fold ``b`` into ``acc`` without allocating when the ufunc's
    result dtype matches (the reduce tree's hot path); other ops and
    dtype mismatches allocate through ``apply_op``."""
    fn = _NP_OPS.get(op)
    if (fn is not None and acc.flags.writeable and acc.dtype == b.dtype
            and op in (MpiOp.SUM, MpiOp.PROD, MpiOp.MAX,
                       MpiOp.MIN, MpiOp.BAND, MpiOp.BOR)):
        fn(acc, b, out=acc)
        return acc
    return apply_op(op, acc, b)


class MpiMessageType(enum.IntEnum):
    # mirror of MpiMessage.h MpiMessageType
    NORMAL = 0
    BARRIER_JOIN = 1
    BARRIER_DONE = 2
    SCATTER = 3
    GATHER = 4
    ALLGATHER = 5
    REDUCE = 6
    SCAN = 7
    ALLREDUCE = 8
    ALLTOALL = 9
    ALLTOALL_PACKED = 10
    SENDRECV = 11
    BROADCAST = 12
    UNACKED = 13
    HANDSHAKE = 14
    # Announces a chunk-pipelined broadcast stream ([n_chunks,
    # total_elems, dtype_code] int64), so receivers follow the root's
    # chunking without a sized template
    CHUNK_HEADER = 100


# Wire header of an MPI payload bound for another host: type u8,
# dtype u8, pad u16, count u64, request id i64
MPI_HEADER_FMT = "<BBHQq"
MPI_HEADER_LEN = struct.calcsize(MPI_HEADER_FMT)


@dataclasses.dataclass
class MpiStatus:
    source: int = 0
    error: int = 0
    count: int = 0
    dtype: int = int(MpiDataType.BYTE)


def pack_mpi_payload(msg_type: MpiMessageType, data: np.ndarray,
                     request_id: int = 0) -> bytes:
    data = np.ascontiguousarray(data)
    head = struct.pack(MPI_HEADER_FMT, int(msg_type),
                       int(mpi_dtype_for(data.dtype)), 0, data.size,
                       request_id)
    return head + data.tobytes()


class MpiWirePayload:
    """A payload bound for another host, serialised late: the header
    and the array's buffer stay apart, so the RPC plane sends both
    without joining them (``buffers()``); ``to_bytes()`` joins them for
    mock recording."""

    __slots__ = ("head", "arr")

    def __init__(self, msg_type: MpiMessageType, data: np.ndarray,
                 request_id: int = 0) -> None:
        self.arr = np.ascontiguousarray(data)
        self.head = struct.pack(MPI_HEADER_FMT, int(msg_type),
                                int(mpi_dtype_for(self.arr.dtype)), 0,
                                self.arr.size, request_id)

    def __len__(self) -> int:
        return len(self.head) + self.arr.nbytes

    def buffers(self) -> list:
        return [self.head,
                memoryview(self.arr.reshape(-1).view(np.uint8))]

    def to_bytes(self) -> bytes:
        return self.head + self.arr.tobytes()


def unpack_mpi_payload(raw) -> tuple[MpiMessageType, np.ndarray, int]:
    msg_type, dtype, _, count, request_id = struct.unpack(
        MPI_HEADER_FMT, bytes(raw[:MPI_HEADER_LEN]))
    arr = np.frombuffer(raw, dtype=np_dtype_for(MpiDataType(dtype)),
                        count=count, offset=MPI_HEADER_LEN)
    # A bytearray is this frame's own buffer: wrap it writable, no copy.
    # Immutable bytes copy, so callers get a writable array.
    if not isinstance(raw, (bytearray, np.ndarray)):
        arr = arr.copy()
    return MpiMessageType(msg_type), arr, request_id
