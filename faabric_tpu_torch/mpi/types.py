"""MPI reduce ops and message types.

Counterpart of ``faabric_tpu/mpi/types.py`` (``MpiOp`` :94, ``UserOp``
:137, ``apply_op`` :158, ``MpiMessageType`` :186). ``apply_op`` folds
numpy arrays with numpy's ufuncs and tensors with torch's, so one
schedule step serves the host ladder and a device payload alike. The
wire packing of the reference (:224-271) belongs to the remote legs,
which this package has not ported.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


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
    CHUNK_HEADER = 100


@dataclasses.dataclass
class MpiStatus:
    source: int = 0
    error: int = 0
    count: int = 0
