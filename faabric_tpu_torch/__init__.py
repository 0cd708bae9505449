"""faabric_tpu_torch: the PyTorch/CUDA port of faabric_tpu.

So far it holds the flagship transformer's serving and training paths
(``models/``, ``data/``), the single-host MPI world with its device
plane (``mpi/``, ``device_plane/``), and faabric's control plane that
gang-schedules guest functions onto worker hosts (``planner/``,
``batch_scheduler/``, ``scheduler/``, ``executor/``, ``runner/``, over
``transport/`` and ``proto.py``), and the mesh substrate that trains the
model sharded over a gang's devices (``parallel/``: meshes, device
collectives, ring attention). It imports ``torch`` and nothing of JAX
or of ``faabric_tpu``. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
without a card and without that request they raise. Hand-written CUDA
kernels for Hopper live in ``ops/csrc/`` and are built at first use.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # Loaded on first use: importing the package itself loads nothing
    # (not torch), so that ``analysis/`` stays standard-library only and
    # the lock-order detector installs before any lock of the port
    if name == "resolve_device":
        from faabric_tpu_torch.util.device import resolve_device

        return resolve_device
    raise AttributeError(
        f"module 'faabric_tpu_torch' has no attribute {name!r}")
