"""Worker runtime (reference src/runner).

``WorkerRuntime`` loads on first use, so that ``python -m
faabric_tpu_torch.runner`` can install the lock-order detector before
the runtime's modules create their locks.
"""

__all__ = ["WorkerRuntime"]


def __getattr__(name: str):
    if name == "WorkerRuntime":
        from faabric_tpu_torch.runner.runtime import WorkerRuntime

        return WorkerRuntime
    raise AttributeError(
        f"module 'faabric_tpu_torch.runner' has no attribute {name!r}")
