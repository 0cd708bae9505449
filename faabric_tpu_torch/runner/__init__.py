"""Worker runtime (reference src/runner)."""

from faabric_tpu_torch.runner.runtime import WorkerRuntime

__all__ = ["WorkerRuntime"]
