"""Deterministic fault injection for chaos testing (counterpart of
``faabric_tpu/faults/``).

One import surface over two layers:

- :mod:`faabric_tpu_torch.faults.registry` — named fault points
  (``transport.send``, ``transport.bulk``, ``executor.run``,
  ``planner.dispatch``, ``mpi.collective``, ``keepalive``) armed from a
  ``FAABRIC_FAULTS`` spec string or programmatically, compiled to a
  shared no-op handle when disabled (same trick as telemetry/metrics.py)
  so instrumented hot paths stay free.
- :mod:`faabric_tpu_torch.util.retry` — the RetryPolicy / CircuitBreaker pair
  the transport layer recovers with (re-exported here for discovery).

See docs/fault_tolerance.md for the spec grammar and recipes.
"""

from faabric_tpu_torch.faults.registry import (
    DROP,
    NULL_FAULT,
    SUPPRESS,
    FaultConnectionError,
    FaultInjected,
    FaultPoint,
    FaultRegistry,
    FaultRule,
    clear_faults,
    fault_point,
    faults_enabled,
    get_fault_identity,
    get_fault_registry,
    install_faults,
    parse_fault_spec,
    set_fault_identity,
    set_faults_enabled,
)
from faabric_tpu_torch.util.retry import CircuitBreaker, RetryPolicy

__all__ = [
    "DROP",
    "NULL_FAULT",
    "SUPPRESS",
    "CircuitBreaker",
    "FaultConnectionError",
    "FaultInjected",
    "FaultPoint",
    "FaultRegistry",
    "FaultRule",
    "RetryPolicy",
    "clear_faults",
    "fault_point",
    "faults_enabled",
    "get_fault_identity",
    "get_fault_registry",
    "install_faults",
    "parse_fault_spec",
    "set_fault_identity",
    "set_faults_enabled",
]
