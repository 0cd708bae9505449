"""Concurrency conformance suite (counterpart of ``faabric_tpu/analysis/``).

Three machine-checks over the port's locks and daemon threads:

- ``guards``   — AST guarded-by lint: shared attributes declare their
  lock (``GUARDS`` class map or a ``# guard: self._lock`` trailing
  comment) and every access is verified to happen inside the matching
  ``with`` scope; also flags check-then-act escapes and known-blocking
  calls made while a lock is held.
- ``protodrift`` — static protocol-drift pass: every RPC call-enum
  member has a registered server handler, and every call-site uses a
  declared member.
- ``lockcheck`` — opt-in runtime detector (``FAABRIC_LOCKCHECK=1``):
  instrumented Lock/RLock wrappers build a held-before graph with cycle
  detection, record per-site hold-time histograms into the telemetry
  registry, and report locks held across blocking syscalls.

``python -m faabric_tpu_torch.analysis.concheck`` runs the static passes
over ``faabric_tpu_torch/`` against the committed baseline
(``concheck_baseline.txt`` beside it).

This package imports only the standard library at module scope:
``lockcheck`` must be installable before torch (or anything else that
creates locks) loads.
"""
