"""Seedable, deterministic fault-injection registry.

Named fault points are armed with rules parsed from a spec string
(``FAABRIC_FAULTS`` env var at process boot, or programmatically via
``install_faults`` in tests). Call sites hold a module-level handle and
gate on a boot-time bool, so with faults disabled the hot path pays one
global-load + branch and nothing else — the same cost model as the
telemetry registry's shared no-op handles.

Spec grammar (``;``-separated rules)::

    spec   := rule (';' rule)*
    rule   := point '=' action (':' arg)? ('@' mod)*
    point  := dotted fault-point name   e.g. transport.send
    action := delay | drop | raise | kill_conn | suppress
    arg    := delay: duration ('50ms', '0.5s', bare seconds)
              raise: the exception message
    mod    := p=<float>      fire with this probability (seeded RNG)
            | after=<int>    skip the first N arrivals
            | times=<int>    fire at most N times, then disarm
            | <key>=<value>  fire only when fire(key=...) ctx matches
                             (substring match on str(value))

Examples::

    FAABRIC_FAULTS="transport.send=delay:50ms@p=0.1"
    FAABRIC_FAULTS="planner.dispatch=kill_conn@times=1;keepalive=suppress@host=w2"

Host-pair rules (network partitions): every fire() is implicitly
stamped with ``src=<this process's host identity>`` (set by the worker
runtime / planner at boot via :func:`set_fault_identity`), so one
cluster-wide spec can partition a specific DIRECTED pair::

    # drop w0 -> w1 only; w1 -> w0 still flows
    FAABRIC_FAULTS="transport.send=drop@src=w0@host=w1"
    # both directions: one rule per direction
    FAABRIC_FAULTS="transport.send=drop@src=w0@host=w1;transport.send=drop@src=w1@host=w0"

Clearing the rules (``clear_faults``, or a ``times=`` budget running
out) heals the partition — call sites re-dial on their next attempt.

Determinism: every rule owns a ``random.Random`` seeded from
``(FAABRIC_FAULTS_SEED, point, rule index)``, so a given spec + seed
fires identically run to run regardless of thread interleaving at other
points.

Actions:

- ``delay`` sleeps, then lets the operation proceed;
- ``raise`` raises :class:`FaultInjected`;
- ``kill_conn`` raises :class:`FaultConnectionError` (a
  ``ConnectionError``, so transport error handling treats it exactly
  like a peer reset and exercises reconnect/retry paths);
- ``drop`` / ``suppress`` return the :data:`DROP` / :data:`SUPPRESS`
  verdict, which the call site interprets (skip the send, skip the
  keep-alive, ...).

State-plane points (same grammar): ``state.pull`` and
``state.push`` fire on a replica's remote chunk pulls/pushes,
``state.replicate`` on the master's synchronous forward to its backup.
All three map a ``drop`` verdict to a raised
:class:`FaultConnectionError` — a dropped state RPC is
indistinguishable from a dead peer, so the retry / no-ack machinery is
what gets exercised, not a silent skip::

    # fail the first backup forward, then heal
    FAABRIC_FAULTS="state.replicate=drop@times=1"
    # every pull from key a/k times out at the client
    FAABRIC_FAULTS="state.pull=kill_conn@key=a/k"
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

# Verdicts returned by fire(); compared by identity at call sites.
DROP = "drop"
SUPPRESS = "suppress"

_ACTIONS = ("delay", "drop", "raise", "kill_conn", "suppress")


class FaultInjected(RuntimeError):
    """Raised by a ``raise`` fault rule."""


class FaultConnectionError(ConnectionError):
    """Raised by a ``kill_conn`` fault rule. Subclasses ConnectionError
    (hence OSError) so transport except-clauses treat it as a real peer
    failure."""


class _NullFaultPoint:
    """Shared no-op handle returned while fault injection is disabled."""

    __slots__ = ()
    name = ""
    active = False

    def fire(self, **ctx) -> Optional[str]:
        return None


NULL_FAULT = _NullFaultPoint()


def _parse_duration(text: str) -> float:
    text = text.strip()
    if text.endswith("ms"):
        return float(text[:-2]) / 1000.0
    if text.endswith("s"):
        return float(text[:-1])
    return float(text)


class FaultRule:
    """One armed rule on one fault point."""

    def __init__(self, point: str, action: str, arg: str = "",
                 p: float = 1.0, after: int = 0,
                 times: Optional[int] = None,
                 matchers: Optional[dict[str, str]] = None,
                 seed: int = 0, index: int = 0) -> None:
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(expected one of {_ACTIONS})")
        self.point = point
        self.action = action
        self.arg = arg
        self.delay_seconds = _parse_duration(arg) if action == "delay" else 0.0
        self.p = p
        self.after = after
        self.times = times
        self.matchers = matchers or {}
        self._lock = threading.Lock()
        self.arrivals = 0
        self.fired = 0
        # Per-rule RNG: deterministic for a fixed (seed, point, index)
        # and immune to draws at other points/rules
        self._rng = random.Random(f"{seed}:{point}:{index}")

    def matches(self, ctx: dict) -> bool:
        for key, want in self.matchers.items():
            if want not in str(ctx.get(key, "")):
                return False
        return True

    def should_fire(self, ctx: dict) -> bool:
        """Arrival-counting + probability gate; True → apply()."""
        if self.matchers and not self.matches(ctx):
            return False
        with self._lock:
            self.arrivals += 1
            if self.arrivals <= self.after:
                return False
            if self.times is not None and self.fired >= self.times:
                return False
            if self.p < 1.0 and self._rng.random() >= self.p:
                return False
            self.fired += 1
            return True

    def apply(self, ctx: dict) -> Optional[str]:
        logger.warning("FAULT %s: %s%s fired (ctx=%s)", self.point,
                       self.action, f":{self.arg}" if self.arg else "", ctx)
        if self.action == "delay":
            time.sleep(self.delay_seconds)
            return None
        if self.action == "drop":
            return DROP
        if self.action == "suppress":
            return SUPPRESS
        if self.action == "kill_conn":
            raise FaultConnectionError(
                f"injected connection failure at {self.point}")
        raise FaultInjected(
            f"{self.point}: {self.arg or 'injected fault'}")

    def to_dict(self) -> dict:
        return {"point": self.point, "action": self.action, "arg": self.arg,
                "p": self.p, "after": self.after, "times": self.times,
                "matchers": dict(self.matchers),
                "arrivals": self.arrivals, "fired": self.fired}


def parse_fault_spec(spec: str, seed: int = 0) -> list[FaultRule]:
    """Parse a FAABRIC_FAULTS spec into rules; raises ValueError on a
    malformed spec (a silently-ignored chaos spec would fake a green
    chaos run)."""
    rules: list[FaultRule] = []
    for index, raw in enumerate(filter(None,
                                       (r.strip() for r in spec.split(";")))):
        if "=" not in raw:
            raise ValueError(f"fault rule {raw!r} lacks 'point=action'")
        point, rest = raw.split("=", 1)
        point = point.strip()
        parts = rest.split("@")
        head, mods = parts[0], parts[1:]
        action, _, arg = head.partition(":")
        action = action.strip()
        p, after, times = 1.0, 0, None
        matchers: dict[str, str] = {}
        for mod in mods:
            if "=" not in mod:
                raise ValueError(f"fault modifier {mod!r} lacks 'key=value'")
            key, _, val = mod.partition("=")
            key, val = key.strip(), val.strip()
            if key == "p":
                p = float(val)
            elif key == "after":
                after = int(val)
            elif key == "times":
                times = int(val)
            else:
                matchers[key] = val
        rules.append(FaultRule(point, action, arg.strip(), p=p, after=after,
                               times=times, matchers=matchers, seed=seed,
                               index=index))
    return rules


class FaultPoint:
    """Live handle for one named fault point. Handles are per-name
    singletons held by the registry, so rules installed later reach
    call sites that already grabbed theirs."""

    __slots__ = ("name", "_rules", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._rules: list[FaultRule] = []
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def set_rules(self, rules: list[FaultRule]) -> None:
        with self._lock:
            self._rules = list(rules)

    def fire(self, **ctx) -> Optional[str]:
        """Evaluate this point's rules against one arrival. May sleep
        (delay), raise (raise/kill_conn) or return a DROP/SUPPRESS
        verdict; returns None when nothing fires."""
        rules = self._rules
        if not rules:
            return None
        # Stamp the firing side's host identity so rules can match a
        # directed host pair (src=..., host=/dest=...) from ONE spec
        # shared cluster-wide. Only paid when rules are armed.
        if _local_identity and "src" not in ctx:
            ctx["src"] = _local_identity
        for rule in rules:
            if rule.should_fire(ctx):
                _count_fired(self.name, rule.action)
                verdict = rule.apply(ctx)
                if verdict is not None:
                    return verdict
        return None


def _count_fired(point: str, action: str) -> None:
    # Lazy import: telemetry must not become a hard dependency of the
    # fault layer (and this only runs when a fault actually fires)
    try:
        from faabric_tpu_torch.telemetry import (
            flight_record,
            get_metrics,
            instant,
        )

        get_metrics().counter(
            "faabric_faults_fired_total", "Injected faults fired",
            point=point, action=action).inc()
        # Visible in /trace (instant marker on the firing thread's row)
        # and in the post-mortem flight ring — an injected fault must be
        # distinguishable from a real one after the fact
        instant("faults", point, action=action)
        flight_record("fault_fired", point=point, action=action)
    except Exception:  # noqa: BLE001 — counting must never mask the fault
        pass


class FaultRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, FaultPoint] = {}

    def point(self, name: str) -> FaultPoint:
        with self._lock:
            pt = self._points.get(name)
            if pt is None:
                pt = FaultPoint(name)
                self._points[name] = pt
            return pt

    def install(self, spec: str, seed: int = 0) -> None:
        """Arm the registry from a spec string (replaces prior rules)."""
        rules = parse_fault_spec(spec, seed=seed)
        by_point: dict[str, list[FaultRule]] = {}
        for r in rules:
            by_point.setdefault(r.point, []).append(r)
        with self._lock:
            names = set(self._points) | set(by_point)
        for name in names:
            self.point(name).set_rules(by_point.get(name, []))
        if rules:
            logger.warning("Fault injection armed: %s (seed=%d)", spec, seed)

    def clear(self) -> None:
        with self._lock:
            points = list(self._points.values())
        for pt in points:
            pt.set_rules([])

    def snapshot(self) -> dict:
        with self._lock:
            points = dict(self._points)
        return {name: [r.to_dict() for r in pt._rules]
                for name, pt in points.items() if pt.active}


_registry: FaultRegistry | None = None
_registry_lock = threading.Lock()

# This process's host identity, stamped into every fire() ctx as ``src``
# so host-pair (partition) rules can match direction. Set at boot by
# WorkerRuntime / PlannerServer; empty = no stamp (standalone tools).
_local_identity = ""
_identity_conflict = False


def set_fault_identity(host: str, force: bool = False) -> None:
    """Record this process's host identity for ``src=`` ctx matching.

    The stamp only makes sense when ONE runtime owns the process (the
    deployment shape for real partitions). In-process multi-host tests
    construct several runtimes side by side; the second DIFFERENT
    identity therefore clears the stamp entirely — a directed rule
    that silently matched the wrong direction would be worse than one
    that matches nothing. Tests that want a specific identity (or to
    reset the conflict latch) pass ``force=True``."""
    global _local_identity, _identity_conflict
    if force:
        _local_identity = host
        _identity_conflict = False
        return
    if _identity_conflict:
        return
    if _local_identity and host and host != _local_identity:
        logger.debug("Multiple fault identities in one process (%s, %s): "
                     "disabling src= stamping", _local_identity, host)
        _identity_conflict = True
        _local_identity = ""
        return
    _local_identity = host


def get_fault_identity() -> str:
    return _local_identity

# Boot-time switch: instrumented modules capture this (and their fault
# point handle) at import, so an unset FAABRIC_FAULTS keeps hot paths at
# a single module-global bool check. Tests flip it via
# set_faults_enabled BEFORE importing/exercising the paths under test,
# or launch subprocesses with the env var set.
_enabled = bool(os.environ.get("FAABRIC_FAULTS", ""))


def faults_enabled() -> bool:
    return _enabled


def set_faults_enabled(on: bool) -> None:
    """Test hook; production processes decide at boot via FAABRIC_FAULTS.
    Call sites gate on the value they read at import time — only modules
    imported (or handles fetched) after the flip observe the new state."""
    global _enabled
    _enabled = on


def get_fault_registry() -> FaultRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = FaultRegistry()
                spec = os.environ.get("FAABRIC_FAULTS", "")
                if spec:
                    seed = int(os.environ.get("FAABRIC_FAULTS_SEED", "0"))
                    _registry.install(spec, seed=seed)
    return _registry


def fault_point(name: str) -> FaultPoint | _NullFaultPoint:
    """The handle call sites hold. Shared no-op when fault injection is
    disabled (the common case): no registry, no allocation, no rules."""
    if not _enabled:
        return NULL_FAULT
    return get_fault_registry().point(name)


def install_faults(spec: str, seed: int = 0) -> None:
    """Programmatic arm (tests): enables injection and installs rules."""
    set_faults_enabled(True)
    get_fault_registry().install(spec, seed=seed)


def clear_faults() -> None:
    global _registry
    if _registry is not None:
        _registry.clear()
    set_faults_enabled(bool(os.environ.get("FAABRIC_FAULTS", "")))
