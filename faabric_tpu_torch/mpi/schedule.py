"""Collective schedule IR + verifier + cache.

Counterpart of ``faabric_tpu/mpi/schedule.py``, whole: a collective
expressed as a small **schedule** — an ordered per-rank program of
``send`` / ``recv`` / ``fold`` / ``copy`` steps over abstract payload
blocks — compiled per (collective, Topology) by
``mpi/schedule_compile.py``, statically **verified** for exactly-once
delivery, cached per (topology-generation, collective, op/dtype-class,
size-class), and executed by one generic runner in ``MpiWorld``.

The IR stays above chunking: a block is an abstract contiguous span
whose element count is a **size symbol** resolved by the runner at
execution time. The verifier never needs real sizes — it checks that
the sender's concatenation symbol sequence equals the receiver's split
sequence, so framing can never desync.

Verifier guarantee (``verify_schedule``): abstract interpretation of
the whole world's programs against per-(src, dst) FIFO channels —
exactly the ordering contract the PTP broker provides — proving:

- **progress**: no rank blocks forever on a recv no send will match;
- **exactly-once**: every output block is written exactly once, and
  holds exactly its expected atom set (for reductions, the
  contribution set folded without overlap);
- **drained channels**: no message is left undelivered at exit.

A schedule that fails verification never reaches the cache, and the
runner refuses any schedule whose ``verified`` flag is unset.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable

# Buffer keys are ("in"|"out"|"tmp", block-id); size symbols are small
# tuples resolved by the runner: ("blk", j) → block j's element count,
# ("seg", i) → ring-segment i of the flat payload, ("all",) → the whole
# payload, ("cnt",) → the scatterv count-vector header (size-N int64).
BufKey = tuple
SizeSym = tuple

SEND = "send"
RECV = "recv"
FOLD = "fold"
COPY = "copy"


class ScheduleError(Exception):
    pass


# ---------------------------------------------------------------------------
# Execution targets
# ---------------------------------------------------------------------------
# A compiled schedule may annotate a phase with an execution TARGET
# (``spec["targets"] = {phase: name}``): an alternative executor the
# runner offers the phase's step group to before falling back to the
# per-step host path. The canonical target is ``device-ring``
# (device_plane/ring.py): annotated permute phases run as one
# ring-permute kernel launch per round on the device plane instead of
# 2(n−1) host messages. Targets must DECLINE (return None from
# ``try_run``) on any mismatch, and their verdict must be
# world-symmetric: a rank-dependent accept/decline would desync the
# message pattern exactly like a desynced family choice.

_STEP_TARGETS: dict[str, object] = {}
_STEP_TARGETS_LOCK = threading.Lock()


def register_step_target(target) -> None:
    """Register (or replace) an execution target under ``target.name``.
    Targets expose ``try_run(world, rank, sched, phase, steps, env,
    resolver) -> int | None`` — the number of leading steps executed,
    or None to decline."""
    with _STEP_TARGETS_LOCK:
        _STEP_TARGETS[target.name] = target


def get_registered_target(name: str):
    with _STEP_TARGETS_LOCK:
        return _STEP_TARGETS.get(name)


def get_step_target(name: str):
    """Runner-side lookup; importing the device plane registers the
    built-in device-ring target, so a schedule annotated with it works
    whether or not the plane was touched first."""
    t = get_registered_target(name)
    if t is None and name == "device-ring":
        from faabric_tpu_torch.device_plane.ring import ensure_registered

        ensure_registered()
        t = get_registered_target(name)
    return t


class ScheduleVerificationError(ScheduleError):
    """The schedule does not prove exactly-once delivery."""


@dataclass(frozen=True)
class Step:
    """One instruction of one rank's program.

    send: concatenate ``keys`` (in order) into one message to ``peer``.
    recv: receive one message from ``peer``, split into ``keys`` by the
          resolved ``syms`` sizes (single-key recvs discover the size
          from the wire and need no resolution).
    fold: ``dst = op(a, b)`` — operand ORDER is part of the schedule
          (prefix scans are order-sensitive; reductions conventionally
          fold (received, mine) like the hand-written rings).
    copy: ``dst = src`` (output assembly / accumulator seeding).
    ``phase`` tags the telemetry span the runner groups this step under.
    """

    op: str
    peer: int = -1
    keys: tuple = ()
    syms: tuple = ()
    dst: BufKey | None = None
    a: BufKey | None = None
    b: BufKey | None = None
    src: BufKey | None = None
    phase: str = ""


@dataclass
class Schedule:
    """A compiled collective: per-rank step programs + the semantic spec
    the verifier checks them against. ``spec`` is (collective-specific)
    extra structure: scatter/scatterv carry ``root``, allreduce carries
    the segment count. ``verified`` is set only by ``verify_schedule``;
    the runner refuses schedules without it."""

    name: str                     # family, e.g. "alltoall.hier"
    collective: str
    size: int
    steps: dict[int, tuple[Step, ...]]
    spec: dict = field(default_factory=dict)
    verified: bool = False

    def n_steps(self) -> int:
        return sum(len(s) for s in self.steps.values())


# ---------------------------------------------------------------------------
# Collective semantics: expected inputs/outputs as atom sets
# ---------------------------------------------------------------------------
# An atom is (owner rank, block id): the indivisible unit of payload the
# verifier tracks. Reductions treat an atom as "rank owner's
# contribution to block id"; fold unions atom sets and rejects overlap.

def _expected_io(collective: str, size: int, spec: dict):
    """(ins, outs): per-rank dicts of BufKey → frozenset(atoms)."""
    n = size
    ins: dict[int, dict] = {r: {} for r in range(n)}
    outs: dict[int, dict] = {r: {} for r in range(n)}
    if collective == "alltoall":
        for r in range(n):
            for j in range(n):
                ins[r][("in", j)] = frozenset({(r, j)})
                outs[r][("out", j)] = frozenset({(j, r)})
    elif collective in ("scatter", "scatterv"):
        root = spec["root"]
        for j in range(n):
            ins[root][("in", j)] = frozenset({(root, j)})
            outs[j][("out", 0)] = frozenset({(root, j)})
        if spec.get("counts_header"):
            # The count-vector header carries no payload atoms; it only
            # binds split sizes at the leaders
            ins[root][("in", "cnt")] = frozenset()
    elif collective == "scan":
        for r in range(n):
            ins[r][("in", 0)] = frozenset({(r, 0)})
            outs[r][("out", 0)] = frozenset({(q, 0) for q in range(r + 1)})
    elif collective == "allreduce":
        segs = spec["segments"]
        for r in range(n):
            for s in range(segs):
                ins[r][("in", s)] = frozenset({(r, s)})
                outs[r][("out", s)] = frozenset({(q, s) for q in range(n)})
    elif collective == "reduce_scatter":
        for r in range(n):
            for j in range(n):
                ins[r][("in", j)] = frozenset({(r, j)})
            outs[r][("out", 0)] = frozenset({(q, r) for q in range(n)})
    elif collective == "allgather":
        for r in range(n):
            ins[r][("in", 0)] = frozenset({(r, 0)})
            for q in range(n):
                outs[r][("out", q)] = frozenset({(q, 0)})
    else:
        raise ScheduleError(f"Unknown collective {collective!r}")
    return ins, outs


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------
def verify_schedule(sched: Schedule) -> Schedule:
    """Prove exactly-once delivery by abstract interpretation (see
    module docstring). Returns ``sched`` with ``verified`` set; raises
    ScheduleVerificationError naming the first violation."""
    n = sched.size
    ins, outs_expected = _expected_io(sched.collective, n, sched.spec)
    env: dict[int, dict] = {r: dict(ins[r]) for r in range(n)}
    out_writes: dict[int, dict] = {r: {} for r in range(n)}
    chans: dict[tuple[int, int], list] = {}
    ptr = [0] * n
    steps = {r: sched.steps.get(r, ()) for r in range(n)}

    def fail(msg: str):
        raise ScheduleVerificationError(
            f"{sched.name} ({sched.collective}, n={n}): {msg}")

    def read(r: int, key: BufKey):
        try:
            return env[r][key]
        except KeyError:
            fail(f"rank {r} reads undefined buffer {key}")

    def write(r: int, key: BufKey, atoms):
        if key[0] == "out":
            count = out_writes[r].get(key, 0)
            if count:
                fail(f"rank {r} writes output {key} twice "
                     f"(double delivery)")
            out_writes[r][key] = count + 1
        env[r][key] = atoms

    progressed = True
    while progressed:
        progressed = False
        for r in range(n):
            while ptr[r] < len(steps[r]):
                st = steps[r][ptr[r]]
                if st.op == SEND:
                    if st.peer == r or not (0 <= st.peer < n):
                        fail(f"rank {r} sends to invalid peer {st.peer}")
                    vals = [read(r, k) for k in st.keys]
                    chans.setdefault((r, st.peer), []).append(
                        (vals, st.syms))
                elif st.op == RECV:
                    q = chans.get((st.peer, r))
                    if not q:
                        break  # blocked on the channel; try other ranks
                    vals, syms = q.pop(0)
                    if len(vals) != len(st.keys) or syms != st.syms:
                        fail(f"rank {r} recv from {st.peer} framing "
                             f"mismatch: sent {syms}, expected {st.syms}")
                    for k, v in zip(st.keys, vals):
                        write(r, k, v)
                elif st.op == FOLD:
                    a, b = read(r, st.a), read(r, st.b)
                    if a & b:
                        fail(f"rank {r} fold {st.dst} double-counts "
                             f"contributions {sorted(a & b)[:4]}")
                    write(r, st.dst, a | b)
                elif st.op == COPY:
                    write(r, st.dst, read(r, st.src))
                else:
                    fail(f"rank {r}: unknown step op {st.op!r}")
                ptr[r] += 1
                progressed = True

    stuck = [r for r in range(n) if ptr[r] < len(steps[r])]
    if stuck:
        details = ", ".join(
            f"r{r}@{ptr[r]}:{steps[r][ptr[r]].op}<-{steps[r][ptr[r]].peer}"
            for r in stuck[:4])
        fail(f"deadlock: ranks {stuck} blocked ({details})")
    leftover = {c: len(q) for c, q in chans.items() if q}
    if leftover:
        fail(f"undelivered messages on channels {leftover} "
             f"(missing recvs)")
    for r in range(n):
        for key, expected in outs_expected[r].items():
            if key not in out_writes[r]:
                fail(f"rank {r} output {key} never written "
                     f"(missing element)")
            got = env[r][key]
            if got != expected:
                missing = sorted(expected - got)[:4]
                extra = sorted(got - expected)[:4]
                fail(f"rank {r} output {key} wrong contents: "
                     f"missing {missing}, extra {extra}")
        unexpected = set(out_writes[r]) - set(outs_expected[r])
        if unexpected:
            fail(f"rank {r} writes undeclared outputs "
                 f"{sorted(unexpected)[:4]}")
    sched.verified = True
    return sched


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
class ScheduleCache:
    """Verified-schedule cache of one MpiWorld, keyed
    (topology-generation, collective, root, op-class, dtype-class,
    size-class). The
    generation in the key makes migration/topology remaps invalidate
    naturally: a remap bumps the world's generation, old entries stop
    matching and age out at the cardinality backstop.

    Cache state across PROCESSES stays in lockstep because every rank
    executes the same collective call sequence with the same payload
    classes — the property the selection-sync round in MpiWorld relies
    on (see ``_sched_family``)."""

    # Entries and counters mutate under the cache lock; rank threads of
    # one process share it
    MAX_ENTRIES = 256

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[tuple, tuple[str, Schedule]] = {}
        # key → world-agreed family, SEPARATE from the evictable
        # schedule entries: MpiWorld's per-rank seen-ledger promises
        # that a key which already ran its selection round never runs
        # another (the round is a world-wide broadcast — skipping it
        # unilaterally would desync channels), so the agreed family
        # must survive the cardinality backstop below. Bytes-tiny (a
        # string per distinct key); pruned of dead generations with
        # the entries.
        self._families: dict[tuple, str] = {}
        self.compiles = 0
        self.hits = 0

    def family_of(self, key: tuple) -> str | None:
        with self._lock:
            return self._families.get(key)

    def note_family(self, key: tuple, family: str) -> None:
        """Record the world-agreed family the moment the selection
        round concludes — before any compile can fail — so a rank that
        marked the round done can always recover the verdict."""
        with self._lock:
            self._families[key] = family

    def get(self, key: tuple) -> Schedule | None:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            self.hits += 1
            return hit[1]

    def get_or_compile(self, key: tuple, family: str,
                       compile_fn: Callable[[], Schedule]) -> Schedule:
        """Single-compilation get: the first rank thread through compiles
        and VERIFIES (verify_schedule is the only path to verified=True);
        siblings wait on the lock and hit. An unverified compile result
        never lands in the cache — the raise propagates to every caller
        of this collective, never a silent fallback."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                return hit[1]
            sched = compile_fn()
            if not sched.verified:
                verify_schedule(sched)
            if len(self._entries) >= self.MAX_ENTRIES:
                # Cardinality backstop: drop entries from dead
                # generations first, then wholesale (recompiles are
                # cheap and deterministic). The family ledger only
                # sheds dead generations — a live key's agreed family
                # must outlive its schedule (see __init__).
                gen = key[0]
                for k in [k for k in self._entries if k[0] != gen]:
                    del self._entries[k]
                for k in [k for k in self._families if k[0] != gen]:
                    del self._families[k]
                if len(self._entries) >= self.MAX_ENTRIES:
                    self._entries.clear()
            self._entries[key] = (family, sched)
            self._families[key] = family
            self.compiles += 1
            return sched

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "compiles": self.compiles, "hits": self.hits}
