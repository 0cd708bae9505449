"""AST guarded-by lint: verify annotated shared state is only touched
under its lock.

Counterpart of ``faabric_tpu/analysis/guards.py``: the same rules and
the same fingerprints, so one finding reads the same from either
package's gate.

Annotation convention:

- A class (or module) declares its guard map either as a literal class
  attribute::

      GUARDS = {"_hosts": "_lock", "_waiters": "_lock"}

  (values name a lock attribute on ``self``; module-level maps name
  module globals), or per-assignment with a trailing comment in
  ``__init__`` / at module scope::

      self._hosts = {}  # guard: self._lock

- Only annotated attributes are checked — the map IS the contract.
  Deliberately lock-free accesses (documented fast paths, benign races)
  either stay out of the map or carry a line pragma::

      # concheck: ok                      (suppress every rule here)
      # concheck: ok(blocking-under-lock) (suppress specific rules)

Rules:

- ``guard-unlocked``     — a guarded attribute is read or written while
  its lock is not held (``with`` scopes only; ``__init__`` is exempt,
  and ``*_locked`` methods are assumed to run under every class lock,
  per the repo convention).
- ``check-then-act``     — a guarded read escapes its lock into a local
  and a later, *separate* acquisition of the same lock writes the same
  attribute conditioned on (or computed from) that stale local.
- ``blocking-under-lock`` — a known-blocking call (socket ops, RPC
  ``sync_send``/``async_send``, indefinite ``.wait()``/``.join()``,
  ``time.sleep``, ``subprocess.*``) happens while any lock is held.

The lint is deliberately heuristic: findings ratchet through
``faabric_tpu_torch/analysis/concheck_baseline.txt``, so a rare
false positive is baselined or pragma'd with a justification instead of
weakening the analyzer.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

__all__ = ["Finding", "analyze_source", "analyze_file", "analyze_paths"]

_GUARD_COMMENT = re.compile(r"#\s*guard:\s*([A-Za-z_][\w.]*)")
_PRAGMA = re.compile(r"#\s*concheck:\s*ok(?:\(([^)]*)\))?")

# Calls that can block the calling thread for network/scheduler time.
# Matched on the attribute name of the call (x.recv(...)); module-style
# calls (time.sleep, subprocess.run) are matched on the dotted pair.
_BLOCKING_METHODS = frozenset({
    "recv", "recv_into", "recvfrom", "send", "sendall", "sendmsg",
    "accept", "connect", "connect_ex", "sync_send", "async_send",
    "communicate",
})
_BLOCKING_DOTTED = frozenset({
    ("time", "sleep"),
    ("socket", "create_connection"),
    ("socket", "getaddrinfo"),
    ("subprocess", "run"), ("subprocess", "call"),
    ("subprocess", "check_call"), ("subprocess", "check_output"),
})
# Indefinite parks: flagged only with no timeout argument (``ev.wait()``,
# ``t.join()``) or an explicit ``None`` timeout.
_INDEFINITE_METHODS = frozenset({"wait", "join"})


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str       # repo-relative
    line: int
    rule: str
    qualname: str   # Class.method / module-level function / "<module>"
    subject: str    # attr or call text the finding is about
    message: str

    @property
    def fingerprint(self) -> str:
        # Line numbers deliberately excluded: the committed baseline must
        # survive unrelated edits above the finding
        return f"{self.path}::{self.qualname}::{self.rule}::{self.subject}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule}: {self.message} "
                f"[{self.qualname}]")


def _is_lock_name(text: str) -> bool:
    last = text.rsplit(".", 1)[-1]
    return "lock" in last.lower() or last in ("_mx", "mx")


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed nodes
        return "<expr>"


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _Pragmas:
    """Line → set of suppressed rules (empty set = all rules)."""

    def __init__(self, source: str) -> None:
        self.by_line: dict[int, frozenset[str]] = {}
        lines = source.splitlines()
        for i, line in enumerate(lines, start=1):
            m = _PRAGMA.search(line)
            if m:
                rules = frozenset(
                    r.strip() for r in (m.group(1) or "").split(",")
                    if r.strip())
                self.by_line[i] = rules
                if line.strip().startswith("#"):
                    # A comment-only pragma also covers the next code
                    # line (skipping the rest of its comment block) —
                    # the idiom for statements too long to carry a
                    # trailing comment
                    j = i
                    while j < len(lines) and (
                            not lines[j].strip()
                            or lines[j].strip().startswith("#")):
                        j += 1
                    self.by_line.setdefault(j + 1, rules)

    def suppressed(self, node: ast.AST, rule: str) -> bool:
        start = getattr(node, "lineno", 0)
        end = getattr(node, "end_lineno", start) or start
        for ln in range(start, end + 1):
            rules = self.by_line.get(ln)
            if rules is not None and (not rules or rule in rules):
                return True
        return False

    def suppressed_def(self, node: ast.AST) -> bool:
        """A bare ``# concheck: ok`` on the ``def`` line waives the
        whole function."""
        rules = self.by_line.get(getattr(node, "lineno", 0))
        return rules is not None and not rules


def _literal_guard_map(node: ast.Assign | ast.AnnAssign) -> dict[str, str]:
    """Parse ``GUARDS = {"_attr": "_lock"}`` literals."""
    value = node.value
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target])
    if not any(isinstance(t, ast.Name) and t.id == "GUARDS"
               for t in targets):
        return {}
    if not isinstance(value, ast.Dict):
        return {}
    out: dict[str, str] = {}
    for k, v in zip(value.keys, value.values):
        if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Constant)
                and isinstance(v.value, str)):
            out[k.value] = v.value
    return out


def _comment_guards(body: list[ast.stmt], source_lines: list[str],
                    self_name: str | None) -> dict[str, str]:
    """Trailing ``# guard: <lock>`` comments on assignments."""
    out: dict[str, str] = {}
    for stmt in body:
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        line = source_lines[stmt.lineno - 1] \
            if stmt.lineno - 1 < len(source_lines) else ""
        m = _GUARD_COMMENT.search(line)
        if not m:
            continue
        guard = m.group(1)
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            if (self_name and isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == self_name):
                out[t.attr] = guard.removeprefix("self.")
            elif self_name is None and isinstance(t, ast.Name):
                out[t.id] = guard
    return out


class _Scope:
    """One class (or the module) carrying a guard map."""

    def __init__(self, name: str, guards: dict[str, str],
                 is_module: bool) -> None:
        self.name = name
        self.is_module = is_module
        # attr → normalized lock text ("self._lock" / "_mock_lock")
        self.guards = {
            attr: (lock if is_module or "." in lock else f"self.{lock}")
            for attr, lock in guards.items()
        }
        self.all_locks = set(self.guards.values())


class _FunctionWalker:
    """Walks one function body tracking the set of held locks."""

    def __init__(self, analyzer: "_Analyzer", scope: _Scope,
                 qualname: str, assume_held: frozenset[str]) -> None:
        self.a = analyzer
        self.scope = scope
        self.qualname = qualname
        self.held: list[str] = list(assume_held)
        self.session = 0                 # increments per lock acquisition
        self.session_of: dict[str, int] = {
            lk: 0 for lk in assume_held}  # lock text → current session id
        # guarded attr → (session, lock) of its last in-lock read
        self.reads: dict[str, tuple[int, str]] = {}
        # local name → (attr, session) for locals carrying guarded reads
        self.tainted: dict[str, tuple[str, int]] = {}
        self.cond_names: list[set[str]] = []  # enclosing If/While tests

    # -- helpers -------------------------------------------------------
    def _report(self, node: ast.AST, rule: str, subject: str,
                message: str) -> None:
        self.a.report(node, rule, self.qualname, subject, message)

    def _guard_for(self, attr_text: str, attr: str) -> str | None:
        """Lock text required for this access, or None if unguarded."""
        if self.scope.is_module:
            return self.scope.guards.get(attr)
        if attr_text.startswith("self."):
            return self.scope.guards.get(attr)
        return None

    # -- statement walk ------------------------------------------------
    def walk_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self.walk_stmt(stmt)

    def walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Deferred execution: nested defs start with no locks held
            self.a.queue_function(stmt, self.scope,
                                  f"{self.qualname}.{stmt.name}",
                                  frozenset())
            return
        if isinstance(stmt, ast.ClassDef):
            self.a.visit_class(stmt, parent=self.qualname)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: list[str] = []
            for item in stmt.items:
                self.scan_expr(item.context_expr)
                text = _unparse(item.context_expr)
                if (_is_lock_name(text)
                        or text in self.scope.all_locks):
                    acquired.append(text)
                if item.optional_vars is not None:
                    self.scan_expr(item.optional_vars)
            for lk in acquired:
                self.session += 1
                self.session_of[lk] = self.session
                self.held.append(lk)
            self.walk_body(stmt.body)
            for lk in reversed(acquired):
                self.held.remove(lk)
                self.session_of.pop(lk, None)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self.scan_expr(stmt.test)
            self.cond_names.append(_names_in(stmt.test))
            self.walk_body(stmt.body)
            self.walk_body(stmt.orelse)
            self.cond_names.pop()
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.scan_expr(stmt.iter)
            self.scan_expr(stmt.target)
            self.walk_body(stmt.body)
            self.walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self.walk_body(stmt.body)
            for h in stmt.handlers:
                self.walk_body(h.body)
            self.walk_body(stmt.orelse)
            self.walk_body(stmt.finalbody)
            return
        if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            self.scan_expr(stmt.subject)
            for case in stmt.cases:
                self.walk_body(case.body)
            return
        # Simple statement: scan its expressions, then record taint for
        # ``local = <expr reading guarded attr under lock>``
        self.scan_expr(stmt)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            attrs = self._guarded_reads_in(stmt.value)
            if attrs and self.held:
                attr = attrs[0]
                lock = self.scope.guards[attr]  # normalized by _Scope
                if lock in self.held:
                    self.tainted[stmt.targets[0].id] = (
                        attr, self.session_of.get(lock, 0))

    def _guarded_reads_in(self, expr: ast.AST) -> list[str]:
        out = []
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                if self.scope.is_module:
                    continue
                if isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr in self.scope.guards:
                    out.append(node.attr)
            elif isinstance(node, ast.Name) and self.scope.is_module \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id in self.scope.guards:
                out.append(node.id)
        return out

    # -- expression scan -----------------------------------------------
    def scan_expr(self, expr: ast.AST) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute):
                self._check_attribute(node)
            elif isinstance(node, ast.Name):
                self._check_global(node)
            elif isinstance(node, ast.Call):
                self._check_call(node)

    def _attr_access(self, attr: str, node: ast.AST,
                     is_write: bool, text: str) -> None:
        lock = self.scope.guards.get(attr)  # normalized by _Scope
        if lock is None:
            return
        if lock in self.held:
            if not is_write:
                self.reads[attr] = (self.session_of.get(lock, 0), lock)
            else:
                self._check_check_then_act(attr, lock, node)
            return
        self._report(
            node, "guard-unlocked", attr,
            f"{'write to' if is_write else 'read of'} {text} outside "
            f"its guard {lock}")

    def _check_attribute(self, node: ast.Attribute) -> None:
        if self.scope.is_module:
            return
        if not (isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return
        if node.attr not in self.scope.guards:
            return
        is_write = isinstance(node.ctx, (ast.Store, ast.Del))
        self._attr_access(node.attr, node, is_write, f"self.{node.attr}")

    def _check_global(self, node: ast.Name) -> None:
        if not self.scope.is_module or node.id not in self.scope.guards:
            return
        is_write = isinstance(node.ctx, (ast.Store, ast.Del))
        self._attr_access(node.id, node, is_write, node.id)

    def _check_check_then_act(self, attr: str, lock: str,
                              node: ast.AST) -> None:
        prior = self.reads.get(attr)
        if prior is None:
            return
        read_sess, read_lock = prior
        cur_sess = self.session_of.get(lock, 0)
        if read_lock != lock or read_sess == cur_sess:
            return
        # The lock was released and re-acquired between the read and this
        # write. Only flag when the write actually depends on a stale
        # local from that earlier session (condition or value).
        stale = {name for name, (a, sess) in self.tainted.items()
                 if a == attr and sess == read_sess}
        if not stale:
            return
        cond = set().union(*self.cond_names) if self.cond_names else set()
        if stale & cond:
            self._report(
                node, "check-then-act", attr,
                f"self.{attr} written under a re-acquired {lock} based "
                f"on a value read in an earlier critical section "
                f"({', '.join(sorted(stale & cond))} escaped the lock)")

    # -- blocking calls ------------------------------------------------
    def _check_call(self, node: ast.Call) -> None:
        if not self.held:
            return
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        recv_text = _unparse(func.value)
        name = func.attr
        blocking = False
        subject = f"{recv_text}.{name}"
        if name in _BLOCKING_METHODS:
            blocking = True
        elif isinstance(func.value, ast.Name) \
                and (func.value.id, name) in _BLOCKING_DOTTED:
            blocking = True
        elif name in _INDEFINITE_METHODS:
            # ev.wait() / t.join() with no timeout parks forever; a
            # cv-style wait on a lock we HOLD is the release-and-wait
            # pattern and is fine
            if recv_text in self.held:
                return
            has_timeout = bool(node.args) or any(
                kw.arg in ("timeout",) and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None)
                for kw in node.keywords)
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value is None:
                has_timeout = False
            blocking = not has_timeout
        if blocking:
            self._report(
                node, "blocking-under-lock", subject,
                f"blocking call {subject}(...) while holding "
                f"{', '.join(sorted(set(self.held)))}")


class _Analyzer:
    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.source_lines = source.splitlines()
        self.pragmas = _Pragmas(source)
        self.tree = ast.parse(source)
        self.findings: list[Finding] = []
        self._queue: list[tuple[ast.AST, _Scope, str, frozenset[str]]] = []

    def report(self, node: ast.AST, rule: str, qualname: str,
               subject: str, message: str) -> None:
        if self.pragmas.suppressed(node, rule):
            return
        self.findings.append(Finding(
            path=self.path, line=getattr(node, "lineno", 0), rule=rule,
            qualname=qualname, subject=subject, message=message))

    def queue_function(self, node, scope: _Scope, qualname: str,
                       assume: frozenset[str]) -> None:
        self._queue.append((node, scope, qualname, assume))

    # -- discovery -----------------------------------------------------
    def run(self) -> list[Finding]:
        module_guards = self._module_guard_map()
        mod_scope = _Scope("<module>", module_guards, is_module=True)
        for stmt in self.tree.body:
            if isinstance(stmt, ast.ClassDef):
                self.visit_class(stmt, parent=None)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.queue_function(stmt, mod_scope, stmt.name,
                                    frozenset())
        while self._queue:
            node, scope, qualname, assume = self._queue.pop()
            if self.pragmas.suppressed_def(node):
                continue
            w = _FunctionWalker(self, scope, qualname, assume)
            w.walk_body(node.body)
        return self.findings

    def _module_guard_map(self) -> dict[str, str]:
        guards: dict[str, str] = {}
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                guards.update(_literal_guard_map(stmt))
        guards.update(_comment_guards(self.tree.body, self.source_lines,
                                      self_name=None))
        return guards

    def visit_class(self, node: ast.ClassDef, parent: str | None) -> None:
        qual = f"{parent}.{node.name}" if parent else node.name
        guards: dict[str, str] = {}
        init: ast.FunctionDef | None = None
        for stmt in node.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                guards.update(_literal_guard_map(stmt))
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == "__init__":
                init = stmt
        if init is not None:
            guards.update(_comment_guards(init.body, self.source_lines,
                                          self_name="self"))
        scope = _Scope(qual, guards, is_module=False)
        for stmt in node.body:
            if isinstance(stmt, ast.ClassDef):
                self.visit_class(stmt, parent=qual)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name in ("__init__", "__new__", "__del__"):
                    continue  # pre-publication / teardown: not shared
                assume: frozenset[str] = frozenset()
                if stmt.name.endswith("_locked"):
                    # Repo convention: *_locked helpers document "caller
                    # holds the lock" — assume every class guard is held
                    assume = frozenset(scope.all_locks)
                self.queue_function(stmt, scope, f"{qual}.{stmt.name}",
                                    assume)


def analyze_source(source: str, path: str = "<string>") -> list[Finding]:
    return _Analyzer(path, source).run()


def analyze_file(file_path: str, rel_path: str | None = None
                 ) -> list[Finding]:
    with open(file_path, encoding="utf-8") as f:
        source = f.read()
    return analyze_source(source, rel_path or file_path)


def analyze_paths(root: str,
                  subdirs: tuple[str, ...] = ("faabric_tpu_torch",)
                  ) -> list[Finding]:
    findings: list[Finding] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root)
                try:
                    findings.extend(analyze_file(full, rel))
                except SyntaxError as e:  # pragma: no cover
                    findings.append(Finding(
                        path=rel, line=e.lineno or 0, rule="parse-error",
                        qualname="<module>", subject="syntax",
                        message=str(e)))
    return findings
