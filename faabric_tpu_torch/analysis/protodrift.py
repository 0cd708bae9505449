"""Static protocol-drift pass over the RPC call enums.

Two invariants, checked over the whole package AST:

- **handler coverage** — every member of a call enum (class name ending
  in ``Calls``/``Call``, e.g. ``PlannerCalls``, ``PointToPointCall``)
  must be referenced inside some server dispatch function
  (``do_sync_recv``/``do_async_recv``). A member nobody dispatches on is
  wire surface the server silently rejects — exactly the drift that
  turns a new client call into "Unknown sync planner call N" at runtime.
  Members prefixed ``NO_`` (the proto null values) are exempt.
- **declared members** — every ``SomeEnum.MEMBER`` attribute access in
  the package must name a declared member of that enum. Python only
  raises on these at call time, so a typo in a rarely-exercised branch
  (an error path, a chaos-only RPC) survives every green test run until
  production hits it. This covers all IntEnums, including the MPI wire
  enums (``MpiMessageType``/``MpiOp``/``MpiDataType``).

Counterpart of ``faabric_tpu/analysis/protodrift.py``. Findings use the
shared ``guards.Finding`` shape so the gate
(``python -m faabric_tpu_torch.analysis.concheck``) ratchets them
through the same baseline.
"""

from __future__ import annotations

import ast
import os

from faabric_tpu_torch.analysis.guards import Finding

__all__ = ["analyze_package"]

_DISPATCH_FUNCS = ("do_sync_recv", "do_async_recv")


def _is_int_enum(node: ast.ClassDef) -> bool:
    for base in node.bases:
        if isinstance(base, ast.Attribute) and base.attr in (
                "IntEnum", "Enum", "IntFlag"):
            return True
        if isinstance(base, ast.Name) and base.id in (
                "IntEnum", "Enum", "IntFlag"):
            return True
    return False


def _enum_members(node: ast.ClassDef) -> dict[str, int]:
    out: dict[str, int] = {}
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    out[t.id] = stmt.lineno
    return out


class _Module:
    def __init__(self, rel: str, tree: ast.Module) -> None:
        self.rel = rel
        self.tree = tree


def _walk_package(root: str, subdirs: tuple[str, ...]) -> list[_Module]:
    mods = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                with open(full, encoding="utf-8") as f:
                    try:
                        tree = ast.parse(f.read())
                    except SyntaxError:
                        continue  # guards pass reports parse errors
                mods.append(_Module(os.path.relpath(full, root), tree))
    return mods


def _attr_refs(node: ast.AST) -> list[tuple[str, str, int]]:
    """Every ``Name.UPPER`` attribute access under ``node``."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.attr.isupper():
            out.append((n.value.id, n.attr, n.lineno))
    return out


def analyze_package(root: str,
                    subdirs: tuple[str, ...] = ("faabric_tpu_torch",)
                    ) -> list[Finding]:
    mods = _walk_package(root, subdirs)

    # enum name → (members, defining module rel path, def line)
    enums: dict[str, tuple[dict[str, int], str, int]] = {}
    for mod in mods:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and _is_int_enum(node):
                enums[node.name] = (_enum_members(node), mod.rel,
                                    node.lineno)

    findings: list[Finding] = []

    # -- declared-member usage (all enums, all code) --------------------
    # Collected per (module, function-ish context) for qualnames; a flat
    # walk is enough since the fingerprint carries the subject.
    handled: dict[str, set[str]] = {name: set() for name in enums}
    for mod in mods:
        in_dispatch: list[tuple[str, str, int]] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in _DISPATCH_FUNCS:
                in_dispatch.extend(_attr_refs(node))
        for enum_name, member, _line in in_dispatch:
            if enum_name in enums:
                handled[enum_name].add(member)
        for enum_name, member, line in _attr_refs(mod.tree):
            info = enums.get(enum_name)
            if info is None:
                continue
            members, _, _ = info
            if member not in members and not member.startswith("_"):
                findings.append(Finding(
                    path=mod.rel, line=line, rule="undeclared-call-member",
                    qualname="<module>", subject=f"{enum_name}.{member}",
                    message=f"{enum_name}.{member} is not a declared "
                            f"member of {enum_name} (protocol drift: "
                            f"this raises AttributeError when reached)"))

    # -- handler coverage (call enums only) -----------------------------
    for enum_name, (members, rel, line) in enums.items():
        if not (enum_name.endswith("Calls") or enum_name.endswith("Call")):
            continue
        for member, mline in sorted(members.items()):
            if member.startswith("NO_"):
                continue
            if member not in handled[enum_name]:
                findings.append(Finding(
                    path=rel, line=mline, rule="unhandled-call",
                    qualname=enum_name, subject=member,
                    message=f"{enum_name}.{member} has no registered "
                            f"server handler (no do_sync_recv/"
                            f"do_async_recv references it)"))
    return findings
