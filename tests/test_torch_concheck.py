"""The static concurrency passes of the port (``faabric_tpu_torch/analysis``):
the guarded-by lint, check-then-act, blocking-under-lock, protocol drift,
the pragma and baseline mechanics, and the gate over the port's tree.

Counterpart of ``tests/unit/test_concheck.py``: its cases on the port's
passes, then parity with the reference's passes — the same fingerprints
over every snippet of those cases and over both packages' trees — and
the reference's tree clean under the port's passes.
"""

from __future__ import annotations

import os
import textwrap

import pytest

from faabric_tpu_torch.analysis.guards import analyze_source
from faabric_tpu_torch.analysis.protodrift import analyze_package

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(findings):
    return {(f.rule, f.subject) for f in findings}


# ---------------------------------------------------------------------------
# The snippets (shared by the ported cases and the parity cases)
# ---------------------------------------------------------------------------

ESCAPE = textwrap.dedent('''
    import threading

    class C:
        GUARDS = {"_items": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def ok(self):
            with self._lock:
                return list(self._items)

        def bad(self):
            return len(self._items)
''')

COMMENT_GUARD = textwrap.dedent('''
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0  # guard: self._lock

        def bump(self):
            self._count += 1
''')

MODULE_GUARD = textwrap.dedent('''
    import threading

    _mock_lock = threading.Lock()
    _calls = []  # guard: _mock_lock

    def record(x):
        _calls.append(x)

    def record_ok(x):
        with _mock_lock:
            _calls.append(x)
''')

LOCKED_SUFFIX = textwrap.dedent('''
    import threading

    class C:
        GUARDS = {"_items": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def _drain_locked(self):
            out, self._items = self._items, []
            return out
''')

CHECK_THEN_ACT = textwrap.dedent('''
    import threading, time

    class C:
        GUARDS = {"_state": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._state = 0

        def bad(self):
            with self._lock:
                n = self._state
            time.sleep(0.1)
            if n == 0:
                with self._lock:
                    self._state = 5

        def good_revalidates(self):
            with self._lock:
                n = self._state
            time.sleep(0.1)
            with self._lock:
                if self._state == n:
                    self._state = 5
''')

BLOCKING = textwrap.dedent('''
    import threading, time

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def bad_socket(self, sock):
            with self._lock:
                sock.sendall(b"x")

        def bad_rpc(self, client):
            with self._lock:
                client.sync_send(1, {})

        def bad_indefinite_wait(self, ev):
            with self._lock:
                ev.wait()

        def ok_bounded_wait(self, ev):
            with self._lock:
                ev.wait(1.0)

        def ok_no_lock(self, sock):
            sock.sendall(b"x")

        def ok_cv_wait(self):
            with self._cv:
                self._cv.wait()
''')

NESTED = textwrap.dedent('''
    import threading

    class C:
        GUARDS = {"_items": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def spawn(self):
            with self._lock:
                def later():
                    return len(self._items)  # runs on a thread
                return later
''')

PRAGMAS = textwrap.dedent('''
    import threading

    class C:
        GUARDS = {"_items": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def fast_path(self):
            return len(self._items)  # concheck: ok

        def fast_path2(self):
            return len(self._items)  # concheck: ok(guard-unlocked)

        def wrong_rule(self):
            return len(self._items)  # concheck: ok(check-then-act)

        def own_line(self):
            # concheck: ok(guard-unlocked) — documented fast path
            return len(self._items)
''')

FINGERPRINT = textwrap.dedent('''
    import threading

    class C:
        GUARDS = {"_items": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def bad(self):
            return len(self._items)
''')

GUARD_SNIPPETS = {
    "escape": ESCAPE, "comment_guard": COMMENT_GUARD,
    "module_guard": MODULE_GUARD, "locked_suffix": LOCKED_SUFFIX,
    "check_then_act": CHECK_THEN_ACT, "blocking": BLOCKING,
    "nested": NESTED, "pragmas": PRAGMAS, "fingerprint": FINGERPRINT,
    "fingerprint_shifted": "\n\n\n" + FINGERPRINT,
}

HANDLERLESS = textwrap.dedent('''
    import enum

    class DemoCalls(enum.IntEnum):
        NO_CALL = 0
        PING = 1
        ORPHANED = 2

    class Server:
        def do_sync_recv(self, msg):
            if msg.code == int(DemoCalls.PING):
                return "pong"
            raise ValueError(msg.code)
''')

UNDECLARED = textwrap.dedent('''
    import enum

    class DemoCalls(enum.IntEnum):
        NO_CALL = 0
        PING = 1

    class Server:
        def do_sync_recv(self, msg):
            if msg.code == int(DemoCalls.PING):
                return "pong"

    def client_call(c):
        c.sync_send(int(DemoCalls.PINNG))  # typo: drift
''')

DRIFT_SNIPPETS = {"handlerless": HANDLERLESS, "undeclared": UNDECLARED}


# ---------------------------------------------------------------------------
# Guarded-by lint
# ---------------------------------------------------------------------------

def test_guarded_field_escape_is_reported():
    findings = analyze_source(ESCAPE, "x.py")
    assert ("guard-unlocked", "_items") in _rules(findings)
    # The locked accessor must NOT fire
    assert all(f.qualname != "C.ok" for f in findings)


def test_comment_guard_annotation_and_writes():
    findings = analyze_source(COMMENT_GUARD, "x.py")
    assert [(f.rule, f.subject, f.qualname) for f in findings] == [
        ("guard-unlocked", "_count", "C.bump")]


def test_module_level_guard_map():
    findings = analyze_source(MODULE_GUARD, "m.py")
    assert [(f.rule, f.qualname) for f in findings] == [
        ("guard-unlocked", "record")]


def test_locked_suffix_convention_assumes_lock_held():
    assert analyze_source(LOCKED_SUFFIX, "x.py") == []


def test_check_then_act_across_lock_release():
    findings = analyze_source(CHECK_THEN_ACT, "x.py")
    hits = [f for f in findings if f.rule == "check-then-act"]
    assert [f.qualname for f in hits] == ["C.bad"]
    # Re-reading the guarded attr under the re-acquired lock (the fix
    # pattern) is recognised as safe


def test_blocking_call_under_lock():
    findings = analyze_source(BLOCKING, "x.py")
    hits = sorted((f.qualname, f.rule) for f in findings
                  if f.rule == "blocking-under-lock")
    assert hits == [("C.bad_indefinite_wait", "blocking-under-lock"),
                    ("C.bad_rpc", "blocking-under-lock"),
                    ("C.bad_socket", "blocking-under-lock")]


def test_nested_function_starts_unlocked():
    findings = analyze_source(NESTED, "x.py")
    # The nested def body runs later, without the lock: must be flagged
    assert ("guard-unlocked", "_items") in _rules(findings)


def test_pragma_suppression_whole_and_per_rule():
    findings = analyze_source(PRAGMAS, "x.py")
    assert [f.qualname for f in findings] == ["C.wrong_rule"]


def test_fingerprint_is_line_stable():
    f1 = analyze_source(FINGERPRINT, "x.py")
    f2 = analyze_source("\n\n\n" + FINGERPRINT, "x.py")  # shift every line
    assert [f.fingerprint for f in f1] == [f.fingerprint for f in f2]
    assert f1[0].line != f2[0].line


# ---------------------------------------------------------------------------
# Protocol drift
# ---------------------------------------------------------------------------

def _write_pkg(tmp_path, server_src: str) -> str:
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "server.py").write_text(server_src)
    return str(tmp_path)


def test_handlerless_enum_member_is_reported(tmp_path):
    root = _write_pkg(tmp_path, HANDLERLESS)
    findings = analyze_package(root, subdirs=("pkg",))
    assert [(f.rule, f.subject) for f in findings] == [
        ("unhandled-call", "ORPHANED")]
    # NO_-prefixed null members are exempt; PING is handled


def test_undeclared_enum_member_usage_is_reported(tmp_path):
    root = _write_pkg(tmp_path, UNDECLARED)
    findings = analyze_package(root, subdirs=("pkg",))
    assert ("undeclared-call-member", "DemoCalls.PINNG") in _rules(findings)


# ---------------------------------------------------------------------------
# The port's tree and the gate
# ---------------------------------------------------------------------------

def test_real_codebase_is_clean_against_baseline(capsys):
    """The port's guard maps and pragmas keep ``faabric_tpu_torch/``
    clean, with an EMPTY baseline: run the gate's entry point so the CLI
    plumbing is covered too."""
    from faabric_tpu_torch.analysis import concheck

    assert concheck.load_baseline(concheck.DEFAULT_BASELINE) == set()
    rc = concheck.main([])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "concheck: 0 finding(s), baseline carries 0" in out
    assert "concheck: ok" in out


def test_baseline_ratchet_reports_fixed_entries(tmp_path, capsys):
    from faabric_tpu_torch.analysis import concheck

    baseline = tmp_path / "baseline.txt"
    baseline.write_text("pkg/ghost.py::C.gone::guard-unlocked::_x\n")
    rc = concheck.main(["--baseline", str(baseline)])
    out = capsys.readouterr().out
    assert rc == 0  # stale baseline entries never fail the gate...
    assert "fixed:" in out  # ...but are surfaced for deletion


def test_gate_fails_on_a_new_finding_and_writes_the_ratchet(
        tmp_path, capsys, monkeypatch):
    """A finding the baseline does not carry fails the gate (exit 1);
    ``--write-baseline`` records it, and the gate then passes."""
    from faabric_tpu_torch.analysis import concheck

    root = tmp_path / "repo"
    (root / "faabric_tpu_torch").mkdir(parents=True)
    (root / "faabric_tpu_torch" / "bad.py").write_text(ESCAPE)
    real = concheck.collect_findings
    monkeypatch.setattr(concheck, "collect_findings",
                        lambda: real(str(root)))
    baseline = tmp_path / "baseline.txt"
    assert concheck.main(["--baseline", str(baseline)]) == 1
    out = capsys.readouterr().out
    assert ("fingerprint: faabric_tpu_torch/bad.py::C.bad::"
            "guard-unlocked::_items") in out
    assert concheck.main(["--baseline", str(baseline),
                          "--write-baseline"]) == 0
    assert concheck.main(["--baseline", str(baseline)]) == 0
    assert "concheck: ok" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Parity with the reference's passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GUARD_SNIPPETS))
def test_guard_snippet_fingerprints_equal_the_reference(name):
    from faabric_tpu.analysis.guards import analyze_source as ref_analyze

    src = GUARD_SNIPPETS[name]
    want = [(f.fingerprint, f.line, f.message)
            for f in ref_analyze(src, "x.py")]
    got = [(f.fingerprint, f.line, f.message)
           for f in analyze_source(src, "x.py")]
    assert got == want


@pytest.mark.parametrize("name", sorted(DRIFT_SNIPPETS))
def test_drift_snippet_fingerprints_equal_the_reference(name, tmp_path):
    from faabric_tpu.analysis.protodrift import (
        analyze_package as ref_analyze,
    )

    root = _write_pkg(tmp_path, DRIFT_SNIPPETS[name])
    want = [(f.fingerprint, f.line) for f in ref_analyze(root, ("pkg",))]
    got = [(f.fingerprint, f.line) for f in analyze_package(root, ("pkg",))]
    assert got and got == want


def _tree_fingerprints(subdir: str):
    from faabric_tpu.analysis import guards as ref_guards
    from faabric_tpu.analysis import protodrift as ref_drift
    from faabric_tpu_torch.analysis import guards, protodrift

    ref = sorted(f.fingerprint for f in (
        ref_guards.analyze_paths(REPO, (subdir,))
        + ref_drift.analyze_package(REPO, (subdir,))))
    port = sorted(f.fingerprint for f in (
        guards.analyze_paths(REPO, (subdir,))
        + protodrift.analyze_package(REPO, (subdir,))))
    return ref, port


@pytest.mark.parametrize("subdir", ["faabric_tpu_torch", "faabric_tpu"])
def test_both_packages_passes_agree_over_each_tree(subdir):
    """Both packages' passes give the same fingerprints over each tree:
    the port's analyzer differs from the reference's in no rule."""
    ref, port = _tree_fingerprints(subdir)
    assert port == ref


def test_reference_tree_stays_clean_under_the_ports_passes():
    from faabric_tpu_torch.analysis.concheck import collect_findings

    findings = collect_findings(REPO, subdirs=("faabric_tpu",))
    assert findings == [], [f.render() for f in findings]


def test_default_scan_is_the_ports_tree():
    """With no subdirs the passes scan ``faabric_tpu_torch/`` (the
    reference's default is its own package)."""
    from faabric_tpu_torch.analysis import guards, protodrift

    seen = set()
    real_file = guards.analyze_file

    def spy(path, rel=None):
        seen.add(os.path.relpath(path, REPO).split(os.sep)[0])
        return real_file(path, rel)

    try:
        guards.analyze_file = spy
        guards.analyze_paths(REPO)
    finally:
        guards.analyze_file = real_file
    assert seen == {"faabric_tpu_torch"}
    assert protodrift.analyze_package(REPO) == []
