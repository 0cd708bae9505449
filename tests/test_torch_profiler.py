"""The port's stack sampler against the JAX package's.

Counterpart of ``tests/unit/test_profiler.py``: thread-name classing,
the stack trie's node and depth bounds, per-thread CPU attribution (the
CPU clock injected, so a loaded machine cannot starve the case), the
GIL-pressure estimator, the disabled no-op pin, the aggregate, render
and diff pipeline, and the refcounted sampler thread, which every case
stops. Cross-package: the same host profiles aggregate, render,
collapse and diff to the reference's documents.
"""

import threading
import time

import pytest

from faabric_tpu_torch.telemetry.profiler import (
    CAP_LABEL,
    NULL_PROFILER,
    TRUNC_LABEL,
    Profiler,
    aggregate_profile,
    bottom_up,
    collapsed_lines,
    diff_profiles,
    get_profiler,
    profile_enabled,
    profile_telemetry_block,
    render_profile,
    reset_profiler,
    start_profiler,
    stop_profiler,
    thread_class,
)


@pytest.fixture(autouse=True)
def _clean_singleton():
    reset_profiler()
    yield
    reset_profiler()


def _sampler_threads():
    return [t for t in threading.enumerate()
            if t.name == "telemetry/profiler"]


@pytest.fixture(autouse=True)
def _clean_port_telemetry():
    from tests.test_torch_telemetry import clean_port_telemetry, port_singletons

    saved = port_singletons()
    yield
    clean_port_telemetry(saved)

# ---------------------------------------------------------------------------
# thread classing
# ---------------------------------------------------------------------------

class TestThreadClass:
    @pytest.mark.parametrize("name,cls", [
        ("MainThread", "main"),
        ("telemetry/profiler", "telemetry/profiler"),
        ("bulk/conn@9031", "bulk/conn"),
        ("planner/recover@app7", "planner/recover"),
        ("executor/pool@e1-0", "executor/pool"),
        ("Thread-7 (drain_stdout)", "other/drain_stdout"),
        ("Thread-12", "unnamed"),
        ("ThreadPoolExecutor-0_1", "other/ThreadPoolExecutor-0"),
        ("pydevd.Writer", "other/pydevd.Writer"),
        ("", "unnamed"),
    ])
    def test_classing_table(self, name, cls):
        assert thread_class(name) == cls


# ---------------------------------------------------------------------------
# trie bounds
# ---------------------------------------------------------------------------

class TestTrieBounds:
    def test_node_budget_folds_into_cap_child(self):
        p = Profiler(interval_s=0.025, max_nodes=8)
        with p._lock:
            for i in range(50):
                p._fold_locked("t/spam",
                               [f"f{i} (a/b.py:1)", f"g{i} (a/b.py:2)"],
                               1.0)
        snap = p.snapshot()
        assert snap["nodes"] <= 8 + 1  # budget + the reserved cap child
        assert snap["dropped_frames"] > 0
        cap_rows = [r for r in snap["stacks"]
                    if CAP_LABEL in r["frames"]]
        assert cap_rows, snap["stacks"]
        # Counts stay exact: every fold landed somewhere
        assert snap["classes"]["t/spam"]["samples"] == 50

    def test_depth_cap_keeps_innermost_frames(self):
        p = Profiler(interval_s=0.025, max_depth=5)
        ready, release = threading.Event(), threading.Event()

        def deep(n):
            if n:
                return deep(n - 1)
            ready.set()
            release.wait(10)

        t = threading.Thread(target=deep, args=(30,),
                             name="test/deep", daemon=True)
        t.start()
        assert ready.wait(10)
        try:
            p.sample_now()
        finally:
            release.set()
            t.join(timeout=10)
        rows = [r for r in p.snapshot()["stacks"]
                if r["class"] == "test/deep"]
        assert rows, p.snapshot()["stacks"]
        frames = rows[0]["frames"]
        assert frames[0] == TRUNC_LABEL
        assert len(frames) <= 6  # marker + max_depth
        # Innermost frames survived the fold: the parked wait() leaf
        # plus the deepest recursion levels just above it
        assert "wait" in frames[-1]
        assert any(f.startswith("deep ") for f in frames[1:])

    def test_snapshot_schema(self):
        p = Profiler(interval_s=0.025)
        p.sample_now()
        snap = p.snapshot()
        assert {"enabled", "pid", "interval_ms", "samples",
                "expected_samples", "wall_s", "sample_cost_ms",
                "overhead_pct", "nodes", "max_nodes", "dropped_frames",
                "classes", "stacks", "gil"} <= set(snap)
        assert {"pressure", "drift_ratio_avg", "drift_ratio_max",
                "runnable_now", "runnable_avg",
                "late_samples"} <= set(snap["gil"])
        assert snap["samples"] == 1


# ---------------------------------------------------------------------------
# CPU + GIL attribution
# ---------------------------------------------------------------------------

class TestAttribution:
    def test_cpu_weighting_separates_spin_from_idle(self, monkeypatch):
        """The reference's case with the per-thread CPU clock injected:
        a thread charged 10 ms a sample against one charged nothing
        (the reference spins a real thread, which a loaded machine can
        starve)."""
        stop = threading.Event()
        st = threading.Thread(target=lambda: stop.wait(30),
                              name="test/spin@1", daemon=True)
        it = threading.Thread(target=lambda: stop.wait(30),
                              name="test/idle@1", daemon=True)
        st.start()
        it.start()
        clock = {"spin": 0.0}

        def fake_cpu():
            clock["spin"] += 0.01
            return {st.native_id: clock["spin"], it.native_id: 0.5}

        p = Profiler(interval_s=0.01)
        monkeypatch.setattr(p, "_read_thread_cpu", fake_cpu)
        try:
            for _ in range(40):
                p.sample_now()
        finally:
            stop.set()
            st.join(timeout=10)
            it.join(timeout=10)
        classes = p.snapshot()["classes"]
        assert "test/spin" in classes and "test/idle" in classes
        spin_cpu = classes["test/spin"]["cpu_ms"]
        assert spin_cpu == pytest.approx(390.0)  # 39 deltas of 10 ms
        assert spin_cpu > 10 * max(classes["test/idle"]["cpu_ms"], 0.1)

    def test_gil_pressure_tracks_drift_and_missed_wakeups(self):
        p = Profiler(interval_s=0.025)
        p.sample_now(drift_s=0.0)
        assert p.snapshot()["gil"]["pressure"] < 0.05
        for _ in range(40):
            p.sample_now(drift_s=0.025)  # a full period late
        gil = p.snapshot()["gil"]
        assert gil["pressure"] > 0.9
        assert gil["drift_ratio_max"] >= 1.0
        p.note_missed(10)
        snap = p.snapshot()
        assert snap["expected_samples"] == snap["samples"] + 10


# ---------------------------------------------------------------------------
# disabled path
# ---------------------------------------------------------------------------

class TestDisabledPath:
    def test_disabled_pins_to_shared_noop(self, monkeypatch):
        monkeypatch.setenv("FAABRIC_PROFILE", "0")
        assert not profile_enabled()
        assert get_profiler() is NULL_PROFILER
        assert profile_telemetry_block() == {}
        assert NULL_PROFILER.snapshot() == {}
        start_profiler()  # must not spawn anything
        assert not _sampler_threads()
        stop_profiler()


# ---------------------------------------------------------------------------
# aggregate / render / diff
# ---------------------------------------------------------------------------

def _snap(stacks, pressure=0.1, samples=100):
    return {
        "enabled": True, "pid": 42, "interval_ms": 25.0,
        "samples": samples, "expected_samples": samples,
        "wall_s": samples * 0.025, "sample_cost_ms": 0.1,
        "overhead_pct": 0.4, "nodes": 16, "max_nodes": 4096,
        "dropped_frames": 0,
        "classes": {s["class"]: {"samples": s["samples"],
                                 "cpu_ms": s["cpu_ms"],
                                 "threads_now": 1} for s in stacks},
        "stacks": stacks,
        "gil": {"pressure": pressure, "drift_ratio_avg": pressure,
                "drift_ratio_max": pressure, "runnable_now": 1,
                "runnable_avg": 1.0, "late_samples": 0},
    }


def _row(cls, frames, samples, cpu_ms):
    return {"class": cls, "frames": frames, "samples": samples,
            "cpu_ms": cpu_ms}


class TestAggregatePipeline:
    def _doc(self):
        return aggregate_profile({
            "hA": {"profile": _snap(
                [_row("planner/tick", ["a (p/q.py:1)", "b (p/q.py:2)"],
                      90, 900.0),
                 _row("main", ["c (p/q.py:3)"], 10, 50.0)])},
            "hB": {"profile": _snap(
                [_row("executor/pool", ["d (p/q.py:4)"], 40, 400.0)],
                pressure=0.5)},
            "hC": {"profile": {}},  # disabled host ships an empty block
        })

    def test_ranking_and_host_attribution(self):
        doc = self._doc()
        assert set(doc["hosts"]) == {"hA", "hB"}
        assert doc["stacks"][0]["host"] == "hA"
        assert doc["stacks"][0]["rank"] == 1
        assert doc["stacks"][0]["cpu_ms"] == 900.0
        assert doc["stacks"][1] == {
            **doc["stacks"][1],
            "host": "hB", "class": "executor/pool"}
        assert doc["gil"]["hB"]["pressure"] == 0.5
        # cpu_share is per-host, not cluster-wide
        assert doc["stacks"][0]["cpu_share"] == pytest.approx(
            900.0 / 950.0, abs=1e-3)

    def test_render_and_collapsed(self):
        doc = self._doc()
        text = render_profile(doc)
        assert "hA" in text and "planner/tick" in text
        lines = collapsed_lines(doc)
        assert any(line.startswith("hA;planner/tick;a (p/q.py:1);b ")
                   for line in lines)
        assert all(line.rsplit(" ", 1)[1].isdigit() for line in lines)
        cpu_lines = collapsed_lines(doc, weight="cpu")
        assert any(line.rsplit(" ", 1)[1] == "900" for line in cpu_lines)

    def test_bottom_up_self_weights(self):
        rows = bottom_up(self._doc())
        # b is hA's leaf: it owns the 900ms, frame a owns none of it
        top = rows[0]
        assert top["frame"].startswith("b ")
        assert top["cpu_ms"] == 900.0
        assert not any(r["frame"].startswith("a ") for r in rows)

    def test_diff_matches_by_host_class_stack(self):
        before = self._doc()
        after = aggregate_profile({
            "hA": {"profile": _snap(
                [_row("planner/tick", ["a (p/q.py:1)", "b (p/q.py:2)"],
                      190, 2900.0),
                 _row("main", ["c (p/q.py:3)"], 10, 50.0)])},
            "hB": {"profile": _snap(
                [_row("executor/pool", ["d (p/q.py:4)"], 40, 400.0)],
                pressure=0.5)},
        })
        rows = diff_profiles(before, after)
        assert rows[0]["host"] == "hA"
        assert rows[0]["cpu_ms_delta"] == 2000.0
        flat = [r for r in rows if r["host"] == "hB"]
        assert all(r["cpu_ms_delta"] == 0 for r in flat)


# ---------------------------------------------------------------------------
# refcounted lifecycle
# ---------------------------------------------------------------------------

class TestLifecycle:
    def test_refcounted_start_stop_leaves_no_thread(self):
        assert not _sampler_threads()
        start_profiler()   # planner
        start_profiler()   # co-resident worker runtime
        assert len(_sampler_threads()) == 1
        stop_profiler()
        assert len(_sampler_threads()) == 1  # one user still holds it
        stop_profiler()
        assert not _sampler_threads()
        # Idempotent past zero
        stop_profiler()
        assert not _sampler_threads()

    def test_sampler_thread_samples_and_is_named(self):
        start_profiler()
        try:
            p = get_profiler()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if p.snapshot()["samples"] >= 2:
                    break
                time.sleep(0.02)
            assert p.snapshot()["samples"] >= 2
            (t,) = _sampler_threads()
            assert thread_class(t.name) == "telemetry/profiler"
        finally:
            stop_profiler()
        assert not _sampler_threads()


# ---------------------------------------------------------------------------
# Cross-package: the same host profiles, the same documents
# ---------------------------------------------------------------------------

def test_profile_pipeline_equals_reference():
    from faabric_tpu.telemetry import profiler as ref_prof

    from faabric_tpu_torch.telemetry import profiler as port_prof

    tel = {
        "hA": {"profile": _snap(
            [_row("planner/tick", ["a (p/q.py:1)", "b (p/q.py:2)"],
                  90, 900.0),
             _row("main", ["c (p/q.py:3)"], 10, 50.0)])},
        "hB": {"profile": _snap(
            [_row("executor/pool", ["d (p/q.py:4)", "e (p/q.py:9)"], 40,
                  400.0)], pressure=0.5)},
        "hC": {"profile": {}},
    }
    got, want = (port_prof.aggregate_profile(tel),
                 ref_prof.aggregate_profile(tel))
    got.pop("generated_at", None)
    want.pop("generated_at", None)
    assert got == want
    assert port_prof.render_profile(got) == ref_prof.render_profile(want)
    for weight in ("samples", "cpu"):
        assert port_prof.collapsed_lines(got, weight=weight) == \
            ref_prof.collapsed_lines(want, weight=weight)
    assert port_prof.bottom_up(got) == ref_prof.bottom_up(want)
    assert port_prof.diff_profiles(got, got) == \
        ref_prof.diff_profiles(want, want)
    for name in ("MainThread", "planner/tick@3", "Thread-7 (worker)",
                 "faabric-mpi-send-2", "executor/pool-1", ""):
        assert port_prof.thread_class(name) == ref_prof.thread_class(name)
