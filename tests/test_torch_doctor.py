"""The port's doctor, timeline, flightdump, statemap and profile CLIs
against the JAX package's on the same inputs.

Each CLI of ``faabric_tpu_torch/runner/`` runs beside its counterpart in
``faabric_tpu/runner/``: both doctors over one ``--dir`` of dumped
sources (every source of the doctor's synthetic cluster, the Prometheus
text written out) and over ``--selftest`` print the same ranked
findings; both timelines render the same text and Chrome trace for the
same ledgers; both flightdumps merge the same dumps (flight rings
written by the port's and the reference's recorders) the same way; the
statemap and profile CLIs print the same tables for the same document.
The analyzers' own cases, with the reference's assertions, are in
``tests/test_torch_perfprofile.py``, ``tests/test_torch_statestats.py``
and ``tests/test_torch_lifecycle.py``.
"""

import importlib
import json

import pytest

pytest.importorskip("jax")

REF, PORT = "faabric_tpu", "faabric_tpu_torch"


def cli(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.runner.{name}")


def run_main(capsys, pkg: str, name: str, argv: list[str]):
    """(exit code, stdout) of one CLI's ``main(argv)``."""
    capsys.readouterr()
    rc = cli(pkg, name).main(argv)
    return rc, capsys.readouterr().out


def prometheus_text(parsed: dict) -> str:
    """The doctor's parsed metrics (name → [(labels, value)]) as text."""
    lines = []
    for name, rows in parsed.items():
        for labels, value in rows:
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            lines.append(f"{name}{{{lab}}} {value!r}" if lab
                         else f"{name} {value!r}")
    return "\n".join(lines) + "\n"


def dump_sources(directory, sources: dict) -> None:
    """Every source as the file ``--dir`` mode reads."""
    for name, body in sources.items():
        if body is None:
            continue
        if name == "metrics":
            (directory / "metrics.txt").write_text(prometheus_text(body))
        else:
            (directory / f"{name}.json").write_text(json.dumps(body))


@pytest.mark.parametrize("mode", [["--json"], [], ["--top", "0"]])
def test_doctors_rank_the_same_findings_over_one_dir(tmp_path, capsys,
                                                     mode):
    sources = cli(REF, "doctor").selftest_sources()
    dump_sources(tmp_path, sources)
    # The port's loader reads back what was dumped
    loaded = cli(PORT, "doctor").load_dir(str(tmp_path))
    assert loaded["metrics"] == sources["metrics"]
    rc_p, out_p = run_main(capsys, PORT, "doctor",
                           ["--dir", str(tmp_path), *mode])
    rc_r, out_r = run_main(capsys, REF, "doctor",
                           ["--dir", str(tmp_path), *mode])
    assert rc_p == rc_r == 0
    assert out_p == out_r
    if mode == ["--json"]:
        kinds = [f["kind"] for f in json.loads(out_p)["findings"]]
        assert {"slow_link", "straggler", "dominant_phase",
                "master_hotspot", "cpu_hotspot"} <= set(kinds)


def test_doctors_selftests_print_the_same(capsys):
    rc_p, out_p = run_main(capsys, PORT, "doctor", ["--selftest"])
    rc_r, out_r = run_main(capsys, REF, "doctor", ["--selftest"])
    assert rc_p == rc_r == 0
    assert out_p == out_r and "doctor selftest OK" in out_p


def test_doctor_with_no_source_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        cli(PORT, "doctor").main([])
    assert e.value.code == 2


def _status(pkg: str) -> dict:
    """Two messages' ledgers, as EXECUTE_BATCH_STATUS returns them."""
    lc = importlib.import_module(f"{pkg}.telemetry.lifecycle")
    proto = importlib.import_module(f"{pkg}.proto")
    msgs = []
    for i, run_ms in enumerate((5.0, 12.5)):
        m = proto.message_factory("u", "f")
        m.id = 1000 + i
        base = 1_000_000_000 + i * 3_000_000
        m.lc = {lc.PHASE_ADMIT: base, lc.PHASE_QUEUE_EXIT: base + 200_000,
                lc.PHASE_SCHED: base + 400_000,
                lc.PHASE_DISPATCH: base + 600_000,
                lc.PHASE_EXEC_QUEUE_EXIT: base + 900_000,
                lc.PHASE_RUN_START: base + 1_000_000,
                lc.PHASE_RUN_END: base + 1_000_000 + int(run_ms * 1e6),
                lc.PHASE_RESULT_PUSH: base + 1_200_000 + int(run_ms * 1e6),
                lc.PHASE_RECORDED: base + 1_500_000 + int(run_ms * 1e6)}
        d = m.to_dict()
        d["executed_host"] = f"h{i}"
        msgs.append(d)
    return {"appId": 123, "finished": True, "messageResults": msgs}


def test_timelines_render_the_same_ledgers_alike():
    port_tl, ref_tl = cli(PORT, "timeline"), cli(REF, "timeline")
    status = _status(PORT)
    # Both packages stamp the same ledgers
    assert ([m["lc"] for m in status["messageResults"]]
            == [m["lc"] for m in _status(REF)["messageResults"]])
    rows_p, rows_r = port_tl._msg_rows(status), ref_tl._msg_rows(status)
    assert rows_p == rows_r
    assert port_tl.render_text(123, rows_p) == ref_tl.render_text(123, rows_r)
    assert (port_tl.chrome_trace_events(123, rows_p)
            == ref_tl.chrome_trace_events(123, rows_r))


def test_flightdumps_merge_the_same_dumps_alike(tmp_path, monkeypatch,
                                                capsys):
    """Rings written by a port recorder and a reference recorder into one
    directory: both CLIs load, merge and print them alike."""
    import itertools

    monkeypatch.setenv("FAABRIC_FLIGHT_DIR", str(tmp_path))
    port_fr = importlib.import_module(f"{PORT}.telemetry.flight")
    ref_fr = importlib.import_module(f"{REF}.telemetry.flight")
    a, b = port_fr.FlightRecorder(size=32), ref_fr.FlightRecorder(size=32)
    b._n = itertools.count(100)
    a.record("send", src=0, dst=2, plane="shm", bytes=4096)
    a.record("group_abort", group=9, reason="peer dead")
    b.record("fault_fired", point="transport.send", action="drop")
    b.record("host_expired", host="w2")
    assert a.dump("mpi_world_aborted")
    assert b.dump("planner_requeue")

    port_fd, ref_fd = cli(PORT, "flightdump"), cli(REF, "flightdump")
    merged = port_fd.merge(str(tmp_path))
    assert merged == ref_fd.merge(str(tmp_path))
    assert len(merged) == 4
    assert port_fd.render(merged, last=3) == ref_fd.render(merged, last=3)
    for argv in ([str(tmp_path), "--json"], [str(tmp_path)],
                 [str(tmp_path), "--kind", "group_abort"]):
        got = run_main(capsys, PORT, "flightdump", argv)
        assert got == run_main(capsys, REF, "flightdump", argv), argv


def test_statemap_and_profile_clis_print_the_same(tmp_path, capsys):
    from tests.test_torch_profiler import _row, _snap
    from tests.test_torch_statestats import _planted_tel

    (tmp_path / "tel.json").write_text(json.dumps(_planted_tel()))
    for argv in (["--file", str(tmp_path / "tel.json")],
                 ["--file", str(tmp_path / "tel.json"), "--top", "1"]):
        got = run_main(capsys, PORT, "statemap", argv)
        assert got[0] == 0 and "demo/hot" in got[1]
        assert got == run_main(capsys, REF, "statemap", argv)

    tel = {"hA": {"profile": _snap(
        [_row("planner/tick", ["a (p/q.py:1)", "b (p/q.py:2)"], 90, 900.0),
         _row("main", ["c (p/q.py:3)"], 10, 50.0)])},
        "hB": {"profile": _snap(
            [_row("executor/pool", ["d (p/q.py:4)"], 40, 400.0)],
            pressure=0.5)}}
    (tmp_path / "prof.json").write_text(json.dumps(tel))
    for extra in ([], ["--bottom-up"], ["--collapsed"],
                  ["--collapsed", "--weight", "cpu"]):
        argv = ["--file", str(tmp_path / "prof.json"), *extra]
        got = run_main(capsys, PORT, "profile", argv)
        assert got[0] == 0 and got[1], extra
        assert got == run_main(capsys, REF, "profile", argv), extra


def test_profile_selftest_attributes_the_planted_spin(capsys):
    rc, out = run_main(capsys, PORT, "profile", ["--selftest"])
    assert rc == 0 and "profile selftest: OK" in out
