"""THREADS and PROCESSES batches, executor pools, thread results and
chaining: the port against the JAX package on the same programs.

Counterparts of ``tests/unit/test_execution_e2e.py``'s
``test_threads_batch_two_hosts_snapshot_merge``,
``test_threads_batch_with_region_hints`` and
``test_chained_functions_and_exec_graph``: each runs once on a planner
and two worker runtimes of each package, in one process on aliased port
ranges, with the reference test's own assertions, and both runs must give
the same merged bytes (or outputs and graphs). Then: a 4-thread
data-parallel SGD step of a small model whose guests take ``jax.grad`` on
the reference's side and torch gradients on the port's, merged through a
float SUM region; PROCESSES batches; pool threads; ``flush``;
``await_thread_result``; a failed snapshot push; the decision cache; and
``chip_smoke.py``'s phase 21 at a small width.

The write-fault trackers (``segv``, ``uffd``) install process-wide state
(a SIGSEGV handler, a userfaultfd), so the merge flow under them, of both
packages, runs in one subprocess of this module (``--tracker-cases``),
started once for the module; each mode reads its result.
"""

import importlib
import json
import os
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = "faabric_tpu", "faabric_tpu_torch"
N_THREADS = 8
MEM_SIZE = 8192
PAGE = 4096
RESULT_TIMEOUT = 30.0
TRACKER_MODES = ("segv", "uffd")


# ---------------------------------------------------------------------------
# Both packages' programs (the subprocess runs these too: numpy and the
# packages' control planes only)
# ---------------------------------------------------------------------------

def pkg(name: str) -> types.SimpleNamespace:
    """One package's modules under the same names."""
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in {
        "executor": "executor", "planner": "planner", "runner": "runner",
        "proto": "proto", "snapshot": "snapshot", "common":
        "transport.common", "config": "util.config", "chain":
        "scheduler.chain", "exec_graph": "util.exec_graph", "scheduler":
        "scheduler", "sched_mod": "scheduler.scheduler", "dirty":
        "util.dirty", "batch_scheduler": "batch_scheduler",
        "testing": "util.testing"}.items()}
    return types.SimpleNamespace(name=name, **mods)


def aligned_zeros(n: int) -> np.ndarray:
    """Zeros starting on a page, in pages of their own: a write-fault
    tracker then protects no page that other objects of the process
    share (their writes would fault into it from any thread), and both
    packages report the same pages."""
    buf = np.zeros(n + 2 * PAGE, np.uint8)
    off = (-buf.ctypes.data) % PAGE
    return buf[off:off + n]


def threads_executor(pk):
    """The reference test's THREADS guest with real memory: each thread
    adds ``group_idx + 1`` to a shared counter (a LONG SUM region) under
    the executor's lock and writes its byte into its own 128-byte diff
    chunk (bytewise)."""

    class ThreadsExecutor(pk.executor.Executor):
        def __init__(self, msg):
            super().__init__(msg)
            self.memory = aligned_zeros(MEM_SIZE)
            self._mem_lock = threading.Lock()

        def get_memory_view(self):
            return self.memory

        def set_memory_size(self, size):
            if size > self.memory.size:
                self.memory = np.concatenate(
                    [self.memory, np.zeros(size - self.memory.size,
                                           np.uint8)])

        def execute_task(self, thread_pool_idx, msg_idx, req):
            msg = req.messages[msg_idx]
            with self._mem_lock:
                self.memory[:8].view(np.int64)[0] += msg.group_idx + 1
            self.memory[128 * (1 + msg.group_idx)] = 100 + msg.group_idx
            return int(pk.proto.ReturnValue.SUCCESS)

    return ThreadsExecutor


def factory_of(pk, executor_cls, on_flush=None):
    class Factory(pk.executor.ExecutorFactory):
        created = 0

        def create_executor(self, msg):
            Factory.created += 1
            return executor_cls(msg)

        def flush_host(self):
            if on_flush is not None:
                on_flush()

    return Factory()


class Cluster:
    """A planner and two worker runtimes of one package on aliased port
    ranges from ``base`` (the reference test's cluster fixture)."""

    def __init__(self, pk, base: int, factory, slots: int = 4) -> None:
        self.pk = pk
        pk.common.register_host_alias("planner", "127.0.0.1", base)
        pk.planner.get_planner().reset()
        self.planner_server = pk.planner.PlannerServer(port_offset=base)
        self.workers = {}
        try:
            self.planner_server.start()
            pk.executor.set_executor_factory(factory)
            for i, name in enumerate(("hostA", "hostB")):
                pk.common.register_host_alias(name, "127.0.0.1",
                                              base + 1000 * (i + 1))
                w = pk.runner.WorkerRuntime(host=name, slots=slots,
                                            n_devices=slots,
                                            planner_host="planner")
                self.workers[name] = w
                w.start()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        pk = self.pk
        try:
            for w in self.workers.values():
                w.shutdown()
        finally:
            self.planner_server.stop()
            pk.planner.get_planner().reset()
            pk.executor.set_executor_factory(None)
            pk.common.clear_host_aliases()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def results_of(worker, req, timeout=RESULT_TIMEOUT):
    return [worker.planner_client.get_message_result(req.app_id, m.id,
                                                     timeout=timeout)
            for m in req.messages]


def threads_request(pk, function: str, n: int):
    req = pk.proto.batch_exec_factory("demo", function, n)
    req.type = int(pk.proto.BatchExecuteType.THREADS)
    for i, m in enumerate(req.messages):
        m.group_idx = i
    return req


def merge_flow(pk, base: int, hints: bool = False) -> dict:
    """``test_threads_batch_two_hosts_snapshot_merge`` (or, with
    ``hints``, ``test_threads_batch_with_region_hints``) on one package;
    returns what both packages must agree on."""
    snap_mod = pk.snapshot
    start = 500 if hints else 1000
    base_mem = np.zeros(MEM_SIZE, dtype=np.uint8)
    base_mem[:8].view(np.int64)[0] = start
    snap = snap_mod.SnapshotData(base_mem.tobytes())
    snap.add_merge_region(0, 8, snap_mod.SnapshotDataType.LONG,
                          snap_mod.SnapshotMergeOperation.SUM)
    if hints:
        # Every write extent declared, no gap fill: the hints engage
        for i in range(N_THREADS):
            snap.add_merge_region(128 * (1 + i), 1,
                                  snap_mod.SnapshotDataType.RAW,
                                  snap_mod.SnapshotMergeOperation.BYTEWISE)
    else:
        snap.fill_gaps_with_bytewise_regions()
    with Cluster(pk, base, factory_of(pk, threads_executor(pk))) as c:
        w = c.workers["hostA"]
        req = threads_request(pk, "threads", N_THREADS)
        key = f"demo/threads_{req.app_id}"
        req.snapshot_key = key
        w.snapshot_registry.register_snapshot(key, snap)
        decision = w.planner_client.call_functions(req)
        assert set(decision.hosts) == {"hostA", "hostB"}
        for r in results_of(w, req):
            assert r.return_value == int(pk.proto.ReturnValue.SUCCESS), \
                r.output_data
        on_b = c.workers["hostB"].snapshot_registry.snapshot_exists(key)
        hints_used = [
            h.scheduler._executors and next(iter(
                h.scheduler._executors.values()))[0]._batch_hints
            for h in c.workers.values()]
        # Diffs are queued before results are reported, so awaiting the
        # results means they have landed
        applied = snap.write_queued_diffs()
    merged = snap.data
    assert applied >= 2, applied
    assert merged[:8].view(np.int64)[0] == start + sum(
        i + 1 for i in range(N_THREADS))
    for i in range(N_THREADS):
        assert merged[128 * (1 + i)] == 100 + i
    assert on_b
    return {"merged": merged.tobytes().hex(), "hosts": sorted(decision.hosts),
            "hints": [None if h is None else [list(x) for x in h]
                      for h in hints_used]}


def free_base() -> int:
    from tests.conftest import next_port_base

    return next_port_base()


def _run_tracker_cases() -> dict:
    results = {}
    for mode in TRACKER_MODES:
        results[mode] = {}
        for name in (REF, PORT):
            pk = pkg(name)
            conf = pk.config.get_system_config()
            try:
                conf.dirty_tracking_mode = mode
                used = pk.dirty.make_dirty_tracker(mode).mode
                obs = merge_flow(pk, free_base())
                results[mode][name] = {"ok": True, "tracker": used,
                                       "obs": obs}
            except Exception as e:  # noqa: BLE001 — reported per case
                results[mode][name] = {"ok": False,
                                       "error": f"{type(e).__name__}: {e}"}
            finally:
                conf.reset()
    return results


if __name__ == "__main__" and "--tracker-cases" in sys.argv:
    print("TRACKER_RESULTS " + json.dumps(_run_tracker_cases()), flush=True)
    sys.exit(0)


# ---------------------------------------------------------------------------
# The test process from here on
# ---------------------------------------------------------------------------

import subprocess  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

pytest.importorskip("jax")

import jax  # noqa: E402

REF_PK, PORT_PK = pkg(REF), pkg(PORT)


@pytest.fixture(autouse=True)
def _isolate():
    yield
    for pk in (REF_PK, PORT_PK):
        pk.testing.set_mock_mode(False)
        pk.common.clear_host_aliases()
        pk.planner.get_planner().reset()
        pk.executor.set_executor_factory(None)
        pk.scheduler.clear_mock_requests()
        pk.batch_scheduler.get_decision_cache().clear()
        pk.config.get_system_config().reset()
    PORT_PK.executor.clear_registered_functions()
    importlib.import_module(
        "faabric_tpu.executor.jax_executor").clear_registered_functions()


def on_both(flow, *args, **kwargs):
    """``flow(pk, base, ...)`` on the reference, then on the port, each on
    a port slot of its own; the observations must be equal."""
    want = flow(REF_PK, free_base(), *args, **kwargs)
    got = flow(PORT_PK, free_base(), *args, **kwargs)
    assert got == want, (got, want)
    return got


# ---------------------------------------------------------------------------
# The reference's THREADS cases
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracker_results():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH", "")]))}
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), "--tracker-cases"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("TRACKER_RESULTS ")]
    assert proc.returncode == 0 and lines, (proc.returncode, proc.stdout,
                                            proc.stderr[-4000:])
    return json.loads(lines[-1].removeprefix("TRACKER_RESULTS "))


@pytest.mark.parametrize("dirty_mode", ["native", *TRACKER_MODES])
def test_threads_batch_two_hosts_snapshot_merge(dirty_mode, monkeypatch,
                                                request):
    """A THREADS batch of 8 over two hosts restores from the main
    thread's snapshot (hostB's copy came through the planner) and merges
    each host's diffs back: the LONG SUM counter and the bytewise slots.
    ``native`` runs here; ``segv`` and ``uffd`` in the tracker subprocess,
    where both packages must run the fault tracker they were asked for
    and give the same merged bytes."""
    if dirty_mode == "native":
        for pk in (REF_PK, PORT_PK):
            monkeypatch.setattr(pk.config.get_system_config(),
                                "dirty_tracking_mode", "native")
        obs = on_both(merge_flow)
        assert obs["hosts"] == ["hostA"] * 4 + ["hostB"] * 4
        return
    res = request.getfixturevalue("tracker_results")[dirty_mode]
    assert res[REF]["ok"], res[REF]
    assert res[PORT]["ok"], res[PORT]
    assert res[PORT]["tracker"] == res[REF]["tracker"]
    assert res[PORT]["obs"] == res[REF]["obs"]


def test_threads_batch_with_region_hints(monkeypatch):
    """With ``DIRTY_REGION_HINTS=1`` and every write extent declared,
    both hosts' trackers bracket only the hinted pages and the merge is
    the same as without hints, on both packages."""
    monkeypatch.setenv("DIRTY_REGION_HINTS", "1")
    for pk in (REF_PK, PORT_PK):
        pk.config.get_system_config().reset()
        assert pk.config.get_system_config().dirty_region_hints
    obs = on_both(merge_flow, hints=True)
    want = [[0, 8]] + [[128 * (1 + i), 1] for i in range(N_THREADS)]
    assert obs["hints"] == [want, want]


def chain_executor(pk):
    """'parent' chains two 'child' calls and sums their outputs."""

    class ChainExecutor(pk.executor.Executor):
        def execute_task(self, thread_pool_idx, msg_idx, req):
            msg = req.messages[msg_idx]
            if msg.function == "child":
                msg.output_data = str(int(msg.input_data) * 10).encode()
                return int(pk.proto.ReturnValue.SUCCESS)
            msg.record_exec_graph = True
            ids = [pk.chain.chain_function("child", str(i).encode())
                   for i in (1, 2)]
            assert sorted(self.get_chained_message_ids()) == sorted(ids)
            assert self.get_chained_message(ids[0]).function == "child"
            total = sum(int(pk.chain.await_chained(i, timeout=10.0)
                            .output_data) for i in ids)
            msg.output_data = str(total).encode()
            return int(pk.proto.ReturnValue.SUCCESS)

    return ChainExecutor


def chain_flow(pk, base: int) -> dict:
    with Cluster(pk, base, factory_of(pk, chain_executor(pk))) as c:
        w = c.workers["hostA"]
        req = pk.proto.batch_exec_factory("demo", "parent", 1)
        req.messages[0].record_exec_graph = True
        w.planner_client.call_functions(req)
        (result,) = results_of(w, req)
        assert result.return_value == int(pk.proto.ReturnValue.SUCCESS), \
            result.output_data
        planner = pk.planner.get_planner()
        graph = pk.exec_graph.build_exec_graph(
            lambda aid, mid: planner.get_message_result(aid, mid),
            result.id, req.app_id)
        as_json = json.loads(graph.to_json())
    nodes = [as_json["root"], *as_json["root"]["chained"]]
    return {"output": result.output_data.decode(),
            "n_chained": len(result.chained_msg_ids),
            "chained": pk.exec_graph.get_chained_functions(result)
            == result.chained_msg_ids,
            "nodes": graph.count_nodes(),
            "children": sorted(c.msg.output_data.decode()
                               for c in graph.root.children),
            "timing": [sorted(n["timing"]) for n in nodes]}


def test_chained_functions_and_exec_graph():
    """A parent chains two children through the planner and sums their
    outputs; the planner's results rebuild the 3-node call tree, each
    node with its queue, run and wall times."""
    obs = on_both(chain_flow)
    assert obs["output"] == "30" and obs["n_chained"] == 2
    assert obs["nodes"] == 3 and obs["children"] == ["10", "20"]
    assert obs["timing"] == [["exec_ms", "queue_ms", "wall_ms"]] * 3


def test_chain_function_raises_when_nothing_is_placed(monkeypatch):
    """A chained call that the planner cannot place raises in the guest
    at once instead of leaving a child nobody runs."""
    from faabric_tpu_torch.batch_scheduler.decision import (
        NOT_ENOUGH_SLOTS,
        SchedulingDecision,
    )
    from faabric_tpu_torch.executor import ExecutorContext

    class Client:
        def call_functions(self, req):
            return SchedulingDecision(NOT_ENOUGH_SLOTS, 0)

    req = PORT_PK.proto.batch_exec_factory("demo", "parent", 1)
    ex = chain_executor(PORT_PK)(req.messages[0])
    ex.scheduler = types.SimpleNamespace(planner_client=Client())
    ExecutorContext.set(ex, req, 0)
    try:
        with pytest.raises(RuntimeError, match="could not be scheduled"):
            PORT_PK.chain.chain_function("child")
    finally:
        ExecutorContext.unset()
    assert ex.get_chained_message_ids() == []


# ---------------------------------------------------------------------------
# A data-parallel SGD step of a small model, JAX guests against torch ones
# ---------------------------------------------------------------------------

SGD_CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
               max_seq=64)
SGD_THREADS, SGD_LR, SLOT = 4, 1e-2, 128


def sgd_setup():
    """Weights from JAX's initialiser, flattened in the port's leaf
    order, and an 8 x 17 token batch; each thread takes 2 rows."""
    from faabric_tpu.models.transformer import ModelConfig as JaxConfig
    from faabric_tpu.models.transformer import init_params

    from faabric_tpu_torch.models.transformer import _leaves

    jcfg = JaxConfig(**SGD_CFG, compute_dtype=jax.numpy.float32)
    np_params = jax.tree.map(np.asarray,
                             init_params(jax.random.PRNGKey(13), jcfg))
    leaves = _leaves(np_params)
    flat = np.concatenate([np.asarray(v, np.float32).ravel()
                           for _, v in leaves])
    batch = np.random.RandomState(13).randint(0, 128, (8, 17))
    return jcfg, np_params, leaves, flat, batch


def sgd_image(snap_mod, flat):
    """The main thread's snapshot: the weights under one FLOAT SUM
    region, then a results page with one bytewise loss slot a thread,
    each its own diff chunk."""
    n = flat.nbytes
    image = np.concatenate([flat.view(np.uint8), np.zeros(4096, np.uint8)])
    snap = snap_mod.SnapshotData(image)
    snap.add_merge_region(0, n, snap_mod.SnapshotDataType.FLOAT,
                          snap_mod.SnapshotMergeOperation.SUM)
    for i in range(SGD_THREADS):
        snap.add_merge_region(n + SLOT * i, SLOT)
    snap.fill_gaps_with_bytewise_regions()
    return snap


class HostSync:
    """The executor's lock and, per batch, a barrier of the host's
    threads: every thread reads the restored weights before any writes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._locks, self._barriers = {}, {}

    def lock(self, executor):
        with self._lock:
            return self._locks.setdefault(id(executor), threading.Lock())

    def barrier(self, executor, req):
        with self._lock:
            return self._barriers.setdefault(
                (id(executor), req.app_id),
                threading.Barrier(req.n_messages()))


def _port_grad(model_cfg, flat, tok, tgt):
    from faabric_tpu_torch.models import Transformer, loss_fn
    from faabric_tpu_torch.models.transformer import _leaves, _param_tree

    model = Transformer(model_cfg, device="cpu")
    with torch.no_grad():
        off = 0
        for _, p in _leaves(_param_tree(model)):
            p.copy_(torch.from_numpy(flat[off:off + p.numel()]).view_as(p))
            off += p.numel()
    loss = loss_fn(model, torch.from_numpy(tok), torch.from_numpy(tgt))
    loss.backward()
    g = torch.cat([p.grad.reshape(-1)
                   for _, p in _leaves(_param_tree(model))])
    return float(loss.detach()), g.numpy()


def _jax_grad_fn(jcfg, leaves):
    from faabric_tpu.models.transformer import loss_fn

    from faabric_tpu_torch.models.transformer import _leaves, _tree

    shapes = [(name, np.shape(v)) for name, v in leaves]

    def unflat(flat):
        out, off = {}, 0
        for name, shape in shapes:
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].reshape(shape)
            off += n
        return _tree(out)

    vg = jax.jit(jax.value_and_grad(
        lambda flat, tok, tgt: loss_fn(unflat(flat), tok, tgt, jcfg)))

    def grad(flat, tok, tgt):
        loss, g = vg(jax.numpy.asarray(flat), tok, tgt)
        return float(loss), np.asarray(g)

    return grad


def sgd_flow(pk, base, grad_of, flat, batch, factory):
    """One THREADS SGD step of 4 guests over two hosts (2 slots each):
    thread i takes the gradient of its 2 rows at the restored weights
    and adds ``-(lr/4) g_i`` into the shared image under the executor's
    lock, then its loss into its slot. Returns the merged image."""
    n = flat.nbytes
    sync = HostSync()

    def guest(ctx):
        mem = ctx.executor.get_memory_view()
        i = ctx.message.app_idx
        w = mem[:n].view(np.float32).copy()
        sync.barrier(ctx.executor, ctx.request).wait(RESULT_TIMEOUT)
        loss, g = grad_of(w, batch[2 * i:2 * i + 2, :-1],
                          batch[2 * i:2 * i + 2, 1:])
        with sync.lock(ctx.executor):
            mem[:n].view(np.float32)[:] += np.float32(-SGD_LR / 4) * g
        mem[n + SLOT * i:n + SLOT * i + 4] = np.frombuffer(
            np.float32(loss).tobytes(), np.uint8)

    register = (PORT_PK.executor.register_function if pk is PORT_PK else
                importlib.import_module(
                    "faabric_tpu.executor.jax_executor").register_function)
    register("demo", "sgd", guest)
    snap = sgd_image(pk.snapshot, flat)
    with Cluster(pk, base, factory, slots=2) as c:
        w = c.workers["hostA"]
        req = pk.proto.batch_exec_factory("demo", "sgd", SGD_THREADS)
        req.type = int(pk.proto.BatchExecuteType.THREADS)
        w.snapshot_registry.register_snapshot(
            pk.proto.get_main_thread_snapshot_key(req.messages[0]), snap)
        decision = w.planner_client.call_functions(req)
        assert sorted(decision.hosts) == ["hostA"] * 2 + ["hostB"] * 2
        for r in results_of(w, req):
            assert r.return_value == int(pk.proto.ReturnValue.SUCCESS), \
                r.output_data
        assert snap.write_queued_diffs() >= 2
    return snap.data.copy()


def test_threads_sgd_step_matches_jax():
    """The merged images of both packages agree within 1e-5, each equals
    ``w - (lr/4) sum g_i`` of its own gradients taken directly, and each
    slot holds its share's loss bit for bit."""
    from faabric_tpu.executor.jax_executor import JaxExecutorFactory

    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.models import ModelConfig

    jcfg, _np_params, leaves, flat, batch = sgd_setup()
    pcfg = ModelConfig(**SGD_CFG, compute_dtype=torch.float32)
    grads = {REF: _jax_grad_fn(jcfg, leaves),
             PORT: lambda w, tok, tgt: _port_grad(pcfg, w, tok, tgt)}
    merged = {
        REF: sgd_flow(REF_PK, free_base(), grads[REF], flat, batch,
                      JaxExecutorFactory()),
        PORT: sgd_flow(PORT_PK, free_base(), grads[PORT], flat, batch,
                       TorchExecutorFactory(device="cpu"))}
    n = flat.nbytes
    for name, image in merged.items():
        shares = [grads[name](flat, batch[2 * i:2 * i + 2, :-1],
                              batch[2 * i:2 * i + 2, 1:])
                  for i in range(SGD_THREADS)]
        want = flat.astype(np.float64) - SGD_LR / 4 * np.sum(
            [g.astype(np.float64) for _, g in shares], axis=0)
        got = image[:n].view(np.float32)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                   err_msg=name)
        assert not np.array_equal(got, flat)
        slots = [image[n + SLOT * i:n + SLOT * i + 4].view(np.float32)[0]
                 for i in range(SGD_THREADS)]
        assert [s.tobytes() for s in slots] == [
            np.float32(loss).tobytes() for loss, _ in shares], name
    np.testing.assert_allclose(merged[PORT][:n].view(np.float32),
                               merged[REF][:n].view(np.float32),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(merged[PORT][n:].view(np.float32),
                               merged[REF][n:].view(np.float32),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# PROCESSES, pools, flush, thread results, snapshot pushes, the cache
# ---------------------------------------------------------------------------

def echo_executor(pk, seen=None, gather=False):
    """Echoes input reversed; with ``gather``, every message of a batch
    waits for the others to start, so no executor frees up mid-batch."""
    barriers, lock = {}, threading.Lock()

    class EchoExecutor(pk.executor.Executor):
        def execute_task(self, thread_pool_idx, msg_idx, req):
            msg = req.messages[msg_idx]
            if gather:
                with lock:
                    barrier = barriers.setdefault(
                        req.app_id, threading.Barrier(req.n_messages()))
                barrier.wait(RESULT_TIMEOUT)
            if seen is not None:
                seen[msg_idx] = (thread_pool_idx,
                                 threading.current_thread().name, self.id)
            msg.output_data = msg.input_data[::-1]
            return int(pk.proto.ReturnValue.SUCCESS)

    return EchoExecutor


def processes_flow(pk, base: int) -> dict:
    """A PROCESSES batch of 3 and a FUNCTIONS batch of 3 on one host:
    both claim one executor per message and report to the planner."""
    factory = factory_of(pk, echo_executor(pk, gather=True))
    out = {}
    with Cluster(pk, base, factory) as c:
        w = c.workers["hostA"]
        for kind in ("PROCESSES", "FUNCTIONS"):
            before = factory.created
            req = pk.proto.batch_exec_factory("demo", f"echo_{kind}", 3)
            req.type = int(getattr(pk.proto.BatchExecuteType, kind))
            for i, m in enumerate(req.messages):
                m.input_data = f"{kind}-{i}".encode()
            decision = w.planner_client.call_functions(req)
            rs = results_of(w, req)
            host = c.workers[decision.hosts[0]].scheduler
            out[kind] = {
                "created": factory.created - before,
                "one_host": len(set(decision.hosts)) == 1,
                "executors": host.get_executor_count(req.messages[0]),
                "outputs": [r.output_data.decode() for r in rs],
                "ok": [r.return_value for r in rs]}
    return out


def test_processes_batches_run_like_functions_batches():
    obs = on_both(processes_flow)
    for kind in ("PROCESSES", "FUNCTIONS"):
        assert obs[kind]["created"] == obs[kind]["executors"] == 3
        assert obs[kind]["outputs"] == [f"{kind}-{i}"[::-1]
                                        for i in range(3)]
        assert obs[kind]["ok"] == [0, 0, 0]


def pool_flow(pk, _base: int) -> dict:
    """A one-host THREADS batch of 6 on an executor whose pool has 4
    threads: message i runs on pool thread i % 4."""
    pk.config.get_system_config().override_cpu_count = 4
    seen = {}
    req = threads_request(pk, "echo", 6)
    req.single_host = True
    ex = echo_executor(pk, seen)(req.messages[0])
    try:
        assert ex.try_claim()
        ex.execute_tasks(list(range(6)), req)
        deadline = time.monotonic() + RESULT_TIMEOUT
        while ex.is_claimed() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not ex.is_claimed()
        prefix = f"executor/pool@{ex.id}-"
        names = sorted(t.name.removeprefix(prefix)
                       for t in threading.enumerate()
                       if t.name.startswith(prefix))
    finally:
        ex.shutdown()
    assert not any(t.name.startswith(prefix) for t in threading.enumerate())
    return {"pool_size": ex.pool_size, "threads": names,
            "seen": {i: [p, name.removeprefix(prefix)]
                     for i, (p, name, _) in sorted(seen.items())}}


def test_pool_threads_take_tasks_by_message_index():
    obs = on_both(pool_flow)
    assert obs["pool_size"] == 4 and obs["threads"] == ["0", "1", "2", "3"]
    assert obs["seen"] == {i: [i % 4, str(i % 4)] for i in range(6)}


def flush_flow(pk, base: int) -> dict:
    """FLUSH over the function-call RPC drops the host's warm executors
    and runs the factory's ``flush_host``; in mock mode the client
    records the call instead."""
    flushed = []
    factory = factory_of(pk, echo_executor(pk),
                         on_flush=lambda: flushed.append(1))
    with Cluster(pk, base, factory) as c:
        w = c.workers["hostA"]
        req = pk.proto.batch_exec_factory("demo", "echo", 2)
        decision = w.planner_client.call_functions(req)
        results_of(w, req)
        hosts = sorted(set(decision.hosts))
        count = lambda: sum(h.scheduler.get_executor_count()  # noqa: E731
                            for h in c.workers.values())
        warm = count()
        for host in hosts:
            client = pk.scheduler.FunctionCallClient(host)
            try:
                client.send_flush()
            finally:
                client.close()
        after = count()
    pk.testing.set_mock_mode(True)
    pk.scheduler.FunctionCallClient("hostZ").send_flush()
    mock = pk.scheduler.get_flush_calls()
    pk.testing.set_mock_mode(False)
    return {"warm": warm, "after": after,
            "flushed": len(flushed) == len(hosts), "mock": mock}


def test_flush_drops_warm_executors_and_calls_flush_host():
    obs = on_both(flush_flow)
    assert obs == {"warm": 2, "after": 0, "flushed": True, "mock": ["hostZ"]}


def await_flow(pk, _base: int) -> dict:
    sched = pk.sched_mod.Scheduler("solo", None)
    t0 = time.monotonic()
    try:
        sched.await_thread_result(42, timeout=0.05)
        raised = False
    except TimeoutError:
        raised = True
    waited = time.monotonic() - t0
    msg = pk.proto.Message(id=42, app_id=1)
    threading.Timer(0.05, sched.set_thread_result_locally,
                    (msg, 3)).start()
    got = sched.await_thread_result(42, timeout=RESULT_TIMEOUT)
    # The reference's shutdown closes the host's state clients
    sched.state = types.SimpleNamespace(close_clients=lambda: None)
    sched.reset()
    try:
        sched.await_thread_result(42, timeout=0.01)
        kept = True
    except TimeoutError:
        kept = False
    return {"raised": raised, "waited": 0.05 <= waited < 5.0, "got": got,
            "kept_after_reset": kept}


def test_await_thread_result_times_out_then_wakes():
    assert on_both(await_flow) == {"raised": True, "waited": True, "got": 3,
                                   "kept_after_reset": False}


class StubScheduler:
    """What an executor needs of its scheduler for a THREADS batch: a
    host, a snapshot registry and the result calls, recorded."""

    def __init__(self, pk, registry):
        self.host = "solo"
        self.snapshot_registry = registry
        self.reports = []
        self.idle = threading.Event()

    def report_thread_result(self, msg, ret, key, diffs):
        self.reports.append((msg.id, ret, diffs))

    def notify_executor_idle(self, executor):
        self.idle.set()


def stress_flow(pk, _base: int, n_tasks: int = 64) -> dict:
    """64 THREADS tasks of one batch on a pool of 16 (more threads than
    cores), switching every microsecond: every thread's pages reach the
    last thread's diff, and the counter misses no update."""
    mem_size = 128 * (n_tasks + 1)
    pk.config.get_system_config().override_cpu_count = 16
    base_mem = np.zeros(mem_size, np.uint8)
    snap = pk.snapshot.SnapshotData(base_mem)
    snap.add_merge_region(0, 8, pk.snapshot.SnapshotDataType.LONG,
                          pk.snapshot.SnapshotMergeOperation.SUM)
    snap.fill_gaps_with_bytewise_regions()
    registry = pk.snapshot.SnapshotRegistry()
    registry.register_snapshot("demo/stress", snap)
    sched = StubScheduler(pk, registry)
    req = threads_request(pk, "threads", n_tasks)
    req.snapshot_key = "demo/stress"
    ex = threads_executor(pk)(req.messages[0])
    ex.memory = aligned_zeros(mem_size)
    ex.scheduler = sched
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert ex.try_claim()
        ex.execute_tasks(list(range(n_tasks)), req)
        assert sched.idle.wait(RESULT_TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
        ex.shutdown()
    with_diffs = [d for _, _, d in sched.reports if d]
    snap.queue_diffs(with_diffs[0])
    snap.write_queued_diffs()
    return {"reports": len(sched.reports), "with_diffs": len(with_diffs),
            "counter": int(snap.data[:8].view(np.int64)[0]),
            "slots": [int(snap.data[128 * (1 + i)]) for i in range(n_tasks)]}


def test_threads_batch_under_a_short_switch_interval():
    obs = on_both(stress_flow)
    assert obs == {"reports": 64, "with_diffs": 1,
                   "counter": sum(range(1, 65)),
                   "slots": [(100 + i) % 256 for i in range(64)]}


def test_failed_snapshot_push_fails_that_hosts_messages():
    """hostB cannot take the main thread's snapshot (its SnapshotServer
    is down): with no requeue budget its threads report FAILED with the
    reason, hostA's run and merge. (With a budget they are requeued:
    ``tests/test_torch_recovery.py``.)"""
    pk = PORT_PK
    pk.config.get_system_config().planner_max_requeues = 0
    with Cluster(pk, free_base(), factory_of(pk, threads_executor(pk))) as c:
        c.workers["hostB"].snapshot_server.stop()
        w = c.workers["hostA"]
        req = threads_request(pk, "threads", N_THREADS)
        snap = pk.snapshot.SnapshotData(np.zeros(MEM_SIZE, np.uint8))
        snap.fill_gaps_with_bytewise_regions()
        req.snapshot_key = "demo/threads_push_fails"
        w.snapshot_registry.register_snapshot(req.snapshot_key, snap)
        decision = w.planner_client.call_functions(req)
        by_id = dict(zip(decision.message_ids, decision.hosts))
        for r in results_of(w, req):
            if by_id[r.id] == "hostB":
                assert r.return_value == int(pk.proto.ReturnValue.FAILED)
                assert r.output_data == b"Snapshot push failed"
            else:
                assert r.return_value == int(pk.proto.ReturnValue.SUCCESS)
        assert sorted(set(by_id.values())) == ["hostA", "hostB"]
        snap.write_queued_diffs()
    got = snap.data
    for i in range(N_THREADS):
        want = 100 + i if by_id[req.messages[i].id] == "hostA" else 0
        assert got[128 * (1 + i)] == want


def cache_flow(pk, base: int) -> dict:
    """Two THREADS batches of one shape: the second takes the first's
    cached placement without asking the policy, and the planner client
    pushes the main thread's snapshot again for each."""
    policy = pk.batch_scheduler.get_batch_scheduler()
    calls = []
    real = policy.make_scheduling_decision

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    policy.make_scheduling_decision = counted
    snap = pk.snapshot.SnapshotData(np.zeros(MEM_SIZE, np.uint8))
    snap.add_merge_region(0, 8, pk.snapshot.SnapshotDataType.LONG,
                          pk.snapshot.SnapshotMergeOperation.SUM)
    snap.fill_gaps_with_bytewise_regions()
    decisions = []
    try:
        with Cluster(pk, base, factory_of(pk, threads_executor(pk))) as c:
            w = c.workers["hostA"]
            planner_reg = pk.planner.get_planner().snapshot_registry
            for _ in range(2):
                req = threads_request(pk, "threads", N_THREADS)
                req.snapshot_key = "demo/threads_cached"
                w.snapshot_registry.register_snapshot(req.snapshot_key, snap)
                decisions.append(w.planner_client.call_functions(req))
                results_of(w, req)
                snap.write_queued_diffs()
                # What the planner holds is the merged image pushed anew
                np.testing.assert_array_equal(
                    planner_reg.get_snapshot(req.snapshot_key).data[:8]
                    .view(np.int64), [36 * (len(decisions) - 1)])
            cached = pk.batch_scheduler.get_decision_cache() \
                .get_cached_decision(req).hosts
    finally:
        del policy.make_scheduling_decision
    return {"policy_calls": len(calls),
            "same": decisions[0].hosts == decisions[1].hosts == cached,
            "counter": int(snap.data[:8].view(np.int64)[0])}


def test_threads_decision_cache_reuses_the_placement():
    assert on_both(cache_flow) == {"policy_calls": 1, "same": True,
                                   "counter": 72}


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 21 at a small width, on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_threads_phase_small():
    """Phase 21's program (a THREADS SGD step over two hosts merged
    through a float SUM region, a second step served from the decision
    cache, chained scoring) on CPU tensors at a small width; the launch
    checks are the card's alone."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from faabric_tpu_torch.models import ModelConfig
    from faabric_tpu_torch.ops import _build

    cfg = ModelConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                      d_ff=128, max_seq=64)
    out = chip_smoke.threads_phase(torch.device("cpu"), _build, cfg=cfg,
                                   seq=16, base=free_base())
    assert out == {}


def test_tracker_modes_never_load_in_the_test_process():
    """The port's write-fault trackers stay in the subprocess."""
    import faabric_tpu_torch.util.native as port_native

    assert not {"segv_tracker", "uffd_tracker"} & set(port_native._cache)
