"""The port's control plane end to end: planner, workers, executors.

Counterpart of ``tests/unit/test_execution_e2e.py``: a port
``PlannerServer`` and two port ``WorkerRuntime`` hosts in one process on
aliased port ranges, every RPC over real sockets. Mirrors its cases
(single-host batch, two-host spread, failure propagation, warm reuse,
scale change, host removal and expiry, ping, mock mode, group mappings
with dispatch), then the torch guest functions: four ranks on distinct
planner device ids, stage 1 of ``dryrun_multichip`` (a gang of four with
a barrier and a ring handoff), and a small model served through the
planner that gives the JAX package's logits and greedy tokens. Guests
run on the CPU (``device="cpu"``).
"""

import threading
import time

import numpy as np
import pytest
import torch

from faabric_tpu_torch.batch_scheduler import reset_batch_scheduler
from faabric_tpu_torch.executor import (
    Executor,
    ExecutorContext,
    ExecutorFactory,
    GuestContext,
    TorchExecutor,
    TorchExecutorFactory,
    clear_registered_functions,
    register_function,
    set_executor_factory,
)
from faabric_tpu_torch.planner import (
    PlannerServer,
    clear_mock_planner_calls,
    get_planner,
)
from faabric_tpu_torch.proto import (
    BatchExecuteType,
    ReturnValue,
    batch_exec_factory,
)
from faabric_tpu_torch.runner import WorkerRuntime
from faabric_tpu_torch.scheduler import (
    FunctionCallClient,
    clear_mock_requests,
    get_batch_requests,
)
from faabric_tpu_torch.transport import (
    PointToPointBroker,
    RpcError,
    clear_host_aliases,
    register_host_alias,
)
from faabric_tpu_torch.transport.ptp_remote import clear_sent_ptp
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.testing import set_mock_mode

RESULT_TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _reset_port_globals():
    """The port's process-wide state, reset after every test (the
    suite's conftest resets the JAX package's)."""
    yield
    set_mock_mode(False)
    clear_host_aliases()
    get_planner().reset()
    clear_registered_functions()
    set_executor_factory(None)
    clear_mock_requests()
    clear_mock_planner_calls()
    clear_sent_ptp()
    reset_batch_scheduler()
    get_system_config().reset()


# Released by a test that inspects an app while its messages run
HOLD = threading.Event()


class EchoExecutor(Executor):
    """Echoes input reversed; function "fail" raises, "hold" waits for
    HOLD first; checks its context."""

    def execute_task(self, thread_pool_idx, msg_idx, req):
        msg = req.messages[msg_idx]
        if msg.function == "fail":
            raise RuntimeError("intentional failure")
        if msg.function == "hold" and not HOLD.wait(RESULT_TIMEOUT):
            raise RuntimeError("never released")
        ctx = ExecutorContext.get()
        assert ctx.msg is msg
        assert ctx.executor is self
        msg.output_data = msg.input_data[::-1]
        return int(ReturnValue.SUCCESS)


class EchoFactory(ExecutorFactory):
    def __init__(self):
        self.created = 0

    def create_executor(self, msg):
        self.created += 1
        return EchoExecutor(msg)


class GangExecutor(Executor):
    """Stage 1 of ``dryrun_multichip`` (``__graft_entry__.py:72-88``):
    ranks hold at the group barrier until the whole gang runs, hand a
    byte to their ring neighbour, and meet again."""

    def execute_task(self, thread_pool_idx, msg_idx, req):
        msg = req.messages[msg_idx]
        broker = self.scheduler.ptp_broker
        broker.wait_for_mappings(msg.group_id, timeout=RESULT_TIMEOUT)
        group = broker.get_group(msg.group_id)
        group.barrier(msg.group_idx, timeout=RESULT_TIMEOUT)
        n = group.group_size
        nxt, prv = (msg.group_idx + 1) % n, (msg.group_idx - 1) % n
        broker.send_message(msg.group_id, msg.group_idx, nxt,
                            bytes([msg.group_idx]))
        got = broker.recv_message(msg.group_id, prv, msg.group_idx,
                                  timeout=RESULT_TIMEOUT)
        if got != bytes([prv]):
            raise RuntimeError(f"rank {msg.group_idx} got {got!r} from {prv}")
        group.barrier(msg.group_idx, timeout=RESULT_TIMEOUT)
        return int(ReturnValue.SUCCESS)


class GangFactory(ExecutorFactory):
    def create_executor(self, msg):
        return GangExecutor(msg)


def _start_cluster(hosts, factory):
    from tests.conftest import next_port_base

    base = next_port_base()
    register_host_alias("planner", "127.0.0.1", base)
    get_planner().reset()
    planner_server = PlannerServer(port_offset=base)
    workers = {}
    try:
        planner_server.start()
        set_executor_factory(factory)
        for i, name in enumerate(hosts):
            register_host_alias(name, "127.0.0.1", base + 1000 * (i + 1))
            w = WorkerRuntime(host=name, slots=4, n_devices=4,
                              planner_host="planner")
            workers[name] = w
            w.start()
    except Exception:
        _stop_cluster(planner_server, workers)
        raise
    return planner_server, workers


def _stop_cluster(planner_server, workers):
    try:
        for w in workers.values():
            w.shutdown()
    finally:
        planner_server.stop()
        get_planner().reset()


@pytest.fixture
def cluster():
    """PlannerServer and two aliased worker runtimes in one process."""
    factory = EchoFactory()
    planner_server, workers = _start_cluster(("hostA", "hostB"), factory)
    try:
        yield {"planner_server": planner_server, "workers": workers,
               "factory": factory}
    finally:
        _stop_cluster(planner_server, workers)


def results_of(worker, req, timeout=RESULT_TIMEOUT):
    return [worker.planner_client.get_message_result(req.app_id, m.id,
                                                     timeout=timeout)
            for m in req.messages]


def test_single_host_batch(cluster):
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("demo", "echo", 3)
    for i, m in enumerate(req.messages):
        m.input_data = f"msg-{i}".encode()
    decision = w.planner_client.call_functions(req)
    assert decision.n_messages == 3
    assert len(set(decision.hosts)) == 1
    for m, result in zip(req.messages, results_of(w, req)):
        assert result.return_value == int(ReturnValue.SUCCESS)
        assert result.output_data == m.input_data[::-1]
        assert result.executed_host == decision.hosts[0]


def test_two_host_batch_spreads_and_completes(cluster):
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("demo", "echo", 8)
    for i, m in enumerate(req.messages):
        m.input_data = bytes([i]) * 8
    decision = w.planner_client.call_functions(req)
    assert decision.n_messages == 8
    assert set(decision.hosts) == {"hostA", "hostB"}
    # Devices pinned from each host's 4-device inventory, one a rank
    for host in ("hostA", "hostB"):
        assert sorted(d for d, h in zip(decision.device_ids, decision.hosts)
                      if h == host) == [0, 1, 2, 3]
    executed = set()
    for m, result in zip(req.messages, results_of(w, req)):
        assert result.return_value == int(ReturnValue.SUCCESS)
        assert result.output_data == m.input_data[::-1]
        executed.add(result.executed_host)
    assert executed == {"hostA", "hostB"}

    # The batch completes: slots return, the in-flight record drains
    planner = get_planner()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        status = planner.get_batch_results(req.app_id)
        if status.finished:
            break
        time.sleep(0.05)
    assert status.finished
    assert status.expected_num_messages == 8
    assert all(h.used_slots == 0 for h in planner.get_available_hosts())
    assert planner.get_scheduling_decision(req.app_id) is None
    remote = w.planner_client.get_batch_results(req.app_id)
    assert remote.finished and len(remote.message_results) == 8


def test_failure_result_propagates(cluster):
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("demo", "fail", 1)
    w.planner_client.call_functions(req)
    result = w.planner_client.get_message_result(
        req.app_id, req.messages[0].id, timeout=RESULT_TIMEOUT)
    assert result.return_value == int(ReturnValue.FAILED)
    assert b"intentional failure" in result.output_data


def test_warm_executor_reuse(cluster):
    w = cluster["workers"]["hostA"]
    for _ in range(3):
        req = batch_exec_factory("demo", "echo", 2)
        w.planner_client.call_functions(req)
        results_of(w, req)
    # Executors are reused across batches, never created per message
    assert cluster["factory"].created <= 4


def test_scale_change_adds_messages(cluster):
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("demo", "echo", 2)
    w.planner_client.call_functions(req)
    decision1 = w.planner_client.get_scheduling_decision(req.app_id)
    assert decision1 is not None and decision1.n_messages == 2
    # Chain two more messages into the running app
    scale = batch_exec_factory("demo", "echo", 2)
    scale.app_id = req.app_id
    for i, m in enumerate(scale.messages):
        m.app_id = req.app_id
        m.app_idx = 2 + i
    d2 = w.planner_client.call_functions(scale)
    assert d2.n_messages == 2
    assert d2.group_id == decision1.group_id
    for result in results_of(w, req) + results_of(w, scale):
        assert result.return_value == int(ReturnValue.SUCCESS)


def test_get_available_hosts_and_removal(cluster):
    w = cluster["workers"]["hostA"]
    hosts = w.planner_client.get_available_hosts()
    assert {h["ip"] for h in hosts} == {"hostA", "hostB"}
    assert all(h["n_devices"] == 4 for h in hosts)
    cluster["workers"]["hostB"].planner_client.remove_host()
    hosts = w.planner_client.get_available_hosts()
    assert {h["ip"] for h in hosts} == {"hostA"}


def test_host_expiry_fails_its_in_flight_messages():
    """A host that misses its keep-alives expires, and its in-flight
    messages report FAILED so that waiters do not hang."""
    set_mock_mode(True)
    planner = get_planner()
    planner.register_host("ghost", 4, 2)
    req = batch_exec_factory("demo", "echo", 2)
    decision = planner.call_batch(req)
    assert decision.hosts == ["ghost", "ghost"]
    assert len(get_batch_requests()) == 1  # dispatched (recorded)
    get_system_config().planner_host_timeout = 0.0
    time.sleep(0.01)
    assert planner.get_available_hosts() == []
    deadline = time.monotonic() + 5
    while (not planner.get_batch_results(req.app_id).finished
           and time.monotonic() < deadline):
        time.sleep(0.02)
    status = planner.get_batch_results(req.app_id)
    assert status.finished
    assert {m.return_value for m in status.message_results} == {
        int(ReturnValue.FAILED)}
    assert {m.output_data for m in status.message_results} == {
        b"Host expired"}


def test_planner_ping(cluster):
    assert cluster["workers"]["hostA"].planner_client.ping()


def test_mock_mode_records_function_calls():
    """Mock mode short-circuits the wire (reference
    FunctionCallClient.cpp:22-60): no servers at all."""
    set_mock_mode(True)
    cli = FunctionCallClient("nowhere")
    req = batch_exec_factory("demo", "echo", 2)
    cli.execute_functions(req)
    recorded = get_batch_requests()
    assert len(recorded) == 1
    assert recorded[0][0] == "nowhere"
    assert recorded[0][1].app_id == req.app_id


def test_group_mappings_distributed_with_dispatch(cluster):
    """Every decision's group mappings reach the hosts it involves
    (reference setAndSendMappingsFromSchedulingDecision), and the group
    is dropped once the app completes."""
    HOLD.clear()
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("demo", "hold", 8)
    try:
        decision = w.planner_client.call_functions(req)
        assert decision.group_id != 0
        for name, worker in cluster["workers"].items():
            broker = worker.ptp_broker
            broker.wait_for_mappings(decision.group_id, timeout=5.0)
            assert broker.group_size(decision.group_id) == 8
            own = broker.get_idxs_registered_for_host(decision.group_id,
                                                      name)
            assert own == {decision.group_idxs[i]
                           for i, h in enumerate(decision.hosts)
                           if h == name}
            assert own
            for idx in own:
                i = decision.group_idxs.index(idx)
                assert (broker.get_device_for_idx(decision.group_id, idx)
                        == decision.device_ids[i])
    finally:
        HOLD.set()
    for r in results_of(w, req):
        assert r.return_value == int(ReturnValue.SUCCESS)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            wk.ptp_broker.group_exists(decision.group_id)
            for wk in cluster["workers"].values()):
        time.sleep(0.02)
    assert not any(wk.ptp_broker.group_exists(decision.group_id)
                   for wk in cluster["workers"].values())


def test_batch_types_the_planner_does_not_serve_raise(cluster):
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("demo", "echo", 2)
    req.type = int(BatchExecuteType.THREADS)
    with pytest.raises(RpcError, match="THREADS"):
        w.planner_client.call_functions(req)
    req = batch_exec_factory("demo", "echo", 2)
    req.elastic_scale_hint = True
    with pytest.raises(RpcError, match="elastic"):
        w.planner_client.call_functions(req)
    assert all(h["used_slots"] == 0
               for h in w.planner_client.get_available_hosts())


def test_not_enough_slots_runs_nothing(cluster):
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("demo", "echo", 9)
    decision = w.planner_client.call_functions(req)
    assert decision.app_id < 0 and decision.n_messages == 0
    assert cluster["factory"].created == 0


# ---------------------------------------------------------------------------
# Torch guest functions
# ---------------------------------------------------------------------------

def test_torch_executor_guest_functions(cluster):
    """Registered guests gang-schedule through the planner and see their
    planner-assigned device ids: four ranks, four distinct ids."""
    @register_function("torchdemo", "square")
    def square(ctx):
        n = int(ctx.message.input_data.decode())
        out = torch.tensor(n, device=ctx.device) ** 2
        assert ctx.device == torch.device("cpu")
        return f"{int(out)}@{ctx.device_id}".encode()

    set_executor_factory(TorchExecutorFactory(device="cpu"))
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("torchdemo", "square", 4)
    for i, m in enumerate(req.messages):
        m.input_data = str(i + 2).encode()
    decision = w.planner_client.call_functions(req)
    devices = set()
    for i, r in enumerate(results_of(w, req)):
        assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
        val, dev = r.output_data.decode().split("@")
        assert int(val) == (i + 2) ** 2
        devices.add(int(dev))
    assert devices == set(decision.device_ids) == {0, 1, 2, 3}


def test_torch_guest_failure_reaches_the_caller(cluster):
    @register_function("torchdemo", "boom")
    def boom(ctx):
        raise ValueError("guest exploded")

    set_executor_factory(TorchExecutorFactory(device="cpu"))
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("torchdemo", "boom", 1)
    unknown = batch_exec_factory("torchdemo", "nobody", 1)
    w.planner_client.call_functions(req)
    w.planner_client.call_functions(unknown)
    (r,) = results_of(w, req)
    assert r.return_value == int(ReturnValue.FAILED)
    assert b"guest exploded" in r.output_data
    (r,) = results_of(w, unknown)
    assert r.return_value == int(ReturnValue.FAILED)
    assert b"no registered function" in r.output_data


def test_guest_device_raises_for_an_id_the_host_does_not_have():
    """On CUDA a guest's device is ``cuda:<planner id>``; an id past the
    host's devices (here: any, without a card) raises rather than
    falling back."""
    from faabric_tpu_torch.batch_scheduler import SchedulingDecision

    broker = PointToPointBroker("solo")
    d = SchedulingDecision(app_id=71, group_id=71)
    d.add_message("solo", 1, 0, 0, device_id=3)
    broker.set_up_local_mappings_from_decision(d)
    req = batch_exec_factory("torchdemo", "x", 1)
    msg = req.messages[0]
    msg.group_id, msg.group_idx = 71, 0

    class Sched:
        ptp_broker = broker

    cuda = TorchExecutor(msg, "cuda")
    cuda.scheduler = Sched()
    ctx = GuestContext(cuda, msg, req)
    assert ctx.device_id == 3
    if torch.cuda.device_count() <= 3:
        with pytest.raises(RuntimeError, match="pinned to device 3"):
            ctx.device
    cpu = TorchExecutor(msg, "cpu")
    cpu.scheduler = Sched()
    ctx = GuestContext(cpu, msg, req)
    assert ctx.device == torch.device("cpu") and ctx.device_id == 3


def test_guest_device_id_raises_when_mappings_do_not_arrive(monkeypatch):
    """A grouped message whose mappings never come names them in its
    error; it does not read as device -1."""
    monkeypatch.setattr(GuestContext, "MAPPINGS_WAIT_SECONDS", 0.05)

    class Sched:
        ptp_broker = PointToPointBroker("solo")

    req = batch_exec_factory("torchdemo", "x", 1)
    msg = req.messages[0]
    msg.group_id, msg.group_idx = 72, 0
    ex = TorchExecutor(msg, "cuda")
    ex.scheduler = Sched()
    with pytest.raises(TimeoutError, match="no mappings for group 72"):
        GuestContext(ex, msg, req).device_id
    msg.group_id = 0
    assert GuestContext(ex, msg, req).device_id == -1


def test_worker_registers_its_cuda_devices_by_default(monkeypatch):
    """A worker whose factory runs guests on CUDA registers the host's
    CUDA device count unless told otherwise; on the CPU it registers
    none."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    class CudaFactory(ExecutorFactory):
        device_type = "cuda"

    assert WorkerRuntime(host="h", slots=4,
                         factory=CudaFactory()).n_devices == 1
    assert WorkerRuntime(host="h", slots=4, n_devices=4,
                         factory=CudaFactory()).n_devices == 4
    assert WorkerRuntime(host="h", slots=4, factory=TorchExecutorFactory(
        device="cpu")).n_devices == 0
    set_executor_factory(None)
    assert WorkerRuntime(host="h", slots=4).n_devices == 0


def test_executor_runs_its_tasks_on_one_worker_thread():
    """A warm executor that is handed tasks at different message indices
    keeps one worker thread."""
    req = batch_exec_factory("demo", "echo", 6)
    for m in req.messages:
        m.input_data = b"ab"
    ex = EchoExecutor(req.messages[0])
    try:
        for idx in (1, 5, 3):
            ex.execute_tasks([idx], req)
        deadline = time.monotonic() + RESULT_TIMEOUT
        while (any(req.messages[i].output_data != b"ba" for i in (1, 3, 5))
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert all(req.messages[i].return_value == int(ReturnValue.SUCCESS)
                   for i in (1, 3, 5))
        assert sum(t.name == f"executor/{ex.id}"
                   for t in threading.enumerate()) == 1
    finally:
        ex.shutdown()
    assert not any(t.name == f"executor/{ex.id}"
                   for t in threading.enumerate())


@pytest.fixture
def gang_host():
    """A planner and one 4-slot, 4-device worker running gang ranks, as
    ``dryrun_multichip`` boots them."""
    planner_server, workers = _start_cluster(("gang-host",), GangFactory())
    try:
        yield workers["gang-host"]
    finally:
        _stop_cluster(planner_server, workers)


def test_dryrun_stage_one_gang_of_four(gang_host):
    """Stage 1 of ``dryrun_multichip``: a gang of 4 pinned one rank per
    device, a barrier, a ring handoff and a second barrier."""
    req = batch_exec_factory("dryrun", "gang", 4)
    decision = gang_host.planner_client.call_functions(req)
    assert decision.n_messages == 4
    assert sorted(decision.device_ids) == [0, 1, 2, 3]
    for r in results_of(gang_host, req):
        assert r.return_value == int(ReturnValue.SUCCESS), r.output_data


def test_gang_across_two_hosts_barriers_and_hands_off():
    """The same gang over two hosts: the barrier and the ring handoff
    cross hosts through the point-to-point servers."""
    planner_server, workers = _start_cluster(("gangA", "gangB"),
                                             GangFactory())
    try:
        w = workers["gangA"]
        req = batch_exec_factory("dryrun", "gang", 8)
        decision = w.planner_client.call_functions(req)
        assert set(decision.hosts) == {"gangA", "gangB"}
        for r in results_of(w, req):
            assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
    finally:
        _stop_cluster(planner_server, workers)


# ---------------------------------------------------------------------------
# Serving through the planner against the JAX package
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=128)
N_NEW = 6


def test_served_small_model_matches_jax(cluster):
    """A ``serve`` guest over a 2-layer, d_model 64 model whose weights
    come from the JAX ``init_params``: served through the planner in
    fp32, its scoring logits match ``faabric_tpu.models.forward`` within
    2e-4 (the frameworks sum in other orders; the bound of
    test_torch_models.py) and its greedy tokens equal
    ``faabric_tpu.models.generate``'s."""
    jax = pytest.importorskip("jax")
    import importlib

    from faabric_tpu.models import ModelConfig as JaxConfig
    from faabric_tpu.models import forward as jax_forward
    from faabric_tpu.models import init_params

    from faabric_tpu_torch.models import ModelConfig, forward, generate
    from faabric_tpu_torch.models import params_from_jax

    jax_generate = importlib.import_module("faabric_tpu.models.generate")
    jcfg = JaxConfig(**SMALL, compute_dtype=jax.numpy.float32,
                     attention_impl="reference", norm_impl="reference")
    params = init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ModelConfig(**SMALL, compute_dtype=torch.float32),
                            device="cpu")
    prompts = np.random.RandomState(0).randint(
        0, SMALL["vocab_size"], (3, 16)).astype(np.int32)

    @register_function("serve", "small")
    def serve(ctx):
        prompt = torch.from_numpy(np.frombuffer(
            ctx.message.input_data, np.int32).copy()).to(ctx.device)[None]
        with torch.inference_mode():
            logits = forward(model, prompt)[0]
            tokens = generate(model, prompt, N_NEW)[0]
        return (logits.numpy().astype(np.float32).tobytes()
                + tokens.numpy().astype(np.int32).tobytes())

    set_executor_factory(TorchExecutorFactory(device="cpu"))
    w = cluster["workers"]["hostA"]
    req = batch_exec_factory("serve", "small", len(prompts))
    for m, p in zip(req.messages, prompts):
        m.input_data = p.tobytes()
    w.planner_client.call_functions(req)
    n_logits = 16 * SMALL["vocab_size"]
    for p, r in zip(prompts, results_of(w, req)):
        assert r.return_value == int(ReturnValue.SUCCESS), r.output_data
        out = np.frombuffer(r.output_data, np.uint8)
        logits = out[:4 * n_logits].view(np.float32).reshape(16, -1)
        tokens = out[4 * n_logits:].view(np.int32)
        want_logits = np.asarray(jax_forward(params, p[None], jcfg))[0]
        want_tokens = np.asarray(jax_generate.generate(
            params, jax.numpy.asarray(p[None]), jcfg, N_NEW))[0]
        np.testing.assert_allclose(logits, want_logits, atol=2e-4, rtol=0)
        np.testing.assert_array_equal(tokens, want_tokens)


def test_executor_threads_serve_concurrently_without_sharing_state():
    """Executor threads run guests at once on one model: each call's
    cache is its own, so concurrent results equal serial ones."""
    from faabric_tpu_torch.models import ModelConfig, Transformer, generate

    model = Transformer(ModelConfig(**SMALL, compute_dtype=torch.float32),
                        device="cpu")
    prompts = [torch.randint(0, 128, (1, 12),
                             generator=torch.Generator().manual_seed(i))
               for i in range(4)]
    with torch.inference_mode():
        serial = [generate(model, p, 5) for p in prompts]
    got = [None] * 4
    barrier = threading.Barrier(4)

    def run(i):
        barrier.wait(10)
        with torch.inference_mode():
            got[i] = generate(model, prompts[i], 5)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    for a, b in zip(got, serial):
        assert torch.equal(a, b)
