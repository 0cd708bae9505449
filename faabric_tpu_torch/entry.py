"""Entry points: the counterparts of ``__graft_entry__.py``'s.

- ``entry()``: one forward pass of the flagship transformer on one
  card, with the reference's config and ``RandomState(0)`` tokens.
- ``dryrun_multichip(n)``: stages 1-3 of the reference's dry run over n
  ranks: gang scheduling through the planner, worker runtime and
  executors; a device allreduce over the gang's devices; one train step
  of the model sharded over a (dp, tp, sp) mesh of them. The pipeline
  and MoE stages (3b-5) are not ported yet (``ROADMAP.md`` Queue 1
  #4-5).

Weights come from a torch generator seeded with 0, so they are not the
JAX package's numbers; pass those (``np_params``, or load them with
``models.convert.params_from_jax``) to compare the two.
"""

from __future__ import annotations

import numpy as np
import torch

from faabric_tpu_torch.models import ModelConfig, Transformer, forward
from faabric_tpu_torch.util.device import resolve_device

ENTRY_CONFIG = ModelConfig(vocab_size=2048, d_model=256, n_layers=2,
                           n_heads=8, d_ff=1024, max_seq=256)
# The reference dry run's stage-3 model
DRYRUN_CONFIG = ModelConfig(vocab_size=128, d_model=32, n_layers=2,
                            n_heads=4, d_ff=64, max_seq=32,
                            compute_dtype=torch.float32)


def entry(device=None):
    """(fn, example_args): ``fn(model, tokens)`` -> logits (2, 128, 2048)."""
    device = resolve_device(device)
    cfg = ENTRY_CONFIG
    gen = torch.Generator(device=device).manual_seed(0)
    model = Transformer(cfg, device=device, generator=gen)
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 128)),
        dtype=torch.int32, device=device)

    def fn(model, tokens):
        with torch.inference_mode():
            return forward(model, tokens)

    return fn, (model, tokens)


def dryrun_multichip(n_devices: int, device=None, cfg: ModelConfig | None = None,
                     np_params: dict | None = None,
                     port_base: int | None = None) -> float:
    """Stages 1-3 of ``__graft_entry__.py::dryrun_multichip`` over
    ``n_devices`` ranks; returns the stage-3 loss.

    1. A port planner and one ``WorkerRuntime`` with ``n_devices``
       logical device slots gang-schedule ``n_devices`` ranks (group
       barrier, ring handoff, barrier), one rank pinned to each slot;
       ``local_devices_for_ids`` maps the slots onto this host's
       ``device`` type (the default ``cuda``; several slots share a card
       where there are fewer cards).
    2. ``DeviceCollectives.allreduce`` of ``np.full(16, rank)`` over the
       gang's devices, checked against numpy.
    3. One ``make_train_step`` of ``cfg`` (the reference's tiny config
       by default) over the reference's mesh, tp = 2 for an even gang and
       sp = 2 where n is a multiple of 8, from ``np_params`` (the JAX
       package's pytree) or the port's own init from seed 0, on the
       reference's ``RandomState(0)`` batch shapes.

    On the card the flash kernels take head dims 16 to 128, so the tiny
    config (head dim 8) runs there only with ``attention_impl=
    "reference"`` (it raises before stage 1 otherwise); nothing swaps the
    kernels out by shape. ``port_base`` places the planner's and the
    worker's ports (random by default). The process's planner must hold
    no hosts (the gang would spread onto them); the run registers and
    then removes one host and its two host aliases, and leaves every
    other alias and the planner's other state as they were."""
    import random

    from faabric_tpu_torch.executor import (
        Executor,
        ExecutorFactory,
        get_executor_factory,
        set_executor_factory,
    )
    from faabric_tpu_torch.models import (
        data_sharding,
        init_train_state,
        make_optimizer,
        make_train_step,
        params_from_jax,
    )
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.parallel import (
        DeviceCollectives,
        MeshConfig,
        build_mesh,
        local_devices_for_ids,
    )
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
    from faabric_tpu_torch.runner import WorkerRuntime
    from faabric_tpu_torch.models import resolve_impls
    from faabric_tpu_torch.ops.flash_attention import HEAD_DIMS
    from faabric_tpu_torch.transport import (
        register_host_alias,
        unregister_host_alias,
    )

    dev = resolve_device(device)
    cfg = cfg or DRYRUN_CONFIG
    if (dev.type == "cuda" and cfg.head_dim not in HEAD_DIMS
            and resolve_impls(cfg, dev).attention_impl != "reference"):
        raise ValueError(
            f"dryrun_multichip: head dim {cfg.head_dim} on {dev}, where the "
            f"flash kernels take head dims {HEAD_DIMS}; pass a cfg with one "
            "of them (ModelConfig() has 64) or attention_impl=\"reference\"")
    if get_planner().get_available_hosts():
        raise RuntimeError("dryrun_multichip runs its own worker host; this "
                           "process's planner already holds hosts")
    timeout = 60.0

    class GangExecutor(Executor):
        def execute_task(self, pool_idx, msg_idx, req):
            # Ranks hold until the whole gang runs, proving coscheduling
            msg = req.messages[msg_idx]
            broker = self.scheduler.ptp_broker
            broker.wait_for_mappings(msg.group_id, timeout=timeout)
            group = broker.get_group(msg.group_id)
            group.barrier(msg.group_idx, timeout=timeout)
            # Point-to-point exchange: ring neighbour handoff
            nxt = (msg.group_idx + 1) % req.n_messages()
            prv = (msg.group_idx - 1) % req.n_messages()
            broker.send_message(msg.group_id, msg.group_idx, nxt,
                                bytes([msg.group_idx]))
            got = broker.recv_message(msg.group_id, prv, msg.group_idx,
                                      timeout=timeout)
            if got != bytes([prv]):
                raise RuntimeError(f"rank {msg.group_idx} got {got!r} "
                                   f"from {prv}")
            group.barrier(msg.group_idx, timeout=timeout)
            return int(ReturnValue.SUCCESS)

    class GangFactory(ExecutorFactory):
        def create_executor(self, msg):
            return GangExecutor(msg)

    try:
        previous_factory = get_executor_factory()
    except RuntimeError:
        previous_factory = None
    # Listener ports stay below the client source ports (30500 up)
    base = random.randint(100, 200) * 100 if port_base is None else port_base
    register_host_alias("dryrun-planner", "127.0.0.1", base)
    register_host_alias("dryrun-host", "127.0.0.1", base + 1000)
    planner_server = PlannerServer(port_offset=base)
    worker = WorkerRuntime(host="dryrun-host", slots=n_devices,
                           n_devices=n_devices, factory=GangFactory(),
                           planner_host="dryrun-planner")
    try:
        planner_server.start()
        worker.start()
        # -- 1. gang scheduling -------------------------------------------
        req = batch_exec_factory("dryrun", "gang", n_devices)
        decision = worker.planner_client.call_functions(req)
        if decision.n_messages != n_devices:
            raise RuntimeError(f"{decision.n_messages} of {n_devices} ranks "
                               "scheduled")
        if sorted(decision.device_ids) != list(range(n_devices)):
            raise RuntimeError(f"gang must pin one rank per device slot, got "
                               f"{decision.device_ids}")
        for m in req.messages:
            r = worker.planner_client.get_message_result(req.app_id, m.id,
                                                         timeout=timeout)
            if r.return_value != int(ReturnValue.SUCCESS):
                raise RuntimeError(f"gang rank failed: {r.output_data!r}")
        # Placement straight from the decision (the group's broker state
        # is cleared once the app completes)
        rank_ids = [decision.device_ids[decision.group_idxs.index(i)]
                    for i in range(n_devices)]
        gang_devices = local_devices_for_ids(rank_ids, dev.type)
    finally:
        worker.shutdown()  # removes its host from the planner
        planner_server.stop()
        unregister_host_alias("dryrun-planner")
        unregister_host_alias("dryrun-host")
        set_executor_factory(previous_factory)

    # -- 2. device allreduce over the gang's devices, against numpy ------
    coll = DeviceCollectives(gang_devices)
    bufs = [np.full(16, float(r), dtype=np.float32) for r in range(n_devices)]
    expected = np.sum(np.stack(bufs), axis=0)
    for got in coll.to_per_rank(coll.allreduce(coll.shard_stacked(bufs),
                                               MpiOp.SUM)):
        np.testing.assert_allclose(got, expected, rtol=1e-6)

    # -- 3. one train step over the gang's (dp, tp, sp) mesh -------------
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % (tp * 2 * 2) == 0 else 1
    mesh = build_mesh(gang_devices, MeshConfig(tp=tp, sp=sp))
    dp = mesh.shape["dp"]
    optimizer = make_optimizer()
    if np_params is None:
        model, opt = init_train_state(
            torch.Generator(device=gang_devices[0]).manual_seed(0), cfg,
            optimizer=optimizer, mesh=mesh)
    else:
        model = params_from_jax(np_params, cfg, mesh=mesh)
        opt = optimizer.init(model)
    step = make_train_step(cfg, optimizer)
    rng = np.random.RandomState(0)
    batch, seq = max(2, 2 * dp), max(8, 8 * sp)
    tokens, targets = (data_sharding(mesh).shard(
        rng.randint(0, cfg.vocab_size, (batch, seq), dtype=np.int32))
        for _ in range(2))
    loss = float(step(model, opt, tokens, targets)[0])
    if not np.isfinite(loss):
        raise RuntimeError(f"stage-3 loss {loss} is not finite")
    return loss
