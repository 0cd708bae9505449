"""Entry points: the counterparts of ``__graft_entry__.py``'s.

- ``entry()``: one forward pass of the flagship transformer on one
  card, with the reference's config and ``RandomState(0)`` tokens.
- ``dryrun_multichip(n)``: the reference's dry run over n ranks, stages
  1-5: gang scheduling through the planner, worker runtime and
  executors; a device allreduce over the gang's devices; one train step
  of the model sharded over a (dp, tp, sp) mesh of them; the pipeline
  (GPipe and 1F1B) over a pp mesh; the MoE family over an ep mesh; MoE
  stages inside the pipeline.

Weights come from a torch generator seeded with 0, so they are not the
JAX package's numbers; pass those (``np_params``, or load them with
``models.convert.params_from_jax``) to compare the two.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import NamedTuple

from faabric_tpu_torch.models import ModelConfig, MoEConfig, Transformer, forward
from faabric_tpu_torch.util.device import resolve_device

ENTRY_CONFIG = ModelConfig(vocab_size=2048, d_model=256, n_layers=2,
                           n_heads=8, d_ff=1024, max_seq=256)
# The reference dry run's stage-3 model
DRYRUN_CONFIG = ModelConfig(vocab_size=128, d_model=32, n_layers=2,
                            n_heads=4, d_ff=64, max_seq=32,
                            compute_dtype=torch.float32)
# The reference dry run's stage-4 MoE model (stage 5: two layers, no aux)
DRYRUN_MOE_CONFIG = MoEConfig(vocab_size=128, d_model=32, n_layers=1,
                              n_heads=4, d_ff=64, max_seq=32, n_experts=2,
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


class DryrunResult(NamedTuple):
    """The dry run's numbers; None where the reference skips a stage."""

    loss: float
    pp_loss: float | None
    moe_loss: float | None
    moe_pp_loss: float | None


def dryrun_multichip(n_devices: int, device=None, cfg: ModelConfig | None = None,
                     moe_cfg: MoEConfig | None = None,
                     np_params: dict | None = None,
                     port_base: int | None = None) -> DryrunResult:
    """``__graft_entry__.py::dryrun_multichip`` over ``n_devices`` ranks.

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
       sp = 2 where n is a multiple of 8.
    3b. For an even gang, the pipeline over (tp 2 where n is a multiple
       of 4, sp 2 where of 16, pp 2): the GPipe loss within 1e-4 of the
       unsharded loss; one step of each schedule, GPipe and 1F1B within
       1e-4 of each other, and 1F1B within 1e-4 of stage 3's step on the
       same weights and batch.
    4. For an even gang, one ``make_moe_train_step`` of ``moe_cfg`` over
       (tp 1, ep 2).
    5. For n a multiple of 8, MoE stages in the pipeline over (pp 2, ep
       2): ``moe_cfg`` at two layers without the aux loss, the GPipe loss
       within 1e-4 of the unsharded ``moe_loss_fn``.

    Every batch comes from one ``RandomState(0)``, drawn in the
    reference's order. The weights of each stage ("train", "pp", "moe",
    "moe_pp") come from ``np_params[stage]`` (the JAX package's pytree,
    from ``PRNGKey`` 0, 2, 1 and 3 in the reference) where given, else
    from the port's own init with a generator seeded 0, 2, 1 and 3.

    On the card the flash kernels take head dims 16 to 128, so the tiny
    configs (head dim 8) run there only with ``attention_impl=
    "reference"`` (it raises before stage 1 otherwise); nothing swaps the
    kernels out by shape. ``port_base`` places the planner's and the
    worker's ports (random by default). The process's planner must hold
    no hosts (the gang would spread onto them); the run registers and
    then removes one host and its two host aliases, and leaves every
    other alias and the planner's other state as they were."""
    import dataclasses
    import random

    from faabric_tpu_torch.executor import (
        Executor,
        ExecutorFactory,
        get_executor_factory,
        set_executor_factory,
    )
    from faabric_tpu_torch.models import (
        MoETransformer,
        data_sharding,
        init_train_state,
        loss_fn,
        make_moe_train_step,
        make_optimizer,
        make_train_step,
        moe_loss_fn,
        params_from_jax,
        resolve_impls,
        shard_moe_params,
        shard_params,
    )
    from faabric_tpu_torch.models.transformer import _param_tree
    from faabric_tpu_torch.mpi import MpiOp
    from faabric_tpu_torch.ops.flash_attention import HEAD_DIMS
    from faabric_tpu_torch.parallel import (
        DeviceCollectives,
        MeshConfig,
        PipelinedTransformer,
        build_mesh,
        init_pp_train_state,
        local_devices_for_ids,
        make_pp_loss,
        make_pp_train_step,
        microbatch,
        pp_data_sharding,
    )
    from faabric_tpu_torch.planner import PlannerServer, get_planner
    from faabric_tpu_torch.proto import ReturnValue, batch_exec_factory
    from faabric_tpu_torch.runner import WorkerRuntime
    from faabric_tpu_torch.transport import (
        register_host_alias,
        unregister_host_alias,
    )

    dev = resolve_device(device)
    cfg = cfg or DRYRUN_CONFIG
    moe_cfg = moe_cfg or DRYRUN_MOE_CONFIG
    for c in (cfg, moe_cfg):
        if (dev.type == "cuda" and c.head_dim not in HEAD_DIMS
                and resolve_impls(c, dev).attention_impl != "reference"):
            raise ValueError(
                f"dryrun_multichip: head dim {c.head_dim} on {dev}, where "
                f"the flash kernels take head dims {HEAD_DIMS}; pass configs "
                "with one of them (ModelConfig() has 64) or "
                "attention_impl=\"reference\"")
    np_params = np_params or {}
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

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=gang_devices[0]).manual_seed(seed)

    def weights(stage: str, c, seed: int) -> dict:
        """The stage's whole weights: the caller's pytree, or the port's
        own init from ``seed`` on the gang's first device."""
        if stage in np_params:
            return np_params[stage]
        kind = MoETransformer if isinstance(c, MoEConfig) else Transformer
        return _param_tree(kind(c, device=gang_devices[0],
                                generator=gen(seed)))

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(f"dryrun_multichip: {what}")

    # -- 3. one train step over the gang's (dp, tp, sp) mesh -------------
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % (tp * 2 * 2) == 0 else 1
    mesh = build_mesh(gang_devices, MeshConfig(tp=tp, sp=sp))
    dp = mesh.shape["dp"]
    optimizer = make_optimizer()
    model = shard_params(weights("train", cfg, 0), mesh, cfg)
    step = make_train_step(cfg, optimizer)
    rng = np.random.RandomState(0)
    batch, seq = max(2, 2 * dp), max(8, 8 * sp)
    tokens, targets = (data_sharding(mesh).shard(
        rng.randint(0, cfg.vocab_size, (batch, seq), dtype=np.int32))
        for _ in range(2))
    loss = float(step(model, optimizer.init(model), tokens, targets)[0])
    check(np.isfinite(loss), f"stage-3 loss {loss} is not finite")

    # -- 3b. the pipeline (pp 2): GPipe and 1F1B -------------------------
    pp_loss = None
    if n_devices % 2 == 0:
        pp_tp = 2 if n_devices % 4 == 0 else 1
        pp_sp = 2 if n_devices % 16 == 0 else 1  # keeps dp >= 2 at n = 8
        pp_mesh = build_mesh(gang_devices, MeshConfig(tp=pp_tp, sp=pp_sp,
                                                      pp=2))
        pbatch = 4 * pp_mesh.shape["dp"]
        raw = weights("pp", cfg, 2)
        ptok = rng.randint(0, cfg.vocab_size, (pbatch, seq), dtype=np.int32)
        ptgt = rng.randint(0, cfg.vocab_size, (pbatch, seq), dtype=np.int32)
        with torch.no_grad():
            ref_loss = float(loss_fn(
                params_from_jax(raw, cfg, device=dev),
                torch.as_tensor(ptok, device=dev),
                torch.as_tensor(ptgt, device=dev)))
            tok_mb, tgt_mb = (pp_data_sharding(pp_mesh).shard(microbatch(a, 4))
                              for a in (ptok, ptgt))
            pp_loss = float(make_pp_loss(cfg, pp_mesh)(
                PipelinedTransformer(cfg, pp_mesh, raw), tok_mb, tgt_mb)[0])
        check(abs(pp_loss - ref_loss) < 1e-4,
              f"pp loss {pp_loss} vs unsharded {ref_loss}")
        # One optimizer step through each schedule from the same weights;
        # dp x tp x pp composed (dp 2, tp 2, pp 2 at n = 8)
        # (the port's own init draws the pipeline's and stage 3's weights
        # from the same generator seed, as the reference from one key)
        sched_losses = {}
        for name in ("gpipe", "1f1b"):
            if "pp" in np_params:
                pp_model = PipelinedTransformer(cfg, pp_mesh, raw)
                pp_opt = optimizer.init(pp_model)
            else:
                pp_model, pp_opt = init_pp_train_state(gen(2), cfg, pp_mesh,
                                                       optimizer)
            pp_step = make_pp_train_step(cfg, optimizer, n_microbatches=4,
                                         schedule_name=name)
            sched_losses[name] = float(pp_step(pp_model, pp_opt, ptok,
                                               ptgt)[0])
            check(np.isfinite(sched_losses[name]),
                  f"{name} step loss {sched_losses[name]}")
        check(abs(sched_losses["1f1b"] - sched_losses["gpipe"]) < 1e-4,
              f"schedules disagree: {sched_losses}")
        # Against stage 3's step over its (dp, tp, sp) mesh on the same
        # weights and batch
        if "pp" in np_params:
            dense = shard_params(raw, mesh, cfg)
            dense_opt = optimizer.init(dense)
        else:
            dense, dense_opt = init_train_state(gen(2), cfg,
                                                optimizer=optimizer, mesh=mesh)
        dense_l0 = float(step(dense, dense_opt,
                              data_sharding(mesh).shard(ptok),
                              data_sharding(mesh).shard(ptgt))[0])
        check(abs(sched_losses["1f1b"] - dense_l0) < 1e-4,
              f"1f1b step loss {sched_losses['1f1b']} vs the stage-3 step's "
              f"{dense_l0}")

    # -- 4. the MoE family over an ep mesh --------------------------------
    moe_loss = None
    if n_devices % 2 == 0:
        moe_mesh = build_mesh(gang_devices, MeshConfig(tp=1, ep=2))
        moe_model = shard_moe_params(weights("moe", moe_cfg, 1), moe_mesh,
                                     moe_cfg)
        moe_step = make_moe_train_step(moe_cfg, optimizer)
        mb = max(2, 2 * moe_mesh.shape["dp"])
        mtok = data_sharding(moe_mesh).shard(
            rng.randint(0, moe_cfg.vocab_size, (mb, 16), dtype=np.int32))
        moe_loss = float(moe_step(moe_model, optimizer.init(moe_model), mtok,
                                  mtok)[0])
        check(np.isfinite(moe_loss), f"MoE loss {moe_loss} is not finite")

    # -- 5. MoE stages inside the pipeline (pp 2, ep 2) -------------------
    moe_pp_loss = None
    if n_devices >= 8 and n_devices % 8 == 0:
        mpp_cfg = dataclasses.replace(moe_cfg, n_layers=2, aux_loss_weight=0.0)
        mpp_mesh = build_mesh(gang_devices, MeshConfig(pp=2, ep=2))
        raw = weights("moe_pp", mpp_cfg, 3)
        # 2 microbatches x (a dp shard of 2 rows)
        mpp_b = 4 * mpp_mesh.shape["dp"]
        ptok2 = rng.randint(0, moe_cfg.vocab_size, (mpp_b, 16), dtype=np.int32)
        with torch.no_grad():
            t2 = torch.as_tensor(ptok2, device=dev)
            ref_moe = float(moe_loss_fn(params_from_jax(raw, mpp_cfg,
                                                        device=dev), t2, t2))
            mtok2 = pp_data_sharding(mpp_mesh).shard(microbatch(ptok2, 2))
            moe_pp_loss = float(make_pp_loss(mpp_cfg, mpp_mesh)(
                PipelinedTransformer(mpp_cfg, mpp_mesh, raw), mtok2, mtok2)[0])
        check(abs(moe_pp_loss - ref_moe) < 1e-4,
              f"MoE pp loss {moe_pp_loss} vs moe_loss_fn {ref_moe}")
    return DryrunResult(loss, pp_loss, moe_loss, moe_pp_loss)
