"""The slice as a whole: the data-parallel step of guests across two
hosts on each data plane, on the CPU.

A port planner and two ``WorkerRuntime``s with
``TorchExecutorFactory(device="cpu")`` run ``chip_smoke.py``'s phase 22
(``planes_phase``) at a small width: the parameters after a step on the
shm rings, on bulk TCP and after broadcast steps on the forced delta
codec are bitwise equal to each other's raw counterparts, and with hier
and int8 the allreduced gradient is within the per-chunk bound of the
exact hier sum (the launch checks and timings are the card's). Then the
trainer of ``test_torch_mpi_api.py`` over two hosts with the planes on:
its parameters after the steps match ``jax.grad`` of the JAX package's
``loss_fn`` within 1e-5 on each plane. The width is chosen so that the
gradient's ring chunks exceed ``BULK_THRESHOLD`` and ride the bulk plane
even over TCP.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import chip_smoke  # noqa: E402
from faabric_tpu_torch.executor import TorchExecutorFactory  # noqa: E402
from faabric_tpu_torch.mpi import MpiWorld  # noqa: E402
from faabric_tpu_torch.ops import _build  # noqa: E402
from faabric_tpu_torch.transport.codec import (  # noqa: E402
    reset_wire_governor,
    set_wire_codec,
)
from tests.conftest import next_port_base  # noqa: E402

MID = dict(vocab_size=2048, d_model=256, n_layers=2, n_heads=4, d_ff=512,
           max_seq=64, attention_impl="reference", norm_impl="reference")
SEQ, PER_RANK, STEPS, LR, RANKS = 32, 2, 2, 0.5, 4


@pytest.fixture(autouse=True)
def _reset_governor():
    reset_wire_governor()
    yield
    reset_wire_governor()


def test_chip_smoke_planes_phase_small(monkeypatch):
    """Phase 22 at a small width: 22a on the shm rings, 22c's int8 leader
    ring against the exact hier sum and its 5/8 wire bytes, 22b on bulk
    TCP and the delta codec, every check of the phase."""
    from faabric_tpu_torch.models import ModelConfig

    monkeypatch.setattr(MpiWorld, "CHUNK_BYTES", 1 << 20)
    cfg = ModelConfig(**MID, compute_dtype=torch.float32)
    launches = chip_smoke.planes_phase(torch.device("cpu"), _build, cfg=cfg,
                                       seq=SEQ, base=next_port_base())
    assert launches == {}  # the plain versions run on the CPU


def _jax_trainer(corpus):
    from faabric_tpu.models import ModelConfig as JaxConfig
    from faabric_tpu.models import init_params
    from faabric_tpu.models import loss_fn as jax_loss_fn

    jcfg = JaxConfig(**MID, compute_dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    grad_fn = jax.jit(jax.grad(jax_loss_fn), static_argnums=(3,))
    for step in range(STEPS):
        grads = None
        for r in range(RANKS):
            b = jnp.asarray(corpus[step, r * PER_RANK:(r + 1) * PER_RANK],
                            dtype=jnp.int32)
            g = grad_fn(params, b[:, :-1], b[:, 1:], jcfg)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        params = jax.tree.map(lambda p, g: p - LR * (g / RANKS), params,
                              grads)
    return np_params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("plane", ["shm", "tcp", "delta"])
def test_ddp_matches_jax_grad_on_each_plane(plane, monkeypatch):
    from faabric_tpu_torch.models import ModelConfig, params_from_jax

    monkeypatch.setattr(MpiWorld, "CHUNK_BYTES", 64 * 1024)
    if plane != "shm":
        monkeypatch.setenv("SHM_BULK", "0")
    corpus = np.random.RandomState(0).randint(
        0, MID["vocab_size"], (STEPS, RANKS * PER_RANK, SEQ + 1))
    np_params, want_params = _jax_trainer(corpus)
    cfg = ModelConfig(**MID, compute_dtype=torch.float32)

    def batch(step, rank, device):
        b = torch.as_tensor(corpus[step, rank * PER_RANK:
                                   (rank + 1) * PER_RANK], device=device)
        return b[:, :-1], b[:, 1:]

    job = {"tensors": True, "steps": STEPS, "lr": LR, "params": {},
           "model": lambda device: params_from_jax(np_params, cfg,
                                                   device=device),
           "batch": batch}
    chip_smoke.register_mpi_guests(job)
    server, workers = chip_smoke.start_cluster(
        {"pA": 2, "pB": 2}, TorchExecutorFactory(device="cpu"),
        base=next_port_base())
    try:
        if plane == "delta":
            set_wire_codec("delta")
        before = chip_smoke.plane_bytes()
        results, _ = chip_smoke.run_gang(workers[0].planner_client, "ddp",
                                         RANKS, timeout=120)
        moved = {k: v - before[k]
                 for k, v in chip_smoke.plane_bytes().items()}
        outs = chip_smoke.guest_outputs(results, "ddp")
        assert {o["rungs"]["allreduce"] for o in outs} == {"ring"}
        bulk = [c for w in workers
                for c in w.ptp_broker._bulk_clients.values()]
        if plane == "shm":
            assert moved["shm"] > 0 and moved["tcp"] == 0
            assert all(c.rings() for c in bulk)
        else:
            assert moved["tcp"] > 0 and moved["shm"] == 0
            assert not any(c.rings() for c in bulk)
        coded = sum(c.coded_frames for c in bulk)
        assert (coded > 0) is (plane == "delta")
    finally:
        chip_smoke.stop_cluster(server, workers)
    got = job["params"]
    assert all(torch.equal(got[0], got[r]) for r in range(1, RANKS))
    want = params_from_jax(want_params, cfg, device="cpu")
    start = params_from_jax(np_params, cfg, device="cpu")
    off = 0
    for (name, p), p0 in zip(want.named_parameters(), start.parameters()):
        n = p.numel()
        mine = got[0][off:off + n].view_as(p)
        off += n
        rel = float((mine - p.detach()).norm() / p.detach().norm())
        assert rel <= 1e-5, (name, rel)
        step = (p - p0).detach()
        assert float(step.norm()) > 0, name
        rel_d = float((mine - p0.detach() - step).norm() / step.norm())
        assert rel_d <= 1e-4, (name, rel_d)
    assert off == got[0].numel()
