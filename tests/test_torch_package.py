"""The port's package boundary: no JAX, no faabric_tpu, no silent CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from faabric_tpu_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "faabric_tpu_torch"


def test_importing_every_module_pulls_in_no_jax_and_no_faabric_tpu():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    assert "faabric_tpu_torch.ops.flash_attention" in modules
    assert {"faabric_tpu_torch.mpi.world", "faabric_tpu_torch.device_plane",
            "faabric_tpu_torch.ops.ring_permute"} <= set(modules)
    # The control plane: proto, transport, scheduling, planner, executors
    assert {"faabric_tpu_torch.proto", "faabric_tpu_torch.util.network",
            "faabric_tpu_torch.transport.ptp_remote",
            "faabric_tpu_torch.batch_scheduler.bin_pack",
            "faabric_tpu_torch.planner.planner",
            "faabric_tpu_torch.planner.server",
            "faabric_tpu_torch.scheduler.scheduler",
            "faabric_tpu_torch.executor.torch_executor",
            "faabric_tpu_torch.runner.runtime"} <= set(modules)
    # The mesh substrate and the sharded model
    assert {"faabric_tpu_torch.parallel", "faabric_tpu_torch.parallel.mesh",
            "faabric_tpu_torch.parallel.collectives",
            "faabric_tpu_torch.parallel.ring_attention",
            "faabric_tpu_torch.models.transformer",
            "faabric_tpu_torch.entry"} <= set(modules)
    # faabric's MPI as guests use it: the wire form, the registry, the
    # guest API, windows and their shared memory
    assert {"faabric_tpu_torch.mpi.types", "faabric_tpu_torch.mpi.registry",
            "faabric_tpu_torch.mpi.api", "faabric_tpu_torch.mpi.window",
            "faabric_tpu_torch.util.memory",
            "faabric_tpu_torch.transport.point_to_point"} <= set(modules)
    # faabric's state KV: authorities, KV, replicas, placement, the RPC,
    # the host-wide State and the device state handles
    assert {"faabric_tpu_torch.state", "faabric_tpu_torch.state.backend",
            "faabric_tpu_torch.state.kv", "faabric_tpu_torch.state.replica",
            "faabric_tpu_torch.state.placement",
            "faabric_tpu_torch.state.remote", "faabric_tpu_torch.state.state",
            "faabric_tpu_torch.state.device_handle"} <= set(modules)
    modules.append("chip_smoke")
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'faabric_tpu'))\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("BAD []"), out.stdout


def test_chip_smoke_imports_nothing_of_jax_even_inside_its_phases():
    """Every import statement of ``chip_smoke.py``, those inside its phase
    functions too, names torch, numpy, the standard library or the port."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "faabric_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "faabric_tpu", "optax"}, names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from faabric_tpu_torch.entry import entry
    from faabric_tpu_torch.models import ModelConfig, Transformer

    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(ModelConfig(vocab_size=32, d_model=16, n_layers=1,
                                n_heads=2, d_ff=32, max_seq=16))
    fn, (model, tokens) = entry(device="cpu")
    assert model.device.type == "cpu" and tokens.shape == (2, 128)


def test_training_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    import numpy as np

    from faabric_tpu_torch.data import DataLoader, TokenDataset
    from faabric_tpu_torch.models import ModelConfig, init_train_state

    cfg = ModelConfig(vocab_size=32, d_model=16, n_layers=1, n_heads=2,
                      d_ff=32, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(None, cfg)
    ds = TokenDataset(np.arange(100, dtype=np.int32), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataLoader(ds, 2)
    model, opt = init_train_state(None, cfg, "cpu")
    assert model.device.type == "cpu"
    assert DataLoader(ds, 2, device="cpu").device.type == "cpu"


def test_mesh_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    from faabric_tpu_torch.batch_scheduler import SchedulingDecision
    from faabric_tpu_torch.entry import dryrun_multichip
    from faabric_tpu_torch.mpi import MpiWorld
    from faabric_tpu_torch.parallel import build_mesh, local_devices_for_ids
    from faabric_tpu_torch.transport import PointToPointBroker

    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        local_devices_for_ids([0, 1])
    broker = PointToPointBroker("solo")
    d = SchedulingDecision(app_id=951, group_id=951)
    d.add_message("solo", 1, 0, 0, device_id=0)
    broker.set_up_local_mappings_from_decision(d)
    world = MpiWorld(broker, 951, 1, 951)
    with pytest.raises(RuntimeError, match="CUDA"):
        world.device_collectives()
    assert world.device_collectives("cpu").devices == [torch.device("cpu")]
    assert local_devices_for_ids([0, 1], "cpu") == [torch.device("cpu")] * 2


def test_device_plane_activation_raises_without_cuda_unless_cpu_is_asked(
        no_cuda):
    from faabric_tpu_torch.batch_scheduler import SchedulingDecision
    from faabric_tpu_torch.mpi import MpiWorld
    from faabric_tpu_torch.transport import PointToPointBroker

    broker = PointToPointBroker("solo")
    d = SchedulingDecision(app_id=950, group_id=950)
    d.add_message("solo", 1, 0, 0, device_id=0)
    broker.set_up_local_mappings_from_decision(d)
    world = MpiWorld(broker, 950, 1, 950)
    with pytest.raises(RuntimeError, match="CUDA"):
        world.activate_device_plane(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        world.activate_device_plane(0, device="cuda")
    assert world.device_plane() is None
    assert world.activate_device_plane(0, device="cpu")
    assert world.device_plane().device == torch.device("cpu")


def test_torch_executor_factory_raises_without_cuda_unless_cpu_is_asked(
        no_cuda):
    from faabric_tpu_torch.executor import TorchExecutorFactory
    from faabric_tpu_torch.proto import message_factory

    with pytest.raises(RuntimeError, match="CUDA"):
        TorchExecutorFactory()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchExecutorFactory("cuda")
    executor = TorchExecutorFactory("cpu").create_executor(
        message_factory("demo", "fn"))
    assert executor.device_type == "cpu"


def test_pipeline_and_moe_entry_points_raise_without_cuda_unless_cpu_is_asked(
        no_cuda):
    from faabric_tpu_torch.models import (
        MoEConfig,
        MoETransformer,
        init_moe_train_state,
    )
    from faabric_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
        init_pp_train_state,
    )

    cfg = MoEConfig(vocab_size=32, d_model=16, n_layers=2, n_heads=2,
                    d_ff=32, max_seq=16, n_experts=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MoETransformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_moe_train_state(None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mesh(config=MeshConfig(pp=1))
    model, _ = init_moe_train_state(None, cfg, "cpu")
    assert model.device.type == "cpu"
    mesh = build_mesh(["cpu"] * 2, MeshConfig(pp=2))
    pp_model, _ = init_pp_train_state(None, cfg, mesh)
    assert {p.device.type for p in pp_model.parameters()} == {"cpu"}
