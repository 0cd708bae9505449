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
