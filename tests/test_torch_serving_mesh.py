"""The mesh half of serving: tp-sharded decode and perplexity against the
JAX package.

Counterpart of ``tests/unit/test_models.py::
test_generate_under_tp_mesh_matches_single_device`` and of the
reference's ``evaluate_perplexity(..., mesh=)``. The JAX side runs on
the conftest's 8 virtual CPU devices with its parameters placed by
``param_shardings``; the port lays the same numpy weights over 8 CPU
ranks (``shard_params``). Everything is fp32, where greedy tokens are
held equal and perplexity within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from faabric_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from faabric_tpu.models import init_params  # noqa: E402
from faabric_tpu.models.evaluate import (  # noqa: E402
    evaluate_perplexity as jax_evaluate_perplexity,
)
from faabric_tpu.models.generate import generate as jax_generate  # noqa: E402
from faabric_tpu.models.transformer import (  # noqa: E402
    param_shardings as jax_param_shardings,
)
from faabric_tpu.parallel import MeshConfig as JaxMeshConfig  # noqa: E402
from faabric_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from faabric_tpu_torch.data import DataLoader, TokenDataset  # noqa: E402
from faabric_tpu_torch.models import (  # noqa: E402
    ModelConfig,
    evaluate_perplexity,
    forward_with_cache,
    generate,
    init_kv_cache,
    init_sharded_kv_cache,
    params_from_jax,
    shard_params,
)
from faabric_tpu_torch.parallel import MeshConfig, build_mesh, named  # noqa: E402

# The reference test's configuration (tests/unit/test_models.py:219-220)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
           max_seq=64)
N_RANKS = 8


def models(mesh_kw=None, seed=0):
    """(JAX params, JAX config, port model, port sharded model, port
    mesh) from one ``init_params`` draw."""
    mesh_kw = mesh_kw or {"dp": 2, "tp": 4}
    jcfg = JaxConfig(**CFG, compute_dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**CFG, compute_dtype=torch.float32)
    model = params_from_jax(np_params, cfg, device="cpu")
    mesh = build_mesh(["cpu"] * N_RANKS, MeshConfig(**mesh_kw))
    return params, jcfg, model, shard_params(np_params, mesh, cfg), mesh


def jax_mesh(**kw):
    return jax_build_mesh(jax.devices()[:N_RANKS], JaxMeshConfig(**kw))


def prompt_np(b=2, s=8, seed=7):
    return np.random.RandomState(seed).randint(0, 64, (b, s)).astype(np.int32)


def by_rows(mesh):
    """The prompt's and the result's per-rank layout: rows over dp."""
    return named(mesh, "dp", None)


def sharded_generate(smodel, mesh, prompt, n, **kw):
    """The port's sharded decode from a whole prompt; checks that every
    rank of a dp group holds the same tokens and gives the whole result."""
    spec = by_rows(mesh)
    outs = generate(smodel, spec.shard(torch.from_numpy(prompt)), n, **kw)
    for group in mesh.groups(("tp", "sp", "pp", "ep")):
        for r in group[1:]:
            assert torch.equal(outs[r], outs[group[0]]), (group, r)
    return spec.gather(outs).numpy()


def test_generate_under_tp_mesh_matches_reference_and_unsharded():
    """The reference test at dp 2 x tp 4: the port's tensor-parallel
    greedy tokens equal its unsharded decode's, and JAX's sharded and
    unsharded tokens (exact)."""
    params, jcfg, model, smodel, mesh = models()
    prompt = prompt_np()
    want = np.asarray(jax_generate(params, jnp.asarray(prompt), jcfg, 8))
    jm = jax_mesh(dp=2, tp=4)
    sharded = jax.device_put(params, jax_param_shardings(jm, jcfg))
    sp = jax.device_put(jnp.asarray(prompt), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("dp", None)))
    want_mesh = np.asarray(jax_generate(sharded, sp, jcfg, 8, mesh=jm))
    np.testing.assert_array_equal(want_mesh, want)

    unsharded = generate(model, torch.from_numpy(prompt), 8).numpy()
    got = sharded_generate(smodel, mesh, prompt, 8)
    np.testing.assert_array_equal(unsharded, want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("mesh_kw,batch", [
    ({"dp": 4, "tp": 2}, 4),
    ({"dp": 1, "tp": 4, "sp": 2}, 2),
    ({"dp": 2, "tp": 2, "ep": 2}, 2),
])
def test_generate_over_other_meshes_matches_jax(mesh_kw, batch):
    """Other layouts of the 8 ranks: the sp and ep ranks hold replicas
    of their dp group's rows; the tokens are JAX's unsharded ones."""
    params, jcfg, _, smodel, mesh = models(mesh_kw)
    prompt = prompt_np(batch, 8, seed=3)
    want = np.asarray(jax_generate(params, jnp.asarray(prompt), jcfg, 6))
    np.testing.assert_array_equal(
        sharded_generate(smodel, mesh, prompt, 6), want)


def test_sharded_forward_with_cache_matches_unsharded_logits():
    """Per-rank prefill and one decode step against the unsharded model
    (fp32; the tp allreduces sum in another order: 2e-5), with each
    rank's cache holding its heads of the unsharded cache."""
    _, _, model, smodel, mesh = models()
    prompt = torch.from_numpy(prompt_np(2, 8, seed=11))
    spec = by_rows(mesh)
    cache = init_kv_cache(model.cfg, 2, "cpu")
    scache = init_sharded_kv_cache(smodel, 2)
    assert scache[0][0]["k"].shape == (1, 64, 1, 8)
    with torch.inference_mode():
        want = forward_with_cache(model, prompt, cache, 0)
        got = forward_with_cache(smodel, spec.shard(prompt), scache, 0)
        np.testing.assert_allclose(spec.gather(got).numpy(), want.numpy(),
                                   atol=2e-5, rtol=0)
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        want = forward_with_cache(model, nxt, cache, 8)
        got = forward_with_cache(smodel, spec.shard(nxt), scache, 8)
    np.testing.assert_allclose(spec.gather(got).numpy(), want.numpy(),
                               atol=2e-5, rtol=0)
    kv_spec = named(mesh, "dp", None, "tp", None)
    for layer in range(2):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                kv_spec.gather([c[layer][name] for c in scache]).numpy(),
                cache[layer][name].numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("chunk", [3, 4])
def test_chunked_prefill_under_mesh_matches_jax(chunk):
    """Chunked prefill (3: a ragged last chunk) over dp 2 x tp 4 gives
    the tokens of whole-prompt prefill and of JAX's chunked prefill."""
    params, jcfg, _, smodel, mesh = models()
    prompt = prompt_np(2, 10, seed=5)
    want = np.asarray(jax_generate(params, jnp.asarray(prompt), jcfg, 6,
                                   prefill_chunk=chunk))
    got = sharded_generate(smodel, mesh, prompt, 6, prefill_chunk=chunk)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sharded_generate(smodel, mesh, prompt, 6), want)


def test_sampled_decode_under_mesh():
    """Sampling takes one generator per dp group. With top-k 1 it is
    JAX's greedy decode; with full sampling each dp group draws what the
    unsharded port draws for its rows from the same seed, and every tp
    rank of a group holds the same tokens (checked in
    ``sharded_generate``)."""
    params, jcfg, model, smodel, mesh = models()
    prompt = prompt_np(2, 8, seed=9)
    gens = [torch.Generator().manual_seed(100 + g) for g in range(2)]
    top1 = sharded_generate(smodel, mesh, prompt, 8, generator=gens,
                            temperature=0.8, top_k=1)
    np.testing.assert_array_equal(
        top1, np.asarray(jax_generate(params, jnp.asarray(prompt), jcfg, 8)))

    kw = dict(temperature=1.3, top_p=0.95)
    gens = [torch.Generator().manual_seed(200 + g) for g in range(2)]
    got = sharded_generate(smodel, mesh, prompt, 8, generator=gens, **kw)
    for g in range(2):
        want = generate(model, torch.from_numpy(prompt[g:g + 1]), 8,
                        generator=torch.Generator().manual_seed(200 + g),
                        **kw).numpy()
        np.testing.assert_array_equal(got[g:g + 1], want)

    spec = by_rows(mesh)
    with pytest.raises(ValueError, match="2 generators"):
        generate(smodel, spec.shard(torch.from_numpy(prompt)), 4,
                 generator=torch.Generator(), temperature=1.0)
    with pytest.raises(ValueError, match="1 generators for dp 2"):
        generate(smodel, spec.shard(torch.from_numpy(prompt)), 4,
                 generator=[torch.Generator()], temperature=1.0)


def test_sharded_decode_runs_the_fused_norm_on_every_rank(monkeypatch):
    """Each forward of the decode runs the fused-norm wrapper 2L + 1
    times on every rank (the count ``chip_smoke.py`` phase 18 holds the
    kernel's launches to); the plain norm runs nowhere."""
    import importlib

    from faabric_tpu_torch.models import transformer

    rms_mod = importlib.import_module("faabric_tpu_torch.ops.rms_norm")

    calls = {"fused": 0, "plain": 0}
    fused, plain = rms_mod.rms_norm, transformer._rms_norm

    def count(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(rms_mod, "rms_norm", count("fused", fused))
    monkeypatch.setattr(transformer, "_rms_norm", count("plain", plain))
    params, jcfg, _, _, mesh = models()
    np_params = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**CFG, compute_dtype=torch.float32, norm_impl="fused")
    smodel = shard_params(np_params, mesh, cfg)
    prompt = prompt_np(2, 8, seed=7)
    got = sharded_generate(smodel, mesh, prompt, 5, prefill_chunk=3)
    n_forwards = 3 + 4  # three prefill chunks, then n_tokens - 1 steps
    assert calls == {"fused": N_RANKS * n_forwards * (2 * CFG["n_layers"] + 1),
                     "plain": 0}
    np.testing.assert_array_equal(
        got, np.asarray(jax_generate(params, jnp.asarray(prompt), jcfg, 5)))


def test_decode_refuses_a_pipeline_mesh():
    _, _, _, _, mesh = models()
    from faabric_tpu_torch.models.generate import _check_decode_mesh

    class Fake:
        cfg = ModelConfig(**CFG)
        mesh = build_mesh(["cpu"] * 2, MeshConfig(pp=2))

    with pytest.raises(ValueError, match="pipeline"):
        _check_decode_mesh(Fake())


def eval_batches(n=2, b=4, s=16):
    rs = np.random.RandomState(21)
    return [(rs.randint(0, 64, (b, s)).astype(np.int32),
             rs.randint(0, 64, (b, s)).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("mesh_kw", [{"dp": 2, "tp": 4},
                                     {"dp": 2, "tp": 2, "sp": 2}])
def test_evaluate_perplexity_under_mesh_matches_jax(mesh_kw):
    """Mean NLL over two batches through the sharded forward, against
    JAX's ``mesh=`` form on the same layout (fp32: 1e-5 relative), from
    whole arrays and from per-rank lists."""
    params, jcfg, _, smodel, mesh = models(mesh_kw)
    batches = eval_batches()
    jm = jax_mesh(**mesh_kw)
    sharded = jax.device_put(params, jax_param_shardings(jm, jcfg))
    data = jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("dp", "sp"))
    want = jax_evaluate_perplexity(
        sharded, jcfg, [tuple(jax.device_put(jnp.asarray(a), data)
                              for a in b) for b in batches], mesh=jm)
    got = evaluate_perplexity(smodel, batches)
    assert got["tokens"] == want["tokens"] == 2 * 4 * 16
    assert abs(got["nll"] - want["nll"]) <= 1e-5 * abs(want["nll"])
    assert abs(got["perplexity"] - want["perplexity"]) <= \
        1e-5 * want["perplexity"]

    spec = named(mesh, "dp", "sp")
    per_rank = [(spec.shard(torch.from_numpy(t)), spec.shard(
        torch.from_numpy(g))) for t, g in batches]
    again = evaluate_perplexity(smodel, per_rank * 2, max_batches=2)
    assert again["tokens"] == got["tokens"]
    assert abs(again["nll"] - got["nll"]) <= 1e-12


def test_evaluate_perplexity_over_a_mesh_loader():
    """The loader with a mesh gives per-rank batches straight to the
    sharded evaluation; the result is the unsharded one's (1e-5)."""
    _, _, model, smodel, mesh = models({"dp": 2, "tp": 4})
    corpus = np.random.RandomState(4).randint(0, 64, 4000).astype(np.int32)
    ds = TokenDataset(corpus, 16)
    loader = DataLoader(ds, 4, seed=3, mesh=mesh)
    got = evaluate_perplexity(smodel, loader, max_batches=2)
    whole = DataLoader(ds, 4, seed=3, device="cpu")
    want = evaluate_perplexity(model, whole, max_batches=2)
    assert got["tokens"] == want["tokens"] == 2 * 4 * 16
    assert abs(got["nll"] - want["nll"]) <= 1e-5 * abs(want["nll"])
