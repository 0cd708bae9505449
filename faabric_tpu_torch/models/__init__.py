from faabric_tpu_torch.models.convert import params_from_jax
from faabric_tpu_torch.models.generate import forward_with_cache, generate, init_kv_cache
from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    Transformer,
    forward,
    loss_fn,
    resolve_impls,
    token_nll,
)

__all__ = [
    "ModelConfig",
    "Transformer",
    "forward",
    "forward_with_cache",
    "generate",
    "init_kv_cache",
    "loss_fn",
    "params_from_jax",
    "resolve_impls",
    "token_nll",
]
