from faabric_tpu_torch.models.checkpoint import restore_train_state, save_train_state
from faabric_tpu_torch.models.convert import params_from_jax, params_to_numpy
from faabric_tpu_torch.models.evaluate import evaluate_perplexity
from faabric_tpu_torch.models.generate import forward_with_cache, generate, init_kv_cache
from faabric_tpu_torch.models.train import (
    data_sharding,
    init_train_state,
    make_multi_step,
    make_optimizer,
    make_train_step,
)
from faabric_tpu_torch.models.transformer import (
    ModelConfig,
    ShardedTransformer,
    Transformer,
    forward,
    loss_fn,
    param_shardings,
    resolve_impls,
    shard_params,
    token_nll,
)

__all__ = [
    "ModelConfig",
    "ShardedTransformer",
    "Transformer",
    "data_sharding",
    "evaluate_perplexity",
    "forward",
    "forward_with_cache",
    "generate",
    "init_kv_cache",
    "init_train_state",
    "loss_fn",
    "make_multi_step",
    "make_optimizer",
    "make_train_step",
    "params_from_jax",
    "param_shardings",
    "params_to_numpy",
    "resolve_impls",
    "restore_train_state",
    "save_train_state",
    "shard_params",
    "token_nll",
]
