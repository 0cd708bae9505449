from faabric_tpu_torch.models.checkpoint import restore_train_state, save_train_state
from faabric_tpu_torch.models.convert import load_params, params_from_jax, params_to_numpy
from faabric_tpu_torch.models.evaluate import evaluate_perplexity
from faabric_tpu_torch.models.generate import (
    forward_with_cache,
    generate,
    init_kv_cache,
    init_sharded_kv_cache,
)
from faabric_tpu_torch.models.moe import (
    MoEConfig,
    MoETransformer,
    ShardedMoETransformer,
    init_moe_train_state,
    make_moe_train_step,
    moe_forward,
    moe_loss_fn,
    moe_param_shardings,
    shard_moe_params,
)
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
    "MoEConfig",
    "MoETransformer",
    "ModelConfig",
    "ShardedMoETransformer",
    "ShardedTransformer",
    "Transformer",
    "data_sharding",
    "evaluate_perplexity",
    "forward",
    "forward_with_cache",
    "generate",
    "init_kv_cache",
    "init_sharded_kv_cache",
    "init_moe_train_state",
    "init_train_state",
    "load_params",
    "loss_fn",
    "make_moe_train_step",
    "make_multi_step",
    "make_optimizer",
    "make_train_step",
    "moe_forward",
    "moe_loss_fn",
    "moe_param_shardings",
    "params_from_jax",
    "param_shardings",
    "params_to_numpy",
    "resolve_impls",
    "restore_train_state",
    "save_train_state",
    "shard_moe_params",
    "shard_params",
    "token_nll",
]
