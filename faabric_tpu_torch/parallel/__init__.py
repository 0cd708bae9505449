"""The mesh substrate: device collectives, meshes and shard specs, ring
attention and pipeline parallelism (counterpart of
``faabric_tpu/parallel/``). ``distributed.py`` is not ported yet
(``ROADMAP.md`` Queue 1 #8)."""

from faabric_tpu_torch.parallel.collectives import (
    DeviceCollectives,
    local_devices_for_ids,
)
from faabric_tpu_torch.parallel.mesh import (
    MESH_AXES,
    Mesh,
    MeshConfig,
    ShardSpec,
    build_mesh,
    mesh_from_group,
    named,
    replicated,
)
from faabric_tpu_torch.parallel.pipeline import (
    PipelinedTransformer,
    init_pp_train_state,
    make_pp_1f1b_value_and_grad,
    make_pp_loss,
    make_pp_train_step,
    microbatch,
    pp_data_sharding,
    pp_param_shardings,
    stack_block_params,
    unstack_block_params,
)
from faabric_tpu_torch.parallel.ring_attention import ring_attention, shard_sequence

__all__ = [
    "DeviceCollectives",
    "MESH_AXES",
    "Mesh",
    "MeshConfig",
    "PipelinedTransformer",
    "ShardSpec",
    "build_mesh",
    "init_pp_train_state",
    "local_devices_for_ids",
    "make_pp_1f1b_value_and_grad",
    "make_pp_loss",
    "make_pp_train_step",
    "mesh_from_group",
    "microbatch",
    "named",
    "pp_data_sharding",
    "pp_param_shardings",
    "replicated",
    "ring_attention",
    "shard_sequence",
    "stack_block_params",
    "unstack_block_params",
]
