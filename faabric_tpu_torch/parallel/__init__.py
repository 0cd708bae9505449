"""The mesh substrate: device collectives, meshes and shard specs, ring
attention, pipeline parallelism and the device plane across worker
processes (counterpart of ``faabric_tpu/parallel/``). Across processes
(``distributed.py``) a mesh lies over the plane's global devices, every
collective crosses the boundary with its backward, and every training
form runs there: the sharded train step, GPipe and 1F1B, ring
attention and the MoE family, MoE stages in the pipeline included."""

from faabric_tpu_torch.parallel.collectives import (
    DeviceCollectives,
    local_devices_for_ids,
)
from faabric_tpu_torch.parallel.distributed import (
    DevicePlaneSpec,
    PlaneDevice,
    current_plane,
    global_devices,
    join_device_plane,
    leave_device_plane,
    plane_summary,
    request_device_plane,
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
    "DevicePlaneSpec",
    "PlaneDevice",
    "current_plane",
    "global_devices",
    "join_device_plane",
    "leave_device_plane",
    "plane_summary",
    "request_device_plane",
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
