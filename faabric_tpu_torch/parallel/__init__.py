"""The mesh substrate: device collectives, meshes and shard specs, ring
attention (counterpart of ``faabric_tpu/parallel/``). The pipeline and
``distributed.py`` are not ported yet (``ROADMAP.md`` Queue 1)."""

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
from faabric_tpu_torch.parallel.ring_attention import ring_attention, shard_sequence

__all__ = [
    "DeviceCollectives",
    "MESH_AXES",
    "Mesh",
    "MeshConfig",
    "ShardSpec",
    "build_mesh",
    "local_devices_for_ids",
    "mesh_from_group",
    "named",
    "replicated",
    "ring_attention",
    "shard_sequence",
]
