from a3vlm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshEnv,
    P,
    PartitionSpec,
    create_mesh,
    current_mesh,
    init_ranks,
    shard_params,
    single_device_mesh,
    use_mesh,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshEnv",
    "P",
    "PartitionSpec",
    "create_mesh",
    "current_mesh",
    "init_ranks",
    "shard_params",
    "single_device_mesh",
    "use_mesh",
]
