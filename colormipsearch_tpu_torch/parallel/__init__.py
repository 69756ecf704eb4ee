"""Target sharding over a device mesh (parallel/mesh.py), across
processes with torch.distributed (parallel/launch.py starts a rank)."""

from colormipsearch_tpu_torch.parallel.mesh import (
    TARGET_AXIS,
    Mesh,
    create_mesh,
    init_distributed,
    shard_target_planes,
    shutdown_distributed,
)

__all__ = ["TARGET_AXIS", "Mesh", "create_mesh", "init_distributed",
           "shard_target_planes", "shutdown_distributed"]
