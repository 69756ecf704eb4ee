"""Target sharding over a device mesh (parallel/mesh.py)."""

from colormipsearch_tpu_torch.parallel.mesh import (
    TARGET_AXIS,
    Mesh,
    create_mesh,
    shard_target_planes,
)

__all__ = ["TARGET_AXIS", "Mesh", "create_mesh", "shard_target_planes"]
