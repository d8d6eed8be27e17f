from .mesh import analysis_mesh, use_mesh, current_mesh
from .sharding import map_particles, shard_particles

__all__ = [
    "analysis_mesh",
    "use_mesh",
    "current_mesh",
    "shard_particles",
    "map_particles",
]
