"""Multi-host data feed.

On a multi-host cluster each process sees only its local devices; the
trajectory must be fed per process and assembled into one global
sharded array. ``distribute_atom_block`` wraps
``jax.make_array_from_process_local_data``: every process supplies the
(frames, local_atoms, d) slab for *its* shard of the particle axis and
receives the global array with the standard atoms sharding (SURVEY.md
§2d: "host feed via per-process trajectory sharding").

Single-process meshes work identically (the local slab is the whole
array), so the code path is exercised by the normal test suite.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import ATOM_AXIS


def atom_shard_for_process(n_atoms: int, mesh: Mesh) -> slice:
    """Global atom range this process must load: contiguous block
    matching the atoms-axis sharding."""
    n_shards = mesh.shape[ATOM_AXIS]
    if n_atoms % n_shards:
        raise ValueError(
            f"n_atoms={n_atoms} must divide evenly over the "
            f"'{ATOM_AXIS}' axis ({n_shards})"
        )
    per_shard = n_atoms // n_shards
    # shards owned by this process = its devices' positions on the axis
    proc = jax.process_index()
    n_proc = jax.process_count()
    shards_per_proc = n_shards // n_proc
    lo = proc * shards_per_proc * per_shard
    hi = lo + shards_per_proc * per_shard
    return slice(lo, hi)


def distribute_atom_block(local_block, n_atoms: int, mesh: Mesh):
    """Assemble a globally-sharded (frames, atoms, d) array from each
    process's local slab (this process's ``atom_shard_for_process``
    range)."""
    sharding = NamedSharding(mesh, P(None, ATOM_AXIS, None))
    global_shape = (
        local_block.shape[0],
        n_atoms,
        local_block.shape[2],
    )
    return jax.make_array_from_process_local_data(
        sharding, local_block, global_shape
    )
