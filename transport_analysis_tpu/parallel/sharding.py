"""Sharding placement helpers.

``shard_particles`` places a ``(frames, particles, dims)`` block with the
particle axis split over the active mesh (see parallel.mesh), and
``map_particles`` runs a per-particle kernel on each device's shard;
the only communication left is the reduction behind the final particle
mean — the communication the reference never had (SURVEY.md §2d).

Host (numpy) blocks are padded on the host and handed to
``jax.device_put`` with their sharding, so each device receives only
its own shard; nothing is staged whole on the first device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import ATOM_AXIS, current_mesh


def _pad_to_multiple(arr, axis: int, multiple: int):
    size = arr.shape[axis]
    rem = size % multiple
    if rem == 0:
        return arr, size
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, multiple - rem)
    xp = np if isinstance(arr, np.ndarray) else jnp
    return xp.pad(arr, pad), size


def shard_particles(arr, axis: int = 1):
    """Place ``arr`` with its particle axis sharded over the active mesh.

    Pads the particle axis up to a multiple of the mesh size (callers
    must slice results back with the original count). No-op when no mesh
    is active.
    """
    mesh = current_mesh()
    if mesh is None:
        arr = jnp.asarray(arr)
        return arr, arr.shape[axis]
    if not isinstance(arr, jax.Array):
        arr = np.asarray(arr)
    n_dev = mesh.shape[ATOM_AXIS]
    arr, orig = _pad_to_multiple(arr, axis, n_dev)
    spec = [None] * arr.ndim
    spec[axis] = ATOM_AXIS
    sharding = NamedSharding(mesh, P(*spec))
    return jax.device_put(arr, sharding), orig


def map_particles(kernel, arr):
    """Run a per-particle ``kernel((N, p, d)) → (L, p)`` over a
    (frames, particles, dims) block.

    Without an active mesh this is ``kernel(arr)`` on the default device.
    With one, the particle axis is sharded over it and every device runs
    ``kernel`` on its own particles (``shard_map``): the analyses' kernels
    are independent per particle and need no communication, whereas
    XLA's partitioner would gather the whole block onto every device to
    run the FFT. Zero-padded particles (added for even sharding)
    contribute zero columns that callers drop by slicing to the original
    particle count.
    """
    mesh = current_mesh()
    if mesh is None:
        return kernel(jnp.asarray(arr))
    arr, _ = shard_particles(arr, axis=1)
    return shard_map(
        kernel, mesh=mesh, in_specs=P(None, ATOM_AXIS, None),
        out_specs=P(None, ATOM_AXIS), check_vma=False,
    )(arr)
