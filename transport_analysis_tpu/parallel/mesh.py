"""Device-mesh management.

The reference is strictly single-process (SURVEY.md §2d). The engine
scales by sharding the *particle* axis across chips: per-particle
correlations are embarrassingly parallel, so the only communication is
the all-reduce behind the final particle mean — XLA inserts a ``psum``
across devices when the input carries a NamedSharding.

Usage::

    from transport_analysis_tpu import parallel
    with parallel.use_mesh(parallel.analysis_mesh()):
        VelocityAutocorr(ag).run()
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import jax
from jax.sharding import Mesh

_state = threading.local()

ATOM_AXIS = "atoms"


def analysis_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices with axis 'atoms'."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ATOM_AXIS,))


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Context manager: analyses run inside shard their particle axis
    over ``mesh`` and let XLA place the cross-chip collectives."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
