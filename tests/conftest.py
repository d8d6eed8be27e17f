"""Test configuration.

Tests run on the CPU with 8 virtual XLA devices so sharded (multi-device)
code paths execute without accelerators. The backend is configured
before JAX initializes one. A process that has already initialized its
backend before pytest starts (``chip_smoke.py`` runs the ``gpu``-marked
tests in-process on the card) keeps it; the ``gpu`` marker's fixture
skips those tests everywhere else.
"""

import os

from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_platforms", "cpu")

try:  # plotting tests only; absent where only the core stack is installed
    import matplotlib

    matplotlib.use("Agg")
except ImportError:
    pass

import numpy as np
import pytest

import transport_analysis_tpu as ta


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` need the GPU backend; decided here, at run
    time, so every process collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU (run: python chip_smoke.py)")


@pytest.fixture(scope="module")
def NSTEP():
    return 5001


# Step trajectory of unit velocities: v(t) = (t, t, t); the reference
# test-suite's workhorse analytic fixture (test_velocityautocorr.py:48-57).
@pytest.fixture(scope="module")
def step_vtraj(NSTEP):
    v = np.arange(NSTEP)
    velocities = np.vstack([v, v, v]).T.reshape(NSTEP, 1, 3)
    u = ta.Universe.empty(1, n_frames=NSTEP, velocities=True)
    for i, ts in enumerate(u.trajectory):
        u.atoms.velocities = velocities[i]
    return u


# Matching positions x(t) = t²/2 (reference test_velocityautocorr.py:61-72)
@pytest.fixture(scope="module")
def step_vtraj_pos(NSTEP):
    x = np.arange(NSTEP).astype(np.float64)
    x *= x / 2
    positions = np.vstack([x, x, x]).T.reshape(NSTEP, 1, 3)
    u_pos = ta.Universe.empty(1)
    u_pos.load_new(positions)
    return u_pos


# Full variant with positions, masses (16) and a 2x2x2 box (volume 8)
# (reference test_viscosity.py:59-86)
@pytest.fixture(scope="module")
def step_vtraj_full(NSTEP):
    from transport_analysis_tpu.core.transformations import set_dimensions

    v = np.arange(NSTEP)
    velocities = np.vstack([v, v, v]).T.reshape(NSTEP, 1, 3)
    x = np.arange(NSTEP).astype(np.float64)
    x *= x / 2
    positions = np.vstack([x, x, x]).T.reshape(NSTEP, 1, 3)
    u = ta.Universe.empty(1, n_frames=NSTEP, velocities=True)
    dim = [2, 2, 2, 90, 90, 90]
    setter = set_dimensions(dim)
    for i, ts in enumerate(u.trajectory):
        u.atoms.velocities = velocities[i]
        u.atoms.positions = positions[i]
        setter(ts)
    u.add_TopologyAttr("masses", [16.0])
    return u


# Synthetic stand-in for the reference's real-data (NCBOX water) fixture:
# a deterministic random 10-atom universe with velocities, positions and
# a box. MDAnalysisTests data is unavailable here; cross-algorithm
# consistency (fft vs windowed) doesn't depend on the data source.
@pytest.fixture(scope="module")
def u_random():
    rng = np.random.RandomState(20260816)
    n_frames, n_atoms = 12, 10
    u = ta.Universe.empty(
        n_atoms,
        n_residues=10,
        n_segments=1,
        atom_resindex=np.arange(10),
        velocities=True,
        n_frames=n_frames,
    )
    from transport_analysis_tpu.core.transformations import set_dimensions

    setter = set_dimensions([20.0, 20.0, 20.0, 90.0, 90.0, 90.0])
    for i, ts in enumerate(u.trajectory):
        u.atoms.positions = rng.uniform(0, 20, (n_atoms, 3))
        u.atoms.velocities = rng.normal(0, 15, (n_atoms, 3))
        setter(ts)
    u.add_TopologyAttr("names", ["O"] * n_atoms)
    u.add_TopologyAttr("resnames", ["WAT"] * 10)
    u.add_TopologyAttr("resids", np.arange(1, 11))
    u.add_TopologyAttr("masses", np.full(n_atoms, 15.999))
    return u


@pytest.fixture(scope="module")
def ag(u_random):
    return u_random.select_atoms("name O and resname WAT and resid 1-10")
