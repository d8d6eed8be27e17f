"""Sharded-vs-unsharded equivalence on the 8-virtual-device CPU mesh
(SURVEY.md §4: sharded-vs-unsharded equivalence tests, multi-device
emulated on the CPU)."""

import jax
import numpy as np
import pytest
from numpy.testing import assert_allclose

import transport_analysis_tpu as ta
from transport_analysis_tpu import (
    EinsteinMSD,
    VelocityAutocorr,
    ViscosityHelfand,
    parallel,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("virtual multi-device CPU backend unavailable")
    return parallel.analysis_mesh()


def test_mesh_has_virtual_devices():
    assert len(jax.devices()) == 8


def test_vacf_sharded_matches(u_random, mesh):
    base = VelocityAutocorr(u_random.atoms).run()
    with parallel.use_mesh(mesh):
        sharded = VelocityAutocorr(u_random.atoms).run()
    assert_allclose(
        sharded.results.timeseries, base.results.timeseries, rtol=1e-12
    )
    assert_allclose(
        sharded.results.vacf_by_particle,
        base.results.vacf_by_particle,
        rtol=1e-12,
    )


def test_vacf_sharded_uneven_particles(mesh):
    # 10 particles over 8 devices forces particle-axis padding
    rng = np.random.RandomState(0)
    u = ta.Universe.empty(10, n_frames=16, velocities=True)
    for ts in u.trajectory:
        u.atoms.velocities = rng.normal(size=(10, 3))
    base = VelocityAutocorr(u.atoms).run()
    with parallel.use_mesh(mesh):
        sharded = VelocityAutocorr(u.atoms).run()
    assert sharded.results.vacf_by_particle.shape == (16, 10)
    assert_allclose(
        sharded.results.timeseries, base.results.timeseries, rtol=1e-12
    )


def test_viscosity_sharded_matches(u_random, mesh):
    base = ViscosityHelfand(u_random.atoms).run()
    with parallel.use_mesh(mesh):
        sharded = ViscosityHelfand(u_random.atoms).run()
    assert_allclose(
        sharded.results.timeseries, base.results.timeseries, rtol=1e-12
    )


def test_msd_sharded_matches(u_random, mesh):
    base = EinsteinMSD(u_random.atoms).run()
    with parallel.use_mesh(mesh):
        sharded = EinsteinMSD(u_random.atoms).run()
    assert_allclose(
        sharded.results.timeseries, base.results.timeseries, rtol=1e-12
    )


def test_windowed_sharded_matches(u_random, mesh):
    base = VelocityAutocorr(u_random.atoms, fft=False).run()
    with parallel.use_mesh(mesh):
        sharded = VelocityAutocorr(u_random.atoms, fft=False).run()
    assert_allclose(
        sharded.results.timeseries, base.results.timeseries, rtol=1e-12
    )


@pytest.mark.parametrize("kernel", ["acf_fft", "msd_fft",
                                    "acf_windowed"])
def test_map_particles_keeps_work_on_each_device(mesh, kernel):
    """Per-particle kernels run on each device's own particles: the
    compiled program gathers nothing, and the result stays sharded."""
    from jax.sharding import PartitionSpec as P

    from transport_analysis_tpu import ops
    from transport_analysis_tpu.parallel import map_particles

    fn = getattr(ops, kernel)
    x = np.random.RandomState(3).normal(size=(64, 13, 3))
    with parallel.use_mesh(mesh):
        out = map_particles(fn, x)
        hlo = jax.jit(lambda a: map_particles(fn, a)).lower(
            x).compile().as_text()
    assert out.sharding.spec == P(None, "atoms")
    assert out.shape[1] % len(mesh.devices.flat) == 0  # padded particles
    assert_allclose(np.asarray(out)[:, :13], np.asarray(fn(x)),
                    rtol=1e-12, atol=1e-12)
    assert "all-gather" not in hlo


def test_multihost_feed_single_process(mesh):
    """distribute_atom_block on a single-process mesh reproduces
    device_put + sharding (the multi-host API degenerates cleanly)."""
    from transport_analysis_tpu.parallel.multihost import (
        atom_shard_for_process,
        distribute_atom_block,
    )
    from transport_analysis_tpu import ops

    rng = np.random.RandomState(2)
    block = rng.normal(size=(16, 16, 3))
    sl = atom_shard_for_process(16, mesh)
    assert (sl.start, sl.stop) == (0, 16)
    garr = distribute_atom_block(block[:, sl], 16, mesh)
    assert garr.shape == (16, 16, 3)
    got = np.asarray(ops.acf_fft(garr))
    want = np.asarray(ops.acf_fft(block))
    assert_allclose(got, want, rtol=1e-12)


def test_multihost_feed_uneven_rejected(mesh):
    from transport_analysis_tpu.parallel.multihost import (
        atom_shard_for_process,
    )

    with pytest.raises(ValueError, match="divide evenly"):
        atom_shard_for_process(10, mesh)


_MP_WORKER = r'''
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
repo = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address="localhost:" + port,
                           num_processes=2, process_id=pid)
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, repo)
import transport_analysis_tpu  # noqa: F401  (x64 on)
from transport_analysis_tpu.parallel.mesh import ATOM_AXIS
from transport_analysis_tpu.parallel import multihost
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

assert jax.process_count() == 2
assert len(jax.local_devices()) == 4 and len(jax.devices()) == 8
mesh = Mesh(np.array(jax.devices()).reshape(8), (ATOM_AXIS,))
n_frames, n_atoms, d = 16, 24, 3
rng = np.random.default_rng(0)  # same full array in both processes
full = rng.standard_normal((n_frames, n_atoms, d))
sl = multihost.atom_shard_for_process(n_atoms, mesh)
assert (sl.start, sl.stop) == (12 * pid, 12 * pid + 12), sl
arr = multihost.distribute_atom_block(full[:, sl, :], n_atoms, mesh)
assert arr.shape == (n_frames, n_atoms, d)
# cross-shard reduction: wrong assembly cannot cancel out
got = jax.jit(lambda a: jnp.sum(a * a, axis=(1, 2)),
              out_shardings=NamedSharding(mesh, P()))(arr)
np.testing.assert_allclose(
    np.asarray(got), np.sum(full * full, axis=(1, 2)), rtol=1e-12)
# per-shard identity: each process reads back ITS device shards
for s in arr.addressable_shards:
    lo = s.index[1].start or 0
    np.testing.assert_array_equal(np.asarray(s.data),
                                  full[:, lo:lo + 3, :])
print("MP_FEED_OK", pid, flush=True)
'''


def test_multihost_feed_two_processes(tmp_path):
    """TRUE multi-process distribute_atom_block: two jax.distributed
    CPU processes (4 virtual devices each -> one 8-device global mesh)
    each feed only their own atom slab and the assembled global array
    is correct — the real multihost feed path, not the single-process
    degenerate."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])

    worker = tmp_path / "mp_worker.py"
    worker.write_text(_MP_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, repo],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process feed worker timed out:\n"
                    + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MP_FEED_OK {pid}" in out, out
