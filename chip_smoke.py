"""End-to-end check of the analysis stack on an NVIDIA GPU.

Usage::

    python chip_smoke.py                # one card: the default phases
    python chip_smoke.py --four-cards   # the multi-device paths, 4 cards

Default phases, one process on one card. The data is the packaged
ethylene-carbonate recipe (``data/generate.py``: 3,680 atoms,
Ornstein–Uhlenbeck dynamics at 300 K, 1 ps frames) written as a
10,000-frame TRR (a 10 ns production run saved each ps, ~0.9 GB of
float32 positions and velocities) and loaded with ``Universe(top, trr)``.
Each analysis runs through its public entry point, twice, and its result
is compared in the same run with a host float64 numpy oracle:

* ``ooc_auto``       vacf/helfand_out_of_core, atom_chunk="auto" under a
                     4 GB budget; the device's peak memory must stay
                     under that budget
* ``vacf_fft``       VelocityAutocorr(ag) + self_diffusivity_gk()
* ``vacf_windowed``  VelocityAutocorr(ag, fft=False, max_lag=1000)
* ``helfand``        ViscosityHelfand(u.atoms, linear_fit_window=...)
* ``msd``            EinsteinMSD(u, select="name O*", msd_type="xyz")
* ``stream``         VelocityAutocorr(ag, frame_block=1000)
* ``gpu_tests``      tests/test_gpu_equivalence.py, in this process

With ``--four-cards`` only the multi-device paths run, each against its
one-card result: atom-sharded VACF and Helfand under
``parallel.use_mesh``, the frame-sharded ring windowed correlation and
the frame-sharded FFT.

Per phase one JSON line: wall of the first call (compiles) and of the
second (steady), their difference as the compile estimate, the largest
error relative to the oracle's maximum, the tolerance (1e-8,
BASELINE.json; 1e-10 between sharded and one-card results) and the
device's ``peak_bytes_in_use`` since the process started. A line before
the last gives ``nvidia-smi``'s card name and power limit. The last line
is ``{"ok": true, "device": {...}}`` when every phase passed; otherwise
the script exits non-zero. Without a GPU it exits non-zero before any
phase.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

import numpy as np

REL_TOL = 1e-8          # BASELINE.json: match the reference to 1e-8
SHARD_TOL = 1e-10       # sharded vs one-card result
OOC_BUDGET_GB = 4.0     # device budget of the atom_chunk="auto" phase
WINDOW_LAGS = 1000      # max_lag of the windowed VACF
ORACLE_SUBSET = 64      # particles checked by the per-lag host loops
TEMP = 300.0

HERE = os.path.dirname(os.path.abspath(__file__))


def rel_err(got, want) -> float:
    """Largest deviation relative to the oracle's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != oracle {want.shape}")
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def peak_bytes(device=None):
    import jax

    device = device or jax.local_devices()[0]
    stats = device.memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def twice(fn):
    """(result of the second call, first wall, second wall); every
    result is host numpy or blocked on, so walls include the device."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


def record(name, first_s, steady_s, errors, tol, **extra):
    err = max(errors.values())
    return {
        "phase": name,
        "ok": bool(err <= tol),
        "first_run_s": round(first_s, 4),
        "steady_s": round(steady_s, 4),
        "compile_s": round(max(first_s - steady_s, 0.0), 4),
        "max_rel_err": err,
        "tol": tol,
        "errors": errors,
        "peak_bytes_in_use": peak_bytes(),
        **extra,
    }


@contextlib.contextmanager
def budget_env(gb: float):
    from transport_analysis_tpu.ops.acf import BUDGET_ENV

    old = os.environ.get(BUDGET_ENV)
    os.environ[BUDGET_ENV] = str(gb)
    try:
        yield
    finally:
        if old is None:
            del os.environ[BUDGET_ENV]
        else:
            os.environ[BUDGET_ENV] = old


class Smoke:
    """The smoke's data: the EC trajectory on disk, its Universe, and
    float64 host copies of what the decoders serve, for the oracles."""

    def __init__(self, workdir: str, n_frames: int, fit_window=None):
        self.workdir = workdir
        self.n_frames = n_frames
        self.fit_window = fit_window or (n_frames // 10, n_frames // 2)
        self._oracle = {}

    def load(self):
        import transport_analysis_tpu as ta
        from transport_analysis_tpu.data import generate
        from transport_analysis_tpu.io import _native

        os.makedirs(self.workdir, exist_ok=True)
        self.top = os.path.join(self.workdir, "ec.pdb")
        self.trr = os.path.join(self.workdir, "ec.trr")
        t0 = time.perf_counter()
        generate.write_topology_pdb(self.top)
        generate.generate_trajectory(self.top, self.trr, self.n_frames)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.u = ta.Universe(self.top, self.trr)
        native = _native.get_trr_decoder() is not None
        batch = self.u.trajectory.read_frames_batch(
            np.arange(self.n_frames))
        read_s = time.perf_counter() - t0
        self.vel = batch["velocities"].astype(np.float64)
        self.pos = batch["positions"].astype(np.float64)
        self.volumes = np.asarray(batch["volumes"], np.float64)
        self.times = np.asarray(batch["times"], np.float64)
        self.masses = np.asarray(self.u.atoms.masses, np.float64)
        return {
            "phase": "data",
            "ok": bool(native and len(self.u.trajectory) == self.n_frames),
            "n_frames": self.n_frames,
            "n_atoms": int(self.vel.shape[1]),
            "trr_bytes": os.path.getsize(self.trr),
            "generate_s": round(gen_s, 3),
            "decode_s": round(read_s, 3),
            "native_trr_decoder": native,
        }

    # --- host float64 oracles -------------------------------------------
    def oracle(self, key):
        if key not in self._oracle:
            from transport_analysis_tpu.ops.acf import acf_fft_numpy
            from transport_analysis_tpu.ops.einstein import (
                einstein_difference_numpy,
            )

            if key == "vacf":
                val = acf_fft_numpy(self.vel)
            elif key == "mvx":
                val = self.masses[None, :, None] * self.vel * self.pos
            elif key == "helfand":
                val = einstein_difference_numpy(
                    self.oracle("mvx"), "mean") / self.helfand_denom()
            else:
                raise KeyError(key)
            self._oracle[key] = val
        return self._oracle[key]

    def helfand_denom(self):
        from transport_analysis_tpu.utils.units import constants

        k_b = constants["Boltzmann_constant"]
        return 2.0 * k_b * float(np.mean(self.volumes)) * TEMP

    def subset(self, n_atoms):
        rng = np.random.RandomState(1)
        k = min(ORACLE_SUBSET, n_atoms)
        return np.sort(rng.choice(n_atoms, k, replace=False))


# --- one-card phases ---------------------------------------------------------
def phase_ooc_auto(s: Smoke):
    """Out-of-core VACF and Helfand with atom_chunk="auto" under a
    budget small enough to split the system; peak device memory must
    stay under that budget. Run first, so the process peak is this
    phase's."""
    from transport_analysis_tpu.ops.acf import auto_atom_chunk, fft_peak_bytes
    from transport_analysis_tpu.ops.einstein import einstein_difference_numpy
    from transport_analysis_tpu.parallel.out_of_core import (
        helfand_out_of_core, vacf_out_of_core,
    )

    spools = os.path.join(s.workdir, "spools")
    with budget_env(OOC_BUDGET_GB):
        chunk = auto_atom_chunk(s.n_frames, d=3, dtype=np.float32)
        vacf, first_v, steady_v = twice(
            lambda: vacf_out_of_core(s.u, os.path.join(spools, "v")))
        (helf, _), first_h, steady_h = twice(
            lambda: helfand_out_of_core(s.u, os.path.join(spools, "h")))
    # the spools quantize m·v·x to float32: the oracle does the same
    mvx32 = s.oracle("mvx").astype(np.float32).astype(np.float64)
    helf_want = (einstein_difference_numpy(mvx32, "mean").mean(axis=1)
                 / s.helfand_denom())
    out = record(
        "ooc_auto", first_v + first_h, steady_v + steady_h,
        {"vacf": rel_err(vacf, s.oracle("vacf").mean(axis=1)),
         "helfand": rel_err(helf, helf_want)},
        REL_TOL, atom_chunk=chunk,
        n_chunks=-(-s.vel.shape[1] // chunk),
        budget_bytes=int(OOC_BUDGET_GB * 1e9),
        model_peak_bytes=fft_peak_bytes(s.n_frames, chunk, 3, 4),
    )
    peak = out["peak_bytes_in_use"]
    out["ok"] = out["ok"] and (peak is None or peak <= OOC_BUDGET_GB * 1e9)
    return out


def phase_vacf_fft(s: Smoke):
    import transport_analysis_tpu as ta

    ag = s.u.select_atoms("all")
    holder = {}

    def run():
        holder["a"] = ta.VelocityAutocorr(ag).run()
        return holder["a"].results.vacf_by_particle

    got, first, steady = twice(run)
    want = s.oracle("vacf")
    d_gk = holder["a"].self_diffusivity_gk()
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    d_want = float(trapezoid(want.mean(axis=1), s.times)) / 3.0
    return record(
        "vacf_fft", first, steady,
        {"vacf_by_particle": rel_err(got, want),
         "diffusivity_gk": abs(d_gk - d_want) / abs(d_want)},
        REL_TOL, diffusivity_gk=d_gk,
    )


def phase_vacf_windowed(s: Smoke):
    import transport_analysis_tpu as ta
    from transport_analysis_tpu.ops.acf import acf_windowed_numpy

    lags = min(WINDOW_LAGS, s.n_frames)
    got, first, steady = twice(
        lambda: ta.VelocityAutocorr(
            s.u.atoms, fft=False, max_lag=lags
        ).run().results.vacf_by_particle)
    sub = s.subset(s.vel.shape[1])
    loop = acf_windowed_numpy(s.vel[:, sub], lags)
    return record(
        "vacf_windowed", first, steady,
        {"subset_vs_host_loop": rel_err(got[:, sub], loop),
         "all_vs_host_fft": rel_err(got, s.oracle("vacf")[:lags])},
        REL_TOL, max_lag=lags, subset=len(sub),
    )


def phase_helfand(s: Smoke):
    import transport_analysis_tpu as ta
    from transport_analysis_tpu.ops.einstein import (
        einstein_difference_windowed_numpy,
    )

    holder = {}

    def run():
        holder["h"] = ta.ViscosityHelfand(
            s.u.atoms, temp_avg=TEMP, linear_fit_window=s.fit_window,
        ).run()
        return holder["h"].results.visc_by_particle

    got, first, steady = twice(run)
    want = s.oracle("helfand")
    lo, hi = s.fit_window
    lagtimes = np.arange(1, s.n_frames)
    slope_want = np.polyfit(lagtimes[lo:hi], want.mean(axis=1)[lo:hi], 1)[0]
    slope = holder["h"].results.viscosity
    sub = s.subset(s.vel.shape[1])
    lags = min(WINDOW_LAGS, s.n_frames)
    loop = einstein_difference_windowed_numpy(
        s.oracle("mvx")[:, sub], "mean", lags) / s.helfand_denom()
    return record(
        "helfand", first, steady,
        {"visc_by_particle": rel_err(got, want),
         "subset_vs_host_loop": rel_err(got[:lags, sub], loop),
         "viscosity": abs(slope - slope_want) / abs(slope_want)},
        REL_TOL, viscosity=slope,
    )


def phase_msd(s: Smoke):
    import transport_analysis_tpu as ta
    from transport_analysis_tpu.ops.einstein import einstein_difference_numpy

    select = "name O*"
    idx = s.u.select_atoms(select).indices
    got, first, steady = twice(
        lambda: ta.EinsteinMSD(
            s.u, select=select, msd_type="xyz"
        ).run().results.msds_by_particle)
    want = einstein_difference_numpy(s.pos[:, idx], "sum")
    return record("msd", first, steady, {"msds_by_particle":
                                         rel_err(got, want)},
                  REL_TOL, n_selected=int(len(idx)))


def phase_stream(s: Smoke):
    import transport_analysis_tpu as ta

    block = max(1, s.n_frames // 10)
    got, first, steady = twice(
        lambda: ta.VelocityAutocorr(
            s.u.atoms, frame_block=block
        ).run().results.vacf_by_particle)
    return record("stream", first, steady,
                  {"vacf_by_particle": rel_err(got, s.oracle("vacf"))},
                  REL_TOL, frame_block=block)


class _Outcomes:
    """pytest plugin: counts each test's call-phase outcome."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests():
    """tests/test_gpu_equivalence.py in this process (the conftest
    keeps the backend this process already initialized)."""
    import pytest

    outcomes = _Outcomes()
    path = os.path.join(HERE, "tests", "test_gpu_equivalence.py")
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      path], plugins=[outcomes])
    wall = time.perf_counter() - t0
    c = outcomes.counts
    return {
        "phase": "gpu_tests",
        "ok": bool(rc == 0 and c["failed"] == 0 and c["skipped"] == 0
                   and c["passed"] > 0),
        "exit_code": int(rc),
        **c,
        "wall_s": round(wall, 3),
        "peak_bytes_in_use": peak_bytes(),
    }


ONE_CARD_PHASES = [phase_ooc_auto, phase_vacf_fft, phase_vacf_windowed,
                   phase_helfand, phase_msd, phase_stream]


# --- four-card phases ----------------------------------------------------
def _shard_devices(arr):
    return sorted(d.id for sh in arr.addressable_shards for d in [sh.device])


def phase_atom_sharded(n_frames=16384, n_atoms=16384, seed=0):
    """VACF and Helfand with the particle axis sharded over every
    device (parallel.use_mesh) against the same analyses on one card."""
    import jax

    import transport_analysis_tpu as ta
    from transport_analysis_tpu import parallel
    from transport_analysis_tpu.core.topology import Topology
    from transport_analysis_tpu.core.trajectory import MemoryReader

    rng = np.random.Generator(np.random.PCG64(seed))
    vel = rng.standard_normal((n_frames, n_atoms, 3), np.float32) * 5
    pos = np.cumsum(vel, axis=0, dtype=np.float32) * np.float32(0.01)
    top = Topology(n_atoms)
    u = ta.Universe(top, MemoryReader(
        pos, velocities=vel, dimensions=[40.0, 40.0, 40.0, 90, 90, 90]))
    u.add_TopologyAttr("masses", rng.uniform(1.0, 16.0, n_atoms))

    def both():
        v = ta.VelocityAutocorr(u.atoms).run().results.vacf_by_particle
        h = ta.ViscosityHelfand(u.atoms).run().results.visc_by_particle
        return v, h

    t0 = time.perf_counter()
    v1, h1 = both()  # one card, once: the reference result
    one_card_s = time.perf_counter() - t0
    mesh = parallel.analysis_mesh()
    with parallel.use_mesh(mesh):
        (v4, h4), first4, steady4 = twice(both)
        placed, _ = parallel.shard_particles(vel)
    held = _shard_devices(placed)
    peaks = [peak_bytes(d) for d in jax.devices()]
    out = record(
        "atom_sharded", first4, steady4,
        {"vacf": rel_err(v4, v1), "helfand": rel_err(h4, h1)},
        SHARD_TOL, one_card_first_s=round(one_card_s, 4), n_frames=n_frames,
        n_atoms=n_atoms, shard_devices=held, peak_bytes_per_device=peaks,
    )
    out["ok"] = out["ok"] and held == sorted(
        d.id for d in jax.devices()) and len(held) == len(jax.devices())
    return out


def phase_ring(n_frames=8192, n_atoms=128, seed=1):
    """Frame-sharded exact windowed correlation (parallel/ring.py)
    against the one-card windowed kernels."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from transport_analysis_tpu import ops
    from transport_analysis_tpu.parallel.ring import (
        windowed_correlation_ring,
    )

    devices = jax.devices()
    mesh = Mesh(np.asarray(devices), ("frames",))
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 5, (n_frames, n_atoms, 3))
    a = np.cumsum(x, axis=0)

    def ring():
        return (windowed_correlation_ring(x, mesh, mode="acf"),
                windowed_correlation_ring(a, mesh, mode="einstein",
                                          sum_d=False))

    def serial():
        return (ops.acf_windowed(x),
                ops.einstein_difference_windowed(a, "mean"))

    (r_acf, r_ein), first, steady = twice(ring)
    (s_acf, s_ein), _, serial_s = twice(serial)
    held = _shard_devices(jax.device_put(x, NamedSharding(mesh, P("frames"))))
    out = record(
        "ring", first, steady,
        {"acf": rel_err(r_acf, s_acf), "einstein": rel_err(r_ein, s_ein)},
        SHARD_TOL, one_card_steady_s=round(serial_s, 4),
        n_frames=n_frames, n_atoms=n_atoms, shard_devices=held,
    )
    out["ok"] = out["ok"] and len(held) == len(devices)
    return out


def phase_sharded_fft(n_frames=65536, n_atoms=64, seed=2):
    """Frame-sharded four-step FFT (parallel/sharded_fft.py, psum_scatter
    reduce) against the one-card native FFT path."""
    import jax
    from jax.sharding import Mesh

    from transport_analysis_tpu import ops
    from transport_analysis_tpu.parallel.sharded_fft import (
        _place, sharded_acf_fft, sharded_msd_fft,
    )

    devices = jax.devices()
    mesh = Mesh(np.asarray(devices), ("frames",))
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 5, (n_frames, n_atoms, 3))
    a = np.cumsum(x, axis=0)

    def sharded():
        return (sharded_acf_fft(x, mesh), sharded_msd_fft(a, mesh))

    def serial():
        return (ops.acf_fft(x), ops.msd_fft(a))

    (g_acf, g_msd), first, steady = twice(sharded)
    (s_acf, s_msd), _, serial_s = twice(serial)
    held = _shard_devices(_place(np.zeros((len(devices) * 8, 1)), mesh,
                                 "frames"))
    out = record(
        "sharded_fft", first, steady,
        {"acf": rel_err(g_acf, s_acf), "msd": rel_err(g_msd, s_msd)},
        SHARD_TOL, one_card_steady_s=round(serial_s, 4),
        n_frames=n_frames, n_atoms=n_atoms, shard_devices=held,
    )
    out["ok"] = out["ok"] and len(held) == len(devices)
    return out


FOUR_CARD_PHASES = [phase_atom_sharded, phase_ring, phase_sharded_fft]


# --- driver ------------------------------------------------------------------
def run_phases(phases):
    """Run each ``(name, fn)`` phase and print its JSON line; a phase
    that raises is a failed phase (traceback on stderr). Returns whether
    every phase passed."""
    import traceback

    ok = True
    for name, fn in phases:
        try:
            rec = fn()
        except Exception:  # recorded as a failed phase: exit non-zero
            traceback.print_exc()
            rec = {"phase": name, "ok": False,
                   "error": traceback.format_exc(limit=1)}
        print(json.dumps(rec), flush=True)
        ok = ok and rec["ok"]
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths on 4 GPUs")
    ap.add_argument("--frames", type=int, default=10000,
                    help="trajectory length of the one-card phases")
    ap.add_argument("--workdir", default=os.path.join(HERE, ".smoke_data"))
    args = ap.parse_args(argv)

    try:
        import jax  # noqa: F401

        import transport_analysis_tpu  # noqa: F401  (float64 on)
        from transport_analysis_tpu.utils.runtime import (
            NoGPUError, enable_compile_cache, gpu_name_and_power_limit,
            require_gpu,
        )
    except ImportError as err:
        print(f"chip_smoke: cannot import the package: {err}",
              file=sys.stderr)
        return 2
    try:
        device = require_gpu()
    except NoGPUError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if device["count"] < want:
        print(f"chip_smoke: needs {want} GPUs, found {device['count']}",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    for line in gpu_name_and_power_limit().splitlines():
        print(f"gpu: {line}", flush=True)
    print(json.dumps({"compile_cache": cache, "device": device}), flush=True)

    if args.four_cards:
        ok = run_phases([(p.__name__[6:], p) for p in FOUR_CARD_PHASES])
    else:
        smoke = Smoke(args.workdir, args.frames)
        try:
            ok = run_phases(
                [("data", smoke.load)]
                + [(p.__name__[6:], lambda p=p: p(smoke))
                   for p in ONE_CARD_PHASES]
                + [("gpu_tests", phase_gpu_tests)])
        finally:
            shutil.rmtree(args.workdir, ignore_errors=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
