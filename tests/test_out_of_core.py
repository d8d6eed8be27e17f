"""Out-of-core spool pipeline: file → per-chunk spools → device →
timeseries, equal to the in-memory analysis."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

import transport_analysis_tpu as ta
from transport_analysis_tpu import VelocityAutocorr
from transport_analysis_tpu.core.topology import Topology
from transport_analysis_tpu.io.trr import TRRReader, TRRWriter
from transport_analysis_tpu.parallel.out_of_core import (
    build_spools,
    vacf_out_of_core,
)


@pytest.fixture()
def trr_universe(tmp_path):
    rng = np.random.RandomState(9)
    n_frames, n_atoms = 24, 10
    vel = rng.normal(0, 8, (n_frames, n_atoms, 3)).astype(np.float32)
    pos = rng.uniform(0, 20, (n_frames, n_atoms, 3)).astype(np.float32)
    path = tmp_path / "t.trr"
    with TRRWriter(path, n_atoms) as w:
        for i in range(n_frames):
            w.write(positions=pos[i], velocities=vel[i],
                    dimensions=[20, 20, 20, 90, 90, 90], time=float(i))
    return ta.Universe(Topology(n_atoms), TRRReader(path))


def test_matches_in_memory(trr_universe, tmp_path):
    ooc = vacf_out_of_core(
        trr_universe, str(tmp_path / "spool"), atom_chunk=3
    )
    ref = VelocityAutocorr(trr_universe.atoms).run()
    assert_allclose(ooc, ref.results.timeseries, rtol=1e-6)


def test_strided_and_capped(trr_universe, tmp_path):
    ooc = vacf_out_of_core(
        trr_universe, str(tmp_path / "spool2"), atom_chunk=4,
        start=2, stop=20, step=2, max_lag=5,
    )
    ref = VelocityAutocorr(trr_universe.atoms, max_lag=5).run(
        start=2, stop=20, step=2
    )
    assert ooc.shape == (5,)
    assert_allclose(ooc, ref.results.timeseries, rtol=1e-6)


def test_spool_reuse(trr_universe, tmp_path):
    spool = str(tmp_path / "spool3")
    frames = np.arange(24)
    p1 = build_spools(
        trr_universe.trajectory, frames,
        trr_universe.atoms.indices, [0, 1, 2], spool, 4,
    )
    mtimes = [__import__("os").path.getmtime(p) for p in p1]
    p2 = build_spools(
        trr_universe.trajectory, frames,
        trr_universe.atoms.indices, [0, 1, 2], spool, 4,
    )
    assert p1 == p2
    mtimes2 = [__import__("os").path.getmtime(p) for p in p2]
    assert mtimes == mtimes2  # complete spools were not rebuilt


def test_checkpoint_resume(trr_universe, tmp_path):
    ckpt = str(tmp_path / "ooc.npz")
    ref = VelocityAutocorr(trr_universe.atoms).run()
    # seed a fake partial checkpoint by running fully once
    ooc = vacf_out_of_core(
        trr_universe, str(tmp_path / "spool4"), atom_chunk=3,
        checkpoint=ckpt,
    )
    assert_allclose(ooc, ref.results.timeseries, rtol=1e-6)
    # resume path with a completed checkpoint returns identical result
    ooc2 = vacf_out_of_core(
        trr_universe, str(tmp_path / "spool4"), atom_chunk=3,
        checkpoint=ckpt,
    )
    assert_allclose(ooc2, ooc, rtol=1e-12)


def test_helfand_out_of_core_matches_in_memory(trr_universe, tmp_path):
    from transport_analysis_tpu import ViscosityHelfand
    from transport_analysis_tpu.parallel.out_of_core import (
        helfand_out_of_core,
    )

    trr_universe.add_TopologyAttr(
        "masses", np.linspace(1.0, 16.0, 10)
    )
    ts, visc = helfand_out_of_core(
        trr_universe, str(tmp_path / "spool_h"), atom_chunk=3,
        linear_fit_window=(2, 10),
    )
    ref = ViscosityHelfand(
        trr_universe.atoms, linear_fit_window=(2, 10)
    ).run()
    # spools quantize the m·v·x accumulator to float32 (the in-memory
    # engine keeps float64 throughout) — 1e-5 relative is the f32 floor
    assert_allclose(ts, ref.results.timeseries, rtol=2e-5, atol=1e-12)
    # the fit differences small numbers — f32 spool noise amplifies
    assert visc == pytest.approx(ref.results.viscosity, rel=1e-3)


def test_helfand_out_of_core_strided_capped(trr_universe, tmp_path):
    from transport_analysis_tpu import ViscosityHelfand
    from transport_analysis_tpu.parallel.out_of_core import (
        helfand_out_of_core,
    )

    trr_universe.add_TopologyAttr("masses", np.full(10, 4.0))
    ts, visc = helfand_out_of_core(
        trr_universe, str(tmp_path / "spool_h2"), atom_chunk=4,
        start=2, stop=20, step=2, max_lag=6,
    )
    ref = ViscosityHelfand(trr_universe.atoms, max_lag=6).run(
        start=2, stop=20, step=2
    )
    assert ts.shape == (6,)
    assert visc is None
    assert_allclose(ts, ref.results.timeseries, rtol=2e-5, atol=1e-12)


def test_msd_out_of_core_matches_in_memory(trr_universe, tmp_path):
    from transport_analysis_tpu import EinsteinMSD
    from transport_analysis_tpu.parallel.out_of_core import (
        msd_out_of_core,
    )

    ooc = msd_out_of_core(
        trr_universe, str(tmp_path / "spool_m"), atom_chunk=3
    )
    ref = EinsteinMSD(trr_universe, select="all").run()
    assert_allclose(ooc, ref.results.timeseries, rtol=1e-5)


def test_helfand_checkpoint_resume(trr_universe, tmp_path):
    from transport_analysis_tpu.parallel.out_of_core import (
        helfand_out_of_core,
    )

    trr_universe.add_TopologyAttr("masses", np.full(10, 2.0))
    ckpt = str(tmp_path / "h.npz")
    ts1, _ = helfand_out_of_core(
        trr_universe, str(tmp_path / "spool_h3"), atom_chunk=3,
        checkpoint=ckpt,
    )
    ts2, _ = helfand_out_of_core(
        trr_universe, str(tmp_path / "spool_h3"), atom_chunk=3,
        checkpoint=ckpt,
    )
    assert_allclose(ts2, ts1, rtol=1e-12)


def test_vacf_out_of_core_sharded_matches_serial(trr_universe, tmp_path):
    """Spooled atoms × frame-sharded FFT == plain out-of-core VACF:
    the north-star composition on the 8-virtual-device mesh."""
    import jax
    from jax.sharding import Mesh

    from transport_analysis_tpu.parallel.out_of_core import (
        vacf_out_of_core_sharded,
    )

    mesh = Mesh(np.array(jax.devices()[:8]), ("frames",))
    got = vacf_out_of_core_sharded(
        trr_universe, str(tmp_path / "sp_sh"), mesh, atom_chunk=4
    )
    ref = vacf_out_of_core(
        trr_universe, str(tmp_path / "sp_plain"), atom_chunk=4
    )
    assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_helfand_out_of_core_sharded_matches_serial(
    trr_universe, tmp_path
):
    """Spooled m·v·x accumulator × frame-sharded Einstein FFT == plain
    out-of-core Helfand: the second half of the composed north star."""
    import jax
    from jax.sharding import Mesh

    from transport_analysis_tpu.parallel.out_of_core import (
        helfand_out_of_core, helfand_out_of_core_sharded,
    )

    try:
        trr_universe.atoms.masses
    except Exception:
        trr_universe.add_TopologyAttr("masses", np.full(10, 2.0))
    mesh = Mesh(np.array(jax.devices()[:8]), ("frames",))
    got_ts, got_visc = helfand_out_of_core_sharded(
        trr_universe, str(tmp_path / "hsp_sh"), mesh, atom_chunk=4,
        linear_fit_window=(2, 10),
    )
    ref_ts, ref_visc = helfand_out_of_core(
        trr_universe, str(tmp_path / "hsp_plain"), atom_chunk=4,
        linear_fit_window=(2, 10),
    )
    assert_allclose(got_ts, ref_ts, rtol=1e-9, atol=1e-12)
    assert got_visc == pytest.approx(ref_visc, rel=1e-8)


class TestAutoAtomChunk:
    """auto_atom_chunk: the largest chunk whose modeled FFT-pass peak
    (ops.acf.fft_peak_bytes) fits the device budget."""

    @pytest.mark.parametrize("n_frames", [100, 10000, 32768, 131072,
                                          1048576])
    def test_largest_chunk_that_fits(self, n_frames):
        from transport_analysis_tpu.ops.acf import (
            auto_atom_chunk, fft_peak_bytes,
        )

        chunk = auto_atom_chunk(n_frames, d=3, hbm_budget_gb=60.0)
        assert fft_peak_bytes(n_frames, chunk, 3) <= 60e9
        assert fft_peak_bytes(n_frames, chunk + 1, 3) > 60e9

    def test_peak_model_terms(self):
        from transport_analysis_tpu.ops.acf import fft_peak_bytes

        # N = 10000 -> M = 32768; one atom, d = 3, f32 source
        n, m, half = 10000, 32768, 16385
        want = (n * 3 * (4 + 8) + m * 3 * 8 + 2 * half * 3 * 16
                + half * 8 + 2 * m * 8)
        assert fft_peak_bytes(n, 1, 3, 4) == want
        # linear in the chunk
        assert fft_peak_bytes(n, 7, 3, 4) == 7 * want

    def test_budget_scales(self):
        from transport_analysis_tpu.ops.acf import auto_atom_chunk

        small = auto_atom_chunk(1048576, d=3, hbm_budget_gb=15.0)
        big = auto_atom_chunk(1048576, d=3, hbm_budget_gb=60.0)
        assert 4 * small <= big <= 4 * small + 3

    def test_budget_resolution_order(self, monkeypatch):
        """Argument > TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB > the
        device's memory_stats()["bytes_limit"]."""
        from transport_analysis_tpu.ops import acf

        class _FakeDev:
            def memory_stats(self):
                return {"bytes_limit": int(40e9)}

        monkeypatch.setattr(acf.jax, "local_devices", lambda: [_FakeDev()])
        monkeypatch.delenv(acf.BUDGET_ENV, raising=False)
        assert acf.device_budget_bytes() == 40e9
        dev_chunk = acf.auto_atom_chunk(32768)
        assert dev_chunk == acf.auto_atom_chunk(32768, hbm_budget_gb=40.0)

        monkeypatch.setenv(acf.BUDGET_ENV, "10")
        assert acf.device_budget_bytes() == 10e9
        assert acf.auto_atom_chunk(32768) == acf.auto_atom_chunk(
            32768, hbm_budget_gb=10.0)

        assert acf.device_budget_bytes(2.5) == 2.5e9
        assert acf.auto_atom_chunk(32768, hbm_budget_gb=40.0) == dev_chunk

    def test_no_reported_limit_raises(self, monkeypatch):
        """A device without a memory limit (the CPU backend) has no
        default budget."""
        from transport_analysis_tpu.ops import acf

        monkeypatch.delenv(acf.BUDGET_ENV, raising=False)
        with pytest.raises(ValueError, match="no memory limit"):
            acf.auto_atom_chunk(1024)

    def test_too_small_budget_raises(self):
        from transport_analysis_tpu.ops.acf import auto_atom_chunk

        with pytest.raises(ValueError, match="does not hold one atom"):
            auto_atom_chunk(1048576, hbm_budget_gb=1e-3)

    def test_f32_source_fits_more_atoms(self):
        from transport_analysis_tpu.ops.acf import auto_atom_chunk

        f64 = auto_atom_chunk(1048576, hbm_budget_gb=60.0)
        f32 = auto_atom_chunk(1048576, hbm_budget_gb=60.0,
                              dtype=np.float32)
        assert f32 > f64

    def test_out_of_core_accepts_auto(self, tmp_path, monkeypatch):
        # default atom_chunk="auto" resolves and matches explicit int
        from transport_analysis_tpu.parallel.out_of_core import (
            vacf_out_of_core,
        )

        rng = np.random.default_rng(5)
        na, nf = 6, 32
        path = str(tmp_path / "t.trr")
        with TRRWriter(path, n_atoms=na) as w:
            for i in range(nf):
                w.write(
                    positions=rng.normal(0, 5, (na, 3)).astype(np.float32),
                    velocities=rng.normal(0, 2, (na, 3)).astype(np.float32),
                    dimensions=[20.0, 20.0, 20.0, 90.0, 90.0, 90.0],
                    time=0.002 * i,
                    step=i,
                )
        u = ta.Universe(Topology(na), path)
        # the CPU device reports no memory limit: name a budget
        monkeypatch.setenv("TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB", "0.01")
        out_auto = vacf_out_of_core(u, str(tmp_path / "s1"))
        out_int = vacf_out_of_core(
            u, str(tmp_path / "s2"), atom_chunk=4
        )
        assert_allclose(out_auto, out_int, rtol=1e-12)
