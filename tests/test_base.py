"""AnalysisBase runtime contract tests: Results mapping, frames=
selection, verbose progress, engine validation."""

import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

import transport_analysis_tpu as ta
from transport_analysis_tpu import VelocityAutocorr
from transport_analysis_tpu.models.base import AnalysisBase, Results


class TestResults:
    def test_attribute_access(self):
        r = Results()
        r.timeseries = [1, 2]
        assert r["timeseries"] == [1, 2]
        r["foo"] = 3
        assert r.foo == 3

    def test_missing_attribute(self):
        r = Results()
        with pytest.raises(AttributeError):
            r.nope

    def test_delete(self):
        r = Results()
        r.x = 1
        del r.x
        assert "x" not in r


class TestRunArguments:
    def test_frames_indices(self, u_random):
        by_slice = VelocityAutocorr(u_random.atoms).run(
            start=0, stop=12, step=3
        )
        by_frames = VelocityAutocorr(u_random.atoms).run(
            frames=[0, 3, 6, 9]
        )
        assert_array_equal(by_frames.frames, [0, 3, 6, 9])
        assert_allclose(
            by_frames.results.timeseries,
            by_slice.results.timeseries,
            rtol=1e-12,
        )

    def test_frames_bool_mask(self, u_random):
        mask = np.zeros(12, bool)
        mask[[1, 5, 7]] = True
        v = VelocityAutocorr(u_random.atoms).run(frames=mask)
        assert_array_equal(v.frames, [1, 5, 7])
        assert v.n_frames == 3

    def test_frames_with_slice_rejected(self, u_random):
        with pytest.raises(ValueError, match="cannot be combined"):
            VelocityAutocorr(u_random.atoms).run(start=1, frames=[0, 1])

    def test_bad_engine(self, u_random):
        with pytest.raises(ValueError, match="engine"):
            VelocityAutocorr(u_random.atoms, engine="bogus")

    def test_verbose_progress(self, u_random, capsys):
        VelocityAutocorr(u_random.atoms, engine="frame").run(verbose=True)
        cap = capsys.readouterr()
        out = cap.out + cap.err  # tqdm writes to stderr
        assert "VelocityAutocorr" in out
        assert "12/12" in out

    def test_verbose_progress_streaming(self, u_random, capsys):
        VelocityAutocorr(u_random.atoms, frame_block=4).run(verbose=True)
        cap = capsys.readouterr()
        out = cap.out + cap.err
        assert "12/12" in out

    def test_quiet_by_default(self, u_random, capsys):
        VelocityAutocorr(u_random.atoms, engine="frame").run()
        cap = capsys.readouterr()
        assert "12/12" not in (cap.out + cap.err)

    def test_times_follow_selection(self, u_random):
        v = VelocityAutocorr(u_random.atoms).run(start=2, stop=10, step=2)
        assert_allclose(v.times, [2.0, 4.0, 6.0, 8.0])


class TestAnalysisBaseSubclassing:
    def test_user_subclass_single_frame(self, u_random):
        """The MDAnalysis-style extension point keeps working."""

        class MeanVelocity(AnalysisBase):
            def __init__(self, ag, **kwargs):
                super().__init__(ag.universe.trajectory, **kwargs)
                self.ag = ag

            def _prepare(self):
                self._acc = np.zeros(3)

            def _single_frame(self):
                self._acc += self.ag.velocities.mean(axis=0)

            def _conclude(self):
                self.results.mean_velocity = self._acc / self.n_frames

        m = MeanVelocity(u_random.atoms).run()
        assert m.results.mean_velocity.shape == (3,)
        direct = np.mean(
            [u_random.trajectory[i].velocities.mean(axis=0)
             for i in range(12)],
            axis=0,
        )
        assert_allclose(m.results.mean_velocity, direct, rtol=1e-6)


class TestDtypeFastMode:
    def test_f32_matches_f64_loosely(self, u_random):
        a = VelocityAutocorr(u_random.atoms).run()
        b = VelocityAutocorr(u_random.atoms, dtype=np.float32).run()
        assert b._velocities.dtype == np.float32
        assert_allclose(
            b.results.timeseries, a.results.timeseries, rtol=1e-4
        )

    def test_f32_viscosity(self, u_random):
        from transport_analysis_tpu import ViscosityHelfand

        a = ViscosityHelfand(u_random.atoms).run()
        b = ViscosityHelfand(u_random.atoms, dtype=np.float32).run()
        assert_allclose(
            b.results.timeseries, a.results.timeseries, rtol=1e-3
        )

    def test_f32_msd(self, u_random):
        from transport_analysis_tpu import EinsteinMSD

        a = EinsteinMSD(u_random.atoms).run()
        b = EinsteinMSD(u_random.atoms, dtype=np.float32).run()
        assert_allclose(
            b.results.timeseries, a.results.timeseries, rtol=1e-3,
            atol=1e-3,
        )


class TestFrameBlockedFeed:
    """frame_block= streams the selection host→device in blocks
    (the batch engine alone materializes the full (N, P, 3) selection
    on host). Results must be identical to the
    one-shot batch engine for every analysis, including strided runs
    and blocks that don't divide the frame count."""

    @pytest.fixture()
    def u(self):
        rng = np.random.RandomState(5)
        n_frames, n_atoms = 37, 6
        u = ta.Universe.empty(n_atoms, n_frames=n_frames,
                              velocities=True)
        u.add_TopologyAttr("masses", np.full(n_atoms, 12.0))
        from transport_analysis_tpu.core.transformations import (
            set_dimensions,
        )

        u.trajectory.add_transformations(
            set_dimensions([8, 8, 8, 90, 90, 90])
        )
        pos = np.cumsum(rng.normal(0, 0.3, (n_frames, n_atoms, 3)),
                        axis=0)
        for i, ts in enumerate(u.trajectory):
            u.atoms.velocities = rng.normal(0, 2, (n_atoms, 3))
            u.atoms.positions = pos[i]
        return u

    @pytest.mark.parametrize("block", [1, 7, 64])
    def test_vacf_blocked_equals_batch(self, u, block):
        from transport_analysis_tpu import VelocityAutocorr

        a = VelocityAutocorr(u.atoms).run()
        b = VelocityAutocorr(u.atoms, frame_block=block).run()
        assert_allclose(b.results.timeseries, a.results.timeseries,
                        rtol=1e-12)
        assert_allclose(b.times, a.times)

    def test_vacf_blocked_strided(self, u):
        from transport_analysis_tpu import VelocityAutocorr

        a = VelocityAutocorr(u.atoms).run(start=3, stop=30, step=3)
        b = VelocityAutocorr(u.atoms, frame_block=4).run(
            start=3, stop=30, step=3
        )
        assert_allclose(b.results.timeseries, a.results.timeseries,
                        rtol=1e-12)

    def test_helfand_blocked_equals_batch(self, u):
        from transport_analysis_tpu import ViscosityHelfand

        a = ViscosityHelfand(u.atoms, linear_fit_window=(3, 15)).run()
        b = ViscosityHelfand(
            u.atoms, linear_fit_window=(3, 15), frame_block=5
        ).run()
        assert_allclose(b.results.timeseries, a.results.timeseries,
                        rtol=1e-12)
        assert b.results.viscosity == pytest.approx(
            a.results.viscosity, rel=1e-12
        )

    def test_msd_blocked_equals_batch(self, u):
        from transport_analysis_tpu import EinsteinMSD

        a = EinsteinMSD(u, select="all").run()
        b = EinsteinMSD(u, select="all", frame_block=8).run()
        assert_allclose(b.results.timeseries, a.results.timeseries,
                        rtol=1e-12)

    def test_bad_frame_block(self, u):
        from transport_analysis_tpu import VelocityAutocorr

        with pytest.raises(ValueError, match="frame_block"):
            VelocityAutocorr(u.atoms, frame_block=0)


class TestResultsPersistence:
    def test_save_and_load_roundtrip(self, tmp_path):
        from transport_analysis_tpu import ViscosityHelfand
        from transport_analysis_tpu.models.base import AnalysisBase
        from transport_analysis_tpu.core.transformations import (
            set_dimensions,
        )

        rng = np.random.RandomState(8)
        u = ta.Universe.empty(5, n_frames=20, velocities=True)
        u.add_TopologyAttr("masses", np.full(5, 16.0))
        u.trajectory.add_transformations(
            set_dimensions([4, 4, 4, 90, 90, 90])
        )
        for i, ts in enumerate(u.trajectory):
            u.atoms.velocities = rng.normal(0, 1, (5, 3))
            u.atoms.positions = rng.uniform(0, 4, (5, 3))
        vh = ViscosityHelfand(u.atoms, linear_fit_window=(2, 10)).run()
        path = tmp_path / "results.npz"
        vh.save(path)
        results, meta = AnalysisBase.load_results(path)
        assert meta["class"] == "ViscosityHelfand"
        assert_allclose(results.timeseries, vh.results.timeseries)
        assert results.viscosity == pytest.approx(
            vh.results.viscosity
        )
        assert_allclose(meta["times"], vh.times)

    def test_save_before_run_raises(self):
        from transport_analysis_tpu import VelocityAutocorr

        u = ta.Universe.empty(3, n_frames=4, velocities=True)
        v = VelocityAutocorr(u.atoms)
        with pytest.raises(RuntimeError, match="run"):
            v.save("/tmp/never.npz")


def test_uniform_writer_dispatch(tmp_path):
    """io.Writer(path, n_atoms) picks the format from the extension
    and returns a context-manager writer accepting Timesteps."""
    from transport_analysis_tpu import io as ta_io

    rng = np.random.RandomState(2)
    u = ta.Universe.empty(6, n_frames=3, velocities=True)
    for i, ts in enumerate(u.trajectory):
        u.atoms.positions = rng.uniform(0, 30, (6, 3))
        u.atoms.velocities = rng.normal(0, 1, (6, 3))

    for name in ("w.trr", "w.dcd", "w.ncdf", "w.h5md"):
        p = tmp_path / name
        kwargs = {"velocities": True} if name.endswith("ncdf") else {}
        with ta_io.Writer(p, 6, **kwargs) as w:
            for ts in u.trajectory:
                w.write(ts)
        r = ta_io.open_trajectory(p)
        assert r.n_frames == 3
        assert_allclose(r[1].positions, u.trajectory[1].positions,
                        atol=1e-3)

    with pytest.raises(ValueError, match="unsupported"):
        ta_io.Writer(tmp_path / "w.xyz", 6)


def test_batch_engine_applies_trajectory_transformations():
    """Regression: MemoryReader.read_frames_batch bypassed registered
    transformations, so set_dimensions box volumes never reached the
    batch engine and ViscosityHelfand raised NoDataError (found by the
    verify flow, round 3)."""
    import numpy as np

    import transport_analysis_tpu as ta
    from transport_analysis_tpu.core.transformations import set_dimensions
    from transport_analysis_tpu.models import ViscosityHelfand

    rng = np.random.default_rng(0)
    n_atoms, n_frames = 4, 32
    u = ta.Universe.empty(n_atoms, n_frames=n_frames, velocities=True,
                          trajectory=True)
    u.load_new(rng.normal(0, 1, (n_frames, n_atoms, 3)),
               velocities=rng.normal(0, 1, (n_frames, n_atoms, 3)),
               dt=0.01)
    u.add_TopologyAttr("masses", np.full(n_atoms, 16.0))
    u.trajectory.add_transformations(
        set_dimensions([20.0, 20.0, 20.0, 90.0, 90.0, 90.0]))
    h = ViscosityHelfand(u.atoms, temp_avg=300.0).run()
    assert np.isfinite(np.asarray(h.results.timeseries)).all()
    # per-frame engine must agree
    h2 = ViscosityHelfand(u.atoms, temp_avg=300.0, engine="frame").run()
    np.testing.assert_allclose(
        np.asarray(h.results.timeseries),
        np.asarray(h2.results.timeseries), rtol=1e-10)
