"""Model-layer f32-exact source mode (models/base.py source_cast).

Trajectory decoders serve float32 samples (core/trajectory.py
``read_frames_batch``; MemoryReader coerces to f32 at
core/trajectory.py:282-284), and f32 values are exactly representable
in float64 — so the models keep the feed buffers f32 under the default
float64 work dtype and the conclude kernels consume them through the
``*_from_f32`` ops entries, which upcast on the device and run the
float64 path, so every assertion here is BIT-identity against the
forced-upcast run
(``TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE=1``).
"""

import numpy as np
import pytest

import transport_analysis_tpu as ta
from transport_analysis_tpu.models.base import source_cast


def _vacf(u, monkeypatch=None, opt_out=False, **kw):
    if opt_out:
        monkeypatch.setenv("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE", "1")
    v = ta.VelocityAutocorr(u.atoms, **kw).run()
    if opt_out:
        monkeypatch.delenv("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE")
    return v


class TestSourceCast:
    def test_f32_passthrough_under_f64(self):
        a = np.ones((3, 2), np.float32)
        out = source_cast(a, np.float64)
        assert out.dtype == np.float32
        assert out is a

    def test_f64_source_untouched(self):
        a = np.ones((3, 2), np.float64)
        assert source_cast(a, np.float64).dtype == np.float64

    def test_f32_work_dtype_stays_f32(self):
        a = np.ones((3, 2), np.float32)
        assert source_cast(a, np.float32).dtype == np.float32

    def test_f64_source_f32_work_downcasts(self):
        a = np.ones((3, 2), np.float64)
        assert source_cast(a, np.float32).dtype == np.float32

    def test_opt_out_env(self, monkeypatch):
        monkeypatch.setenv("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE", "1")
        a = np.ones((3, 2), np.float32)
        assert source_cast(a, np.float64).dtype == np.float64


class TestVACFF32Source:
    def test_buffer_stays_f32(self, u_random):
        v = _vacf(u_random)
        assert v._velocities.dtype == np.float32
        assert v.results.timeseries.dtype == np.float64

    def test_fft_bit_identical_to_upcast(self, u_random, monkeypatch):
        a = _vacf(u_random)
        b = _vacf(u_random, monkeypatch, opt_out=True)
        assert b._velocities.dtype == np.float64
        np.testing.assert_array_equal(
            a.results.vacf_by_particle, b.results.vacf_by_particle
        )

    def test_windowed_bit_identical_to_upcast(self, u_random,
                                              monkeypatch):
        a = _vacf(u_random, fft=False)
        b = _vacf(u_random, monkeypatch, opt_out=True, fft=False)
        np.testing.assert_array_equal(
            a.results.vacf_by_particle, b.results.vacf_by_particle
        )

    def test_frame_block_buffer_f32(self, u_random, monkeypatch):
        a = _vacf(u_random, frame_block=5)
        assert np.dtype(a._velocities.dtype) == np.float32
        b = _vacf(u_random, monkeypatch, opt_out=True, frame_block=5)
        np.testing.assert_array_equal(
            a.results.vacf_by_particle, b.results.vacf_by_particle
        )

    def test_atom_chunk_matches(self, u_random, monkeypatch):
        a = _vacf(u_random, atom_chunk=3)
        b = _vacf(u_random, monkeypatch, opt_out=True, atom_chunk=3)
        np.testing.assert_array_equal(
            a.results.vacf_by_particle, b.results.vacf_by_particle
        )

    def test_frame_engine_unaffected(self, u_random):
        # the per-frame parity engine fills the f64 _prepare buffer
        v = ta.VelocityAutocorr(u_random.atoms, engine="frame").run()
        assert v._velocities.dtype == np.float64

    def test_f32_fast_mode_unchanged(self, u_random):
        v = _vacf(u_random, dtype=np.float32)
        assert v._velocities.dtype == np.float32
        assert v._work_dtype == np.float32


class TestHelfandF32Source:
    def test_buffers_f32_results_identical(self, u_random, monkeypatch):
        a = ta.ViscosityHelfand(u_random.atoms).run()
        assert a._velocities.dtype == np.float32
        assert a._positions.dtype == np.float32
        monkeypatch.setenv("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE", "1")
        b = ta.ViscosityHelfand(u_random.atoms).run()
        assert b._velocities.dtype == np.float64
        np.testing.assert_array_equal(
            a.results.visc_by_particle, b.results.visc_by_particle
        )

    def test_frame_block_identical(self, u_random, monkeypatch):
        a = ta.ViscosityHelfand(u_random.atoms, frame_block=5).run()
        assert np.dtype(a._velocities.dtype) == np.float32
        monkeypatch.setenv("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE", "1")
        b = ta.ViscosityHelfand(u_random.atoms, frame_block=5).run()
        np.testing.assert_array_equal(
            np.asarray(a.results.visc_by_particle),
            np.asarray(b.results.visc_by_particle),
        )

    def test_windowed_identical(self, u_random, monkeypatch):
        a = ta.ViscosityHelfand(u_random.atoms, fft=False).run()
        monkeypatch.setenv("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE", "1")
        b = ta.ViscosityHelfand(u_random.atoms, fft=False).run()
        np.testing.assert_array_equal(
            a.results.visc_by_particle, b.results.visc_by_particle
        )


class TestMSDF32Source:
    @pytest.mark.parametrize("fft", [True, False])
    def test_bit_identical_to_upcast(self, u_random, monkeypatch, fft):
        a = ta.EinsteinMSD(u_random, fft=fft).run()
        assert a._positions.dtype == np.float32
        monkeypatch.setenv("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE", "1")
        b = ta.EinsteinMSD(u_random, fft=fft).run()
        assert b._positions.dtype == np.float64
        np.testing.assert_array_equal(
            a.results.msds_by_particle, b.results.msds_by_particle
        )

    def test_frame_block_buffer_f32(self, u_random):
        a = ta.EinsteinMSD(u_random, frame_block=5).run()
        assert np.dtype(a._positions.dtype) == np.float32


class TestOracleStillHolds:
    """The analytic step-trajectory oracle through the f32-source path
    (velocities 0..5000 are integers — exactly representable in f32,
    so the reference characteristic-polynomial values still hold)."""

    def test_step_vacf_value(self, step_vtraj, NSTEP):
        from tests.test_velocityautocorr import characteristic_poly

        v = ta.VelocityAutocorr(step_vtraj.atoms).run()
        assert v._velocities.dtype == np.float32
        np.testing.assert_almost_equal(
            v.results.timeseries,
            characteristic_poly(NSTEP, 3),
            decimal=4,
        )
