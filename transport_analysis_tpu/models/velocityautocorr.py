"""Velocity autocorrelation function (VACF) and Green–Kubo diffusivity.

JAX counterpart of the reference's ``VelocityAutocorr``
(velocityautocorr.py:72-422), computing

    C(j Δt) = 1/(N−j) · Σ_i v(iΔt)·v((i+j)Δt)

averaged over all atoms in the group. Same public surface as the
reference — ctor ``(atomgroup, dim_type, fft)``, ``run(start, stop,
step)``, ``results.timeseries`` / ``results.vacf_by_particle``,
``self_diffusivity_gk`` / ``_gk_odd``, ``plot_vacf`` /
``plot_running_integral`` — but the frame loop is a single batched
device transfer and both correlation paths are fused XLA kernels
batched over every particle at once (the reference loops particles in
Python on the FFT path, velocityautocorr.py:210-213, and lags in Python
on the windowed path, :223-235).

Results are in MDAnalysis standard units: (Å/ps)² against ps.
"""

from __future__ import annotations

import numpy as np

from ..core.groups import UpdatingAtomGroup
from ..utils.errors import NoDataError
from .. import ops
from ..parallel.sharding import map_particles
from .base import AnalysisBase
from ._dims import parse_dim_type


class VelocityAutocorr(AnalysisBase):
    """Velocity autocorrelation function over an AtomGroup.

    Parameters
    ----------
    atomgroup : AtomGroup
        Atoms to average over. ``UpdatingAtomGroup`` is rejected — lag
        correlations need a fixed particle set.
    dim_type : {'xyz', 'xy', 'yz', 'xz', 'x', 'y', 'z'}
        Components included in the VACF. Defaults to 'xyz'.
    fft : bool
        ``True`` (default): Wiener–Khinchin FFT algorithm, batched over
        particles. ``False``: exact windowed per-lag summation.
    """

    def __init__(self, atomgroup, dim_type: str = "xyz", fft: bool = True,
                 max_lag=None, atom_chunk=None, checkpoint=None,
                 dtype=np.float64, **kwargs):
        super().__init__(atomgroup.universe.trajectory, **kwargs)
        if isinstance(atomgroup, UpdatingAtomGroup):
            raise TypeError(
                "UpdatingAtomGroups are not valid for VACF computation"
            )
        self.dim_type = dim_type.lower()
        self._dim, self.dim_fac = parse_dim_type(self.dim_type)
        self.fft = fft
        self.max_lag = max_lag
        # float64 default (reference-grade numerics); float32 is the
        # fast mode (~1e-6 relative accuracy)
        self._work_dtype = np.dtype(dtype)
        self.atom_chunk = atom_chunk
        self.checkpoint = checkpoint
        self.atomgroup = atomgroup
        self.n_particles = len(atomgroup)
        self._run_called = False

    # --- engine hooks -------------------------------------------------------
    def _prepare(self):
        self.results.vacf_by_particle = np.zeros(
            (self.n_frames, self.n_particles)
        )
        self._velocities = np.zeros(
            (self.n_frames, self.n_particles, self.dim_fac),
            dtype=self._work_dtype,
        )

    def _validate_trajectory(self):
        if not self._trajectory.has_velocities:
            raise NoDataError(
                "VACF computation requires velocities in the trajectory"
            )

    def _process_batch(self, batch):
        if "velocities" not in batch:
            raise NoDataError(
                "VACF computation requires velocities in the trajectory"
            )
        from .base import source_cast

        v = batch["velocities"][:, self.atomgroup.indices]
        # f32 decoder output stays f32 under a float64 work dtype —
        # the conclude kernel upcasts it on the device via
        # ops.acf_fft_from_f32 (see base.source_cast)
        self._velocities = source_cast(v, self._work_dtype)[
            :, :, self._dim
        ]

    def _process_block(self, batch, offset):
        """Frame-blocked feed (``frame_block=`` ctor kwarg): blocks
        stream host→device so the full (N, P, d) selection only ever
        exists on device (models/base.py DeviceSeriesBuffer)."""
        if "velocities" not in batch:
            raise NoDataError(
                "VACF computation requires velocities in the trajectory"
            )
        from .base import DeviceSeriesBuffer, source_cast

        block = source_cast(
            batch["velocities"][:, self.atomgroup.indices],
            self._work_dtype,
        )[:, :, self._dim]
        if offset == 0:
            # device buffer dtype follows the first block: f32 under a
            # float64 work dtype (f32-exact source mode)
            self._vel_buf = DeviceSeriesBuffer(
                (self.n_frames, len(self.atomgroup), len(self._dim)),
                block.dtype,
            )
        self._vel_buf.write(block, offset)
        self._velocities = self._vel_buf.array()

    def _single_frame(self):
        if not self._ts.has_velocities:
            raise NoDataError(
                "VACF computation requires velocities in the trajectory"
            )
        self._velocities[self._frame_index] = self.atomgroup.velocities[
            :, self._dim
        ]

    def _conclude(self):
        self.n_lags = (
            self.n_frames
            if self.max_lag is None
            else min(self.max_lag, self.n_frames)
        )
        f32_src = (
            np.dtype(self._velocities.dtype) == np.float32
            and self._work_dtype == np.float64
        )
        if self.fft:
            if f32_src:
                def kernel(v):
                    return ops.acf_fft_from_f32(v)[: self.n_lags]
            else:
                def kernel(v):
                    return ops.acf_fft(v)[: self.n_lags]
        elif f32_src:
            def kernel(v):
                # exact windowed path needs the f64 operand; upcast
                # on DEVICE (exact) so the transfer stays 4-byte
                import jax.numpy as jnp

                return ops.acf_windowed(
                    jnp.asarray(v).astype(jnp.float64),
                    max_lag=self.n_lags,
                )
        else:
            def kernel(v):
                return ops.acf_windowed(v, max_lag=self.n_lags)
        if self.atom_chunk:
            from ..parallel.streaming import chunked_per_particle

            timeseries, by_particle = chunked_per_particle(
                kernel,
                np.asarray(self._velocities),
                self.atom_chunk,
                checkpoint=self.checkpoint,
            )
            self.results.vacf_by_particle = by_particle
            self.results.timeseries = timeseries
        else:
            # slice away any particle padding added for even sharding
            by_particle = map_particles(kernel, self._velocities)[
                :, : self.n_particles]
            self.results.vacf_by_particle = np.asarray(by_particle)
            self.results.timeseries = np.asarray(by_particle.mean(axis=1))
        self._run_called = True

    # --- derived quantities ---------------------------------------------------
    def _require_run(self, what="plotting"):
        if not self._run_called:
            raise RuntimeError(f"Analysis must be run prior to {what}")

    def self_diffusivity_gk(self, start: int = 0, stop: int = 0,
                            step: int = 1):
        """Green–Kubo self-diffusivity D = ∫C(t)dt / d via the trapezoid
        rule (reference velocityautocorr.py:287-322)."""
        self._require_run("computing self-diffusivity")
        stop = self.n_lags if stop == 0 else min(stop, self.n_lags)
        return float(
            ops.trapezoid(
                self.results.timeseries[start:stop:step],
                self.times[: self.n_lags][start:stop:step],
            )
        ) / self.dim_fac

    def self_diffusivity_gk_odd(self, start: int = 0, stop: int = 0,
                                step: int = 1):
        """Green–Kubo self-diffusivity via Simpson's rule; recommended
        for an odd number of evenly spaced points (reference
        velocityautocorr.py:324-360)."""
        self._require_run("computing self-diffusivity")
        stop = self.n_lags if stop == 0 else min(stop, self.n_lags)
        return float(
            ops.simpson(
                self.results.timeseries[start:stop:step],
                self.times[: self.n_lags][start:stop:step],
            )
        ) / self.dim_fac

    # --- plotting -------------------------------------------------------------
    def plot_vacf(
        self,
        start: int = 0,
        stop: int = 0,
        step: int = 1,
        xlabel: str = "Time (ps)",
        ylabel: str = "Velocity Autocorrelation Function (Å^2 / ps^2)",
    ):
        """VACF vs time plot; returns the matplotlib ``Line2D`` list
        (reference velocityautocorr.py:240-285)."""
        import matplotlib.pyplot as plt

        self._require_run("plotting")
        stop = self.n_lags if stop == 0 else min(stop, self.n_lags)
        fig, ax_vacf = plt.subplots()
        ax_vacf.set_xlabel(xlabel)
        ax_vacf.set_ylabel(ylabel)
        return ax_vacf.plot(
            self.times[: self.n_lags][start:stop:step],
            self.results.timeseries[start:stop:step],
        )

    def plot_running_integral(
        self,
        start: int = 0,
        stop: int = 0,
        step: int = 1,
        initial: float = 0,
        xlabel: str = "Time (ps)",
        ylabel: str = "Running Integral of the VACF (Å^2 / ps)",
    ):
        """Running integral ∫C(t)dt / d vs time (reference
        velocityautocorr.py:362-422)."""
        import matplotlib.pyplot as plt

        self._require_run("plotting")
        stop = self.n_lags if stop == 0 else min(stop, self.n_lags)
        times = self.times[: self.n_lags]
        running_integral = (
            np.asarray(
                ops.cumulative_trapezoid(
                    self.results.timeseries[start:stop:step],
                    times[start:stop:step],
                    initial=initial,
                )
            )
            / self.dim_fac
        )
        fig, ax = plt.subplots()
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        return ax.plot(times[start:stop:step], running_integral)
