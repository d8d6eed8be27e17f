"""Einstein mean-squared-displacement (MSD) analysis.

Counterpart of ``MDAnalysis.analysis.msd.EinsteinMSD``, which the
reference consumes as the independent Einstein-relation cross-check on
Green–Kubo diffusivity (reference test_velocityautocorr.py:15,589-597)
and which BASELINE.json lists as a build config. Computes

    MSD(j Δt) = ⟨ |r(iΔt + jΔt) − r(iΔt)|² ⟩_{i, particles}

with either the FFT (Kneller/Calandrini) algorithm — batched over all
particles in one device call — or the exact windowed summation.
"""

from __future__ import annotations

import numpy as np

from ..core.groups import AtomGroup
from ..utils.errors import NoDataError
from .. import ops
from ..parallel.sharding import map_particles
from .base import AnalysisBase
from ._dims import parse_dim_type


class EinsteinMSD(AnalysisBase):
    """MSD via the Einstein relation.

    Parameters
    ----------
    u : Universe or AtomGroup
        Universe (with ``select`` applied) or an AtomGroup directly.
    select : str
        Selection string applied when ``u`` is a Universe. Default "all".
    msd_type : {'xyz', 'xy', 'yz', 'xz', 'x', 'y', 'z'}
        Components included (summed, MSD convention).
    fft : bool
        FFT algorithm (default) vs exact windowed summation.
    """

    def __init__(self, u, select: str = "all", msd_type: str = "xyz",
                 fft: bool = True, max_lag=None, atom_chunk=None,
                 checkpoint=None, dtype=np.float64,
                 **kwargs):
        if isinstance(u, AtomGroup):
            ag = u if select in ("all", None) else u.select_atoms(select)
        else:
            ag = u.select_atoms(select)
        super().__init__(ag.universe.trajectory, **kwargs)
        self.ag = ag
        self.atomgroup = ag
        self.msd_type = msd_type.lower()
        self._dim, self.dim_fac = parse_dim_type(self.msd_type)
        self.fft = fft
        self.max_lag = max_lag
        self.atom_chunk = atom_chunk
        self.checkpoint = checkpoint
        self._work_dtype = np.dtype(dtype)
        self.n_particles = len(ag)
        self._run_called = False

    def _prepare(self):
        self.results.msds_by_particle = np.zeros(
            (self.n_frames, self.n_particles)
        )
        self._positions = np.zeros(
            (self.n_frames, self.n_particles, self.dim_fac),
            dtype=self._work_dtype,
        )

    def _validate_trajectory(self):
        if not self._trajectory.has_positions:
            raise NoDataError("MSD computation requires positions")

    def _process_batch(self, batch):
        if "positions" not in batch:
            raise NoDataError("MSD computation requires positions")
        from .base import source_cast

        # f32 decoder output stays f32 under a float64 work dtype —
        # upcast on the device via einstein_difference_fft_from_f32
        self._positions = source_cast(
            batch["positions"][:, self.ag.indices], self._work_dtype
        )[:, :, self._dim]

    def _process_block(self, batch, offset):
        """Frame-blocked feed: position blocks stream host→device
        (models/base.py DeviceSeriesBuffer)."""
        if "positions" not in batch:
            raise NoDataError("MSD computation requires positions")
        from .base import DeviceSeriesBuffer, source_cast

        block = source_cast(
            batch["positions"][:, self.ag.indices], self._work_dtype
        )[:, :, self._dim]
        if offset == 0:
            self._pos_buf = DeviceSeriesBuffer(
                (self.n_frames, len(self.ag), len(self._dim)),
                block.dtype,
            )
        self._pos_buf.write(block, offset)
        self._positions = self._pos_buf.array()

    def _single_frame(self):
        if not self._ts.has_positions:
            raise NoDataError("MSD computation requires positions")
        self._positions[self._frame_index] = self.ag.positions[:, self._dim]

    def _conclude(self):
        self.n_lags = (
            self.n_frames
            if self.max_lag is None
            else min(self.max_lag, self.n_frames)
        )

        f32_src = (
            np.dtype(self._positions.dtype) == np.float32
            and self._work_dtype == np.float64
        )

        def kernel(p):
            if self.fft:
                if f32_src:
                    return ops.einstein_difference_fft_from_f32(
                        p, reduce_mode="sum"
                    )[: self.n_lags]
                return ops.einstein_difference_fft(
                    p, reduce_mode="sum"
                )[: self.n_lags]
            if f32_src:
                # exact windowed path: upcast on DEVICE (exact)
                import jax.numpy as jnp

                p = jnp.asarray(p).astype(jnp.float64)
            return ops.einstein_difference_windowed(
                p, reduce_mode="sum", max_lag=self.n_lags
            )

        if self.atom_chunk:
            from ..parallel.streaming import chunked_per_particle

            _, by_particle = chunked_per_particle(
                kernel,
                np.asarray(self._positions),
                self.atom_chunk,
                checkpoint=self.checkpoint,
            )
        else:
            by_particle = map_particles(kernel, self._positions)[
                :, : self.n_particles]
        self.results.msds_by_particle = np.asarray(by_particle)
        self.results.timeseries = np.asarray(by_particle.mean(axis=1))
        self._run_called = True
