"""Analysis runtime: the engine that drives trajectory analyses.

Re-provides the ``MDAnalysis.analysis.base.AnalysisBase`` template-method
contract the reference plugs into (SURVEY.md §1 L2): ``run(start, stop,
step, frames, verbose)`` drives ``_prepare()`` → per-frame work →
``_conclude()``, exposing ``n_frames``, ``times``, ``frames``,
``_frame_index``, ``_ts`` and a dict-like ``results``.

Batch-first redesign: instead of the reference's serial per-frame Python
loop (its hot loop #1), subclasses that implement ``_process_batch``
receive the *entire* strided frame selection as stacked arrays in one
``read_frames_batch`` call and ship it to the device as a single block.
The per-frame ``_single_frame`` hook remains fully supported — both for
user subclasses written against the MDAnalysis API and as an explicit
``engine="frame"`` parity mode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def source_cast(arr, work_dtype) -> np.ndarray:
    """f32-exact source handling for model feed buffers.

    Trajectory decoders serve float32 samples (core/trajectory.py
    ``read_frames_batch``; every binary MD format stores f32). Those
    values are exactly representable in float64, so a float64-grade
    analysis does not require an 8-byte host buffer: keep the block
    f32 and let the ops layer consume it through the ``*_from_f32``
    entries (ops/acf.py ``acf_fft_from_f32``), which upcast inside the
    device program — half the host RAM and half the host→device
    transfer.

    Returns ``arr`` unchanged when the work dtype is float64 and the
    source is float32; otherwise casts to the work dtype. Set
    ``TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE=1`` to force the eager
    host upcast (bit-identical results).
    """
    import os

    arr = np.asarray(arr)
    work_dtype = np.dtype(work_dtype)
    if (
        work_dtype == np.float64
        and arr.dtype == np.float32
        and not os.environ.get("TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE")
    ):
        return arr
    return arr if arr.dtype == work_dtype else arr.astype(work_dtype)


class Results(dict):
    """dict with attribute access (MDAnalysis ``Results`` parity;
    consumed by the reference at velocityautocorr.py:121-125)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as err:
            raise AttributeError(
                f"'Results' object has no attribute '{key}'"
            ) from err

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as err:
            raise AttributeError(
                f"'Results' object has no attribute '{key}'"
            ) from err


class DeviceSeriesBuffer:
    """Assembles a (n_frames, …) series on the DEVICE from host frame
    blocks: the host holds one decoded block at a time while the full
    selection accumulates on the device (donated ``dynamic_update_slice``, so
    each write reuses the buffer's memory instead of copying it).

    This is the frame-blocked feed for the batch engine — without it,
    ``read_frames_batch`` materializes the entire (N, P, d) selection
    in host RAM before the first device op, which contradicts the
    streaming design at north-star sizes (SURVEY.md §7 L2).
    """

    def __init__(self, shape, dtype):
        import jax.numpy as jnp

        self._buf = jnp.zeros(shape, dtype)

    @staticmethod
    def _writer():
        import jax

        if DeviceSeriesBuffer._write_fn is None:
            def write(buf, block, offset):
                idx = (offset,) + (0,) * (buf.ndim - 1)
                return jax.lax.dynamic_update_slice(buf, block, idx)

            DeviceSeriesBuffer._write_fn = jax.jit(
                write, donate_argnums=0
            )
        return DeviceSeriesBuffer._write_fn

    _write_fn = None

    def write(self, block, offset: int):
        import jax.numpy as jnp

        block = jnp.asarray(block, dtype=self._buf.dtype)
        self._buf = self._writer()(self._buf, block, offset)

    def array(self):
        return self._buf


class AnalysisBase:
    def __init__(self, trajectory, verbose: bool = False, engine=None,
                 frame_block: Optional[int] = None, **kwargs):
        self._trajectory = trajectory
        self._verbose = verbose
        if engine not in (None, "batch", "frame"):
            raise ValueError("engine must be 'batch' or 'frame'")
        self._engine = engine
        if frame_block is not None and frame_block < 1:
            raise ValueError("frame_block must be a positive int")
        self._frame_block = frame_block
        self.results = Results()

    # --- frame bookkeeping ----------------------------------------------------
    def _setup_frames(
        self, trajectory, start=None, stop=None, step=None, frames=None
    ):
        if frames is not None:
            if not (start is None and stop is None and step is None):
                raise ValueError(
                    "start/stop/step cannot be combined with frames"
                )
            frames = np.asarray(frames)
            if frames.dtype == bool:
                frames = np.flatnonzero(frames)
            frame_indices = frames.astype(np.int64)
            self.start = self.stop = self.step = None
        else:
            start, stop, step = trajectory.check_slice_indices(
                start, stop, step
            )
            self.start, self.stop, self.step = start, stop, step
            frame_indices = np.arange(start, stop, step, dtype=np.int64)
        self.frames = frame_indices
        self.n_frames = len(frame_indices)
        self.times = np.zeros(self.n_frames, dtype=np.float64)

    # --- subclass hooks ---------------------------------------------------------
    def _prepare(self):
        pass

    def _single_frame(self):  # pragma: no cover - overridden
        raise NotImplementedError(
            "analysis subclasses must implement _single_frame "
            "or _process_batch"
        )

    def _validate_trajectory(self):
        """Batch-engine hook: raise (e.g. NoDataError) if the trajectory
        lacks required per-frame data. Called before any frame is read."""

    def _conclude(self):
        pass

    # --- results persistence ---------------------------------------------------
    def save(self, path) -> None:
        """Persist ``results`` plus run metadata (times, frames,
        analysis class) to a single ``.npz``. The reference leaves
        persistence to the user (SURVEY.md §5 'checkpoint/resume:
        none'); long streamed runs deserve a one-liner."""
        if not self.results:
            raise RuntimeError(
                "nothing to save — call run() before save()"
            )
        payload = {}
        for key, value in self.results.items():
            if value is None:
                continue
            payload[f"results/{key}"] = np.asarray(value)
        payload["meta/class"] = np.asarray(type(self).__name__)
        payload["meta/times"] = np.asarray(self.times)
        payload["meta/frames"] = np.asarray(self.frames)
        np.savez(path, **payload)

    @staticmethod
    def load_results(path):
        """Load an ``.npz`` written by :meth:`save` →
        ``(Results, meta_dict)``; scalar results come back as Python
        floats."""
        results = Results()
        meta = {}
        with np.load(path, allow_pickle=False) as z:
            for key in z.files:
                kind, _, name = key.partition("/")
                value = z[key]
                if kind == "results":
                    results[name] = (
                        float(value) if value.ndim == 0 else value
                    )
                else:
                    meta[name] = (
                        str(value) if value.dtype.kind in "US"
                        else value
                    )
        return results, meta

    # --- driver --------------------------------------------------------------------
    def run(
        self,
        start: Optional[int] = None,
        stop: Optional[int] = None,
        step: Optional[int] = None,
        frames=None,
        verbose: Optional[bool] = None,
    ):
        from ..utils.profiling import StageTimer

        self.timing = StageTimer()
        self._setup_frames(
            self._trajectory, start=start, stop=stop, step=step, frames=frames
        )
        self._prepare()
        use_batch = (
            hasattr(self, "_process_batch") and self._engine != "frame"
        )
        use_stream = (
            use_batch
            and self._frame_block is not None
            and hasattr(self, "_process_block")
        )
        show_progress = verbose if verbose is not None else self._verbose
        if use_stream:
            self._validate_trajectory()
            with self.timing.stage("io"):
                from ..io.prefetch import prefetch_batches
                from ..utils.progress import progress_bar

                times = []
                offset = 0
                blocks = prefetch_batches(
                    self._trajectory, self.frames,
                    block_size=self._frame_block,
                )
                bar = progress_bar(
                    total=len(self.frames),
                    desc=type(self).__name__,
                    disable=not show_progress,
                )
                for block in blocks:
                    times.append(np.asarray(block["times"]))
                    self._process_block(block, offset)
                    offset += len(block["times"])
                    bar.update(len(block["times"]))
                bar.close()
                self.times = np.concatenate(times).astype(np.float64)
        elif use_batch:
            self._validate_trajectory()
            with self.timing.stage("io"):
                batch = self._trajectory.read_frames_batch(self.frames)
                self.times = np.asarray(batch["times"], dtype=np.float64)
                self._process_batch(batch)
        else:
            with self.timing.stage("io"):
                from ..utils.progress import progress_bar

                bar = progress_bar(
                    total=self.n_frames,
                    desc=type(self).__name__,
                    disable=not show_progress,
                )
                for i, frame_index in enumerate(self.frames):
                    ts = self._trajectory[int(frame_index)]
                    self._frame_index = i
                    self._ts = ts
                    self.times[i] = ts.time
                    self._single_frame()
                    bar.update(1)
                bar.close()
        with self.timing.stage("compute"):
            self._conclude()
        self.timing.counters(
            n_frames=self.n_frames,
            n_particles=getattr(self, "n_particles", 0),
        )
        return self
