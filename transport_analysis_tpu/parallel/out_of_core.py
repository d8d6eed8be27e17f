"""Out-of-core correlation for trajectories larger than host RAM.

The dense (frames, atoms, 3) float64 block the reference materializes
(SURVEY.md §5) is impossible at 100k atoms × 1M frames (~2.4 TB). This
pipeline makes it a two-pass streaming problem:

pass 1 — decode: frame blocks stream through the prefetch pipeline
  (background-thread C++ decode) and are scattered into per-atom-chunk
  *spool* files on disk, each shaped (n_frames, chunk, d) float32 —
  i.e. a blocked on-disk transpose from frame-major to chunk-major.

pass 2 — correlate: each spool memmaps in, ships to the device, runs
  the batched correlation kernel, and accumulates into the particle
  mean. Device and host memory stay bounded by the chunk size.

Every chunk completion is checkpointable (parallel/streaming.py), so a
multi-hour run resumes mid-stream.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..io.prefetch import prefetch_batches


def build_spools(
    reader,
    frames: Sequence[int],
    atom_indices: np.ndarray,
    dim: Sequence[int],
    spool_dir: str,
    atom_chunk: int,
    field: str = "velocities",
    frame_block: int = 1024,
    transform=None,
    aux: Sequence[str] = (),
) -> list[str]:
    """Pass 1: stream-decode ``frames`` and scatter into spool files.

    ``field`` names the spools; by default it is also the batch key to
    spool. ``transform(batch) → (nb, n_selected_atoms, d)`` overrides
    the per-block extraction — this is how derived accumulators (the
    Helfand m·v·x) spool without materializing their factors twice.
    ``aux`` lists per-frame scalar batch keys (e.g. ``volumes``) to
    collect across the whole pass; they are persisted next to the
    spools (``{field}_aux.npz``, see :func:`load_aux`) so resumed runs
    skip the decode entirely.

    Returns the spool paths (one per atom chunk). Existing complete
    spools are reused (resume support).
    """
    os.makedirs(spool_dir, exist_ok=True)
    n_frames = len(frames)
    atom_indices = np.asarray(atom_indices)
    n_atoms = len(atom_indices)
    d = len(dim)
    n_chunks = -(-n_atoms // atom_chunk)

    if transform is None:
        def transform(batch):  # noqa: F811 — default extraction
            return batch[field][:, atom_indices][:, :, dim]

    paths = [
        os.path.join(spool_dir, f"{field}_chunk{c:05d}.f32")
        for c in range(n_chunks)
    ]
    marker = os.path.join(spool_dir, f"{field}.complete")
    if os.path.exists(marker):
        return paths

    mmaps = []
    for c, path in enumerate(paths):
        width = min(atom_chunk, n_atoms - c * atom_chunk)
        mmaps.append(
            np.lib.format.open_memmap(
                path,
                mode="w+",
                dtype=np.float32,
                shape=(n_frames, width, d),
            )
        )

    aux_acc: dict[str, list] = {k: [] for k in aux}
    row = 0
    for batch in prefetch_batches(reader, frames,
                                  block_size=frame_block):
        data = np.asarray(transform(batch))
        nb = data.shape[0]
        for c, mm in enumerate(mmaps):
            lo = c * atom_chunk
            hi = min(lo + atom_chunk, n_atoms)
            mm[row:row + nb] = data[:, lo:hi]
        for k in aux:
            aux_acc[k].append(np.asarray(batch[k]))
        row += nb
    for mm in mmaps:
        mm.flush()
    del mmaps
    if aux:
        np.savez(
            os.path.join(spool_dir, f"{field}_aux.npz"),
            **{k: np.concatenate(v) for k, v in aux_acc.items()},
        )
    with open(marker, "w") as fh:
        fh.write("ok\n")
    return paths


def load_aux(spool_dir: str, field: str) -> dict:
    """Per-frame scalars collected during :func:`build_spools` pass 1."""
    with np.load(os.path.join(spool_dir, f"{field}_aux.npz")) as z:
        return {k: z[k] for k in z.files}


def correlate_spools(
    kernel,
    paths: Sequence[str],
    n_particles: int,
    checkpoint: Optional[str] = None,
    prefetch: bool = True,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Pass 2: run ``kernel((N, chunk, d)) → (L,) or (L, chunk)``
    over each spool and return the particle-mean timeseries (L,).

    Kernels SHOULD particle-sum on device and return (L,): the
    per-atom curves are never used here, and reading them back costs
    L×chunk×8 B per chunk (~0.8 GB at the N=2^20 rung — ~840 GB
    over the full north-star atom stream) versus L×8 B (~8 MB) for
    the summed series. A 2-D (L, chunk) result is still accepted and
    summed on host (back-compat for custom kernels).

    ``prefetch`` reads spool c+1 on a background thread while the
    device correlates chunk c — the sequential disk read rides inside
    the chunk wall instead of after it (steady-state feed of the
    north-star plan; host RAM holds at most two chunks).

    ``stats``: pass a dict to receive per-chunk walls:
    ``read_s`` (disk read per spool, on the reader thread),
    ``stall_s`` (time the consumer waited for its block — the part of
    the read NOT hidden under compute), ``kernel_s`` (device
    correlate+readback per chunk). With prefetch, feed-overlap
    fraction = 1 - sum(stall)/sum(read) (first chunk's read is
    unhideable and excluded from the overlap accounting)."""
    import time as _time

    acc = None
    start = 0
    if checkpoint and os.path.exists(checkpoint):
        state = np.load(checkpoint)
        if int(state["n_particles"]) == n_particles:
            acc = state["acc"]
            start = int(state["next_spool"])

    read_s: list = []
    stall_s: list = []
    kernel_s: list = []

    def _read(c):
        # full sequential read (NOT mmap page faults mid-kernel): the
        # block is handed to the device feed as one contiguous buffer
        t0 = _time.perf_counter()
        with open(paths[c], "rb") as fh:
            out = np.lib.format.read_array(fh)
        read_s.append(_time.perf_counter() - t0)
        return out

    todo = range(start, len(paths))
    if prefetch and len(todo) > 1:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=1)

        def loop():
            for c in todo:
                q.put(_read(c))

        threading.Thread(target=loop, daemon=True).start()

        def _get():
            t0 = _time.perf_counter()
            out = q.get()
            stall_s.append(_time.perf_counter() - t0)
            return out

        blocks = (_get() for _ in todo)
    else:
        blocks = (_read(c) for c in todo)

    for c, block in zip(todo, blocks):
        t0 = _time.perf_counter()
        result = np.asarray(kernel(block))
        kernel_s.append(_time.perf_counter() - t0)
        del block
        if acc is None:
            acc = np.zeros(result.shape[0], np.float64)
        acc += result if result.ndim == 1 else result.sum(axis=1)
        if checkpoint:
            tmp = checkpoint + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, acc=acc, next_spool=c + 1,
                         n_particles=n_particles)
            os.replace(tmp, checkpoint)
    if stats is not None:
        stats["read_s"] = read_s
        stats["stall_s"] = stall_s
        stats["kernel_s"] = kernel_s
    return acc / max(n_particles, 1)


def _auto_chunk(atom_chunk, n_frames: int, d: int) -> int:
    """Resolve atom_chunk="auto" via ops.acf.auto_atom_chunk (the
    device-memory model of one float32 spool block's FFT pass); integer
    values pass through unchanged."""
    if atom_chunk == "auto":
        from ..ops.acf import auto_atom_chunk

        return auto_atom_chunk(n_frames, d=d, dtype=np.float32)
    return int(atom_chunk)


def _resolve(universe_or_ag, start, stop, step):
    from ..core.groups import AtomGroup

    ag = (
        universe_or_ag
        if isinstance(universe_or_ag, AtomGroup)
        else universe_or_ag.atoms
    )
    reader = ag.universe.trajectory
    s, e, st = reader.check_slice_indices(start, stop, step)
    return ag, reader, np.arange(s, e, st)


def vacf_out_of_core(
    universe_or_ag,
    spool_dir: str,
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    start=None,
    stop=None,
    step=None,
    max_lag: Optional[int] = None,
    checkpoint: Optional[str] = None,
) -> np.ndarray:
    """End-to-end out-of-core VACF: file → spools → device → timeseries.

    Returns the particle-averaged VACF (max_lag or n_frames long).
    """
    from .. import ops

    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim))
    paths = build_spools(
        reader, frames, ag.indices, list(dim), spool_dir, atom_chunk,
        field="velocities",
    )

    def kernel(block):
        # spool blocks are f32 trajectory samples: they ship as f32
        # and are upcast on the device
        out = ops.acf_fft_from_f32(block)
        if max_lag:
            out = out[:max_lag]
        return out.sum(axis=1)  # particle-sum ON DEVICE: (L,) readback

    return correlate_spools(
        kernel, paths, len(ag), checkpoint=checkpoint
    )


def helfand_out_of_core(
    universe_or_ag,
    spool_dir: str,
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    temp_avg: float = 300.0,
    start=None,
    stop=None,
    step=None,
    max_lag: Optional[int] = None,
    checkpoint: Optional[str] = None,
    linear_fit_window: Optional[tuple] = None,
):
    """Out-of-core Einstein–Helfand viscosity function (and slope).

    Pass 1 spools the *derived accumulator* m·v·x — one float32 stream
    instead of separate velocity/position spools — and collects per-
    frame box volumes; pass 2 runs the FFT lag-difference kernel per
    atom chunk. Mirrors ``ViscosityHelfand`` semantics (mean over
    components, ÷ 2·k_B·⟨V⟩·T, lag-0 row ≡ 0; reference
    viscosity.py:201-245) at trajectories far beyond host RAM.

    Returns ``(timeseries, viscosity_or_None)``.
    """
    from .. import ops
    from ..utils.units import constants

    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim))
    masses = np.asarray(ag.masses, np.float64)
    indices = ag.indices
    dim = list(dim)

    def transform(batch):
        v = batch["velocities"][:, indices][:, :, dim]
        x = batch["positions"][:, indices][:, :, dim]
        return masses[None, :, None] * v.astype(np.float64) * x

    paths = build_spools(
        reader, frames, indices, dim, spool_dir, atom_chunk,
        field="mvx", transform=transform, aux=("volumes", "times"),
    )
    volumes = load_aux(spool_dir, "mvx")["volumes"]
    if np.any(volumes == 0.0):
        from ..utils.errors import NoDataError

        raise NoDataError(
            "viscosity computation requires a nonzero box volume in "
            "every frame (matches ViscosityHelfand's in-memory check)"
        )
    vol_avg = float(np.mean(volumes))

    def kernel(block):
        out = ops.einstein_difference_fft_from_f32(block, "mean")
        if max_lag:
            out = out[:max_lag]
        return out.sum(axis=1)  # particle-sum ON DEVICE: (L,) readback

    raw = correlate_spools(kernel, paths, len(ag), checkpoint=checkpoint)
    k_B = constants["Boltzmann_constant"]
    timeseries = raw / (2.0 * k_B * vol_avg * temp_avg)

    viscosity = None
    if linear_fit_window is not None:
        lo, hi = linear_fit_window
        lagtimes = np.arange(len(timeseries), dtype=np.float64)
        slope, _ = np.polyfit(lagtimes[lo:hi], timeseries[lo:hi], 1)
        viscosity = slope
    return timeseries, viscosity


def msd_out_of_core(
    universe_or_ag,
    spool_dir: str,
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    start=None,
    stop=None,
    step=None,
    max_lag: Optional[int] = None,
    checkpoint: Optional[str] = None,
) -> np.ndarray:
    """Out-of-core Einstein MSD (components summed, matching
    ``EinsteinMSD`` / tidynamics.msd semantics)."""
    from .. import ops

    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim))
    paths = build_spools(
        reader, frames, ag.indices, list(dim), spool_dir, atom_chunk,
        field="positions",
    )

    def kernel(block):
        # msd_fft(r) == einstein_difference_fft(r, "sum"), upcast on
        # the device (see the VACF kernel above)
        out = ops.einstein_difference_fft_from_f32(block, "sum")
        if max_lag:
            out = out[:max_lag]
        return out.sum(axis=1)  # particle-sum ON DEVICE: (L,) readback

    return correlate_spools(
        kernel, paths, len(ag), checkpoint=checkpoint
    )


def vacf_out_of_core_sharded(
    universe_or_ag,
    spool_dir: str,
    mesh,
    axis_name: str = "frames",
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    start=None,
    stop=None,
    step=None,
    checkpoint: Optional[str] = None,
) -> np.ndarray:
    """Out-of-core VACF with the FFT frame axis sharded over a mesh —
    the composition that reaches the 100k×1M north star: atoms stream
    through disk spools (host memory bound), frames shard over chips
    (device memory bound), and each chunk's correlation runs the
    four-step distributed FFT (parallel/sharded_fft.py).

    Per-lag normalization matches ``vacf_out_of_core`` exactly; the
    two agree at f64 rounding (tested on the virtual 8-device mesh).
    """
    from .sharded_fft import sharded_acf_fft

    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim))
    paths = build_spools(
        reader, frames, ag.indices, list(dim), spool_dir, atom_chunk,
        field="velocities",
    )

    def kernel(block):
        out = sharded_acf_fft(
            np.asarray(block, dtype=np.float64), mesh, axis_name
        )
        # particle-sum before readback (elementwise per frame — the
        # frame sharding is preserved; gather is (L,) not (L, chunk))
        return out.sum(axis=1)

    return correlate_spools(
        kernel, paths, len(ag), checkpoint=checkpoint
    )


def helfand_out_of_core_sharded(
    universe_or_ag,
    spool_dir: str,
    mesh,
    axis_name: str = "frames",
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    temp_avg: float = 300.0,
    start=None,
    stop=None,
    step=None,
    checkpoint: Optional[str] = None,
    linear_fit_window: Optional[tuple] = None,
):
    """Out-of-core Einstein–Helfand viscosity with the FFT frame axis
    sharded over a mesh — the second half of the composed north star
    (VACF + Helfand at 100k atoms × 1M frames): the m·v·x accumulator
    spools through disk per atom chunk while each chunk's Einstein
    lag-difference curve runs the distributed four-step FFT
    (parallel/sharded_fft.py ``sharded_msd_fft`` with the Helfand
    component-mean convention).

    Semantics match :func:`helfand_out_of_core` (which matches
    ``ViscosityHelfand``; reference viscosity.py:201-245). Returns
    ``(timeseries, viscosity_or_None)``.
    """
    from .sharded_fft import sharded_msd_fft
    from ..utils.units import constants

    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim))
    masses = np.asarray(ag.masses, np.float64)
    indices = ag.indices
    dim = list(dim)

    def transform(batch):
        v = batch["velocities"][:, indices][:, :, dim]
        x = batch["positions"][:, indices][:, :, dim]
        return masses[None, :, None] * v.astype(np.float64) * x

    paths = build_spools(
        reader, frames, indices, dim, spool_dir, atom_chunk,
        field="mvx", transform=transform, aux=("volumes", "times"),
    )
    volumes = load_aux(spool_dir, "mvx")["volumes"]
    if np.any(volumes == 0.0):
        from ..utils.errors import NoDataError

        raise NoDataError(
            "viscosity computation requires a nonzero box volume in "
            "every frame (matches ViscosityHelfand's in-memory check)"
        )
    vol_avg = float(np.mean(volumes))

    def kernel(block):
        out = sharded_msd_fft(
            np.asarray(block, dtype=np.float64), mesh, axis_name,
            reduce_mode="mean",
        )
        return out.sum(axis=1)

    raw = correlate_spools(kernel, paths, len(ag), checkpoint=checkpoint)
    k_B = constants["Boltzmann_constant"]
    timeseries = raw / (2.0 * k_B * vol_avg * temp_avg)

    viscosity = None
    if linear_fit_window is not None:
        lo, hi = linear_fit_window
        lagtimes = np.arange(len(timeseries), dtype=np.float64)
        slope, _ = np.polyfit(lagtimes[lo:hi], timeseries[lo:hi], 1)
        viscosity = slope
    return timeseries, viscosity
