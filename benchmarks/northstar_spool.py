"""File-based north-star rehearsal: TRR on disk → C++ decode →
atom-chunk spools → FFT correlation on the GPU → VACF timeseries.

This is the real end-to-end pipeline (no device-side synthesis):
everything `vacf_out_of_core` does, at the largest slice the local
disk affords, with per-stage walls. Complements benchmarks/
northstar.py, which isolates the device correlation rate. Exits
non-zero without a GPU.

Usage:
  python benchmarks/northstar_spool.py --frames 16384 --atoms 4096
  # disk use ≈ frames × atoms × 12 B (TRR, velocities only is not a
  # TRR option — positions ride along) ≈ 2 × that for spools
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import transport_analysis_tpu  # noqa: E402,F401
from transport_analysis_tpu.utils.runtime import (  # noqa: E402
    enable_compile_cache, require_gpu,
)


def write_trajectory(path, n_frames, n_atoms, block=256):
    """Random-walk TRR with velocities, written in frame blocks."""
    from transport_analysis_tpu.io.trr import TRRWriter

    rng = np.random.Generator(np.random.PCG64(7))
    dims = [40.0, 40.0, 40.0, 90.0, 90.0, 90.0]
    pos = rng.uniform(0, 40, (n_atoms, 3)).astype(np.float32)
    with TRRWriter(path, n_atoms=n_atoms) as w:
        for i in range(n_frames):
            vel = rng.normal(0, 10, (n_atoms, 3)).astype(np.float32)
            w.write(positions=pos, velocities=vel, dimensions=dims,
                    time=0.002 * i, step=i)
            pos += vel * np.float32(0.002)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--atoms", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--keep-dir", default=None,
                    help="reuse/keep the data dir (default: temp)")
    args = ap.parse_args()
    device = require_gpu()
    enable_compile_cache()

    workdir = args.keep_dir or tempfile.mkdtemp(prefix="nsspool_")
    os.makedirs(workdir, exist_ok=True)
    trr = os.path.join(workdir, "traj.trr")

    t0 = time.perf_counter()
    if not os.path.exists(trr):
        write_trajectory(trr, args.frames, args.atoms)
    t_write = time.perf_counter() - t0
    size_gb = os.path.getsize(trr) / 1e9

    # minimal topology: Universe over the TRR alone
    from transport_analysis_tpu.parallel.out_of_core import (
        build_spools, correlate_spools,
    )
    from transport_analysis_tpu import ops
    from transport_analysis_tpu.io.trr import TRRReader

    reader = TRRReader(trr)
    frames = np.arange(args.frames)
    spool_dir = os.path.join(workdir, "spools")

    t0 = time.perf_counter()
    paths = build_spools(
        reader, frames, np.arange(args.atoms), [0, 1, 2], spool_dir,
        args.chunk, field="velocities",
    )
    t_spool = time.perf_counter() - t0

    def kernel(block):
        # f32 ships (half the feed bytes), upcast on device;
        # particle-sum on the device so the readback is (L,), not the
        # (L, chunk) per-atom curves
        return ops.acf_fft_from_f32(block).sum(axis=1)

    t0 = time.perf_counter()
    stats = {}
    ts = correlate_spools(kernel, paths, args.atoms, stats=stats)
    t_corr = time.perf_counter() - t0

    # oracle on a small sub-block
    ref_block = np.load(paths[0], mmap_mode="r")[:, :16]
    ref = ops.acf.acf_fft_numpy(
        np.asarray(ref_block, np.float64)).mean(axis=1)
    got = np.asarray(
        ops.acf_fft(np.asarray(ref_block, np.float64))).mean(axis=1)
    rel = float(np.max(np.abs(got - ref)) / np.abs(ref).max())

    lags = args.frames * (args.frames + 1) // 2 * args.atoms
    print(json.dumps({
        "metric": (
            f"spool pipeline VACF (N={args.frames}, P={args.atoms}, "
            f"chunk={args.chunk}, f64, file={size_gb:.2f} GB)"),
        "value": lags / t_corr, "unit": "atom-frame-lags/s",
        "stages_s": {
            "write_fixture": round(t_write, 1),
            "decode_to_spools": round(t_spool, 1),
            "correlate": round(t_corr, 1),
        },
        "decode_mb_s": round(size_gb * 1e3 / t_spool, 1),
        "chunk_vacf_rel_err_vs_host": rel,
        "timeseries_lag0": float(ts[0]),
        "device": device,
        # real-pipeline prefetch overlap: per-chunk
        # disk-read walls vs consumer stalls. The first chunk's read
        # cannot hide (nothing computes yet); steady-state overlap =
        # 1 - stall/read over the remaining chunks.
        "prefetch": {
            "read_s": [round(v, 2) for v in stats.get("read_s", [])],
            "stall_s": [round(v, 2) for v in stats.get("stall_s", [])],
            "kernel_s": [round(v, 2) for v in stats.get("kernel_s", [])],
            # null when there is no steady state to speak of (prefetch
            # off, or a single-chunk run) — sum([])/eps would otherwise
            # report a fictitious perfect 1.0 (round-4 advisor finding)
            "steady_overlap_frac": (
                round(
                    1.0 - sum(stats["stall_s"][1:])
                    / max(sum(stats["read_s"][1:]), 1e-9), 3)
                if len(stats.get("read_s", [])) >= 2
                and len(stats.get("stall_s", [])) >= 2 else None),
        },
    }))
    if not args.keep_dir:
        shutil.rmtree(workdir)


if __name__ == "__main__":
    main()
