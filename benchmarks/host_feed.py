"""Standalone host decode + prefetch benchmark (SURVEY §7 hard part c).

Quantifies the feed side of the pipeline independently of the device:

1. TRR batch decode throughput — the multithreaded C++ decoder
   (io/_native/trr_decode.cpp) vs the pure-Python fallback, in MB/s
   (on-disk bytes) and frames/s.
2. Prefetch overlap efficiency — wall time of decode interleaved with
   a simulated device compute vs the serial sum of both
   (io/prefetch.py BatchPrefetcher; 1.0 = perfect overlap).

Prints one JSON line per measurement: what the HOST side sustains, to
check against the device's feed requirement. Needs no accelerator.

Usage: python benchmarks/host_feed.py [--frames N] [--atoms P]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def make_trr(path, n_frames, n_atoms):
    from transport_analysis_tpu.io.trr import TRRWriter

    rng = np.random.RandomState(0)
    dims = [40.0, 40.0, 40.0, 90.0, 90.0, 90.0]
    pos = rng.uniform(0, 40, (n_atoms, 3)).astype(np.float32)
    with TRRWriter(path, n_atoms=n_atoms) as w:
        for i in range(n_frames):
            vel = rng.normal(0, 10, (n_atoms, 3)).astype(np.float32)
            w.write(positions=pos, velocities=vel, dimensions=dims,
                    time=0.5 * i, step=i)
            pos = pos + vel * 0.001
    return os.path.getsize(path)


def bench_decode(path, n_frames, native: bool, reps: int = 3):
    # flip the cached native-library state (io/_native caches the
    # ctypes handle in module globals)
    from transport_analysis_tpu.io import _native
    from transport_analysis_tpu.io.trr import TRRReader

    if native:
        _native._lib_failed = False
        if _native._load_library() is None:
            raise RuntimeError("native TRR decoder unavailable")
    else:
        _native._lib = None
        _native._lib_failed = True
    r = TRRReader(path)
    idx = np.arange(n_frames)
    r.read_frames_batch(idx[:8])  # warm (mmap, lazy native build)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = r.read_frames_batch(idx)
        best = min(best, time.perf_counter() - t0)
    assert out["positions"].shape[0] == n_frames
    return best


def bench_prefetch(path, n_frames, block: int, compute_s: float):
    from transport_analysis_tpu.io.prefetch import (
        iter_frame_blocks, prefetch_batches,
    )
    from transport_analysis_tpu.io.trr import TRRReader

    r = TRRReader(path)
    frames = np.arange(n_frames)
    r.read_frames_batch(frames[:8])

    # serial: decode all blocks, then "compute" per block
    t0 = time.perf_counter()
    n_blocks = 0
    for blk in iter_frame_blocks(frames, block):
        r.read_frames_batch(blk)
        n_blocks += 1
    decode_wall = time.perf_counter() - t0
    serial = decode_wall + n_blocks * compute_s

    t0 = time.perf_counter()
    for batch in prefetch_batches(r, frames, block_size=block):
        time.sleep(compute_s)  # simulated device compute
    overlapped = time.perf_counter() - t0
    lower_bound = max(decode_wall, n_blocks * compute_s)
    eff = (serial - overlapped) / (serial - lower_bound) \
        if serial > lower_bound else 1.0
    return decode_wall, serial, overlapped, min(max(eff, 0.0), 1.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=192)
    ap.add_argument("--atoms", type=int, default=12288)
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "feed.trr")
        nbytes = make_trr(path, args.frames, args.atoms)
        mb = nbytes / 1e6

        for native in (True, False):
            wall = bench_decode(path, args.frames, native)
            print(json.dumps({
                "metric": "trr_decode_" + (
                    "native_cpp" if native else "python"),
                "value": round(mb / wall, 1), "unit": "MB/s",
                "frames_per_s": round(args.frames / wall, 1),
                "file_mb": round(mb, 1), "wall_s": round(wall, 3),
            }))

        block = max(16, args.frames // 8)
        dec, serial, overlapped, eff = bench_prefetch(
            path, args.frames, block, compute_s=0.05)
        print(json.dumps({
            "metric": "prefetch_overlap_efficiency",
            "value": round(eff, 3), "unit": "fraction",
            "decode_wall_s": round(dec, 3),
            "serial_s": round(serial, 3),
            "overlapped_s": round(overlapped, 3),
        }))


if __name__ == "__main__":
    main()
