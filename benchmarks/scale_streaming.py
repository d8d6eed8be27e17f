"""Scale demonstration: atom-chunked streaming VACF+Helfand toward the
100k-atom × 1M-frame north star (BASELINE.json).

Streams (frames, chunk, 3) blocks host→device, runs the fused f64
correlation kernels per chunk, and accumulates the particle mean —
device memory bounded by the chunk size regardless of total atoms.
Prints one JSON line per configuration. Exits non-zero without a GPU.

Usage: python benchmarks/scale_streaming.py [--frames N] [--atoms P]
       [--chunk C] [--dtype float32|float64]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import transport_analysis_tpu  # noqa: E402,F401
from transport_analysis_tpu import ops  # noqa: E402
from transport_analysis_tpu.parallel.streaming import (  # noqa: E402
    chunked_per_particle,
)
from transport_analysis_tpu.utils.runtime import (  # noqa: E402
    enable_compile_cache, require_gpu,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--atoms", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--dtype", default="float64")
    args = ap.parse_args()
    device = require_gpu()
    enable_compile_cache()

    dtype = np.dtype(args.dtype)
    rng = np.random.RandomState(0)
    vel = rng.normal(0, 5, (args.frames, args.atoms, 3)).astype(dtype)

    def kernel(chunk):
        return ops.acf_fft(chunk)

    # warm compile on one chunk
    _ = np.asarray(kernel(vel[:, : args.chunk]))

    t0 = time.perf_counter()
    timeseries, _ = chunked_per_particle(
        kernel, vel, args.chunk, want_by_particle=False
    )
    wall = time.perf_counter() - t0

    lag_work = (args.frames * (args.frames + 1) // 2) * args.atoms
    print(
        json.dumps(
            {
                "config": f"N={args.frames},P={args.atoms},"
                          f"chunk={args.chunk},{dtype.name}",
                "wall_s": round(wall, 3),
                "atom_frames_per_s": args.frames * args.atoms / wall,
                "effective_atom_frame_lags_per_s": lag_work / wall,
                "device": device,
                "vacf_lag0": float(timeseries[0]),
            }
        )
    )


if __name__ == "__main__":
    main()
