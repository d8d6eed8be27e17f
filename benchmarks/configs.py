"""Per-config benchmarks for BASELINE.json configurations 1-4 on one GPU.

Prints one JSON line per config, each naming its device. Each config
is one jitted function of the public ops, timed as the median wall of
REPS calls that end in ``block_until_ready``, after a compiling call.
Config #5 (streaming at scale) lives in benchmarks/northstar.py.

Usage: python benchmarks/configs.py [--quick]
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import transport_analysis_tpu  # noqa: E402,F401
from transport_analysis_tpu import ops  # noqa: E402
from transport_analysis_tpu.utils.runtime import (  # noqa: E402
    enable_compile_cache, require_gpu,
)

REPS = 4


def timed(fn, *args):
    """Median wall of the jitted ``fn`` over REPS blocked calls."""
    f = jax.jit(fn)
    out = jax.block_until_ready(f(*args))
    assert np.all(np.isfinite(np.asarray(out)))
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def lags_full(n, p):
    return n * (n + 1) // 2 * p


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    device = require_gpu()
    enable_compile_cache()

    rng = np.random.RandomState(0)
    results = []

    # 1: windowed (exact) VACF — O(N²·P·d) on device
    n, p = (1024, 64) if args.quick else (4096, 128)
    vel = jnp.asarray(rng.normal(0, 5, (n, p, 3)))
    w = timed(lambda v: ops.acf_windowed(v), vel)
    results.append({
        "config": f"1 VACF windowed exact (N={n}, P={p}, f64)",
        "value": lags_full(n, p) / w, "unit": "atom-frame-lags/s",
        "wall_s": w,
    })

    n, p = (2048, 128) if args.quick else (8192, 512)
    vel = jnp.asarray(rng.normal(0, 5, (n, p, 3)))
    times = jnp.arange(n, dtype=jnp.float64) * 0.002

    # 2: VACF FFT + Green-Kubo diffusivity
    def vacf_gk(v):
        ts = ops.acf_fft(v).mean(axis=1)
        return ts + ops.trapezoid(ts, times) / 3.0

    w = timed(vacf_gk, vel)
    results.append({
        "config": f"2 VACF FFT + GK diffusivity (N={n}, P={p}, f64)",
        "value": lags_full(n, p) / w, "unit": "atom-frame-lags/s",
        "wall_s": w,
    })

    # 3: Helfand viscosity function
    pos = jnp.asarray(
        np.cumsum(np.asarray(vel), axis=0) * 0.002
        + rng.uniform(0, 20, (1, p, 3))
    )
    masses = jnp.asarray(rng.uniform(1, 16, p))

    def helfand(v, x):
        accum = masses[None, :, None] * v * x
        return ops.einstein_difference_fft(accum, "mean").mean(axis=1)

    w = timed(helfand, vel, pos)
    results.append({
        "config": f"3 Helfand viscosity function (N={n}, P={p}, f64)",
        "value": lags_full(n, p) / w, "unit": "atom-frame-lags/s",
        "wall_s": w,
    })

    # 4: Einstein MSD via FFT
    w = timed(lambda x: ops.msd_fft(x).mean(axis=1), pos)
    results.append({
        "config": f"4 Einstein MSD FFT (N={n}, P={p}, f64)",
        "value": lags_full(n, p) / w, "unit": "atom-frame-lags/s",
        "wall_s": w,
    })

    for r in results:
        r["device"] = device
        print(json.dumps(r))


if __name__ == "__main__":
    main()
