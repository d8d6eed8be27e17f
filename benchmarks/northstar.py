"""North-star-shaped run: 100k atoms × 32k frames, VACF + Helfand,
streamed through one GPU in atom chunks (BASELINE.json's north star is
100k atoms × 1M frames).

Two feed modes:

--feed device (default): each atom chunk is synthesized ON DEVICE (jax
  PRNG + cumsum inside the jitted step, keyed per chunk), so the run
  measures the correlation rate the card sustains when the feed keeps
  up.

--feed host: chunks are generated on the host and shipped with
  device_put, the shape of the real file-streaming path.

Per chunk (``--chunk`` atoms × all frames, default from
ops.acf.auto_atom_chunk): f64 VACF (FFT autocorrelation) + Helfand
lag-difference curve through the public ops, both particle-summed on
the device → two (frames,) readbacks, which also end the chunk's wall.
Effective atom-frame-lags/s uses the reference's windowed work units:
2 analyses × N(N+1)/2 lags × P. Exits non-zero without a GPU.

Usage:
  python benchmarks/northstar.py                      # 100352 × 32768
  python benchmarks/northstar.py --feed host --atoms 16384 --frames 8192
"""

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import transport_analysis_tpu  # noqa: E402,F401
from transport_analysis_tpu import ops  # noqa: E402
from transport_analysis_tpu.ops.acf import (  # noqa: E402
    acf_fft_numpy, auto_atom_chunk,
)
from transport_analysis_tpu.utils.runtime import (  # noqa: E402
    enable_compile_cache, require_gpu,
)
from transport_analysis_tpu.utils.units import constants  # noqa: E402

KB = constants["Boltzmann_constant"]
TEMP = 300.0
VOL = 8000.0


@jax.jit
def _analyze(vel, pos, masses):
    """Per-chunk particle sums of the VACF and the Helfand curve."""
    vacf_sum = ops.acf_fft(vel).sum(axis=1)
    accum = masses[None, :, None] * vel * pos
    helf_sum = ops.einstein_difference_fft(accum, "mean").sum(axis=1)
    return vacf_sum, helf_sum


def _host_chunk(n_frames, chunk, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    vel = rng.standard_normal(
        (n_frames, chunk, 3), dtype=np.float32
    ) * np.float32(5.0)
    pos = (
        np.cumsum(vel, axis=0, dtype=np.float32) * np.float32(0.002)
        + rng.uniform(0, 20, (1, chunk, 3)).astype(np.float32)
    )
    masses = rng.uniform(1, 16, chunk)
    return vel, pos, masses


def _device_step(n_frames, chunk):
    """Synthesize a float32 chunk on the device (the trajectory
    formats' precision), upcast, and analyze it — one program."""

    @jax.jit
    def step(key):
        kv, kp, km = jax.random.split(key, 3)
        vel32 = 5.0 * jax.random.normal(
            kv, (n_frames, chunk, 3), jnp.float32)
        pos32 = (jnp.cumsum(vel32, axis=0) * jnp.float32(0.002)
                 + jax.random.uniform(kp, (1, chunk, 3), jnp.float32,
                                      0.0, 20.0))
        masses = jax.random.uniform(km, (chunk,), jnp.float64, 1.0, 16.0)
        return _analyze(vel32.astype(jnp.float64),
                        pos32.astype(jnp.float64), masses)

    return step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32768)
    ap.add_argument("--atoms", type=int, default=100352)
    ap.add_argument("--chunk", type=int, default=0,
                    help="atoms per device chunk (0 = auto from the "
                         "device memory)")
    ap.add_argument("--feed", choices=("device", "host"), default="device")
    ap.add_argument("--check", action="store_true",
                    help="verify one chunk against the host f64 oracle")
    args = ap.parse_args()
    device = require_gpu()
    enable_compile_cache()

    n_frames = args.frames
    chunk = args.chunk or auto_atom_chunk(n_frames, d=3)
    n_chunks = -(-args.atoms // chunk)
    n_atoms = n_chunks * chunk  # keep chunks uniform

    vacf_acc = np.zeros(n_frames, np.float64)
    helf_acc = np.zeros(n_frames, np.float64)

    if args.feed == "device":
        step = _device_step(n_frames, chunk)
        key = jax.random.PRNGKey(0)
        jax.block_until_ready(step(jax.random.fold_in(key, 10**6)))
        t0 = time.perf_counter()
        for c in range(n_chunks):
            vs, hs = step(jax.random.fold_in(key, c))
            vacf_acc += np.asarray(vs)  # readback ends the chunk
            helf_acc += np.asarray(hs)
        wall = time.perf_counter() - t0
    else:
        q = queue.Queue(maxsize=2)

        def produce():
            for c in range(n_chunks):
                q.put(_host_chunk(n_frames, chunk, 1000 + c))
            q.put(None)

        threading.Thread(target=produce, daemon=True).start()
        vel, pos, masses = _host_chunk(n_frames, chunk, 999)
        jax.block_until_ready(_analyze(
            jnp.asarray(vel, jnp.float64), jnp.asarray(pos, jnp.float64),
            jnp.asarray(masses)))
        t0 = time.perf_counter()
        while True:
            item = q.get()
            if item is None:
                break
            vel, pos, masses = item
            vs, hs = _analyze(
                jnp.asarray(vel).astype(jnp.float64),
                jnp.asarray(pos).astype(jnp.float64),
                jnp.asarray(masses),
            )
            vacf_acc += np.asarray(vs)
            helf_acc += np.asarray(hs)
        wall = time.perf_counter() - t0

    vacf_ts = vacf_acc / n_atoms
    helf_ts = helf_acc / n_atoms / (2.0 * KB * VOL * TEMP)
    times = np.arange(n_frames) * 0.002
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    gk_d = trapezoid(vacf_ts, times) / 3.0
    w = slice(n_frames // 8, n_frames // 2)
    slope = np.polyfit(np.arange(n_frames)[w], helf_ts[w], 1)[0]

    lags = 2 * (n_frames * (n_frames + 1) // 2) * n_atoms
    result = {
        "metric": (
            f"north-star slice VACF+Helfand (N={n_frames}, P={n_atoms}, "
            f"chunk={chunk}, f64, feed={args.feed})"
        ),
        "value": lags / wall,
        "unit": "atom-frame-lags/s",
        "wall_s": wall,
        "chunk": chunk,
        "n_chunks": n_chunks,
        "gk_diffusivity": float(gk_d),
        "helfand_slope": float(slope),
        "device": device,
    }

    if args.check:
        vel, pos, masses = _host_chunk(n_frames, chunk, 1000)
        sub = slice(0, 64)
        ref = acf_fft_numpy(vel[:, sub].astype(np.float64)).sum(axis=1)
        got = np.asarray(ops.acf_fft_from_f32(vel[:, sub])).sum(axis=1)
        result["hostchunk_vacf_rel_err"] = float(
            np.max(np.abs(got - ref)) / np.abs(ref).max()
        )

    print(json.dumps(result))


if __name__ == "__main__":
    main()
