"""Process set-up for programs that measure or check the accelerator:
where the compile cache lives, and refusing to run without a GPU."""

from __future__ import annotations

import os
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

# fixed, gitignored directory at the root of the source checkout: the
# cache key includes nothing that moves, so a later run from the same
# checkout finds what an earlier one compiled
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its path.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it
    and nothing else is set. Otherwise the cache goes to
    :data:`CHECKOUT_CACHE_DIR`. Call before the first compilation.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR


class NoGPUError(RuntimeError):
    """Raised where a measurement needs a GPU and JAX found none."""


def require_gpu() -> dict:
    """The device record (platform, kind, count) of the GPU backend.

    Raises :class:`NoGPUError` when JAX's default devices are not GPUs:
    a measurement never falls back to the CPU.
    """
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's devices are {devices[0].platform!r}"
        )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one line per
    card (``name, power.limit``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
