"""
transport_analysis_tpu
======================

A JAX trajectory-analysis engine with the capability surface of
MDAnalysis/transport-analysis (reference: /root/reference), rebuilt from
scratch on JAX/XLA.

Unlike the reference — a thin pure-Python layer over MDAnalysis's per-frame
Python loop (reference transport_analysis/velocityautocorr.py:72,
viscosity.py:26) — this package provides the full stack itself:

* ``core``     — Universe / AtomGroup / Timestep data model + selection
                 language (the slice of MDAnalysis contracts the reference
                 consumes, see SURVEY.md §2b).
* ``models``   — the analyses: ``VelocityAutocorr``, ``ViscosityHelfand``,
                 ``EinsteinMSD`` with the reference's API surface
                 (``run(start, stop, step)``, ``results.timeseries``, ...).
* ``ops``      — batched XLA kernels: Wiener–Khinchin autocorrelation,
                 windowed lag sums, Einstein-difference correlations,
                 trapezoid/Simpson integration, linear fits.
* ``parallel`` — device-mesh sharding (atoms over chips) and frame-chunked
                 streaming for trajectories that exceed device memory.
* ``io``       — trajectory readers/writers (TRR, DCD, Amber NetCDF, H5MD,
                 PDB topology) with a C++ frame-decode fast path.

Numerics: transport properties need float64-grade accuracy (reference
velocityautocorr.py:208 requires float64 for the FFT path). We therefore
enable JAX x64 at import unless ``TRANSPORT_ANALYSIS_TPU_NO_X64`` is set.
The FFT paths run complex128 transforms natively (cuFFT on the GPU).
"""

import os as _os

import jax as _jax

if not _os.environ.get("TRANSPORT_ANALYSIS_TPU_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

from ._version import get_versions as _get_versions  # noqa: E402

_versions = _get_versions()
__version__ = _versions["version"]
__git_revision__ = _versions["full-revisionid"]
del _versions

from .utils.errors import NoDataError  # noqa: E402
from .core.universe import Universe  # noqa: E402
from .core.groups import AtomGroup, UpdatingAtomGroup  # noqa: E402
from .models.velocityautocorr import VelocityAutocorr  # noqa: E402
from .models.viscosity import ViscosityHelfand  # noqa: E402
from .models.msd import EinsteinMSD  # noqa: E402
from . import io  # noqa: E402
from . import ops  # noqa: E402
from . import parallel  # noqa: E402

__all__ = [
    "Universe",
    "AtomGroup",
    "UpdatingAtomGroup",
    "NoDataError",
    "VelocityAutocorr",
    "ViscosityHelfand",
    "EinsteinMSD",
    "__version__",
]
