"""pdwt-tpu: a JAX discrete wavelet transform framework.

Capabilities (re-designed for XLA, not ported) of pierrepaleo/PDWT:
multi-level 1D/2D DWT and stationary (undecimated) SWT, forward and
inverse, separable and non-separable, periodic boundary extension on
arbitrary (including odd) sizes, a 72-wavelet filter bank plus custom
filters, batched 1D transforms, thresholding / proximal operators, norms,
cycle spinning, and multi-chip sharded execution over a
``jax.sharding.Mesh`` with ring halo exchange (see :mod:`pdwt_tpu.parallel`).
Beyond the reference: 3D DWT/SWT (``core.dwt3d`` etc. — the reference's
first stated limitation), custom filters of any length, and
multi-resolution SWT approximation stacks (``keep_approx=True``).

Layers:

* ``filters``  — the 72-wavelet bank + custom filter constructors
* ``core``     — functional transforms (jnp/fma backends, pad-pluggable)
* ``ops``      — thresholds, norms, algebra, shifts
* ``api``      — the PDWT-style stateful ``Wavelets`` facade
* ``parallel`` — meshes, halo exchange, shard_map'd transforms
* ``models``   — translation-invariant denoising pipelines
* ``native``   — ctypes bindings to the C++ CPU engine (cpp/)
* ``utils``    — raw .dat I/O helpers
"""
from . import core, filters, models, ops, parallel, utils
from .api import Wavelets, WaveletSpec
from .api_extras import DualTree, Starlet
from .api_packets import WaveletPackets
from .core.modes import MODES
from .core.precision import TIERS
from .filters import (
    Wavelet,
    get_wavelet,
    list_wavelets,
    make_custom_wavelet,
    quad_filters,
    register_wavelet,
)

__version__ = "0.2.0"

__all__ = [
    "Wavelets", "WaveletSpec", "WaveletPackets", "Starlet", "DualTree",
    "Wavelet",
    "get_wavelet", "list_wavelets", "make_custom_wavelet",
    "register_wavelet", "quad_filters",
    "MODES", "TIERS",
    "core", "filters", "models", "ops", "parallel", "utils",
]
