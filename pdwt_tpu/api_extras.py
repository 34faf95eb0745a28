"""Stateful facades for the beyond-reference transform families.

``Starlet`` and ``DualTree`` close the API-story gap between the
functional cores (core/starlet.py, core/dualtree.py) and the
``Wavelets``/``WaveletPackets`` pattern: state is a pytree on device,
every pipeline traces ONCE per configuration (eager per-op calls are
the facade anti-pattern, see api.py), and the denoise entry points run
shift→analysis→threshold→synthesis as one program.

    >>> S = Starlet(img, levels=4)
    >>> den = S.denoise()                 # k-sigma, knob-free
    >>> D = DualTree(img, levels=4)
    >>> den = D.denoise(k=3.0)            # complex magnitude k-sigma

The CWT (core/continuous.py) stays functional-only BY DESIGN: a
scaleogram is an analysis product (one call, no state to mutate, no
threshold/invert cycle), matching the scipy/pywt ``cwt()`` shape users
expect — a stateful wrapper would add a class with one method.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .core import dualtree as dt_mod
# NOTE: core/__init__ rebinds the name "starlet" to the FUNCTION, so
# `from .core import starlet` would not give the module — import the
# submodule's names directly.
from .core.starlet import StarletCoeffs, istarlet
from .core.starlet import starlet as _starlet


class _JitFacade:
    def __init__(self):
        self._jit = {}

    def _jitted(self, key, make):
        fn = self._jit.get(key)
        if fn is None:
            fn = jax.jit(make())
            self._jit[key] = fn
        return fn


class Starlet(_JitFacade):
    """Isotropic à-trous (starlet) transform of one 1D/2D/3D array
    (spatial rank inferred from ``img.ndim``; pass ``ndim=`` for
    batched leading axes).  ``gen`` selects the generation (see
    core/starlet.py)."""

    def __init__(self, img, levels: int = 4, *, ndim: Optional[int] = None,
                 gen: int = 2, dtype=None,
                 backend: Optional[str] = None):
        super().__init__()
        img = jnp.asarray(img, dtype)
        self.ndim = int(ndim) if ndim is not None else min(img.ndim, 3)
        if not 1 <= self.ndim <= 3:
            raise ValueError(f"ndim must be 1..3, got {self.ndim}")
        if levels < 1:
            raise ValueError("levels must be >= 1")
        if gen not in (1, 2):
            raise ValueError(f"gen must be 1 or 2, got {gen}")
        self.levels = int(levels)
        self.gen = gen
        self.backend = backend
        self.d_image = img
        self.coeffs: Optional[StarletCoeffs] = None

    def _key(self, tag):
        return (tag, self.d_image.shape, str(self.d_image.dtype),
                self.levels, self.ndim, self.gen)

    def forward(self) -> StarletCoeffs:
        self.coeffs = self._jitted(self._key("fwd"), lambda: (
            lambda x: _starlet(x, self.levels, ndim=self.ndim,
                               gen=self.gen, backend=self.backend)
        ))(self.d_image)
        return self.coeffs

    def inverse(self) -> jnp.ndarray:
        if self.coeffs is None:
            raise ValueError("run forward() first (or assign .coeffs)")
        return self._jitted(self._key("inv"), lambda: (
            lambda c: istarlet(c, ndim=self.ndim, gen=self.gen,
                               backend=self.backend)
        ))(self.coeffs)

    def denoise(self, k=3.0, *, mode: str = "soft") -> jnp.ndarray:
        """Knob-free k-sigma denoise (models.starlet_auto_denoise) as
        one jitted program on the held image; does not touch
        ``.coeffs``."""
        from .models.denoiser import starlet_auto_denoise

        kk = tuple(k) if isinstance(k, (list, tuple)) else float(k)
        return self._jitted(self._key(("dn", kk, mode)), lambda: (
            lambda x: starlet_auto_denoise(x, self.levels, k=kk,
                                           ndim=self.ndim, gen=self.gen,
                                           mode=mode, backend=self.backend)
        ))(self.d_image)


class DualTree(_JitFacade):
    """Dual-tree complex wavelet transform of one 1D signal / 2D image
    (6 oriented complex bands per level in 2D, ~4x redundancy,
    near-shift-invariant; see core/dualtree.py)."""

    def __init__(self, img, levels: int = 4, *,
                 order: Tuple[int, int] = (2, 4), dtype=None,
                 backend: Optional[str] = None):
        super().__init__()
        img = jnp.asarray(img, dtype)
        if img.ndim not in (1, 2):
            raise ValueError(
                f"DualTree holds one 1D signal or 2D image, got "
                f"shape {img.shape}; use core.dtcwt1d/2d for batches")
        if levels < 1:
            raise ValueError("levels must be >= 1")
        self.ndim = img.ndim
        self.levels = int(levels)
        self.order = tuple(order)
        self.backend = backend
        self.d_image = img
        self.coeffs = None

    def _key(self, tag):
        return (tag, self.d_image.shape, str(self.d_image.dtype),
                self.levels, self.order)

    def forward(self):
        fwd = dt_mod.dtcwt2d if self.ndim == 2 else dt_mod.dtcwt1d
        self.coeffs = self._jitted(self._key("fwd"), lambda: (
            lambda x: fwd(x, self.levels, order=self.order,
                          backend=self.backend)))(self.d_image)
        return self.coeffs

    def inverse(self) -> jnp.ndarray:
        if self.coeffs is None:
            raise ValueError("run forward() first (or assign .coeffs)")
        if self.ndim == 2:
            inv = lambda c: dt_mod.idtcwt2d(c, self.d_image.shape[-2:],
                                            order=self.order,
                                            backend=self.backend)
        else:
            inv = lambda c: dt_mod.idtcwt1d(c, self.d_image.shape[-1],
                                            order=self.order,
                                            backend=self.backend)
        return self._jitted(self._key("inv"), lambda: inv)(self.coeffs)

    def magnitudes(self):
        """Per-level oriented magnitude stacks |c| (the DT-CWT's
        shift-invariant feature maps); run forward() first."""
        if self.coeffs is None:
            raise ValueError("run forward() first")
        return tuple(jnp.abs(d) for d in self.coeffs.details)

    def denoise(self, k=3.0, *, mode: str = "soft") -> jnp.ndarray:
        """Knob-free complex-magnitude k-sigma denoise
        (core.dtcwt_auto_denoise) as one jitted program."""
        kk = tuple(k) if isinstance(k, (list, tuple)) else float(k)
        return self._jitted(self._key(("dn", kk, mode)), lambda: (
            lambda x: dt_mod.dtcwt_auto_denoise(x, self.levels, k=kk,
                                                mode=mode,
                                                order=self.order,
                                                backend=self.backend)
        ))(self.d_image)
