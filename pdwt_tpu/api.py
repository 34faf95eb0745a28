"""Stateful ``Wavelets`` facade — API parity with the reference class.

Mirrors the reference public surface (reference: src/wt.h:20-76 and
src/wt.cu) on top of the purely functional core:

* the reference class owns raw device buffers and mutates them in place;
  here the "state" is a coefficient pytree and an image array — both
  ordinary JAX arrays living on the accelerator, with transforms jitted
  per configuration.
* configuration errors raise ``ValueError`` instead of setting
  ``W_CREATION_ERROR`` and printing (reference: src/wt.cu:148-152,
  174-183); recoverable misuse (e.g. thresholding after inverse) warns and
  no-ops exactly like the reference (src/wt.cu:311-314).
* the 8-state machine (reference: src/wt.h:8-17) is kept as
  :class:`WState` for introspection and to guard the same sequences.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import warnings
from functools import partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import ops
from .core import nonseparable as ns_core
from .core import separable as sep_core
from .core.separable import Coeffs1D, Coeffs2D
from .core.separable import _all_periodization
from .core.shapes import coeff_shapes_1d, coeff_shapes_2d, div2, max_level
from .filters import (
    Wavelet,
    get_wavelet,
    make_custom_wavelet,
    quad_filters,
)


class WState(enum.Enum):
    """Reference: src/wt.h:8-17.

    The four ``*_ERROR`` members mirror the reference enum for API
    parity, but this framework raises real ``ValueError``s for
    configuration errors instead of parking the object in an error
    state (SURVEY.md §5 "failure detection"), so nothing here ever
    *sets* them; user code matching on the reference states still
    imports cleanly."""

    INIT = "W_INIT"
    FORWARD = "W_FORWARD"
    INVERSE = "W_INVERSE"
    THRESHOLD = "W_THRESHOLD"
    CREATION_ERROR = "W_CREATION_ERROR"
    FORWARD_ERROR = "W_FORWARD_ERROR"
    INVERSE_ERROR = "W_INVERSE_ERROR"
    THRESHOLD_ERROR = "W_THRESHOLD_ERROR"


@dataclasses.dataclass(frozen=True)
class WaveletSpec:
    """Static transform configuration (the reference's ``w_info`` +
    constructor flags, src/utils.h:9-19, src/wt.h:42)."""

    wname: str
    nr: int
    nc: int
    nlevels: int
    ndim: int = 2
    do_swt: bool = False
    do_separable: bool = True
    do_cycle_spinning: bool = False
    dtype: str = "float32"
    hlen: int = 2
    nd: int = 1  # depth (ndim == 3 only; the reference has no 3D)
    #: boundary extension (core/modes.py); "periodization" = the
    #: reference scheme, the rest are the pywt modes (DWT only); a
    #: per-axis tuple follows pywt's tuple-of-modes semantics
    mode: Union[str, Tuple[str, ...]] = "periodization"
    #: precision tier (core/precision.py), implied by ``dtype``
    precision: str = "exact"

    @property
    def shape(self):
        return (self.nd, self.nr, self.nc) if self.ndim == 3 \
            else (self.nr, self.nc)


class Wavelets:
    """Stateful wavelet transform bound to one image geometry.

    Parameters mirror the reference constructor (reference: src/wt.h:42):

    >>> W = Wavelets(img, wname="db7", levels=5)
    >>> W.forward(); W.soft_threshold(10.0); img_dn = W.inverse()

    Like the reference, the facade holds exactly ONE 1D signal or 2D
    image — or (beyond the reference, whose README lists 3D as its first
    limitation) one 3D volume, with the separable transforms, cycle
    spinning, thresholds, norms and the 7-band flat coefficient
    numbering extended accordingly.  For batched throughput (image
    stacks, batched-1D with arbitrary leading dims) use the functional
    core directly (``pdwt_tpu.core.dwt2d`` et al. broadcast over leading
    axes) or the sharded entry points in ``pdwt_tpu.parallel``.
    """

    def __init__(
        self,
        img=None,
        nr: Optional[int] = None,
        nc: Optional[int] = None,
        wname: str = "haar",
        levels: int = 1,
        do_separable: bool = True,
        do_cycle_spinning: bool = False,
        do_swt: bool = False,
        ndim: int = 2,
        dtype=None,
        seed: int = 0,
        backend: Optional[str] = None,
        mode: str = "periodization",
        precision: Optional[str] = None,
        device=None,
    ):
        from .core import modes as modes_mod
        from .core import precision as prec_mod
        from .core.separable import _all_periodization

        if isinstance(mode, str):
            modes_mod.check_mode(mode)
        else:
            # pywt per-axis semantics: one mode per transformed axis
            # (length checked against ndim below, once geometry is known)
            mode = tuple(modes_mod.check_mode(m) for m in mode)
        if dtype is None:
            # bf16-* tiers imply bf16 arrays; everything else runs f32.
            dtype = (jnp.bfloat16
                     if precision is not None and precision.startswith("bf16-")
                     else jnp.float32)
        resolved_tier = prec_mod.tier_for(jnp.dtype(dtype).name, precision)
        if not _all_periodization(mode):
            if do_swt:
                raise ValueError(
                    "the stationary transform is periodic by definition "
                    "(pywt.swt has no mode either); non-periodization "
                    "boundary modes apply to the decimated DWT only")
            if not do_separable:
                raise ValueError(
                    "non-separable transforms support mode='periodization' "
                    "only")
            if do_cycle_spinning:
                warnings.warn(
                    "cycle spinning shifts circularly, which mixes opposite "
                    "edges — with a non-periodization boundary mode the "
                    "shifted transforms are not shift-consistent at the "
                    "borders")
        nd = 1
        if img is not None:
            img = jnp.asarray(img, dtype=dtype)
            if img.ndim == 1:
                img = img[None, :]
                ndim = 1
            if img.ndim == 3:
                ndim = 3  # volume — beyond the reference (no 3D there)
                nd, nr, nc = img.shape
            elif img.ndim != 2:
                raise ValueError(
                    f"expected a 1D, 2D or 3D array, got shape {img.shape}; "
                    "use the functional core (pdwt_tpu.core) for extra "
                    "batch dims"
                )
            else:
                nr, nc = img.shape
        elif nr is None or nc is None:
            raise ValueError("provide either an image or (nr, nc)")

        if levels < 1:
            warnings.warn(
                "cannot initialize wavelet coefficients with nlevels < 1; "
                "forcing nlevels = 1"  # reference: src/wt.cu:111-114
            )
            levels = 1
        if nr == 1:  # 1D data (reference: src/wt.cu:133-136)
            ndim = 1
        if ndim in (1, 3) and not do_separable:
            warnings.warn(
                f"{ndim}D DWT is incompatible with non-separable transform; "
                "ignoring do_separable"  # reference: src/wt.cu:138-142 (1D)
            )
            do_separable = True
        if ndim not in (1, 2, 3):
            raise ValueError(f"ndim={ndim} is not implemented")
        if do_cycle_spinning and do_swt:
            warnings.warn(
                "makes little sense to use cycle spinning with stationary "
                "wavelet transform"  # reference: src/wt.cu:177
            )
        if do_cycle_spinning and ndim == 1:
            # reference: src/wt.cu:179-183 (creation error)
            raise ValueError(
                "cycle spinning is not implemented for 1D; use SWT instead"
            )

        self._wavelet: Optional[Wavelet] = get_wavelet(wname)
        hlen = self._wavelet.hlen
        self._quads_fwd = None
        self._quads_inv = None
        if not do_separable:
            self._quads_fwd = quad_filters(self._wavelet.dec_lo, self._wavelet.dec_hi)
            self._quads_inv = quad_filters(self._wavelet.rec_lo, self._wavelet.rec_hi)

        # Max achievable level (reference: src/wt.cu:155-165).
        n_min = {1: nc, 2: min(nr, nc), 3: min(nd, nr, nc)}[ndim]
        wmax = max_level(n_min, hlen)
        if levels > wmax:
            dims = {1: f"length-{nc} signal", 2: f"{nr}x{nc} image",
                    3: f"{nd}x{nr}x{nc} volume"}[ndim]
            # wmax can be 0 when the smallest axis is below the filter
            # support; a transform still needs >= 1 level (periodic
            # extension tiles the short axis), so clamp like the
            # nlevels<1 constructor guard instead of crashing.
            warnings.warn(
                f"required level ({levels}) is greater than the maximum possible "
                f"level for {wname} ({wmax}) on a {dims}; forcing "
                f"nlevels = {max(wmax, 1)}"
            )
            levels = max(wmax, 1)

        if not isinstance(mode, str):
            mode = modes_mod.per_axis(mode, ndim)  # length vs geometry
        self.spec = WaveletSpec(
            wname=wname, nr=nr, nc=nc, nlevels=levels, ndim=ndim,
            do_swt=do_swt, do_separable=do_separable,
            do_cycle_spinning=do_cycle_spinning,
            dtype=jnp.dtype(dtype).name, hlen=hlen, nd=nd,
            mode=mode, precision=resolved_tier,
        )
        self._dtype = jnp.dtype(dtype)
        self._backend = backend
        # device placement (the analogue of the reference TODO's
        # "user-defined target CUDA device", reference: TODO.txt):
        # a jax.Device or Sharding; jit follows the input placement.
        self._device = device
        self.state = WState.INIT
        self.current_shift_r = 0
        self.current_shift_c = 0
        self.current_shift_d = 0  # depth shift (3D cycle spinning)
        self._rng = np.random.default_rng(seed)

        if img is None:
            img = jnp.zeros((nd, nr, nc) if ndim == 3 else (nr, nc),
                            dtype=self._dtype)
        if device is not None:
            img = jax.device_put(img, device)
        self.d_image = img if ndim in (2, 3) else img.reshape(nr, nc)
        self._coeffs = self._zero_coeffs()
        # jit cache for the transform pipelines: the reference launches
        # hand-written kernels per level (src/wt.cu:247-266); here each
        # configuration compiles ONCE into a single fused XLA program —
        # eager per-op dispatch would be a host round-trip per slice.
        self._jit_cache: dict = {}

    def copy(self) -> "Wavelets":
        """Deep copy (reference copy constructor: src/wt.cu:191-222).

        JAX arrays are immutable, so "deep copy" is a pytree re-reference;
        the clone shares the jit cache (compiled programs are stateless)
        but nothing mutable."""
        import copy as _copy

        w = object.__new__(Wavelets)
        w.__dict__.update(self.__dict__)
        w._rng = _copy.deepcopy(self._rng)
        return w

    def __copy__(self) -> "Wavelets":
        return self.copy()

    def _jitted(self, key, make):
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = jax.jit(make())
            self._jit_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # properties / bookkeeping
    # ------------------------------------------------------------------

    @property
    def wname(self) -> str:
        return self.spec.wname

    @property
    def coeffs(self):
        """The coefficient pytree (Coeffs1D / Coeffs2D)."""
        return self._coeffs

    @coeffs.setter
    def coeffs(self, value):
        self._coeffs = value
        self.state = WState.FORWARD

    def _zero_coeffs(self):
        s = self.spec
        z = partial(jnp.zeros, dtype=self._dtype)
        from .core.separable import _all_periodization

        if not _all_periodization(s.mode):
            # pywt size rule: per-level lengths depend on the filter
            # support (core/modes.py dec_len); DWT only (ctor guards).
            from .core.modes import level_sizes as _msizes
            from .core.modes import per_axis

            axes = ((s.nd, s.nr, s.nc) if s.ndim == 3
                    else (s.nr, s.nc) if s.ndim == 2 else (s.nc,))
            per = per_axis(s.mode, len(axes))
            chains = [_msizes(n, s.nlevels, s.hlen, m)
                      for n, m in zip(axes, per)]
            det_shapes = [tuple(ch[i + 1] for ch in chains)
                          for i in range(s.nlevels)]
            if s.ndim == 3:
                from .core.separable3d import Coeffs3D

                return Coeffs3D(
                    z(det_shapes[-1]),
                    tuple(tuple(z(d) for _ in range(7)) for d in det_shapes),
                )
            if s.ndim == 2:
                return Coeffs2D(
                    z(det_shapes[-1]),
                    tuple((z(d), z(d), z(d)) for d in det_shapes),
                )
            return Coeffs1D(
                z((s.nr, det_shapes[-1][0])),
                tuple(z((s.nr, d[0])) for d in det_shapes),
            )
        if s.ndim == 3:
            from .core.separable3d import Coeffs3D
            from .core.shapes import coeff_shapes_3d

            a_shape, det_shapes = coeff_shapes_3d(
                s.nd, s.nr, s.nc, s.nlevels, s.do_swt)
            return Coeffs3D(
                z(a_shape),
                tuple(tuple(z(d) for _ in range(7)) for d in det_shapes),
            )
        if s.ndim == 2:
            a_shape, det_shapes = coeff_shapes_2d(s.nr, s.nc, s.nlevels, s.do_swt)
            return Coeffs2D(
                z(a_shape),
                tuple((z(d), z(d), z(d)) for d in det_shapes),
            )
        a_len, det_lens = coeff_shapes_1d(s.nc, s.nlevels, s.do_swt)
        return Coeffs1D(
            z((s.nr, a_len)), tuple(z((s.nr, d)) for d in det_lens)
        )

    def _check_not_inverse(self, action: str) -> bool:
        if self.state == WState.INVERSE:
            warnings.warn(
                f"cannot {action}, as the coefficients were modified by "
                "inverse()"  # reference: src/wt.cu:311-314
            )
            return False
        return True

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------

    def _fwd_wavelet(self) -> Wavelet:
        if self._wavelet is None:
            raise ValueError("no forward filters set")
        return self._wavelet

    def _make_forward_fn(self):
        """One jitted program: (optional circshift) + full multi-level
        analysis (reference dispatch: src/wt.cu:247-266)."""
        s = self.spec
        w = self._wavelet
        quads = self._quads_fwd
        be = self._backend

        def fn(img, sd, sr, sc):
            if s.do_cycle_spinning:
                img = (ops.circshift3d(img, sd, sr, sc) if s.ndim == 3
                       else ops.circshift2d(img, sr, sc))
            if s.ndim == 1:
                if not s.do_swt:
                    return sep_core.dwt1d(img, w, s.nlevels, backend=be,
                                          mode=s.mode)
                return sep_core.swt1d(img, w, s.nlevels, backend=be)
            if s.ndim == 3:
                from .core import separable3d as sep3

                if not s.do_swt:
                    return sep3.dwt3d(img, w, s.nlevels, backend=be,
                                      mode=s.mode)
                return sep3.swt3d(img, w, s.nlevels, backend=be)
            if s.do_separable:
                if not s.do_swt:
                    return sep_core.dwt2d(img, w, s.nlevels, backend=be,
                                          mode=s.mode)
                return sep_core.swt2d(img, w, s.nlevels, backend=be)
            if quads is None:
                raise ValueError("no forward quad filters set")
            if not s.do_swt:
                return ns_core.dwt2d_ns(img, quads, s.nlevels)
            return ns_core.swt2d_ns(img, quads, s.nlevels)

        return fn

    def forward(self):
        """Compute the coefficient pytree from the current image
        (reference: src/wt.cu:236-271)."""
        s = self.spec
        if s.do_separable or s.ndim == 1:
            self._fwd_wavelet()  # friendly error before tracing
        if s.do_cycle_spinning:
            # host-side draw like the reference's rand() (src/wt.cu:243-244),
            # but from a seeded generator; shift itself runs on device
            # (traced args -> no recompile per draw).
            self.current_shift_r = int(self._rng.integers(0, s.nr))
            self.current_shift_c = int(self._rng.integers(0, s.nc))
            if s.ndim == 3:
                self.current_shift_d = int(self._rng.integers(0, s.nd))
        key = ("fwd", s, self._wavelet, None if self._quads_fwd is None
               else self._quads_fwd.tobytes())
        fn = self._jitted(key, self._make_forward_fn)
        self._coeffs = fn(self.d_image, self.current_shift_d,
                          self.current_shift_r, self.current_shift_c)
        self.state = WState.FORWARD
        return self._coeffs

    def run_denoise(self, beta, mode: str = "soft",
                    do_thresh_appcoeffs: bool = False,
                    normalize: bool = False):
        """The whole denoise pipeline — (cycle-spin shift) → analysis →
        threshold → sparsity norm → synthesis → unshift — as ONE jitted
        program and ONE device dispatch (the step-by-step
        ``forward(); soft_threshold(); norm1(); inverse()`` sequence
        costs 4+ dispatches and host round trips).
        Separable specs only.  On the SWT path the norm uses
        ``ops.thresholded_norm1``, which XLA can fuse with the
        threshold that feeds the synthesis.
        Stateless: returns ``(denoised, norm1)`` on device and leaves
        the facade's image/coefficients untouched."""
        s = self.spec
        if not (s.do_separable or s.ndim == 1):
            raise ValueError("run_denoise supports separable specs only")
        w = self._fwd_wavelet()
        be = self._backend
        from .models.denoiser import _THRESH as _thresh_fns

        thr = _thresh_fns.get(mode)
        if thr is None:
            raise ValueError(
                f"unknown mode {mode!r}; pick from {sorted(_thresh_fns)}")
        # sequence betas are safe on the fused path: iswt*_denoise
        # reroutes them to the ops threshold internally and
        # thresholded_norm1 resolves them per (level, band)
        fuse = (s.do_swt and s.ndim != 1
                and mode in ("soft", "hard", "garrote"))

        def make():
            from .core import separable3d as sep3

            def fn(img, sd, sr, sc, b):
                if s.do_cycle_spinning:
                    img = (ops.circshift3d(img, sd, sr, sc)
                           if s.ndim == 3
                           else ops.circshift2d(img, sr, sc))
                if s.ndim == 1:
                    fwd = sep_core.swt1d if s.do_swt else sep_core.dwt1d
                elif s.ndim == 3:
                    fwd = sep3.swt3d if s.do_swt else sep3.dwt3d
                else:
                    fwd = sep_core.swt2d if s.do_swt else sep_core.dwt2d
                fwd_kw = {} if s.do_swt else {"mode": s.mode}
                c = fwd(img, w, s.nlevels, backend=be, **fwd_kw)
                if fuse:
                    n1 = ops.thresholded_norm1(
                        c, b, mode=mode, normalize=normalize,
                        do_thresh_appcoeffs=do_thresh_appcoeffs)
                    inv_den = (sep3.iswt3d_denoise if s.ndim == 3
                               else sep_core.iswt2d_denoise)
                    out = inv_den(
                        c, w, b, mode=mode, normalize=normalize,
                        do_thresh_appcoeffs=do_thresh_appcoeffs,
                        backend=be)
                else:
                    c = thr(c, b, normalize=normalize,
                            do_thresh_appcoeffs=do_thresh_appcoeffs)
                    n1 = ops.norm1(c)
                    if s.ndim == 1:
                        out = (sep_core.iswt1d(c, w, backend=be)
                               if s.do_swt
                               else sep_core.idwt1d(c, w, s.nc,
                                                    backend=be,
                                                    mode=s.mode))
                    elif s.ndim == 3:
                        out = (sep3.iswt3d(c, w, backend=be)
                               if s.do_swt
                               else sep3.idwt3d(c, w, (s.nd, s.nr, s.nc),
                                                backend=be, mode=s.mode))
                    else:
                        out = (sep_core.iswt2d(c, w, backend=be)
                               if s.do_swt
                               else sep_core.idwt2d(c, w, (s.nr, s.nc),
                                                    backend=be,
                                                    mode=s.mode))
                if s.do_cycle_spinning:
                    out = (ops.circshift3d(out, -sd, -sr, -sc)
                           if s.ndim == 3
                           else ops.circshift2d(out, -sr, -sc))
                return out, n1

            return fn

        sd = sr = sc = 0
        if s.do_cycle_spinning:
            sr = int(self._rng.integers(0, s.nr))
            sc = int(self._rng.integers(0, s.nc))
            if s.ndim == 3:
                sd = int(self._rng.integers(0, s.nd))
        key = ("run_denoise", mode, do_thresh_appcoeffs, normalize, s,
               self._wavelet)
        return self._jitted(key, make)(self.d_image, sd, sr, sc, beta)

    def inverse(self):
        """Reconstruct the image from the coefficients
        (reference: src/wt.cu:273-307)."""
        if self.state == WState.INVERSE:
            warnings.warn(
                "inverse() has already been run; result available via "
                "get_image()"  # reference: src/wt.cu:274-277
            )
            return self.d_image
        if self.state in (WState.FORWARD_ERROR, WState.THRESHOLD_ERROR):
            warnings.warn("inverse transform not computed due to earlier error")
            return None

        s = self.spec
        w = self._wavelet
        be = self._backend
        quads = self._quads_inv

        def make():
            def fn(c, sd, sr, sc):
                if s.ndim == 1:
                    if not s.do_swt:
                        img = sep_core.idwt1d(c, w, s.nc, backend=be,
                                              mode=s.mode)
                    else:
                        img = sep_core.iswt1d(c, w, backend=be)
                elif s.ndim == 3:
                    from .core import separable3d as sep3

                    if not s.do_swt:
                        img = sep3.idwt3d(c, w, s.shape, backend=be,
                                          mode=s.mode)
                    else:
                        img = sep3.iswt3d(c, w, backend=be)
                else:
                    if s.do_separable:
                        if not s.do_swt:
                            img = sep_core.idwt2d(c, w, s.shape, backend=be,
                                                  mode=s.mode)
                        else:
                            img = sep_core.iswt2d(c, w, backend=be)
                    else:
                        if quads is None:
                            raise ValueError("no inverse quad filters set")
                        if not s.do_swt:
                            img = ns_core.idwt2d_ns(c, quads, s.shape)
                        else:
                            img = ns_core.iswt2d_ns(c, quads)
                if s.do_cycle_spinning:
                    img = (ops.circshift3d(img, -sd, -sr, -sc)
                           if s.ndim == 3
                           else ops.circshift2d(img, -sr, -sc))
                return img

            return fn

        key = ("inv", s, w, None if quads is None else quads.tobytes())
        img = self._jitted(key, make)(
            self._coeffs, self.current_shift_d, self.current_shift_r,
            self.current_shift_c)
        self.d_image = img
        self.state = WState.INVERSE
        return img

    # ------------------------------------------------------------------
    # thresholding / proximal operators
    # ------------------------------------------------------------------

    def soft_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False):
        if not self._check_not_inverse("threshold coefficients"):
            return
        fn = self._jitted(
            ("soft", do_thresh_appcoeffs, normalize, self.spec),
            lambda: partial(ops.soft_threshold,
                            do_thresh_appcoeffs=do_thresh_appcoeffs,
                            normalize=normalize))
        self._coeffs = fn(self._coeffs, beta)
        self.state = WState.THRESHOLD

    def hard_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False):
        if not self._check_not_inverse("threshold coefficients"):
            return
        fn = self._jitted(
            ("hard", do_thresh_appcoeffs, normalize, self.spec),
            lambda: partial(ops.hard_threshold,
                            do_thresh_appcoeffs=do_thresh_appcoeffs,
                            normalize=normalize))
        self._coeffs = fn(self._coeffs, beta)
        self.state = WState.THRESHOLD

    def group_soft_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                             normalize: bool = False):
        if not self._check_not_inverse("threshold coefficients"):
            return
        fn = self._jitted(
            ("group", do_thresh_appcoeffs, normalize, self.spec),
            lambda: partial(ops.group_soft_threshold,
                            do_thresh_appcoeffs=do_thresh_appcoeffs,
                            normalize=normalize))
        self._coeffs = fn(self._coeffs, beta)
        self.state = WState.THRESHOLD

    def garrote_threshold(self, beta, do_thresh_appcoeffs: bool = False,
                          normalize: bool = False):
        """Non-negative garrote (reference TODO.txt: "More threshold
        types")."""
        if not self._check_not_inverse("threshold coefficients"):
            return
        fn = self._jitted(
            ("garrote", do_thresh_appcoeffs, normalize, self.spec),
            lambda: partial(ops.garrote_threshold,
                            do_thresh_appcoeffs=do_thresh_appcoeffs,
                            normalize=normalize))
        self._coeffs = fn(self._coeffs, beta)
        self.state = WState.THRESHOLD

    def firm_threshold(self, beta, beta2, do_thresh_appcoeffs: bool = False,
                       normalize: bool = False):
        """Firm/semisoft threshold with lower knee ``beta`` and upper
        knee ``beta2`` (reference TODO.txt: "More threshold types")."""
        if not self._check_not_inverse("threshold coefficients"):
            return
        fn = self._jitted(
            ("firm", do_thresh_appcoeffs, normalize, self.spec),
            lambda: partial(ops.firm_threshold,
                            do_thresh_appcoeffs=do_thresh_appcoeffs,
                            normalize=normalize))
        self._coeffs = fn(self._coeffs, beta, beta2)
        self.state = WState.THRESHOLD

    def noise_sigma(self) -> float:
        """Robust MAD noise estimate from the finest diagonal band."""
        return float(self._jitted(("nsigma", self.spec),
                                  lambda: ops.noise_sigma)(self._coeffs))

    def universal_threshold(self) -> float:
        """VisuShrink σ·sqrt(2 ln N) for the current coefficients —
        feed straight back into :meth:`soft_threshold`."""
        return float(self._jitted(("uthresh", self.spec),
                                  lambda: ops.universal_threshold)(
            self._coeffs))

    def bayes_shrink(self, do_thresh_appcoeffs: bool = False):
        """One-call adaptive denoise: BayesShrink per-band thresholds +
        soft threshold, fused into a single jitted program."""
        if not self._check_not_inverse("threshold coefficients"):
            return

        def make():
            def fn(c):
                return ops.soft_threshold(
                    c, ops.bayes_thresholds(c),
                    do_thresh_appcoeffs=do_thresh_appcoeffs)
            return fn

        self._coeffs = self._jitted(
            ("bayes", do_thresh_appcoeffs, self.spec), make)(self._coeffs)
        self.state = WState.THRESHOLD

    def shrink(self, beta, do_thresh_appcoeffs: bool = True):
        if not self._check_not_inverse("shrink coefficients"):
            return
        fn = self._jitted(
            ("shrink", do_thresh_appcoeffs, self.spec),
            lambda: partial(ops.shrink,
                            do_thresh_appcoeffs=do_thresh_appcoeffs))
        self._coeffs = fn(self._coeffs, beta)
        self.state = WState.THRESHOLD

    def proj_linf(self, beta, do_thresh_appcoeffs: bool = True):
        if not self._check_not_inverse("project coefficients"):
            return
        fn = self._jitted(
            ("linf", do_thresh_appcoeffs, self.spec),
            lambda: partial(ops.proj_linf,
                            do_thresh_appcoeffs=do_thresh_appcoeffs))
        self._coeffs = fn(self._coeffs, beta)
        self.state = WState.THRESHOLD

    # ------------------------------------------------------------------
    # norms / algebra / shifting
    # ------------------------------------------------------------------

    def norm1(self) -> float:
        return float(self._jitted(("norm1", self.spec),
                                  lambda: ops.norm1)(self._coeffs))

    def norm2sq(self) -> float:
        return float(self._jitted(("norm2sq", self.spec),
                                  lambda: ops.norm2sq)(self._coeffs))

    def norm_l21(self, do_thresh_appcoeffs: bool = False) -> float:
        """Group-lasso (L2,1) norm over group_soft_threshold's
        cross-subband groups (reference TODO.txt: "compute norm related
        to threshold (… group-lasso)")."""
        return float(self._jitted(
            ("norm_l21", do_thresh_appcoeffs, self.spec),
            lambda: partial(ops.norm_l21,
                            do_thresh_appcoeffs=do_thresh_appcoeffs)
        )(self._coeffs))

    def circshift(self, sr: int, sc: int, inplace: bool = True,
                  sd: int = 0):
        """Circular shift of the image (reference: src/wt.cu:366-368;
        the non-inplace variant mirrors src/wt.h:63 ``inplace=0``: the
        shifted image is returned and the internal state is untouched).
        ``sd`` shifts the depth axis of a 3D volume."""
        if self.spec.ndim == 1:
            shifted = self._jitted(
                ("shift1", self.spec), lambda: ops.circshift1d)(
                self.d_image, sc)
        elif self.spec.ndim == 3:
            shifted = self._jitted(
                ("shift3", self.spec), lambda: ops.circshift3d)(
                self.d_image, sd, sr, sc)
        else:
            shifted = self._jitted(
                ("shift2", self.spec), lambda: ops.circshift2d)(
                self.d_image, sr, sc)
        if inplace:
            self.d_image = shifted
            return None
        return shifted

    def add_wavelet(self, other: "Wavelets", alpha=1.0):
        """In-place coefficient axpy: self += alpha * other
        (reference: src/wt.cu:624-657)."""
        if (self.spec.nlevels != other.spec.nlevels
                or self.spec.wname.lower() != other.spec.wname.lower()):
            raise ValueError(
                "add_wavelet(): right operand is not the same transform "
                "(wname, level)")
        if self.state == WState.INVERSE or other.state == WState.INVERSE:
            warnings.warn(
                "add_wavelet(): this operation makes no sense when wavelet "
                "has just been inverted")
            return 1
        if (self.spec.nd, self.spec.nr, self.spec.nc, self.spec.ndim) != (
                other.spec.nd, other.spec.nr, other.spec.nc,
                other.spec.ndim):
            raise ValueError("add_wavelet(): operands do not have the same geometry")
        if self.spec.do_swt != other.spec.do_swt:
            raise ValueError("add_wavelet(): operands should both use SWT or DWT")
        if (self.spec.do_cycle_spinning and other.spec.do_cycle_spinning
                and (self.current_shift_r, self.current_shift_c)
                != (other.current_shift_r, other.current_shift_c)):
            raise ValueError("add_wavelet(): operands do not have the same "
                             "current shift")
        self._coeffs = self._jitted(
            ("axpy", self.spec), lambda: ops.add_coeffs)(
            self._coeffs, other._coeffs, alpha)
        return 0

    # ------------------------------------------------------------------
    # data movement (get/set) — reference: src/wt.cu:421-508
    # ------------------------------------------------------------------

    def get_image(self, copy: bool = True):
        """Image data.  ``copy=True`` (default) returns a host numpy
        array (the reference's D2H ``get_image``, src/wt.cu:421-424);
        ``copy=False`` returns the on-device ``jax.Array`` WITHOUT any
        host transfer — the analogue of the reference's raw
        device-pointer export for external pipelines
        (reference: src/wt.cu:660-667 ``image_int_ptr``).  The returned
        array supports the DLPack protocol (``__dlpack__``) for
        zero-copy hand-off to other frameworks."""
        if copy:
            return np.asarray(self.d_image)
        return self.d_image

    def set_image(self, img):
        img = jnp.asarray(img, dtype=self._dtype).reshape(self.spec.shape
                                                          if self.spec.ndim == 3
                                                          else (self.spec.nr,
                                                                self.spec.nc))
        if self._device is not None:
            img = jax.device_put(img, self._device)
        self.d_image = img
        self.state = WState.INIT

    def _coeff_ref(self, num: int):
        """Map the reference's flat coefficient numbering to the pytree.

        2D: 0=A, then H1,V1,D1=1,2,3, H2,V2,D2=4,5,6, ...
        1D: 0=A, then D1..Dn  (reference: src/wt.cu:442-465).
        3D (no reference counterpart): 0=A, then the 7 bands of level 1
        in DETAIL_KEYS_3D order (daa..ddd) = 1..7, level 2 = 8..14, ...
        """
        s = self.spec
        if num == 0:
            return ("a",)
        if s.ndim == 3:
            level = (num - 1) // 7
            band = (num - 1) % 7
            if level >= s.nlevels:
                raise IndexError(f"coefficient {num} out of range")
            return ("d2", level, band)
        if s.ndim == 2:
            level = (num - 1) // 3      # 0-based
            band = (num - 1) % 3
            if level >= s.nlevels:
                raise IndexError(f"coefficient {num} out of range")
            return ("d2", level, band)
        if num > s.nlevels:
            raise IndexError(f"coefficient {num} out of range")
        return ("d1", num - 1)

    def get_coeff(self, num: int, copy: bool = True):
        """One coefficient subband by the reference's flat numbering.
        ``copy=False`` returns the on-device ``jax.Array`` without a
        host transfer (the analogue of src/wt.cu:660-667
        ``coeff_int_ptr``; DLPack-exportable)."""
        if self.state == WState.INVERSE:
            warnings.warn(
                "get_coeff(): inverse() has been performed, the coefficients "
                "do not make sense anymore")  # reference: src/wt.cu:476-479
            return None
        ref = self._coeff_ref(num)
        if ref[0] == "a":
            out = self._coeffs.approx
        elif ref[0] == "d2":
            out = self._coeffs.details[ref[1]][ref[2]]
        else:
            out = self._coeffs.details[ref[1]]
        return np.asarray(out) if copy else out

    def set_coeff(self, coeff, num: int):
        # Cast to the EXISTING subband's dtype, not the spec dtype: a
        # caller may have installed a pytree whose leaves differ in dtype
        # (e.g. an f32 approximation beside bf16 details), and set_coeff
        # must not downcast it.
        ref = self._coeff_ref(num)
        if ref[0] == "a":
            coeff = jnp.asarray(coeff, self._coeffs.approx.dtype).reshape(
                self._coeffs.approx.shape)
            self._coeffs = type(self._coeffs)(coeff, self._coeffs.details)
            return
        details = list(self._coeffs.details)
        if ref[0] == "d2":
            level = list(details[ref[1]])
            coeff = jnp.asarray(coeff, level[ref[2]].dtype).reshape(
                level[ref[2]].shape)
            level[ref[2]] = coeff
            details[ref[1]] = tuple(level)
        else:
            coeff = jnp.asarray(coeff, details[ref[1]].dtype).reshape(
                details[ref[1]].shape)
            details[ref[1]] = coeff
        self._coeffs = type(self._coeffs)(self._coeffs.approx, tuple(details))

    # ------------------------------------------------------------------
    # custom filters — reference: src/wt.cu:560-602
    # ------------------------------------------------------------------

    def set_filters_forward(self, filtername: str, filter1, filter2,
                            filter3=None, filter4=None):
        n = len(np.atleast_1d(np.asarray(filter1)))
        if self.spec.do_separable:
            w_old = self._wavelet
            self._wavelet = make_custom_wavelet(
                filtername, filter1, filter2,
                w_old.rec_lo if (w_old is not None and w_old.hlen == n)
                else np.zeros(n),
                w_old.rec_hi if (w_old is not None and w_old.hlen == n)
                else np.zeros(n),
            )
        else:
            if filter3 is None or filter4 is None:
                raise ValueError(
                    "set_filters_forward(): expected 4 filters for "
                    "non-separable filtering")
            # No length cap: the reference's 40-tap limit is a CUDA
            # constant-memory artifact its own TODO.txt asks to remove.
            q = np.stack([np.asarray(f, np.float64) for f in
                          (filter1, filter2, filter3, filter4)])
            self._quads_fwd = q
            n = q.shape[-1]
        hlen_changed = n != self.spec.hlen
        self.spec = dataclasses.replace(self.spec, wname=filtername, hlen=n)
        if hlen_changed and not _all_periodization(self.spec.mode):
            # non-periodization coefficient shapes depend on the filter
            # support (pywt size rule) — rebuild the zero pytree
            self._coeffs = self._zero_coeffs()
            self.state = WState.INIT
        return 0

    def set_filters_inverse(self, filter1, filter2, filter3=None, filter4=None):
        if self.spec.do_separable:
            w = self._wavelet
            self._wavelet = make_custom_wavelet(
                self.spec.wname, w.dec_lo, w.dec_hi, filter1, filter2)
        else:
            if filter3 is None or filter4 is None:
                raise ValueError(
                    "set_filters_inverse(): expected 4 filters for "
                    "non-separable filtering")
            self._quads_inv = np.stack([np.asarray(f, np.float64) for f in
                                        (filter1, filter2, filter3, filter4)])
        return 0

    # ------------------------------------------------------------------
    # introspection — reference: src/wt.cu:513-552
    # ------------------------------------------------------------------

    def info(self) -> dict:
        s = self.spec
        npix = s.nd * s.nr * s.nc  # nd == 1 unless ndim == 3
        if not s.do_swt:
            mem = 5 * npix * self._dtype.itemsize
        elif s.ndim == 3:
            # 3D SWT: (7n+1) full-size bands + image + tmp (analogue of
            # the reference's 2D (3n+4) formula, src/wt.cu:533-539)
            mem = (7 * s.nlevels + 4) * npix * self._dtype.itemsize
        elif s.ndim == 2:
            mem = (3 * s.nlevels + 4) * npix * self._dtype.itemsize
        else:
            mem = (s.nlevels + 4) * npix * self._dtype.itemsize
        dev = jax.devices()[0]
        return {
            "dims": (s.shape if s.ndim == 3
                     else (s.nr, s.nc) if s.ndim == 2 else s.nc),
            "batched_1d": s.ndim == 1 and s.nr > 1,
            "wavelet": s.wname,
            "levels": s.nlevels,
            "stationary": s.do_swt,
            "cycle_spinning": s.do_cycle_spinning,
            "separable": s.do_separable,
            "dtype": s.dtype,
            "mode": s.mode,
            "precision": s.precision,
            "estimated_memory_mb": mem / 1e6,
            "device": f"{dev.platform}:{dev.device_kind}",
            "state": self.state.value,
        }

    def print_informations(self):
        i = self.info()
        print("------------- Wavelet transform infos ------------")
        if self.spec.ndim in (2, 3):
            print(f"Data dimensions : {i['dims']}")
        elif i["batched_1d"]:
            print(f"Data dimensions : ({self.spec.nr}, {self.spec.nc}) "
                  "[batched 1D transform]")
        else:
            print(f"Data dimensions : {self.spec.nc}")
        yn = {False: "no", True: "yes"}
        print(f"Wavelet name : {i['wavelet']}")
        print(f"Number of levels : {i['levels']}")
        print(f"Stationary WT : {yn[i['stationary']]}")
        print(f"Cycle spinning : {yn[i['cycle_spinning']]}")
        print(f"Separable transform : {yn[i['separable']]}")
        print(f"Boundary mode : {i['mode']}")
        print(f"Precision tier : {i['precision']}")
        print(f"Estimated memory footprint : {i['estimated_memory_mb']:.2f} MB")
        print(f"Running on device : {i['device']}")
        print("--------------------------------------------------")

    def __repr__(self):
        s = self.spec
        return (f"Wavelets({s.wname!r}, shape=({s.nr}, {s.nc}), ndim={s.ndim}, "
                f"levels={s.nlevels}, swt={s.do_swt}, separable={s.do_separable}, "
                f"cycle_spinning={s.do_cycle_spinning}, dtype={s.dtype}, "
                f"mode={s.mode}, precision={s.precision}, "
                f"state={self.state.value})")
