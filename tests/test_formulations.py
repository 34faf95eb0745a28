"""The two device formulations (``xla`` grouped convolutions and ``fma``
polyphase slices) against the NumPy oracle, for every transform family
the GPU default is chosen on, over the representative wavelets."""
import numpy as np
import pytest

import jax.numpy as jnp

import np_oracle as O
from pdwt_tpu.core import separable as S
from pdwt_tpu.core import separable3d as S3
from pdwt_tpu.filters import get_wavelet

KINDS = ("dwt2d", "swt2d", "dwt1d", "dwt3d")
SHAPES = {"dwt2d": (23, 30), "swt2d": (20, 24), "dwt1d": (3, 37),
          "dwt3d": (6, 9, 10)}


def _axis_pass(x, w, axis, level=None):
    """Oracle analysis along ``axis``: (lo, hi) of the 1D level."""
    xt = np.moveaxis(x, axis, -1)
    if level is None:
        lo, hi = O.dwt1_level(xt, w.dec_lo, w.dec_hi)
    else:
        lo, hi = O.swt1_level(xt, w.dec_lo, w.dec_hi, level)
    return np.moveaxis(lo, -1, axis), np.moveaxis(hi, -1, axis)


def _oracle(kind, x, w):
    """Leaves in the engines' pytree order."""
    if kind == "dwt1d":
        lo1, hi1 = O.dwt1_level(x, w.dec_lo, w.dec_hi)
        lo2, hi2 = O.dwt1_level(lo1, w.dec_lo, w.dec_hi)
        return [lo2, hi1, hi2]
    if kind == "dwt2d":
        a1, h1, v1, d1 = O.dwt2_level(x, w.dec_lo, w.dec_hi)
        a2, h2, v2, d2 = O.dwt2_level(a1, w.dec_lo, w.dec_hi)
        return [a2, h1, v1, d1, h2, v2, d2]
    if kind == "swt2d":
        out, a = [], x
        for lvl in (1, 2):
            lo_c, hi_c = _axis_pass(a, w, -1, lvl)
            a, h = _axis_pass(lo_c, w, -2, lvl)
            v, d = _axis_pass(hi_c, w, -2, lvl)
            out.append((h, v, d))
        return [a] + [t for lvl in out for t in lvl]
    # dwt3d, one level: channel 4*k_col + 2*k_row + k_dep
    bands = {}
    for kc, tc in enumerate(_axis_pass(x, w, -1)):
        for kr, tr in enumerate(_axis_pass(tc, w, -2)):
            for kd, td in enumerate(_axis_pass(tr, w, -3)):
                bands[4 * kc + 2 * kr + kd] = td
    return [bands[k] for k in range(8)]


def _engine(kind, x, w, backend):
    if kind == "dwt1d":
        c = S.dwt1d(x, w, 2, backend=backend)
    elif kind == "dwt2d":
        c = S.dwt2d(x, w, 2, backend=backend)
    elif kind == "swt2d":
        c = S.swt2d(x, w, 2, backend=backend)
    else:
        c = S3.dwt3d(x, w, 1, backend=backend)
    if kind == "dwt1d":
        return [c.approx] + list(c.details)
    return [c.approx] + [t for lvl in c.details for t in lvl]


@pytest.mark.parametrize("kind", KINDS)
def test_xla_equals_fma_equals_oracle(kind, wname):
    w = get_wavelet(wname)
    x = np.random.default_rng(7).standard_normal(SHAPES[kind])
    ref = _oracle(kind, x, w)
    for backend in ("xla", "fma"):
        got = _engine(kind, jnp.asarray(x), w, backend)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.shape == r.shape, (backend, g.shape, r.shape)
            np.testing.assert_allclose(np.asarray(g), r, rtol=0,
                                       atol=1e-10, err_msg=backend)
