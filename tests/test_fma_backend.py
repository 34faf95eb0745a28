"""The `fma` backend must match the gather oracle bit-semantics.

Kept small: the broad semantic sweeps run on the platform-default backend;
this module pins fma == gather on representative parities/sizes so the
GPU's default formulation is covered by the CPU suite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu.core import separable as S
from pdwt_tpu.filters import get_wavelet


def _max_abs(a, b):
    return max(
        float(jnp.abs(x - y).max())
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


@pytest.mark.parametrize("wname", ["haar", "db7", "bior3.1", "sym8"])
def test_fma_dwt2d_matches_gather(rng, wname):
    w = get_wavelet(wname)
    shape = (33, 41)
    x = jnp.asarray(rng.standard_normal(shape))
    cf = S.dwt2d(x, w, 2, backend="fma")
    cg = S.dwt2d(x, w, 2, backend="gather")
    assert _max_abs(cf, cg) < 1e-12
    rf = S.idwt2d(cf, w, shape, backend="fma")
    rg = S.idwt2d(cg, w, shape, backend="gather")
    assert float(jnp.abs(rf - rg).max()) < 1e-12
    assert float(jnp.abs(rf - x).max()) < 1e-10


@pytest.mark.parametrize("wname", ["db7", "bior4.4"])
def test_fma_swt2d_matches_gather(rng, wname):
    w = get_wavelet(wname)
    x = jnp.asarray(rng.standard_normal((40, 56)))
    cf = S.swt2d(x, w, 3, backend="fma")
    cg = S.swt2d(x, w, 3, backend="gather")
    assert _max_abs(cf, cg) < 1e-12
    rf = S.iswt2d(cf, w, backend="fma")
    assert float(jnp.abs(rf - x).max()) < 1e-10


def test_fma_1d_matches_gather(rng):
    w = get_wavelet("db20")  # longest filter: 40 taps
    x = jnp.asarray(rng.standard_normal((3, 129)))
    cf = S.dwt1d(x, w, 1, backend="fma")
    cg = S.dwt1d(x, w, 1, backend="gather")
    assert _max_abs(cf, cg) < 1e-12
    rf = S.idwt1d(cf, w, 129, backend="fma")
    assert float(jnp.abs(rf - x).max()) < 1e-10
    sf = S.swt1d(x, w, 1, backend="fma")
    sg = S.swt1d(x, w, 1, backend="gather")
    assert _max_abs(sf, sg) < 1e-12
