"""Haar fast path: exactness, known values, equality with the conv engine."""
import jax
import jax.numpy as jnp
import numpy as np

from pdwt_tpu.core import haar as H
from pdwt_tpu.core import separable as S
from pdwt_tpu.filters import get_wavelet


def test_haar2d_known_values():
    x = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    c = H.haar_dwt2d(x, 1)
    # a = (1+2+3+4)/2, h = ((1-3)+(2-4))/2, v = ((1+3)-(2+4))/2, d = ((1-3)-(2-4))/2
    assert np.allclose(np.asarray(c.approx), [[5.0]])
    assert np.allclose(np.asarray(c.details[0][0]), [[-2.0]])  # H: along rows
    assert np.allclose(np.asarray(c.details[0][1]), [[-1.0]])  # V: along cols
    assert np.allclose(np.asarray(c.details[0][2]), [[0.0]])


def test_haar1d_known_values():
    x = jnp.asarray([1.0, 3.0])
    c = H.haar_dwt1d(x, 1)
    s = 1 / np.sqrt(2)
    assert np.allclose(np.asarray(c.approx), [4 * s])
    assert np.allclose(np.asarray(c.details[0]), [-2 * s])


def test_haar2d_pr_exact(rng):
    """2D haar fwd+inv is exact to double roundoff
    (the reference quotes ~1e-13 on [0,255], src/haar.cu:190-192)."""
    x = jnp.asarray(rng.uniform(0, 255, (128, 128)))
    xr = H.haar_idwt2d(H.haar_dwt2d(x, 4), (128, 128))
    assert float(jnp.abs(xr - x).max()) < 1e-12


def test_haar1d_pr_exact(rng):
    """Unlike the reference 1D haar (known FIXME, ~1e-5 error,
    src/haar.cu:190-192), this path is exact."""
    x = jnp.asarray(rng.uniform(0, 255, (4, 1024)))
    xr = H.haar_idwt1d(H.haar_dwt1d(x, 5), 1024)
    assert float(jnp.abs(xr - x).max()) < 1e-10


def test_haar_equals_separable_engine(rng):
    w = get_wavelet("haar")
    for shape in [(32, 32), (31, 33)]:
        x = jnp.asarray(rng.standard_normal(shape))
        cf = H.haar_dwt2d(x, 2)
        cs = S.dwt2d(x, w, 2)
        err = max(float(jnp.abs(a - b).max()) for a, b in zip(
            jax.tree_util.tree_leaves(cf), jax.tree_util.tree_leaves(cs)))
        assert err < 1e-12, shape


def test_haar_odd_sizes(rng):
    x = jnp.asarray(rng.standard_normal((7, 9)))
    c = H.haar_dwt2d(x, 1)
    assert c.approx.shape == (4, 5)
    xr = H.haar_idwt2d(c, (7, 9))
    assert float(jnp.abs(xr - x).max()) < 1e-12
