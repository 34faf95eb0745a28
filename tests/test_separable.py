"""Separable DWT/SWT: perfect reconstruction, oracle equality, backends."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import np_oracle as oracle
from pdwt_tpu.core import separable as S
from pdwt_tpu.filters import get_wavelet, list_wavelets

SHAPES_2D = [(64, 64), (65, 63), (37, 41)]


def _max_abs(tree_a, tree_b):
    return max(
        float(jnp.abs(a - b).max())
        for a, b in zip(jax.tree_util.tree_leaves(tree_a),
                        jax.tree_util.tree_leaves(tree_b))
    )


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_dwt2d_perfect_reconstruction(wname, shape, rng):
    w = get_wavelet(wname)
    levels = 3 if min(shape) >= 2 * (w.hlen - 1) * 4 else 1
    x = jnp.asarray(rng.standard_normal(shape))

    @jax.jit
    def roundtrip(x):
        return S.idwt2d(S.dwt2d(x, w, levels), w, shape)

    err = float(jnp.abs(roundtrip(x) - x).max())
    assert err < 1e-7, (wname, shape, err)


@pytest.mark.slow
def test_dwt1d_perfect_reconstruction_all72(rng):
    """Every wavelet in the bank, odd and even lengths, multi-level 1D."""
    x_even = jnp.asarray(rng.standard_normal((2, 256)))
    x_odd = jnp.asarray(rng.standard_normal((2, 257)))
    for name in list_wavelets():
        w = get_wavelet(name)
        for x in (x_even, x_odd):
            n = x.shape[-1]
            c = S.dwt1d(x, w, 2)
            xr = S.idwt1d(c, w, n)
            err = float(jnp.abs(xr - x).max())
            assert err < 1e-7, (name, n, err)


def test_dwt2d_matches_numpy_oracle(wname, rng):
    w = get_wavelet(wname)
    for shape in [(32, 32), (33, 31)]:
        x = rng.standard_normal(shape)
        a, h, v, d = oracle.dwt2_level(x, w.dec_lo, w.dec_hi)
        c = S.dwt2d(jnp.asarray(x), w, 1)
        np.testing.assert_allclose(np.asarray(c.approx), a, atol=1e-10)
        np.testing.assert_allclose(np.asarray(c.details[0][0]), h, atol=1e-10)
        np.testing.assert_allclose(np.asarray(c.details[0][1]), v, atol=1e-10)
        np.testing.assert_allclose(np.asarray(c.details[0][2]), d, atol=1e-10)
        # inverse oracle
        xr = oracle.idwt2_level(a, h, v, d, w.rec_lo, w.rec_hi, shape)
        xj = S.idwt2d(c, w, shape)
        np.testing.assert_allclose(np.asarray(xj), xr, atol=1e-10)


def test_backends_bit_identical(rng):
    w = get_wavelet("db5")
    x = jnp.asarray(rng.standard_normal((45, 52)))
    c1 = S.dwt2d(x, w, 2, backend="xla")
    c2 = S.dwt2d(x, w, 2, backend="gather")
    assert _max_abs(c1, c2) < 1e-12
    r1 = S.idwt2d(c1, w, (45, 52), backend="xla")
    r2 = S.idwt2d(c1, w, (45, 52), backend="gather")
    assert float(jnp.abs(r1 - r2).max()) < 1e-12


def test_coefficient_shapes(rng):
    w = get_wavelet("db7")
    x = jnp.asarray(rng.standard_normal((117, 93)))
    c = S.dwt2d(x, w, 2)
    assert c.approx.shape == (30, 24)  # 117->59->30, 93->47->24
    assert c.details[0][0].shape == (59, 47)
    assert c.details[1][0].shape == (30, 24)


def test_batched_dims(rng):
    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((3, 2, 40, 44)))
    c = S.dwt2d(x, w, 2)
    assert c.approx.shape == (3, 2, 10, 11)
    xr = S.idwt2d(c, w, (40, 44))
    assert float(jnp.abs(xr - x).max()) < 1e-7
    # batched equals per-sample
    c0 = S.dwt2d(x[1, 0], w, 2)
    assert float(jnp.abs(c.approx[1, 0] - c0.approx).max()) < 1e-12


def test_dwt1d_batch_is_rowwise(rng):
    """Batched 1D: each row transformed independently
    (reference: src/separable.cu:213-236)."""
    w = get_wavelet("sym8")
    x = jnp.asarray(rng.standard_normal((16, 128)))
    c = S.dwt1d(x, w, 3)
    c_row = S.dwt1d(x[5], w, 3)
    assert float(jnp.abs(c.approx[5] - c_row.approx).max()) < 1e-12
    assert c.approx.shape == (16, 16)
    assert c.details[0].shape == (16, 64)


def test_linearity(rng):
    w = get_wavelet("db4")
    x = jnp.asarray(rng.standard_normal((32, 32)))
    y = jnp.asarray(rng.standard_normal((32, 32)))
    ca = S.dwt2d(2.0 * x + y, w, 2)
    cb = jax.tree_util.tree_map(
        lambda a, b: 2.0 * a + b, S.dwt2d(x, w, 2), S.dwt2d(y, w, 2))
    assert _max_abs(ca, cb) < 1e-9


def test_energy_preservation_orthogonal(rng):
    """Orthogonal wavelets preserve the L2 norm on even sizes."""
    for name in ("db6", "sym5", "coif2"):
        w = get_wavelet(name)
        x = jnp.asarray(rng.standard_normal((64, 64)))
        c = S.dwt2d(x, w, 3)
        e = sum(float(jnp.sum(l**2)) for l in jax.tree_util.tree_leaves(c))
        assert abs(e - float(jnp.sum(x**2))) / e < 1e-10, name


def test_float32_accuracy_on_image_range(rng):
    """float32 recon error on [0,255] data stays at roundoff scale
    (the reference quotes ~1e-13 double / demo-scale accuracy,
    src/haar.cu:190-192)."""
    w = get_wavelet("db7")
    x = jnp.asarray(
        rng.uniform(0, 255, (256, 256)).astype(np.float32))
    c = S.dwt2d(x, w, 5)
    xr = S.idwt2d(c, w, (256, 256))
    assert xr.dtype == jnp.float32
    err = float(jnp.abs(xr - x).max())
    assert err < 5e-3, err  # ~2e-5 relative to the 255 range


@pytest.mark.slow
def test_tail_fusion_halo_wider_than_level(rng, monkeypatch):
    """Deep levels where the periodic halo exceeds the level size
    (long wavelet, tiny deepest level) must tile the wrap instead of
    crashing at trace time (regression: db18 128x128 levels=4)."""
    import jax.numpy as jnp

    w = get_wavelet("db18")  # hlen=36: wrap of 17 > 8x8 deepest level
    x = jnp.asarray(rng.standard_normal((1, 64, 128)), jnp.float32)
    cp = S.dwt2d(x, w, 3, backend="fma")
    cg = S.dwt2d(x, w, 3, backend="gather")
    err = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(cp), jax.tree_util.tree_leaves(cg)))
    assert err < 1e-4
    yp = S.idwt2d(cp, w, (64, 128), backend="fma")
    assert float(jnp.abs(yp - x).max()) < 1e-4
