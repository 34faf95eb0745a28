"""Stationary (undecimated) wavelet transform tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import np_oracle as oracle
from pdwt_tpu.core import separable as S
from pdwt_tpu.filters import get_wavelet


def test_swt2d_perfect_reconstruction(wname, rng):
    w = get_wavelet(wname)
    for shape in [(48, 48), (47, 45)]:
        x = jnp.asarray(rng.standard_normal(shape))

        @jax.jit
        def roundtrip(x):
            return S.iswt2d(S.swt2d(x, w, 3), w)

        err = float(jnp.abs(roundtrip(x) - x).max())
        assert err < 1e-7, (wname, shape, err)


def test_swt1d_perfect_reconstruction(wname, rng):
    w = get_wavelet(wname)
    for n in (96, 97):
        x = jnp.asarray(rng.standard_normal((4, n)))
        xr = S.iswt1d(S.swt1d(x, w, 3), w)
        err = float(jnp.abs(xr - x).max())
        assert err < 1e-7, (wname, n, err)


def test_swt_sizes_are_undecimated(rng):
    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((30, 41)))
    c = S.swt2d(x, w, 3)
    assert c.approx.shape == (30, 41)
    for det in c.details:
        for band in det:
            assert band.shape == (30, 41)


def test_swt1d_matches_numpy_oracle(rng):
    w = get_wavelet("db4")
    x = rng.standard_normal((3, 50))
    lo, hi = oracle.swt1_level(x, w.dec_lo, w.dec_hi, level=1)
    lo2, hi2 = oracle.swt1_level(lo, w.dec_lo, w.dec_hi, level=2)
    c = S.swt1d(jnp.asarray(x), w, 2)
    np.testing.assert_allclose(np.asarray(c.details[0]), hi, atol=1e-10)
    np.testing.assert_allclose(np.asarray(c.details[1]), hi2, atol=1e-10)
    np.testing.assert_allclose(np.asarray(c.approx), lo2, atol=1e-10)


def test_swt_shift_equivariance(rng):
    """Undecimated transform commutes with circular shifts (the property
    cycle spinning approximates for the decimated DWT)."""
    w = get_wavelet("db2")
    x = jnp.asarray(rng.standard_normal((32, 32)))
    c_shifted = S.swt2d(jnp.roll(x, (5, 7), (0, 1)), w, 2)
    c = S.swt2d(x, w, 2)
    rolled = jax.tree_util.tree_map(
        lambda t: jnp.roll(t, (5, 7), (-2, -1)), c)
    err = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(c_shifted), jax.tree_util.tree_leaves(rolled)))
    assert err < 1e-9


def test_swt_deep_levels_dilation_exceeds_size(rng):
    """Dilated support larger than the signal must still wrap correctly
    (the reference's single-wrap boundary logic cannot go this deep; the
    mod-based formulation handles it)."""
    w = get_wavelet("db2")
    x = jnp.asarray(rng.standard_normal((8, 16)))
    c = S.swt2d(x, w, 4)  # level 4: dilation 8, support 25 > 8 rows
    xr = S.iswt2d(c, w)
    assert float(jnp.abs(xr - x).max()) < 1e-7


def test_iswt2d_denoise_fused_matches_unfused(rng, monkeypatch):
    """Threshold-then-inverse in one step (fma formulation) == threshold then
    iswt2d; thresholded_norm1 == norm1 of the thresholded pytree."""
    import jax
    import jax.numpy as jnp

    from pdwt_tpu import ops
    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet

    w = get_wavelet("db4")
    x = jnp.asarray(rng.standard_normal((1, 128, 128)) * 10,
                    jnp.float32)
    c = sep.swt2d(x, w, 2, backend="gather")
    thr_fns = {"soft": ops.soft_threshold, "hard": ops.hard_threshold,
               "garrote": ops.garrote_threshold}
    for mode in ("soft", "hard", "garrote"):
        for normalize in (False, True):
            c_thr = thr_fns[mode](c, 3.0, normalize=normalize)
            y_ref = sep.iswt2d(c_thr, w, backend="gather")
            y_fused = sep.iswt2d_denoise(c, w, 3.0, mode=mode,
                                         normalize=normalize,
                                         backend="fma")
            err = float(jnp.abs(y_fused - y_ref).max())
            assert err < 1e-4, (mode, normalize, err)
            n_ref = float(ops.norm1(c_thr))
            n_fast = float(ops.thresholded_norm1(c, 3.0, mode=mode,
                                                 normalize=normalize))
            assert abs(n_fast - n_ref) / max(n_ref, 1) < 1e-6


@pytest.mark.slow
def test_iswt2d_denoise_fused_grad(rng, monkeypatch):
    """jax.grad through the one-step threshold+inverse equals grad
    through the separate threshold->iswt2d composition —
    including the gradient w.r.t. beta on the soft path."""
    import jax
    import jax.numpy as jnp

    from pdwt_tpu import ops
    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet

    w = get_wavelet("db4")
    x = jnp.asarray(rng.standard_normal((1, 128, 128)) * 10, jnp.float32)

    thr_fns = {"soft": ops.soft_threshold, "hard": ops.hard_threshold,
               "garrote": ops.garrote_threshold}
    for mode in ("soft", "hard", "garrote"):
        def loss_fused(v, b):
            c = sep.swt2d(v, w, 2, backend="gather")
            y = sep.iswt2d_denoise(c, w, b, mode=mode, backend="fma")
            return jnp.sum(y ** 2)

        def loss_ref(v, b):
            c = sep.swt2d(v, w, 2, backend="gather")
            y = sep.iswt2d(thr_fns[mode](c, b), w, backend="gather")
            return jnp.sum(y ** 2)

        gx_f, gb_f = jax.grad(loss_fused, argnums=(0, 1))(x, 3.0)
        gx_r, gb_r = jax.grad(loss_ref, argnums=(0, 1))(x, 3.0)
        scale = float(jnp.abs(gx_r).max())
        assert float(jnp.abs(gx_f - gx_r).max()) / scale < 1e-5, mode
        assert abs(float(gb_f) - float(gb_r)) / max(abs(float(gb_r)), 1) \
            < 1e-5, mode


def test_swt_keep_approx_multires(rng):
    """keep_approx returns the per-level approximation stack (the
    reference TODO.txt's "return all app coeffs" multi-resolution
    feature): A_l equals the lowpass chain recomputed level by level,
    and the last entry is coeffs.approx."""
    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((32, 40)))
    c, approxs = S.swt2d(x, w, 3, keep_approx=True)
    assert len(approxs) == 3
    assert all(a.shape == x.shape for a in approxs)
    np.testing.assert_array_equal(np.asarray(approxs[-1]),
                                  np.asarray(c.approx))
    # A_l == swt2d(x, l).approx (the chain is level-prefix-stable)
    for lvl in (1, 2, 3):
        ref = S.swt2d(x, w, lvl).approx
        np.testing.assert_allclose(np.asarray(approxs[lvl - 1]),
                                   np.asarray(ref), rtol=0, atol=1e-12)
    # 1D variant
    s = jnp.asarray(rng.standard_normal((4, 64)))
    c1, ap1 = S.swt1d(s, w, 2, keep_approx=True)
    assert len(ap1) == 2 and ap1[-1].shape == s.shape
    np.testing.assert_array_equal(np.asarray(ap1[-1]), np.asarray(c1.approx))
    np.testing.assert_allclose(np.asarray(ap1[0]),
                               np.asarray(S.swt1d(s, w, 1).approx),
                               rtol=0, atol=1e-12)


def test_swt_keep_approx_interpret_pallas(rng, monkeypatch):
    """Both device formulations return the same multi-resolution
    stack."""
    w = get_wavelet("db2")
    x = jnp.asarray(rng.standard_normal((16, 128)), jnp.float32)
    c_ref, ap_ref = S.swt2d(x, w, 2, keep_approx=True, backend="fma")
    c_p, ap_p = S.swt2d(x, w, 2, keep_approx=True, backend="xla")
    assert len(ap_p) == 2
    for a, b in zip(ap_ref, ap_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-5)


def test_iswt2d_denoise_sequence_beta(rng, monkeypatch):
    """Per-level/per-band beta sequences route the fused entry point to
    the ops path on every backend (the kernels threshold a level with
    one scalar) — semantics match threshold-then-inverse."""
    import jax.numpy as jnp

    from pdwt_tpu import ops
    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet

    w = get_wavelet("db4")
    x = jnp.asarray(rng.standard_normal((128, 128)) * 10, jnp.float32)
    c = sep.swt2d(x, w, 2, backend="gather")
    betas = [(1.0, 2.0, 3.0), (4.0, 5.0, 6.0)]
    ref = sep.iswt2d(ops.soft_threshold(c, betas), w, backend="gather")
    got = sep.iswt2d_denoise(c, w, betas, backend="fma")
    assert float(jnp.abs(got - ref).max()) < 1e-4


def test_modwt_energy_partition_and_roundtrip(rng):
    """filters.modwt_wavelet: the rescaled bank turns the SWT into the
    maximal-overlap DWT — for an orthonormal mother wavelet the periodic
    MODWT partitions the signal energy exactly (Percival & Walden):
    ||x||^2 == ||approx_J||^2 + sum_j ||detail_j||^2 — and perfect
    reconstruction is preserved (the rescale is PR-neutral)."""
    from pdwt_tpu.filters import modwt_wavelet

    mw = modwt_wavelet("db4")
    x = jnp.asarray(rng.standard_normal(256), jnp.float64)
    c = S.swt1d(x, mw, 3)
    e = float(jnp.sum(c.approx**2)
              + sum(jnp.sum(d**2) for d in c.details))
    assert abs(e - float(jnp.sum(x**2))) / e < 1e-11
    y = S.iswt1d(c, mw)
    assert float(jnp.abs(y - x).max()) < 1e-10

    # 2D: energy partition over the 3 detail bands per level + PR
    img = jnp.asarray(rng.standard_normal((64, 64)), jnp.float64)
    c2 = S.swt2d(img, mw, 2)
    e2 = float(jnp.sum(c2.approx**2)
               + sum(jnp.sum(b**2) for lvl in c2.details for b in lvl))
    assert abs(e2 - float(jnp.sum(img**2))) / e2 < 1e-11
    y2 = S.iswt2d(c2, mw)
    assert float(jnp.abs(y2 - img).max()) < 1e-10

    # level-1 MODWT coefficients are exactly the 1/sqrt(2) rescale of
    # the unnormalized SWT's
    w = get_wavelet("db4")
    cu = S.swt1d(x, w, 2)
    cm = S.swt1d(x, mw, 2)
    assert float(jnp.abs(cm.details[0]
                         - cu.details[0] * 0.5 ** 0.5).max()) < 1e-10
