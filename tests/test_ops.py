"""Thresholding / norms / shift operators vs plain numpy."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu import ops
from pdwt_tpu.core import separable as S
from pdwt_tpu.filters import get_wavelet

SQRT2 = math.sqrt(2.0)


@pytest.fixture
def coeffs2d(rng):
    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((32, 32)))
    return S.dwt2d(x, w, 3)


@pytest.fixture
def coeffs1d(rng):
    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((4, 64)))
    return S.dwt1d(x, w, 3)


def _np_soft(x, b):
    return np.sign(x) * np.maximum(np.abs(x) - b, 0)


def test_soft_threshold_values(coeffs2d):
    beta = 0.5
    out = ops.soft_threshold(coeffs2d, beta)
    for lvl in range(3):
        for band in range(3):
            np.testing.assert_allclose(
                np.asarray(out.details[lvl][band]),
                _np_soft(np.asarray(coeffs2d.details[lvl][band]), beta),
                atol=1e-12)
    # approx untouched by default
    np.testing.assert_array_equal(np.asarray(out.approx),
                                  np.asarray(coeffs2d.approx))


def test_soft_threshold_appcoeffs_and_normalize(coeffs2d):
    beta = 0.8
    out = ops.soft_threshold(coeffs2d, beta, do_thresh_appcoeffs=True,
                             normalize=True)
    # level i (1-based) uses beta / sqrt(2)^i (reference: src/common.cu:244)
    for lvl in range(3):
        np.testing.assert_allclose(
            np.asarray(out.details[lvl][0]),
            _np_soft(np.asarray(coeffs2d.details[lvl][0]),
                     beta / SQRT2 ** (lvl + 1)),
            atol=1e-12)
    # approx uses beta / sqrt(2)^nlevels (reference: src/common.cu:231-234)
    np.testing.assert_allclose(
        np.asarray(out.approx),
        _np_soft(np.asarray(coeffs2d.approx), beta / SQRT2 ** 3),
        atol=1e-12)


def test_hard_threshold(coeffs1d):
    beta = 0.7
    out = ops.hard_threshold(coeffs1d, beta)
    for lvl in range(3):
        ref = np.asarray(coeffs1d.details[lvl])
        np.testing.assert_allclose(
            np.asarray(out.details[lvl]), np.where(np.abs(ref) > beta, ref, 0),
            atol=1e-12)


def test_proj_linf(coeffs2d):
    beta = 0.3
    out = ops.proj_linf(coeffs2d, beta)
    for leaf in jax.tree_util.tree_leaves(out):
        assert float(jnp.abs(leaf).max()) <= beta + 1e-12
    # sign preserved
    h0 = np.asarray(coeffs2d.details[0][0])
    h0_out = np.asarray(out.details[0][0])
    mask = np.abs(h0) > 1e-9
    assert np.all(np.sign(h0[mask]) == np.sign(h0_out[mask]))


def test_group_soft_threshold(coeffs2d):
    beta = 0.4
    out = ops.group_soft_threshold(coeffs2d, beta, do_thresh_appcoeffs=True)
    h, v, d = (np.asarray(t) for t in coeffs2d.details[1])
    norm = np.sqrt(h * h + v * v + d * d)
    fac = np.where(norm > 0, np.maximum(1 - beta / norm, 0), 0)
    np.testing.assert_allclose(np.asarray(out.details[1][0]), h * fac,
                               atol=1e-12)
    # approx joins the group only at the coarsest level
    h, v, d = (np.asarray(t) for t in coeffs2d.details[2])
    a = np.asarray(coeffs2d.approx)
    norm = np.sqrt(h * h + v * v + d * d + a * a)
    fac = np.where(norm > 0, np.maximum(1 - beta / norm, 0), 0)
    np.testing.assert_allclose(np.asarray(out.approx), a * fac, atol=1e-12)


def test_shrink(coeffs2d):
    beta = 1.5
    out = ops.shrink(coeffs2d, beta)
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(coeffs2d)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b) / 2.5,
                                   atol=1e-12)


def test_norms(coeffs2d):
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(coeffs2d)]
    n1 = sum(np.abs(l).sum() for l in leaves)
    n2 = sum((l ** 2).sum() for l in leaves)
    assert abs(float(ops.norm1(coeffs2d)) - n1) < 1e-8
    assert abs(float(ops.norm2sq(coeffs2d)) - n2) < 1e-8


def test_norm_l21(coeffs2d):
    """L2,1 norm matches numpy over group_soft_threshold's grouping, and
    the fused thresholded variant equals norm_l21 of the thresholded
    pytree (for both appcoeffs conventions and normalize)."""
    for app in (False, True):
        expect = 0.0
        for i, det in enumerate(coeffs2d.details):
            bands = [np.asarray(t) for t in det]
            n2 = sum(t * t for t in bands)
            if app and i == coeffs2d.levels - 1:
                n2 = n2 + np.asarray(coeffs2d.approx) ** 2
            expect += np.sqrt(n2).sum()
        if not app:
            expect += np.abs(np.asarray(coeffs2d.approx)).sum()
        got = float(ops.norm_l21(coeffs2d, do_thresh_appcoeffs=app))
        assert abs(got - expect) < 1e-8

        for normalize in (False, True):
            beta = 0.4
            thr = ops.group_soft_threshold(coeffs2d, beta,
                                           do_thresh_appcoeffs=app,
                                           normalize=normalize)
            slow = float(ops.norm_l21(thr, do_thresh_appcoeffs=app))
            fast = float(ops.thresholded_norm_l21(coeffs2d, beta,
                                                  normalize=normalize,
                                                  do_thresh_appcoeffs=app))
            assert abs(fast - slow) < 1e-8, (app, normalize)


def test_add_coeffs(coeffs2d):
    out = ops.add_coeffs(coeffs2d, coeffs2d, alpha=-1.0)
    for leaf in jax.tree_util.tree_leaves(out):
        assert float(jnp.abs(leaf).max()) == 0.0
    out = ops.add_coeffs(coeffs2d, coeffs2d, alpha=2.0)
    np.testing.assert_allclose(np.asarray(out.approx),
                               3 * np.asarray(coeffs2d.approx), atol=1e-12)


def test_circshift(rng):
    x = np.arange(12, dtype=np.float64).reshape(3, 4)
    out = np.asarray(ops.circshift2d(jnp.asarray(x), 1, 2))
    # out[y,x] = in[(y-1) mod 3, (x-2) mod 4] (reference: src/common.cu:202-211)
    ref = np.empty_like(x)
    for y in range(3):
        for xx in range(4):
            ref[y, xx] = x[(y - 1) % 3, (xx - 2) % 4]
    np.testing.assert_array_equal(out, ref)
    # inverse shift restores
    back = np.asarray(ops.circshift2d(jnp.asarray(out), -1, -2))
    np.testing.assert_array_equal(back, x)


def test_threshold_norm_pipeline_jits(coeffs2d):
    """The regularization inner loop (threshold + norm1) as one jitted
    program — the reference needs 3*levels cublas calls with host syncs
    (src/wt.cu:398-418); here it is a single device program."""

    @jax.jit
    def step(c, beta):
        c = ops.soft_threshold(c, beta)
        return c, ops.norm1(c)

    c, n = step(coeffs2d, 0.1)
    assert np.isfinite(float(n))


def test_checkpoint_roundtrip(tmp_path, rng):
    """Coefficient save/load (SURVEY.md §5 checkpoint parity)."""
    import jax
    import jax.numpy as jnp
    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet
    from pdwt_tpu.utils import load_coeffs, save_coeffs

    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((40, 56)))
    c = sep.dwt2d(x, w, 2)
    p = str(tmp_path / "c2d.npz")
    save_coeffs(p, c)
    c2 = load_coeffs(p)
    assert c2.levels == c.levels
    for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c2)):
        assert jnp.abs(a - jnp.asarray(b)).max() == 0
    # 1D
    s = jnp.asarray(rng.standard_normal((3, 64)))
    c1 = sep.dwt1d(s, w, 2)
    p1 = str(tmp_path / "c1d.npz")
    save_coeffs(p1, c1)
    c1b = load_coeffs(p1)
    for a, b in zip(jax.tree.leaves(c1), jax.tree.leaves(c1b)):
        assert jnp.abs(a - jnp.asarray(b)).max() == 0


def test_debug_sanitizers(rng):
    """NaN guard (checkify) + coefficient geometry audit."""
    import jax.numpy as jnp
    import numpy as np
    import pytest as _pytest

    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet
    from pdwt_tpu.utils import assert_finite, checked, validate_coeffs

    f = checked(lambda x: (assert_finite(x, "input"), x * 2)[1])
    assert float(f(jnp.ones(3))[0]) == 2.0
    with _pytest.raises(Exception, match="NaN/Inf"):
        f(jnp.array([1.0, float("nan")]))

    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((37, 53)), jnp.float32)
    c = sep.dwt2d(x, w, 2)
    validate_coeffs(c, 37, 53, levels=2)            # passes
    with _pytest.raises(ValueError, match="levels"):
        validate_coeffs(c, 37, 53, levels=3)
    bad = type(c)(c.approx[..., :-1], c.details)
    with _pytest.raises(ValueError, match="approx"):
        validate_coeffs(bad, 37, 53, levels=2)
    c1 = sep.swt1d(x[0], w, 2)
    validate_coeffs(c1, 53, levels=2, swt=True)


def test_checkpoint_roundtrip_bf16(tmp_path, rng, monkeypatch):
    """bf16-tier coefficient pytrees, and pytrees mixing f32 and bf16
    leaves, must survive the npz round-trip exactly — npz has no
    bfloat16 descriptor, so the checkpoint tags and views them as
    uint16."""
    import jax
    import jax.numpy as jnp

    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet
    from pdwt_tpu.utils.checkpoint import load_coeffs, save_coeffs

    w = get_wavelet("db4")
    x = jnp.asarray(rng.uniform(0, 255, (256, 256)),
                    jnp.float32).astype(jnp.bfloat16)
    c = sep.dwt2d(x, w, 2, backend="fma")
    assert all(t.dtype == jnp.bfloat16 for t in jax.tree.leaves(c))
    c = type(c)(c.approx.astype(jnp.float32), c.details)  # mixed dtypes
    p = str(tmp_path / "c.npz")
    save_coeffs(p, c)
    c2 = load_coeffs(p)
    assert c2.approx.dtype == np.float32
    assert c2.details[0][0].dtype.name == "bfloat16"
    for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c2)):
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# new threshold types + estimators (reference TODO.txt "More threshold types")
# ---------------------------------------------------------------------------


def test_garrote_threshold_values(coeffs2d):
    beta = 0.5
    out = ops.garrote_threshold(coeffs2d, beta)
    for lvl in range(3):
        for band in range(3):
            x = np.asarray(coeffs2d.details[lvl][band])
            ref = np.where(np.abs(x) > beta, x - beta * beta / x, 0.0)
            np.testing.assert_allclose(
                np.asarray(out.details[lvl][band]), ref, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.approx),
                                  np.asarray(coeffs2d.approx))
    # finite gradient through the kink and at zero
    g = jax.grad(lambda c: ops.norm2sq(ops.garrote_threshold(c, 0.5)))(
        coeffs2d)
    assert np.isfinite(np.asarray(g.details[0][0])).all()


def test_firm_threshold_values(coeffs2d):
    b1, b2 = 0.3, 0.9
    out = ops.firm_threshold(coeffs2d, b1, b2)
    for lvl in range(3):
        for band in range(3):
            x = np.asarray(coeffs2d.details[lvl][band])
            ax = np.abs(x)
            ref = np.where(ax <= b1, 0.0,
                           np.where(ax >= b2, x,
                                    np.sign(x) * b2 * (ax - b1) / (b2 - b1)))
            np.testing.assert_allclose(
                np.asarray(out.details[lvl][band]), ref, atol=1e-12)
    # firm with b2 -> b1^+ approaches hard threshold
    out_h = ops.firm_threshold(coeffs2d, 0.5, 0.5 + 1e-9)
    ref_h = ops.hard_threshold(coeffs2d, 0.5)
    np.testing.assert_allclose(np.asarray(out_h.details[1][1]),
                               np.asarray(ref_h.details[1][1]), atol=1e-6)


def test_threshold_per_level_and_per_band_beta(coeffs2d, coeffs1d):
    betas = [(0.1, 0.2, 0.3), (0.4, 0.5, 0.6), (0.7, 0.8, 0.9)]
    out = ops.soft_threshold(coeffs2d, betas)
    for lvl in range(3):
        for band in range(3):
            np.testing.assert_allclose(
                np.asarray(out.details[lvl][band]),
                _np_soft(np.asarray(coeffs2d.details[lvl][band]),
                         betas[lvl][band]), atol=1e-12)
    # per-level scalars for 1D pytrees; appcoeffs take the coarsest entry
    out1 = ops.hard_threshold(coeffs1d, [0.2, 0.4, 0.8],
                              do_thresh_appcoeffs=True)
    x = np.asarray(coeffs1d.details[2])
    np.testing.assert_allclose(np.asarray(out1.details[2]),
                               np.where(np.abs(x) > 0.8, x, 0), atol=1e-12)
    a = np.asarray(coeffs1d.approx)
    np.testing.assert_allclose(np.asarray(out1.approx),
                               np.where(np.abs(a) > 0.8, a, 0), atol=1e-12)


def test_noise_sigma_and_universal(rng):
    w = get_wavelet("db4")
    sigma = 7.0
    x = jnp.asarray(rng.standard_normal((256, 256)) * sigma, jnp.float32)
    c = S.dwt2d(x, w, 3)
    est = float(ops.noise_sigma(c))
    assert abs(est - sigma) / sigma < 0.05, est
    n = sum(int(b.size) for det in c.details for b in det)
    ut = float(ops.universal_threshold(c))
    assert abs(ut - est * math.sqrt(2 * math.log(n))) < 1e-3
    # explicit sigma wins
    assert abs(float(ops.universal_threshold(c, jnp.float32(1.0)))
               - math.sqrt(2 * math.log(n))) < 1e-5


def test_bayes_thresholds_structure_and_denoise(rng):
    w = get_wavelet("db4")
    # piecewise-constant signal + noise: BayesShrink should beat doing
    # nothing by a wide margin
    clean = np.zeros((128, 128), np.float32)
    clean[32:96, 32:96] = 100.0
    noisy = jnp.asarray(clean + rng.standard_normal((128, 128)) * 10.0,
                        jnp.float32)
    c = S.dwt2d(noisy, w, 3)
    betas = ops.bayes_thresholds(c)
    assert len(betas) == 3 and all(len(b) == 3 for b in betas)
    den = S.idwt2d(ops.soft_threshold(c, list(betas)), w, (128, 128))
    mse_n = float(jnp.mean((noisy - clean) ** 2))
    mse_d = float(jnp.mean((den - clean) ** 2))
    assert mse_d < 0.5 * mse_n, (mse_d, mse_n)


def test_auto_denoise_model(rng):
    from pdwt_tpu.models import auto_denoise

    clean = np.zeros((128, 128), np.float32)
    clean[32:96, 32:96] = 100.0
    noisy = jnp.asarray(clean + rng.standard_normal((128, 128)) * 10.0,
                        jnp.float32)
    mse_n = float(jnp.mean((noisy - clean) ** 2))
    for method, swt in (("bayes", False), ("universal", False),
                        ("bayes", True)):
        den = jax.jit(lambda x, m=method, s=swt: auto_denoise(
            x, "db4", 3, method=m, swt=s))(noisy)
        mse_d = float(jnp.mean((den - clean) ** 2))
        assert mse_d < 0.6 * mse_n, (method, swt, mse_d, mse_n)
    with pytest.raises(ValueError):
        auto_denoise(noisy, "db4", 3, method="nope")


def test_sure_thresholds(rng):
    """SURE picks ~0 on pure signal (keep everything), large on pure
    noise; the risk minimizer matches a brute-force SURE scan."""
    w = get_wavelet("db4")
    # pure noise: hybrid picks substantial thresholds
    noise = jnp.asarray(rng.standard_normal((128, 128)) * 5.0, jnp.float32)
    cn = S.dwt2d(noise, w, 2)
    tn = ops.sure_thresholds(cn)
    assert len(tn) == 2 and all(len(t) == 3 for t in tn)
    assert all(float(t) > 3.0 for lvl in tn for t in lvl), tn

    # brute-force cross-check on one band (non-hybrid exact argmin)
    d = np.asarray(cn.details[0][2]).ravel()
    s = float(ops.noise_sigma(cn)) ** 2
    cands = np.concatenate([[0.0], np.abs(d)])
    best = min(
        float(len(d) * s - 2 * s * (np.abs(d) <= t).sum()
              + np.minimum(d * d, t * t).sum())
        for t in cands)
    t_lib = float(ops.sure_thresholds(cn, hybrid=False)[0][2])
    got = float(len(d) * s - 2 * s * (np.abs(d) <= t_lib).sum()
                + np.minimum(d * d, t_lib * t_lib).sum())
    assert abs(got - best) <= 1e-3 * abs(best) + 1e-6

    # denoising quality: auto_denoise(sure) beats the noisy input
    from pdwt_tpu.models import auto_denoise

    clean = np.zeros((128, 128), np.float32)
    clean[32:96, 32:96] = 100.0
    noisy = jnp.asarray(clean + rng.standard_normal((128, 128)) * 10.0,
                        jnp.float32)
    den = jax.jit(lambda x: auto_denoise(x, "db4", 3, method="sure"))(noisy)
    mse_n = float(jnp.mean((noisy - clean) ** 2))
    mse_d = float(jnp.mean((den - clean) ** 2))
    assert mse_d < 0.5 * mse_n, (mse_d, mse_n)


def test_thresholded_norm1_garrote(coeffs2d):
    n_ref = float(ops.norm1(ops.garrote_threshold(coeffs2d, 0.5)))
    n_fast = float(ops.thresholded_norm1(coeffs2d, 0.5, mode="garrote"))
    assert abs(n_fast - n_ref) / n_ref < 1e-10
