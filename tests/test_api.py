"""Stateful Wavelets facade: construction rules, state machine, get/set,
custom filters, cycle spinning — API parity with the reference class."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu import Wavelets
from pdwt_tpu.api import WState
from pdwt_tpu.filters import get_wavelet


def _image(rng, shape=(64, 64)):
    return rng.uniform(0, 255, shape)


def test_forward_inverse_roundtrip(rng):
    img = _image(rng)
    W = Wavelets(img, wname="db7", levels=3, dtype=jnp.float64)
    W.forward()
    assert W.state == WState.FORWARD
    # overwrite the image to prove inverse() reads only the coefficients
    # (the reference demo's zeroed-image trick, src/demo.cpp:208-214)
    W.set_image(np.zeros_like(img))
    out = W.inverse()
    assert W.state == WState.INVERSE
    assert np.abs(np.asarray(out) - img).max() < 1e-9


def test_denoise_scenario(rng):
    """Demo scenario 3: forward + soft_threshold + inverse
    (reference: src/demo.cpp:201-205)."""
    img = _image(rng)
    W = Wavelets(img, wname="db7", levels=3)
    W.forward()
    n1_before = W.norm1()
    l21_before = W.norm_l21()
    assert 0 < l21_before <= n1_before + 1e-3  # group L2 <= sum of L1s
    W.soft_threshold(90.0)
    assert W.norm1() < n1_before
    assert W.norm_l21() < l21_before
    out = W.inverse()
    assert np.isfinite(np.asarray(out)).all()


def test_levels_clamped(rng):
    with pytest.warns(UserWarning, match="maximum possible level"):
        W = Wavelets(_image(rng, (64, 64)), wname="db7", levels=99)
    # wmaxlev = ilog2(64 / 13) = 2 (reference: src/wt.cu:159)
    assert W.spec.nlevels == 2


def test_levels_lt_1_forced(rng):
    with pytest.warns(UserWarning, match="nlevels"):
        W = Wavelets(_image(rng), wname="haar", levels=0)
    assert W.spec.nlevels == 1


def test_1d_autodetect(rng):
    W = Wavelets(rng.standard_normal(128), wname="db3", levels=2)
    assert W.spec.ndim == 1
    W.forward()
    out = W.inverse()
    assert out.shape == (1, 128)


def test_batched_1d(rng):
    x = rng.standard_normal((16, 256))
    W = Wavelets(x, wname="sym8", levels=3, ndim=1)
    W.forward()
    assert W.coeffs.approx.shape == (16, 32)
    out = np.asarray(W.inverse())
    assert np.abs(out - x).max() < 1e-4


def test_1d_nonseparable_forced_separable(rng):
    with pytest.warns(UserWarning, match="non-separable"):
        W = Wavelets(rng.standard_normal((1, 64)), wname="db2", levels=2,
                     do_separable=False, ndim=1)
    assert W.spec.do_separable


def test_cycle_spinning_1d_rejected(rng):
    with pytest.raises(ValueError, match="cycle spinning"):
        Wavelets(rng.standard_normal((1, 64)), wname="db2", levels=1,
                 do_cycle_spinning=True, ndim=1)


def test_cycle_spinning_roundtrip(rng):
    img = _image(rng)
    W = Wavelets(img, wname="db4", levels=2, do_cycle_spinning=True,
                 dtype=jnp.float64, seed=7)
    W.forward()
    assert (W.current_shift_r, W.current_shift_c) != (0, 0)
    out = np.asarray(W.inverse())
    assert np.abs(out - img).max() < 1e-9


def test_cycle_spinning_swt_warns(rng):
    with pytest.warns(UserWarning, match="Cycle spinning|cycle spinning"):
        Wavelets(_image(rng), wname="db2", levels=1, do_swt=True,
                 do_cycle_spinning=True)


def test_unknown_wavelet_raises(rng):
    with pytest.raises(ValueError, match="unknown wavelet"):
        Wavelets(_image(rng), wname="nosuch", levels=1)


def test_threshold_after_inverse_warns(rng):
    W = Wavelets(_image(rng), wname="db2", levels=2)
    W.forward()
    W.inverse()
    with pytest.warns(UserWarning, match="modified by"):
        W.soft_threshold(1.0)


def test_inverse_twice_warns(rng):
    W = Wavelets(_image(rng), wname="db2", levels=2)
    W.forward()
    W.inverse()
    with pytest.warns(UserWarning, match="already been run"):
        W.inverse()


def test_get_coeff_numbering(rng):
    """2D numbering: 0=A, (H1,V1,D1)=1,2,3, (H2,V2,D2)=4,5,6
    (reference: src/wt.cu:442-449)."""
    W = Wavelets(_image(rng, (64, 48)), wname="db2", levels=2)
    W.forward()
    assert W.get_coeff(0).shape == (16, 12)
    assert W.get_coeff(1).shape == (32, 24)
    assert W.get_coeff(4).shape == (16, 12)
    assert np.array_equal(W.get_coeff(0), np.asarray(W.coeffs.approx))
    assert np.array_equal(W.get_coeff(5), np.asarray(W.coeffs.details[1][1]))
    with pytest.raises(IndexError):
        W.get_coeff(7)


def test_get_coeff_after_inverse_warns(rng):
    W = Wavelets(_image(rng), wname="db2", levels=1)
    W.forward()
    W.inverse()
    with pytest.warns(UserWarning, match="get_coeff"):
        assert W.get_coeff(0) is None


def test_set_coeff_roundtrip(rng):
    W = Wavelets(_image(rng), wname="db3", levels=2, dtype=jnp.float64)
    W.forward()
    a = W.get_coeff(0)
    W.set_coeff(np.zeros_like(a), 0)
    assert np.abs(W.get_coeff(0)).max() == 0
    W.set_coeff(a, 0)
    np.testing.assert_array_equal(W.get_coeff(0), a)


def test_set_get_image(rng):
    img = _image(rng)
    W = Wavelets(nr=64, nc=64, wname="haar", levels=1)
    W.set_image(img)
    np.testing.assert_allclose(W.get_image(), img, atol=1e-4)
    assert W.state == WState.INIT


def test_add_wavelet(rng):
    img = _image(rng)
    W1 = Wavelets(img, wname="db2", levels=2, dtype=jnp.float64)
    W2 = Wavelets(img, wname="db2", levels=2, dtype=jnp.float64)
    W1.forward()
    W2.forward()
    W1.add_wavelet(W2, alpha=1.0)  # coefficients doubled
    out = np.asarray(W1.inverse())
    assert np.abs(out - 2 * img).max() < 1e-8


def test_add_wavelet_mismatch(rng):
    W1 = Wavelets(_image(rng), wname="db2", levels=2)
    W2 = Wavelets(_image(rng), wname="db3", levels=2)
    with pytest.raises(ValueError, match="same transform"):
        W1.add_wavelet(W2)


def test_custom_filters_legall53(rng):
    """LeGall 5/3 as a custom biorthogonal bank (the reference demo's
    worked example, src/demo.cpp:141-179)."""
    dec_lo = np.array([0.0, -1 / 8, 2 / 8, 6 / 8, 2 / 8, -1 / 8])
    dec_hi = np.array([0.0, -0.5, 1.0, -0.5, 0.0, 0.0])
    rec_lo = np.array([0.0, 0.5, 1.0, 0.5, 0.0, 0.0])
    rec_hi = np.array([0.0, -1 / 8, -2 / 8, 6 / 8, -2 / 8, -1 / 8])
    img = _image(rng)
    W = Wavelets(img, wname="db2", levels=2, dtype=jnp.float64)
    W.set_filters_forward("LeGall 5/3", dec_lo, dec_hi)
    W.set_filters_inverse(rec_lo, rec_hi)
    assert W.spec.hlen == 6
    W.forward()
    out = np.asarray(W.inverse())
    assert np.abs(out - img).max() < 1e-9


def test_custom_filters_beyond_reference_cap(rng):
    """set_filters accepts >40 taps (the reference's TODO.txt wish) and
    the resulting 44-tap PR bank round-trips through the facade."""
    from pdwt_tpu.filters import get_wavelet

    w = get_wavelet("db20")
    pad = lambda f: np.concatenate([np.zeros(2), f, np.zeros(2)])
    img = _image(rng, (128, 128))  # max_level(128, hlen=44) == 1
    W = Wavelets(img, wname="db2", levels=1, dtype=jnp.float64)
    W.set_filters_forward("big44", pad(w.dec_lo), pad(w.dec_hi))
    W.set_filters_inverse(pad(w.rec_lo), pad(w.rec_hi))
    assert W.spec.hlen == 44
    W.forward()
    out = np.asarray(W.inverse())
    assert np.abs(out - img).max() < 1e-7


def test_nonseparable_custom_quads(rng):
    w = get_wavelet("db3")
    img = _image(rng)
    W = Wavelets(img, wname="db3", levels=2, do_separable=False,
                 dtype=jnp.float64)
    W.forward()
    out = np.asarray(W.inverse())
    assert np.abs(out - img).max() < 1e-7  # [0,255] data, table-limited


def test_info_and_repr(rng):
    W = Wavelets(_image(rng), wname="db7", levels=2, do_swt=True)
    i = W.info()
    assert i["wavelet"] == "db7"
    assert i["stationary"]
    # SWT 2D memory estimate: (3n+4) * Nr * Nc * itemsize
    # (reference: src/wt.cu:535-539)
    assert i["estimated_memory_mb"] == pytest.approx(
        (3 * 2 + 4) * 64 * 64 * 4 / 1e6)
    assert "db7" in repr(W)
    W.print_informations()


def test_swt_api_roundtrip(rng):
    img = _image(rng)
    W = Wavelets(img, wname="sym4", levels=3, do_swt=True, dtype=jnp.float64)
    W.forward()
    assert W.get_coeff(1).shape == (64, 64)  # undecimated
    out = np.asarray(W.inverse())
    assert np.abs(out - img).max() < 1e-9


def test_zero_copy_device_export(rng):
    """get_image/get_coeff(copy=False) return the on-device jax.Array
    with NO host round-trip (reference device-pointer export intent,
    src/wt.cu:660-667), and the export speaks DLPack."""
    import jax

    img = rng.uniform(0, 255, (64, 64)).astype(np.float32)
    W = Wavelets(img, wname="db3", levels=2)
    out = W.get_image(copy=False)
    assert isinstance(out, jax.Array)
    assert out is W.d_image            # the very same device buffer
    assert hasattr(out, "__dlpack__")
    W.forward()
    a = W.get_coeff(0, copy=False)
    assert isinstance(a, jax.Array)
    assert a is W._coeffs.approx
    # round-trip through DLPack (zero-copy consumer hand-off)
    back = jnp.from_dlpack(out)
    assert np.asarray(back).tolist() == np.asarray(out).tolist()


def test_circshift_not_inplace(rng):
    img = rng.uniform(0, 255, (32, 32)).astype(np.float32)
    W = Wavelets(img, wname="haar", levels=1)
    before = W.get_image()
    shifted = W.circshift(3, 5, inplace=False)
    assert np.array_equal(W.get_image(), before)          # state untouched
    assert np.array_equal(np.asarray(shifted),
                          np.roll(before, (3, 5), (0, 1)))
    W.circshift(3, 5)                                      # inplace default
    assert np.array_equal(W.get_image(),
                          np.roll(before, (3, 5), (0, 1)))


def test_facade_bf16_mode(rng):
    """Stateful facade end-to-end in the bf16-fast tier: every subband
    (approximation included) and the reconstruction are bf16; threshold,
    set_coeff, and inverse keep that dtype."""
    for backend in ("fma", "xla"):
        _facade_bf16_roundtrip(rng, backend)


def _facade_bf16_roundtrip(rng, backend):
    img = rng.uniform(0, 255, (256, 256)).astype(np.float32)
    W = Wavelets(img, wname="db4", levels=2, dtype=jnp.bfloat16,
                 backend=backend)
    W.forward()
    assert all(t.dtype == jnp.bfloat16
               for t in jax.tree_util.tree_leaves(W._coeffs))
    a = W.get_coeff(0)
    W.set_coeff(a, 0)
    assert W._coeffs.approx.dtype == jnp.bfloat16
    W.soft_threshold(2.0)
    assert W._coeffs.details[0][0].dtype == jnp.bfloat16
    W.set_image(np.zeros_like(img))
    out = W.inverse()
    assert out.dtype == jnp.bfloat16
    # soft threshold at beta=2 perturbs by <= 2 per subband pass; loose
    # functional bound on [0,255] data incl. bf16 mode error
    assert np.abs(np.asarray(out, np.float32) - img).max() < 40


def test_facade_bf16_mode_3d(rng):
    """bf16-fast tier through the facade for a VOLUME: bf16 subbands and
    a bf16 reconstruction within the bf16 storage floor."""
    for backend in ("fma", "xla"):
        _facade_bf16_roundtrip_3d(rng, backend)


def _facade_bf16_roundtrip_3d(rng, backend):
    vol = rng.uniform(0, 255, (32, 64, 256)).astype(np.float32)
    W = Wavelets(vol, wname="db4", levels=2, dtype=jnp.bfloat16,
                 backend=backend)
    W.forward()
    assert all(t.dtype == jnp.bfloat16
               for t in jax.tree_util.tree_leaves(W._coeffs))
    W.set_image(np.zeros_like(vol))
    out = W.inverse()
    assert out.dtype == jnp.bfloat16
    assert np.abs(np.asarray(out, np.float32) - vol).max() < 8.0


def test_levels_clamped_to_one_when_wmax_zero(rng):
    """A limiting axis below the filter support gives wmax=0; the clamp
    must force 1 level (periodic extension tiles the short axis), not
    crash building zero-level coefficient shapes (regression)."""
    vol = rng.uniform(0, 255, (8, 64, 64)).astype(np.float32)
    with pytest.warns(UserWarning, match="forcing"):
        W = Wavelets(vol, wname="db4", levels=2)  # max_level(8, 8) == 0
    assert W.spec.nlevels == 1
    W.forward()
    out = np.asarray(W.inverse())
    assert np.abs(out - vol).max() < 1e-2


def test_new_threshold_methods_and_estimators(rng):
    """garrote/firm/bayes_shrink facade methods + estimator scalars
    (reference TODO.txt 'More threshold types')."""
    from pdwt_tpu import ops
    from pdwt_tpu.core import separable as S
    from pdwt_tpu.filters import get_wavelet

    img = _image(rng)
    w = get_wavelet("db3")
    for name, args in (("garrote_threshold", (2.0,)),
                       ("firm_threshold", (1.0, 3.0)),
                       ("bayes_shrink", ())):
        W = Wavelets(img, wname="db3", levels=3)
        W.forward()
        getattr(W, name)(*args)
        got = W.get_coeff(3)  # D1
        c = S.dwt2d(jnp.asarray(img), w, 3)
        fn = {"garrote_threshold": lambda: ops.garrote_threshold(c, 2.0),
              "firm_threshold": lambda: ops.firm_threshold(c, 1.0, 3.0),
              "bayes_shrink": lambda: ops.soft_threshold(
                  c, list(ops.bayes_thresholds(c)))}[name]
        # facade pipelines run f32; the oracle composition runs x64
        np.testing.assert_allclose(got, np.asarray(fn().details[0][2]),
                                   rtol=1e-5, atol=1e-3)
        out = np.asarray(W.inverse())
        assert np.isfinite(out).all()

    W = Wavelets(img, wname="db3", levels=3)
    W.forward()
    sig = W.noise_sigma()
    ut = W.universal_threshold()
    c = S.dwt2d(jnp.asarray(img), w, 3)
    assert abs(sig - float(ops.noise_sigma(c))) < 1e-5
    assert abs(ut - float(ops.universal_threshold(c))) < 1e-4


def test_run_denoise_single_dispatch(rng):
    """run_denoise == forward + threshold + norm1 + inverse (+ unshift),
    for DWT and SWT specs, 2D and 3D, without touching facade state."""
    from pdwt_tpu import ops
    from pdwt_tpu.core import separable as S
    from pdwt_tpu.core import separable3d as S3
    from pdwt_tpu.filters import get_wavelet

    w = get_wavelet("db3")
    img = _image(rng)
    for swt in (False, True):
        W = Wavelets(img, wname="db3", levels=3, do_swt=swt)
        out, n1 = W.run_denoise(5.0)
        assert W.state is WState.INIT  # stateless
        c = S.swt2d(jnp.asarray(img), w, 3) if swt \
            else S.dwt2d(jnp.asarray(img), w, 3)
        ct = ops.soft_threshold(c, 5.0)
        ref = S.iswt2d(ct, w) if swt else S.idwt2d(ct, w, img.shape)
        assert float(jnp.abs(out - ref).max()) < 1e-3
        assert abs(float(n1) - float(ops.norm1(ct))) / float(
            ops.norm1(ct)) < 1e-5

    # 3D + garrote + cycle spinning roundtrips finitely
    vol = (rng.standard_normal((8, 16, 16)) * 50).astype(np.float32)
    W3 = Wavelets(vol, wname="db2", levels=2, do_swt=False,
                  do_cycle_spinning=True)
    out3, n13 = W3.run_denoise(2.0, mode="garrote")
    assert out3.shape == vol.shape and np.isfinite(float(n13))

    # non-separable spec refuses
    Wn = Wavelets(img, wname="db3", levels=2, do_separable=False)
    with pytest.raises(ValueError, match="separable"):
        Wn.run_denoise(1.0)


def test_run_denoise_sequence_beta_and_mode_errors(rng):
    """Per-level beta sequences work on the fused SWT facade path
    (review finding): result equals threshold-then-inverse and the
    norm matches; unknown modes raise ValueError."""
    from pdwt_tpu import ops
    from pdwt_tpu.core import separable as S
    from pdwt_tpu.filters import get_wavelet

    img = _image(rng)
    w = get_wavelet("db3")
    betas = [1.0, 2.0, 3.0]
    W = Wavelets(img, wname="db3", levels=3, do_swt=True)
    out, n1 = W.run_denoise(betas)
    c = S.swt2d(jnp.asarray(img, jnp.float32), w, 3)
    ct = ops.soft_threshold(c, betas)
    ref = S.iswt2d(ct, w)
    assert float(jnp.abs(out - ref).max()) < 1e-3
    assert abs(float(n1) - float(ops.norm1(ct))) / float(
        ops.norm1(ct)) < 1e-5
    with pytest.raises(ValueError, match="unknown mode"):
        W.run_denoise(1.0, mode="sofft")
