"""Boundary extension modes (pywt non-periodization semantics).

pywt itself is not installed in this image, so equality is asserted
against tests/np_oracle.py's independent statement of the pywt C
algorithm (downsampling_convolution / upsampling_convolution_valid_sf /
common.c extension loops) plus hand-computed pywt golden values for the
haar/symmetric case.  The oracle and pdwt_tpu/core/modes.py use
deliberately different formulations (iterative re-extension vs
closed-form index maps), so agreement is a genuine cross-check.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import np_oracle as O
from pdwt_tpu.core import conv, modes
from pdwt_tpu.core import separable as S
from pdwt_tpu.core import separable3d as S3
from pdwt_tpu.filters import get_wavelet

NP_MODES = [m for m in modes.MODES if m != "periodization"]
WAVS = ["haar", "db2", "sym8", "bior3.1", "coif2"]


# ---------------------------------------------------------------------------
# Extension machinery vs the oracle (wide pads included)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", NP_MODES)
@pytest.mark.parametrize("n,lo,hi", [(8, 3, 5), (8, 20, 19), (2, 7, 6),
                                     (5, 11, 12), (3, 0, 4)])
def test_extend_matches_oracle(mode, n, lo, hi, rng):
    x = rng.standard_normal((2, n))
    want = O.ext1(x, lo, hi, mode)
    got = np.asarray(modes.extend(jnp.asarray(x), -1, lo, hi, mode))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_extend_axis_and_errors(rng):
    x = rng.standard_normal((4, 6))
    got = np.asarray(modes.extend(jnp.asarray(x), 0, 2, 3, "symmetric"))
    want = O.ext1(x.T, 2, 3, "symmetric").T
    np.testing.assert_allclose(got, want, atol=1e-12)
    with pytest.raises(ValueError):
        modes.extend(jnp.ones((1, 1)), -1, 1, 1, "reflect")
    with pytest.raises(ValueError):
        modes.check_mode("sym")  # pywt alias not supported; be explicit


# ---------------------------------------------------------------------------
# Golden pywt values (hand-computed from the pywt spec)
# ---------------------------------------------------------------------------

def test_haar_symmetric_golden():
    """pywt.dwt([1,2,3,4,5], 'haar', mode='symmetric')."""
    c = S.dwt1d(jnp.arange(1.0, 6.0), get_wavelet("haar"), 1,
                mode="symmetric", backend="fma")
    s = 2.0 ** -0.5
    np.testing.assert_allclose(np.asarray(c.approx),
                               [3 * s, 7 * s, 10 * s], atol=1e-12)
    np.testing.assert_allclose(np.asarray(c.details[0]),
                               [-s, -s, 0.0], atol=1e-12)
    y = S.idwt1d(c, get_wavelet("haar"), 5, mode="symmetric", backend="fma")
    np.testing.assert_allclose(np.asarray(y), [1, 2, 3, 4, 5], atol=1e-12)


# ---------------------------------------------------------------------------
# Size rules
# ---------------------------------------------------------------------------

def test_size_rules():
    assert modes.dec_len(16, 8, "periodization") == 8
    assert modes.dec_len(17, 8, "periodization") == 9
    assert modes.dec_len(16, 8, "symmetric") == 11  # floor((16+7)/2)
    assert modes.dec_len(17, 8, "zero") == 12
    assert modes.rec_len(11, 8, "symmetric") == 16
    assert modes.level_sizes(16, 2, 8, "symmetric") == [16, 11, 9]


# ---------------------------------------------------------------------------
# 1D / 2D equality vs the oracle, all conv backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["fma", "xla", "gather"])
@pytest.mark.parametrize("mode", ["symmetric", "zero", "reflect"])
def test_dwt1d_oracle_backends(backend, mode, rng):
    w = get_wavelet("db3")
    x = rng.standard_normal((2, 23))
    c = S.dwt1d(jnp.asarray(x), w, 1, mode=mode, backend=backend)
    lo, hi = O.dwt1_level_mode(x, w.dec_lo, w.dec_hi, mode)
    np.testing.assert_allclose(np.asarray(c.approx), lo, atol=1e-10)
    np.testing.assert_allclose(np.asarray(c.details[0]), hi, atol=1e-10)
    y = S.idwt1d(c, w, 23, mode=mode, backend=backend)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


@pytest.mark.parametrize("wname", WAVS)
@pytest.mark.parametrize("mode", NP_MODES)
def test_dwt2d_level_oracle(wname, mode, rng):
    w = get_wavelet(wname)
    x = rng.standard_normal((13, 18))
    c = S.dwt2d(jnp.asarray(x), w, 1, mode=mode, backend="fma")
    a, h, v, d = O.dwt2_level_mode(x, w.dec_lo, w.dec_hi, mode)
    np.testing.assert_allclose(np.asarray(c.approx), a, atol=1e-9)
    np.testing.assert_allclose(np.asarray(c.details[0][0]), h, atol=1e-9)
    np.testing.assert_allclose(np.asarray(c.details[0][1]), v, atol=1e-9)
    np.testing.assert_allclose(np.asarray(c.details[0][2]), d, atol=1e-9)


# ---------------------------------------------------------------------------
# Multi-level perfect reconstruction, 1D/2D/3D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname", WAVS)
@pytest.mark.parametrize("mode", NP_MODES)
def test_roundtrip_2d_multilevel(wname, mode, rng):
    w = get_wavelet(wname)
    x = rng.standard_normal((2, 21, 16))
    c = S.dwt2d(jnp.asarray(x), w, 3, mode=mode)
    y = S.idwt2d(c, w, (21, 16), mode=mode)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


@pytest.mark.parametrize("mode", NP_MODES)
def test_roundtrip_1d_multilevel(mode, rng):
    w = get_wavelet("sym8")
    x = rng.standard_normal((3, 57))
    c = S.dwt1d(jnp.asarray(x), w, 2, mode=mode)
    y = S.idwt1d(c, w, 57, mode=mode)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


@pytest.mark.parametrize("mode", ["symmetric", "zero", "antireflect"])
def test_roundtrip_3d(mode, rng):
    w = get_wavelet("db2")
    x = rng.standard_normal((9, 12, 11))
    c = S3.dwt3d(jnp.asarray(x), w, 2, mode=mode)
    y = S3.idwt3d(c, w, (9, 12, 11), mode=mode)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)
    # coefficient shapes follow the pywt size rule on every axis
    s1 = tuple(modes.dec_len(n, w.hlen, mode) for n in (9, 12, 11))
    assert c.details[0][0].shape == s1


def test_signal_shorter_than_filter(rng):
    """Extension wider than the signal (reflection cycling)."""
    w = get_wavelet("sym8")  # hlen 16
    x = rng.standard_normal((2, 9))
    for mode in ("symmetric", "antisymmetric", "periodic", "reflect"):
        c = S.dwt1d(jnp.asarray(x), w, 1, mode=mode)
        lo, hi = O.dwt1_level_mode(x, w.dec_lo, w.dec_hi, mode)
        np.testing.assert_allclose(np.asarray(c.approx), lo, atol=1e-10)
        y = S.idwt1d(c, w, 9, mode=mode)
        np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


# ---------------------------------------------------------------------------
# Error surface
# ---------------------------------------------------------------------------

def test_mode_errors(rng):
    w = get_wavelet("db2")
    x = jnp.asarray(rng.standard_normal((8, 8)))
    with pytest.raises(ValueError):
        S.dwt2d(x, w, 1, mode="symmetri")
    with pytest.raises(ValueError):
        S.dwt2d(x, w, 1, mode="symmetric", backend="pallas")
    with pytest.raises(ValueError):
        conv.analysis_pass(x[None, None], (w.dec_lo, w.dec_hi), axis=-1,
                           decimate=False, mode="symmetric")
    with pytest.raises(ValueError):
        conv.analysis_pass(x[None, None], (w.dec_lo, w.dec_hi), axis=-1,
                           mode="symmetric", pad_fn=conv.wrap_pad)
    odd = np.asarray([1.0, 2.0, 1.0])
    from pdwt_tpu.filters import make_custom_wavelet
    wc = make_custom_wavelet("odd3", odd, odd, odd, odd)
    with pytest.raises(ValueError):
        # pywt parity rule: non-periodization inverse needs even hlen
        conv.synthesis_pass(jnp.ones((1, 2, 1, 8)), (wc.rec_lo, wc.rec_hi),
                            axis=-1, mode="symmetric")


# ---------------------------------------------------------------------------
# Facade integration (Wavelets mode= / precision= / device=)
# ---------------------------------------------------------------------------

def test_facade_mode_roundtrip(rng):
    from pdwt_tpu import Wavelets

    img = rng.standard_normal((37, 29)).astype(np.float32)
    W = Wavelets(img, wname="db4", levels=2, mode="symmetric")
    W.forward()
    # coefficient shapes follow the pywt rule
    w = get_wavelet("db4")
    sizes_r = modes.level_sizes(37, 2, w.hlen, "symmetric")
    sizes_c = modes.level_sizes(29, 2, w.hlen, "symmetric")
    assert W.get_coeff(0).shape == (sizes_r[2], sizes_c[2])
    assert W.get_coeff(1).shape == (sizes_r[1], sizes_c[1])
    rec = W.inverse()
    np.testing.assert_allclose(np.asarray(rec), img, atol=1e-4)
    assert W.info()["mode"] == "symmetric"
    # zeroed-coeffs geometry matches the forward's
    W2 = Wavelets(nr=37, nc=29, wname="db4", levels=2, mode="symmetric")
    assert W2.coeffs.approx.shape == W.coeffs.approx.shape


def test_facade_mode_denoise(rng):
    from pdwt_tpu import Wavelets

    img = rng.standard_normal((32, 32)).astype(np.float32)
    W = Wavelets(img, wname="sym4", levels=2, mode="reflect")
    out, n1 = W.run_denoise(0.1)
    assert out.shape == (32, 32)
    assert float(n1) > 0


def test_facade_mode_errors():
    from pdwt_tpu import Wavelets

    with pytest.raises(ValueError):
        Wavelets(nr=16, nc=16, wname="db2", mode="symmetric", do_swt=True)
    with pytest.raises(ValueError):
        Wavelets(nr=16, nc=16, wname="db2", mode="symmetric",
                 do_separable=False)
    with pytest.raises(ValueError):
        Wavelets(nr=16, nc=16, wname="db2", mode="symmetrical")
    with pytest.warns(UserWarning):
        Wavelets(nr=16, nc=16, wname="db2", mode="zero",
                 do_cycle_spinning=True)


def test_facade_precision_tiers_coexist(rng):
    """Two instances with different tiers in ONE process: each keeps its
    tier in its spec (distinct jit keys), the bf16 tier implies bf16
    arrays, and tiers that no longer exist raise."""
    from pdwt_tpu import Wavelets

    img = rng.standard_normal((16, 16)).astype(np.float32)
    We = Wavelets(img, wname="db2", levels=2, precision="exact")
    Wb = Wavelets(img, wname="db2", levels=2, precision="bf16-fast")
    assert We.spec.precision == "exact" and Wb.spec.precision == "bf16-fast"
    assert We.spec != Wb.spec  # distinct jit keys
    assert Wb.spec.dtype == "bfloat16"
    ce, cb = We.forward(), Wb.forward()
    assert cb.approx.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(cb.approx, np.float32),
                               np.asarray(ce.approx), atol=5e-2)
    assert We.info()["precision"] == "exact"
    for gone in ("mixed", "bf16-balanced", "bf16-accurate"):
        with pytest.raises(ValueError, match="unknown precision"):
            Wavelets(img, wname="db2", precision=gone)
    with pytest.raises(ValueError):
        Wavelets(img, wname="db2", precision="bf16-fast", dtype=jnp.float32)
    with pytest.raises(ValueError):
        Wavelets(img, wname="db2", precision="exactly")


def test_facade_device_kwarg(rng):
    import jax

    from pdwt_tpu import Wavelets

    dev = jax.devices()[-1]  # conftest forces 8 virtual CPU devices
    img = rng.standard_normal((16, 16)).astype(np.float32)
    W = Wavelets(img, wname="db2", levels=2, device=dev)
    assert W.d_image.devices() == {dev}
    W.forward()
    assert W.coeffs.approx.devices() == {dev}
    rec = W.inverse()
    np.testing.assert_allclose(np.asarray(rec), img, atol=1e-5)
    W.set_image(img)
    assert W.d_image.devices() == {dev}


def test_custom_filter_rezero_under_mode(rng):
    from pdwt_tpu import Wavelets

    W = Wavelets(nr=20, nc=20, wname="db2", levels=2, mode="symmetric")
    shape_before = W.coeffs.approx.shape
    w8 = get_wavelet("db8")
    W.set_filters_forward("db8", w8.dec_lo, w8.dec_hi)
    W.set_filters_inverse(w8.rec_lo, w8.rec_hi)
    assert W.coeffs.approx.shape != shape_before  # pywt sizes track hlen
    img = rng.standard_normal((20, 20)).astype(np.float32)
    W.set_image(img)
    W.forward()
    np.testing.assert_allclose(np.asarray(W.inverse()), img, atol=1e-4)


# ---------------------------------------------------------------------------
# Per-axis modes (pywt tuple-of-modes semantics)
# ---------------------------------------------------------------------------

def test_per_axis_modes_2d_matches_composed_oracle(rng):
    """mode=(row, col) applies independent extensions per axis; checked
    against the 1D oracle composed with different modes per axis."""
    w = get_wavelet("db3")
    x = rng.standard_normal((14, 17))
    c = S.dwt2d(jnp.asarray(x), w, 1, mode=("symmetric", "zero"))
    lo_x, hi_x = O.dwt1_level_mode(x, w.dec_lo, w.dec_hi, "zero")  # cols
    a, h = O.dwt1_level_mode(lo_x.T, w.dec_lo, w.dec_hi, "symmetric")
    v, d = O.dwt1_level_mode(hi_x.T, w.dec_lo, w.dec_hi, "symmetric")
    np.testing.assert_allclose(np.asarray(c.approx), a.T, atol=1e-9)
    np.testing.assert_allclose(np.asarray(c.details[0][2]), d.T, atol=1e-9)
    y = S.idwt2d(c, w, (14, 17), mode=("symmetric", "zero"))
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


def test_per_axis_modes_3d_and_mixed_periodization(rng):
    w = get_wavelet("db2")
    x = rng.standard_normal((8, 10, 12))
    m = ("periodization", "symmetric", "reflect")
    c = S3.dwt3d(jnp.asarray(x), w, 2, mode=m)
    # per-axis size rules
    assert c.details[0][0].shape == (4, modes.dec_len(10, 4, "symmetric"),
                                     modes.dec_len(12, 4, "reflect"))
    y = S3.idwt3d(c, w, (8, 10, 12), mode=m)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


def test_per_axis_modes_facade_and_errors(rng):
    from pdwt_tpu import Wavelets

    img = rng.standard_normal((24, 20)).astype(np.float32)
    W = Wavelets(img, wname="db2", levels=2, mode=("reflect", "zero"))
    W.forward()
    rec = W.inverse()
    np.testing.assert_allclose(np.asarray(rec), img, atol=1e-4)
    assert W.spec.mode == ("reflect", "zero")
    with pytest.raises(ValueError):
        Wavelets(img, wname="db2", mode=("reflect",))  # wrong arity
    with pytest.raises(ValueError):
        S.dwt1d(jnp.asarray(img), get_wavelet("db2"), 1,
                mode=("zero", "zero"))
    with pytest.raises(ValueError):
        S.dwt2d(jnp.asarray(img), get_wavelet("db2"), 1,
                mode=("zero", "sym"))


def test_fs_dwt_modes(rng):
    """Fully separable (anisotropic) transform with pywt boundary modes,
    including per-axis mixes and per-axis level counts."""
    from pdwt_tpu.core.anisotropic import fs_dwt, fs_idwt, fs_slices

    w = get_wavelet("db3")
    x = rng.standard_normal((2, 19, 26))
    for mode in ("symmetric", ("zero", "reflect")):
        y = fs_dwt(jnp.asarray(x), w, (2, 3), mode=mode)
        back = fs_idwt(y, w, (19, 26), (2, 3), mode=mode)
        np.testing.assert_allclose(np.asarray(back), x, atol=1e-9)
    # block addressing matches the pywt size rule
    sl = fs_slices((19, 26), (2, 3), mode="symmetric", hlen=w.hlen)
    sizes = modes.level_sizes(19, 2, w.hlen, "symmetric")
    assert sl[0]["a"] == slice(0, sizes[2])
    assert sl[0]["d1"].stop - sl[0]["d1"].start == sizes[1]
