"""3D separable DWT/SWT tests — the capability the reference lists as
its first limitation ("3D is not handled at the moment",
reference: README.md) and therefore has no counterpart kernels for.
The per-axis index semantics are the same core/conv.py spec the 1D/2D
tests pin down; these tests assert 3D-specific structure on top."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu import ops
from pdwt_tpu.core import separable as S
from pdwt_tpu.core import separable3d as S3
from pdwt_tpu.filters import get_wavelet

BACKENDS = ("fma", "gather", "xla")


def _vol(rng, shape=(16, 24, 32)):
    return jnp.asarray(rng.standard_normal(shape))


@pytest.mark.slow
def test_dwt3d_perfect_reconstruction(rng):
    w = get_wavelet("db4")
    for shape in [(16, 24, 32), (15, 21, 33)]:  # incl. odd sizes
        x = _vol(rng, shape)
        for bk in BACKENDS:
            c = S3.dwt3d(x, w, 2, backend=bk)
            y = S3.idwt3d(c, w, shape, backend=bk)
            err = float(jnp.abs(y - x).max())
            assert err < 1e-9, (shape, bk, err)


def test_dwt3d_backend_equality(rng):
    w = get_wavelet("db7")
    x = _vol(rng)
    ref = S3.dwt3d(x, w, 2, backend="fma")
    for bk in ("gather", "xla"):
        c = S3.dwt3d(x, w, 2, backend=bk)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(c)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-12)


@pytest.mark.slow
def test_swt3d_perfect_reconstruction(rng):
    w = get_wavelet("db3")
    for shape in [(12, 20, 24), (11, 19, 23)]:
        x = _vol(rng, shape)
        for bk in BACKENDS:
            c = S3.swt3d(x, w, 2, backend=bk)
            y = S3.iswt3d(c, w, backend=bk)
            err = float(jnp.abs(y - x).max())
            assert err < 1e-9, (shape, bk, err)
            assert c.approx.shape == shape  # undecimated
            assert all(b.shape == shape for lv in c.details for b in lv)


def test_dwt3d_shapes_and_channel_order(rng):
    """Sizes follow div2 per axis; the 7 detail bands follow the
    documented channel order ch = 4*k_col + 2*k_row + k_dep: a volume
    varying ONLY along depth puts all detail energy in bands whose key
    has d in the depth slot (daa at level 1)."""
    w = get_wavelet("haar")
    x = jnp.broadcast_to(
        jnp.asarray(rng.standard_normal((16, 1, 1))), (16, 8, 8))
    c = S3.dwt3d(x, w, 1, backend="fma")
    assert c.approx.shape == (8, 4, 4)
    assert len(c.details[0]) == 7
    energies = [float(jnp.abs(b).max()) for b in c.details[0]]
    # key order: daa, ada, dda, aad, dad, add, ddd
    assert S3.DETAIL_KEYS_3D[0] == "daa"
    assert energies[0] > 1e-3  # depth-highpass captures the variation
    for k, e in zip(S3.DETAIL_KEYS_3D[1:], energies[1:]):
        assert e < 1e-9, (k, e)


def test_dwt3d_equals_axiswise_1d_composition(rng):
    """One 3D level == the 1D analysis applied along each axis in turn
    (cols, rows, depth) — ties the 3D engine to the validated 1D spec."""
    w = get_wavelet("db2")
    x = _vol(rng, (8, 12, 16))

    def analysis_axis(v, axis):
        from pdwt_tpu.core import conv

        arr = v[None, None]  # (1, 1, D, R, C) or with channels folded
        out = conv.analysis_pass(arr, (w.dec_lo, w.dec_hi), axis=axis,
                                 backend="gather")
        return out[0]  # (2, ...)

    t = analysis_axis(x, -1)                       # (2, D, R, C/2)
    z = jnp.stack([analysis_axis(t[k], -2)
                   for k in range(2)])             # (2, 2, D, R/2, C/2)
    u = jnp.stack([jnp.stack([analysis_axis(z[i, j], -3)
                              for j in range(2)])
                   for i in range(2)])             # (2,2,2,D/2,R/2,C/2)
    c = S3.dwt3d(x, w, 1, backend="gather")
    # u[k_col, k_row, k_dep] vs channel 4*k_col + 2*k_row + k_dep
    np.testing.assert_allclose(np.asarray(u[0, 0, 0]),
                               np.asarray(c.approx), atol=1e-12)
    for ch in range(1, 8):
        kc, kr, kd = ch >> 2, (ch >> 1) & 1, ch & 1
        np.testing.assert_allclose(np.asarray(u[kc, kr, kd]),
                                   np.asarray(c.details[0][ch - 1]),
                                   atol=1e-12, err_msg=str(ch))


def test_3d_multilevel_sizes(rng):
    w = get_wavelet("db2")
    x = _vol(rng, (24, 24, 40))
    c = S3.dwt3d(x, w, 3, backend="fma")
    assert c.approx.shape == (3, 3, 5)
    assert [lv[0].shape for lv in c.details] == [
        (12, 12, 20), (6, 6, 10), (3, 3, 5)]


@pytest.mark.slow
def test_3d_batched(rng):
    w = get_wavelet("db3")
    x = _vol(rng, (2, 12, 16, 24))  # leading batch axis
    c = S3.dwt3d(x, w, 2, backend="fma")
    assert c.approx.shape == (2, 3, 4, 6)
    y = S3.idwt3d(c, w, (12, 16, 24), backend="fma")
    assert y.shape == x.shape
    assert float(jnp.abs(y - x).max()) < 1e-9
    # batch slices are independent
    c0 = S3.dwt3d(x[0], w, 2, backend="fma")
    np.testing.assert_allclose(np.asarray(c.approx[0]),
                               np.asarray(c0.approx), atol=1e-12)


def test_swt3d_keep_approx(rng):
    w = get_wavelet("db2")
    x = _vol(rng, (8, 12, 16))
    c, approxs = S3.swt3d(x, w, 2, backend="fma", keep_approx=True)
    assert len(approxs) == 2
    np.testing.assert_array_equal(np.asarray(approxs[-1]),
                                  np.asarray(c.approx))
    np.testing.assert_allclose(
        np.asarray(approxs[0]),
        np.asarray(S3.swt3d(x, w, 1, backend="fma").approx), atol=1e-12)


def test_3d_threshold_and_norms(rng):
    """The ops pytree machinery covers Coeffs3D."""
    w = get_wavelet("db2")
    x = _vol(rng, (8, 12, 16))
    c = S3.dwt3d(x, w, 2, backend="fma")
    n1 = float(ops.norm1(c))
    assert n1 > 0 and np.isfinite(n1)
    ct = ops.soft_threshold(c, 0.5, normalize=True)
    assert ct.approx.shape == c.approx.shape
    assert float(ops.norm1(ct)) < n1
    cg = ops.group_soft_threshold(c, 0.5, do_thresh_appcoeffs=True)
    assert float(ops.norm2sq(cg)) < float(ops.norm2sq(c))
    th = float(ops.thresholded_norm1(c, 0.5))
    assert np.isfinite(th)
    # hard threshold + shrink smoke
    ops.hard_threshold(c, 0.5)
    ops.shrink(c, 0.5)


def test_3d_gradients(rng):
    """jax.grad flows through the 3D transforms (pure jnp compositions)."""
    w = get_wavelet("db2")
    x = _vol(rng, (8, 8, 16)).astype(jnp.float32)

    def loss(v):
        c = S3.dwt3d(v, w, 1, backend="fma")
        return ops.norm2sq(c)

    g = jax.grad(loss)(x)
    # analysis is orthogonal-ish for db2: grad of ||Wx||^2 = 2x exactly
    # when W is orthonormal (periodic db2 is)
    np.testing.assert_allclose(np.asarray(g), 2 * np.asarray(x),
                               rtol=0, atol=1e-4)


def test_3d_checkpoint_roundtrip(rng, tmp_path):
    from pdwt_tpu.utils import checkpoint as ckpt

    w = get_wavelet("db2")
    x = _vol(rng, (8, 12, 16)).astype(jnp.float32)
    c = S3.dwt3d(x, w, 2, backend="fma")
    p = str(tmp_path / "c3.npz")
    ckpt.save_coeffs(p, c)
    c2 = ckpt.load_coeffs(p)
    assert isinstance(c2, S3.Coeffs3D) and c2.levels == 2
    for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_3d_facade_roundtrip_and_state(rng):
    """The Wavelets facade accepts a 3D volume (beyond the reference) —
    forward/threshold/norm/inverse, the zeroed-image reconstruction
    proof, and the 7-band flat coefficient numbering."""
    from pdwt_tpu import Wavelets

    vol = rng.uniform(0, 255, (16, 24, 32)).astype(np.float32)
    W = Wavelets(vol, wname="db2", levels=2)  # max_level(16, hlen=4) == 2
    assert W.spec.ndim == 3 and W.spec.shape == (16, 24, 32)
    W.forward()
    n1 = W.norm1()
    assert np.isfinite(n1) and n1 > 0
    # flat numbering: 0=A, 1..7 level-1 bands, 8..14 level-2
    a = W.get_coeff(0)
    assert a.shape == (4, 6, 8)
    b14 = W.get_coeff(14)
    assert b14.shape == (4, 6, 8)
    assert W.get_coeff(1).shape == (8, 12, 16)
    with pytest.raises(IndexError):
        W.get_coeff(15)
    # set_coeff round-trip
    W.set_coeff(np.zeros_like(a), 0)
    np.testing.assert_array_equal(W.get_coeff(0), 0)
    W.set_coeff(a, 0)
    # zeroed-image proof + reconstruction
    W.set_image(np.zeros_like(vol))
    out = np.asarray(W.inverse())
    assert out.shape == vol.shape
    assert np.abs(out - vol).max() < 1e-3
    info = W.info()
    assert info["dims"] == (16, 24, 32)
    W.print_informations()


def test_3d_facade_swt_threshold(rng):
    from pdwt_tpu import Wavelets

    vol = rng.uniform(0, 255, (8, 16, 16)).astype(np.float32)
    W = Wavelets(vol, wname="haar", levels=2, do_swt=True)
    W.forward()
    W.soft_threshold(10.0, normalize=True)
    out = np.asarray(W.inverse())
    assert out.shape == vol.shape
    # denoising moved the image but kept it in range
    assert np.abs(out - vol).max() < 50


def test_3d_facade_cycle_spinning(rng):
    """3D cycle spinning: shift -> transform -> inverse -> unshift is
    the identity (jnp.roll on all three axes)."""
    from pdwt_tpu import Wavelets

    vol = rng.uniform(0, 255, (8, 16, 16)).astype(np.float32)
    W = Wavelets(vol, wname="db2", levels=1, do_cycle_spinning=True,
                 seed=7)
    W.forward()
    assert (W.current_shift_d, W.current_shift_r, W.current_shift_c) \
        != (0, 0, 0)
    out = np.asarray(W.inverse())
    assert np.abs(out - vol).max() < 1e-3


def test_3d_validate_coeffs(rng):
    from pdwt_tpu.utils.debug import validate_coeffs

    w = get_wavelet("db2")
    x = _vol(rng, (8, 12, 16))
    c = S3.dwt3d(x, w, 2, backend="fma")
    validate_coeffs(c, 12, 16, nd=8, levels=2)
    with pytest.raises(ValueError, match="approx"):
        validate_coeffs(c, 12, 16, nd=16, levels=2)


def test_3d_pallas_rejects_pad_fn(rng):
    """backend="pallas" is an unknown backend, with or without a
    pad_fn, matching the 2D engines."""
    from pdwt_tpu.core import conv

    w = get_wavelet("db2")
    x = _vol(rng, (8, 8, 16)).astype(jnp.float32)
    for pad_fn in (None, conv.wrap_pad):
        with pytest.raises(ValueError, match="unknown backend"):
            S3.dwt3d(x, w, 1, backend="pallas", pad_fn=pad_fn)
        with pytest.raises(ValueError, match="unknown backend"):
            S3.swt3d(x, w, 1, backend="pallas", pad_fn=pad_fn)


def test_3d_denoise_step(rng):
    """The flagship denoise pipeline in 3D: one jitted program, shift-
    invariant under the random spin, reduces the coefficient norm."""
    from pdwt_tpu.models.denoiser import denoise_step_3d

    vol = jnp.asarray(rng.standard_normal((8, 16, 16)), jnp.float32)
    key = jax.random.key(0)
    for swt in (False, True):
        out, n1 = jax.jit(
            lambda v: denoise_step_3d(v, key, "db2", 2, 0.5, swt=swt))(vol)
        assert out.shape == vol.shape
        assert np.isfinite(float(n1))
        # beta=0 and no spin is the identity
        out0, _ = denoise_step_3d(vol, None, "db2", 2, 0.0, swt=swt)
        assert float(jnp.abs(out0 - vol).max()) < 1e-5


def test_3d_mxu_fallback_small_shapes(rng):
    """bf16 volumes (the bf16-fast tier) keep bf16 storage for every
    subband and the reconstruction, on both formulations, within the
    bf16 storage floor on [0, 255] data."""
    w = get_wavelet("db2")
    shape = (4, 16, 16)
    x = jnp.asarray(rng.uniform(0, 255, shape), jnp.float32)
    xb = x.astype(jnp.bfloat16)
    for be in ("xla", "fma"):
        cb = S3.dwt3d(xb, w, 1, backend=be)
        assert all(t.dtype == jnp.bfloat16 for t in jax.tree.leaves(cb))
        yb = S3.idwt3d(cb, w, shape, backend=be)
        assert yb.dtype == jnp.bfloat16
        assert float(jnp.abs(yb.astype(jnp.float32) - x).max()) < 8.0


@pytest.mark.slow
def test_3d_iswt_denoise_fused_matches_unfused(rng):
    """iswt3d_denoise equals threshold-then-iswt3d, for f32 and bf16,
    soft, hard and garrote; and it is differentiable."""
    w = get_wavelet("db4")
    shape = (8, 64, 256)
    x = jnp.asarray(rng.uniform(0, 255, shape), jnp.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        c = S3.swt3d(x.astype(dt), w, 2)
        tol = 1e-3 if dt == jnp.float32 else 3.0
        for mode in ("soft", "hard", "garrote"):
            thr = {"soft": ops.soft_threshold,
                   "hard": ops.hard_threshold,
                   "garrote": ops.garrote_threshold}[mode]
            slow = S3.iswt3d(thr(c, 5.0), w)
            fast = S3.iswt3d_denoise(c, w, 5.0, mode=mode)
            assert fast.dtype == slow.dtype
            err = float(jnp.abs(fast.astype(jnp.float32)
                                - slow.astype(jnp.float32)).max())
            assert err < tol, (dt, mode, err)

    # differentiable end-to-end
    def loss(v):
        c = S3.swt3d(v, w, 1)
        y = S3.iswt3d_denoise(c, w, 2.0)
        return jnp.sum(y * y)

    g = jax.grad(loss)(x[:4, :32, :128])
    assert np.isfinite(np.asarray(g)).all()


def test_3d_denoise_step_fused_norm(rng):
    """denoise_step_3d(swt=True) routes the fused path: the returned
    norm equals norm1 of the thresholded pytree."""
    from pdwt_tpu.models import denoise_step_3d

    vol = jnp.asarray(rng.uniform(0, 255, (8, 16, 16)), jnp.float32)
    out, n1 = denoise_step_3d(vol, None, "db2", 2, 3.0, swt=True)
    w = get_wavelet("db2")
    c = S3.swt3d(vol, w, 2)
    n1_ref = float(ops.norm1(ops.soft_threshold(c, 3.0)))
    assert abs(float(n1) - n1_ref) / n1_ref < 1e-5
    slow = S3.iswt3d(ops.soft_threshold(c, 3.0), w)
    assert float(jnp.abs(out - slow).max()) < 1e-3


def test_auto_denoise_3d(rng):
    from pdwt_tpu.models import auto_denoise_3d

    clean = np.zeros((8, 64, 64), np.float32)
    clean[2:6, 16:48, 16:48] = 100.0
    noisy = jnp.asarray(clean + rng.standard_normal((8, 64, 64)) * 10.0,
                        jnp.float32)
    mse_n = float(jnp.mean((noisy - clean) ** 2))
    for method in ("bayes", "universal", "sure"):
        den = jax.jit(lambda v, m=method: auto_denoise_3d(
            v, "db2", 2, method=m))(noisy)
        mse_d = float(jnp.mean((den - clean) ** 2))
        # VisuShrink famously oversmooths sharp edges — weaker bound
        bound = 0.85 if method == "universal" else 0.6
        assert mse_d < bound * mse_n, (method, mse_d, mse_n)
    with pytest.raises(ValueError):
        auto_denoise_3d(noisy, "db2", 2, method="nope")
