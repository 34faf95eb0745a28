"""Sharded (multi-chip) transforms must be bit-identical to single-device.

Runs on the 8-virtual-device CPU backend configured in conftest.py — the
standard way to validate pjit/shard_map meshes without a pod
(SURVEY.md §4).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu import parallel as par
from pdwt_tpu.core import separable as sep
from pdwt_tpu.filters import get_wavelet
from pdwt_tpu.models.denoiser import sharded_denoise_step


def _max_err(a, b):
    return max(
        float(jnp.abs(x - y).max())
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh((2, 2, 2), ("data", "row", "col"))


AXES = dict(data_axis="data", row_axis="row", col_axis="col")


@pytest.mark.parametrize("wname", ["haar", "db7", "bior4.4"])
@pytest.mark.parametrize("swt", [False, True])
@pytest.mark.slow
def test_sharded_2d_matches_single_device(mesh, rng, wname, swt):
    w = get_wavelet(wname)
    levels = 3
    x = rng.standard_normal((4, 128, 128)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)

    c_sh = par.dwt2d(xs, w, levels, mesh, swt=swt, **AXES)
    c_ref = (sep.swt2d if swt else sep.dwt2d)(jnp.asarray(x), w, levels)
    assert _max_err(c_sh, c_ref) == 0.0

    y_sh = par.idwt2d(c_sh, w, (128, 128), mesh, swt=swt, **AXES)
    if swt:
        y_ref = sep.iswt2d(c_ref, w)
    else:
        y_ref = sep.idwt2d(c_ref, w, (128, 128))
    assert _max_err(y_sh, y_ref) == 0.0
    assert float(jnp.abs(y_sh - x).max()) < 5e-5


@pytest.mark.slow
def test_sharded_swt_halo_wider_than_shard(mesh, rng):
    """Deep-level SWT: dilated halo (hlen-1)*2^(level-1) exceeds the local
    shard -> exercises the multi-hop ring exchange."""
    w = get_wavelet("db7")  # hlen=14: level-4 halo = 13*8 = 104 > 64
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)
    c_sh = par.swt2d(xs, w, 4, mesh, **AXES)
    c_ref = sep.swt2d(jnp.asarray(x), w, 4)
    assert _max_err(c_sh, c_ref) == 0.0
    y = par.iswt2d(c_sh, w, (128, 128), mesh, **AXES)
    assert float(jnp.abs(y - x).max()) < 5e-5


@pytest.mark.parametrize("swt", [False, True])
def test_sharded_1d_matches_single_device(mesh, rng, swt):
    w = get_wavelet("sym8")
    s = rng.standard_normal((8, 256)).astype(np.float32)
    ss = par.shard_image(s, mesh, data_axis="data", col_axis="col")
    kw = dict(data_axis="data", col_axis="col")
    c_sh = par.dwt1d(ss, w, 2, mesh, swt=swt, **kw)
    c_ref = (sep.swt1d if swt else sep.dwt1d)(jnp.asarray(s), w, 2)
    assert _max_err(c_sh, c_ref) == 0.0
    y = par.idwt1d(c_sh, w, 256, mesh, swt=swt, **kw)
    assert float(jnp.abs(y - s).max()) < 5e-5


def test_divisibility_errors(mesh, rng):
    w = get_wavelet("db2")
    x = jnp.zeros((4, 100, 128))  # 100 not divisible by 2 shards * 2^3
    with pytest.raises(ValueError, match="divisible"):
        par.dwt2d(x, w, 3, mesh, **AXES)


def test_sharded_denoise_step_jits(mesh, rng):
    x = rng.standard_normal((4, 64, 64)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)

    @jax.jit
    def step(img):
        return sharded_denoise_step(img, "db4", 2, 1.0, mesh, **AXES)

    out, n1 = step(xs)
    assert out.shape == x.shape
    assert np.isfinite(float(n1))
    # thresholding with beta=0 is the identity -> perfect reconstruction
    out0, _ = jax.jit(lambda im: sharded_denoise_step(
        im, "db4", 2, 0.0, mesh, **AXES))(xs)
    assert float(jnp.abs(out0 - x).max()) < 5e-5


def test_norms_on_sharded_coeffs(mesh, rng):
    from pdwt_tpu import ops
    w = get_wavelet("db3")
    x = rng.standard_normal((4, 64, 64)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)
    c_sh = par.dwt2d(xs, w, 2, mesh, **AXES)
    c_ref = sep.dwt2d(jnp.asarray(x), w, 2)
    n_sh = float(jax.jit(ops.norm1)(c_sh))
    n_ref = float(ops.norm1(c_ref))
    assert abs(n_sh - n_ref) / n_ref < 1e-5


@pytest.mark.slow
def test_sharded_pallas_matches_single_device(mesh, rng, monkeypatch):
    """Ring halo exchange feeding the fma formulation's level passes
    matches the single-device gather oracle."""
    w = get_wavelet("db7")
    x = rng.standard_normal((4, 256, 512)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)
    c_sh = par.dwt2d(xs, w, 2, mesh, backend="fma", **AXES)
    c_ref = sep.dwt2d(jnp.asarray(x), w, 2, backend="gather")
    assert _max_err(c_sh, c_ref) < 1e-5
    y = par.idwt2d(c_sh, w, (256, 512), mesh, backend="fma", **AXES)
    assert float(jnp.abs(y - x).max()) < 1e-5


@pytest.mark.slow
def test_sharded_pallas_swt_matches_single_device(mesh, rng, monkeypatch):
    w = get_wavelet("db7")
    x = rng.standard_normal((2, 128, 256)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)
    c_sh = par.swt2d(xs, w, 3, mesh, backend="fma", **AXES)
    c_ref = sep.swt2d(jnp.asarray(x), w, 3, backend="gather")
    assert _max_err(c_sh, c_ref) < 1e-5
    y = par.iswt2d(c_sh, w, (128, 256), mesh, backend="fma", **AXES)
    assert float(jnp.abs(y - x).max()) < 1e-5


@pytest.mark.parametrize("swt", [False, True])
@pytest.mark.slow
def test_sharded_pallas_1d_matches_single_device(mesh, rng, swt,
                                                 monkeypatch):
    """Sharded batched-1D on the fma formulation (ring halos along the
    signal axis) matches the single-device gather oracle."""
    w = get_wavelet("db7")
    x = rng.standard_normal((16, 512)).astype(np.float32)
    xs = par.shard_image(x, mesh, data_axis="data", col_axis="col")
    if swt:
        c_sh = par.swt1d(xs, w, 2, mesh, data_axis="data", col_axis="col",
                         backend="fma")
        c_ref = sep.swt1d(jnp.asarray(x), w, 2, backend="gather")
    else:
        c_sh = par.dwt1d(xs, w, 2, mesh, data_axis="data", col_axis="col",
                         backend="fma")
        c_ref = sep.dwt1d(jnp.asarray(x), w, 2, backend="gather")
    assert _max_err(c_sh, c_ref) < 1e-5
    if swt:
        y = par.iswt1d(c_sh, w, 512, mesh, data_axis="data",
                       col_axis="col", backend="fma")
    else:
        y = par.idwt1d(c_sh, w, 512, mesh, data_axis="data",
                       col_axis="col", backend="fma")
    assert float(jnp.abs(y - x).max()) < 1e-5


@pytest.mark.parametrize("swt", [False, True])
def test_sharded_mxu_bf16_bit_identical(mesh, rng, monkeypatch, swt):
    """Sharded bf16 level == single-device bf16 level bit-for-bit: the
    ring halo exchange delivers the same periodic values the local wrap
    does, and bf16 halos move half the bytes of f32 ones."""
    w = get_wavelet("db4")
    x = rng.uniform(0, 255, (2, 512, 512)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xs = par.shard_image(xb, mesh, **AXES)
    c_sh = par.dwt2d(xs, w, 1, mesh, swt=swt, backend="fma", **AXES)
    c_ref = (sep.swt2d if swt else sep.dwt2d)(xb, w, 1, backend="fma")
    assert all(t.dtype == jnp.bfloat16 for t in jax.tree.leaves(c_sh))
    assert _max_err(jax.tree.map(lambda t: t.astype(jnp.float32), c_sh),
                    jax.tree.map(lambda t: t.astype(jnp.float32),
                                 c_ref)) == 0.0
    y_sh = par.idwt2d(c_sh, w, (512, 512), mesh, swt=swt,
                      backend="fma", **AXES)
    y_ref = (sep.iswt2d(c_ref, w, backend="fma") if swt
             else sep.idwt2d(c_ref, w, (512, 512), backend="fma"))
    assert y_sh.dtype == jnp.bfloat16
    assert _max_err(y_sh.astype(jnp.float32),
                    y_ref.astype(jnp.float32)) == 0.0


@pytest.mark.slow
def test_sharded_mxu_modes_recon(mesh, rng, monkeypatch):
    """Deeper sharded bf16 runs reconstruct within the bf16 storage
    floor; the removed 'mixed' tier raises."""
    w = get_wavelet("db4")
    x = rng.uniform(0, 255, (2, 256, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xs = par.shard_image(xb, mesh, **AXES)
    c_sh = par.dwt2d(xs, w, 2, mesh, backend="fma", **AXES)
    y_sh = par.idwt2d(c_sh, w, (256, 256), mesh, backend="fma", **AXES)
    assert y_sh.dtype == jnp.bfloat16
    assert float(jnp.abs(y_sh.astype(jnp.float32) - x).max()) < 5.0

    with pytest.raises(ValueError, match="unknown precision"):
        sep.dwt2d(jnp.asarray(x), w, 2, precision="mixed")


def test_sharded_mxu_1d_modes(mesh, rng, monkeypatch):
    w = get_wavelet("sym8")
    x = rng.uniform(-10, 10, (64, 1024)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xs = par.shard_image(xb, mesh, data_axis="data", col_axis="col")
    c_sh = par.dwt1d(xs, w, 2, mesh, data_axis="data", col_axis="col",
                     backend="fma")
    assert all(t.dtype == jnp.bfloat16 for t in jax.tree.leaves(c_sh))
    y_sh = par.idwt1d(c_sh, w, 1024, mesh, data_axis="data",
                      col_axis="col", backend="fma")
    assert y_sh.dtype == jnp.bfloat16
    assert float(jnp.abs(y_sh.astype(jnp.float32) - x).max()) < 0.3


@pytest.mark.parametrize("swt", [False, True])
@pytest.mark.slow
def test_sharded_nonseparable_matches_single_device(mesh, rng, swt):
    """Sharded rank-r non-separable transforms: the
    rank-decomposed passes run per shard with ring halos and must be
    bit-identical to the single-device rank path."""
    from pdwt_tpu.core import nonseparable as ns

    q = np.zeros((4, 6, 6))
    g = np.random.default_rng(3)
    for _ in range(2):
        q += np.einsum("si,j->sij", g.standard_normal((4, 6)),
                       g.standard_normal(6))
    q /= np.abs(q).sum(axis=(1, 2), keepdims=True)
    levels = 2
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)

    c_sh = par.dwt2d_ns(xs, q, levels, mesh, swt=swt, **AXES)
    c_ref = (ns.swt2d_ns if swt else ns.dwt2d_ns)(jnp.asarray(x), q,
                                                  levels)
    assert _max_err(c_sh, c_ref) == 0.0

    if swt:
        y_sh = par.iswt2d_ns(c_sh, q, mesh, **AXES)
        y_ref = ns.iswt2d_ns(c_ref, q)
    else:
        y_sh = par.idwt2d_ns(c_sh, q, (128, 128), mesh, **AXES)
        y_ref = ns.idwt2d_ns(c_ref, q, (128, 128))
    assert _max_err(y_sh, y_ref) == 0.0


@pytest.mark.parametrize("swt", [False, True])
@pytest.mark.slow
def test_sharded_3d_matches_single_device(mesh, rng, swt):
    """Volumes sharded over (depth, row, col) — halos ride all three
    rings; results must be bit-identical to the single-device engine."""
    from pdwt_tpu.core import separable3d as sep3

    w = get_wavelet("db4")
    levels = 2
    axes3 = dict(dep_axis="data", row_axis="row", col_axis="col")
    x = rng.standard_normal((16, 32, 32)).astype(np.float32)
    xs = par.shard_image(x, mesh, **axes3)

    c_sh = par.dwt3d(xs, w, levels, mesh, swt=swt, **axes3)
    c_ref = (sep3.swt3d if swt else sep3.dwt3d)(
        jnp.asarray(x), w, levels)
    assert _max_err(c_sh, c_ref) == 0.0

    y_sh = par.idwt3d(c_sh, w, (16, 32, 32), mesh, swt=swt, **axes3)
    y_ref = (sep3.iswt3d(c_ref, w) if swt
             else sep3.idwt3d(c_ref, w, (16, 32, 32)))
    assert _max_err(y_sh, y_ref) == 0.0
    assert float(jnp.abs(y_sh - x).max()) < 5e-5


@pytest.mark.slow
def test_sharded_3d_batched_data_axis(mesh, rng):
    """Batch over data, volume over (row, col) only — depth unsharded."""
    from pdwt_tpu.core import separable3d as sep3

    w = get_wavelet("db2")
    x = rng.standard_normal((2, 8, 32, 32)).astype(np.float32)
    xs = par.shard_image(x, mesh, data_axis="data", dep_axis=None,
                         row_axis="row", col_axis="col")
    axes = dict(data_axis="data", row_axis="row", col_axis="col")
    c_sh = par.dwt3d(xs, w, 2, mesh, **axes)
    c_ref = sep3.dwt3d(jnp.asarray(x), w, 2)
    assert _max_err(c_sh, c_ref) == 0.0
    y_sh = par.idwt3d(c_sh, w, (8, 32, 32), mesh, **axes)
    assert float(jnp.abs(y_sh - x).max()) < 5e-5


def test_sharded_3d_divisibility_error(mesh, rng):
    w = get_wavelet("db2")
    x = rng.standard_normal((12, 32, 32)).astype(np.float32)  # 12 % (2*4) != 0
    xs = par.shard_image(x, mesh, dep_axis="data", row_axis="row",
                         col_axis="col")
    with pytest.raises(ValueError, match="divisible"):
        par.dwt3d(xs, w, 2, mesh, dep_axis="data", row_axis="row",
                  col_axis="col")


@pytest.mark.slow
def test_sharded_3d_pallas_matches_single_device(mesh, rng, monkeypatch):
    """Sharded 3D: ring halos on every sharded axis, depth included,
    feeding the fma formulation, against the gather oracle."""
    w = get_wavelet("db4")
    axes3 = dict(dep_axis="data", row_axis="row", col_axis="col")
    x = rng.standard_normal((8, 256, 512)).astype(np.float32)
    xs = par.shard_image(x, mesh, **axes3)
    c_sh = par.dwt3d(xs, w, 2, mesh, backend="fma", **axes3)
    from pdwt_tpu.core import separable3d as sep3
    c_ref = sep3.dwt3d(jnp.asarray(x), w, 2, backend="gather")
    assert _max_err(c_sh, c_ref) < 1e-4
    y = par.idwt3d(c_sh, w, (8, 256, 512), mesh, backend="fma",
                   **axes3)
    assert float(jnp.abs(y - x).max()) < 1e-4


@pytest.mark.slow
def test_sharded_3d_pallas_swt_matches_single_device(mesh, rng,
                                                     monkeypatch):
    w = get_wavelet("db4")
    axes3 = dict(dep_axis="data", row_axis="row", col_axis="col")
    x = rng.standard_normal((4, 128, 256)).astype(np.float32)
    xs = par.shard_image(x, mesh, **axes3)
    c_sh = par.swt3d(xs, w, 2, mesh, backend="fma", **axes3)
    from pdwt_tpu.core import separable3d as sep3
    c_ref = sep3.swt3d(jnp.asarray(x), w, 2, backend="gather")
    assert _max_err(c_sh, c_ref) < 1e-4
    y = par.iswt3d(c_sh, w, (4, 128, 256), mesh, backend="fma",
                   **axes3)
    assert float(jnp.abs(y - x).max()) < 1e-4


@pytest.mark.slow
def test_sharded_3d_mxu_modes(mesh, rng, monkeypatch):
    """bf16 volumes per shard: bf16 subbands through the ring halos and
    a reconstruction within the bf16 storage floor."""
    w = get_wavelet("db4")
    axes3 = dict(dep_axis="data", row_axis="row", col_axis="col")
    x = rng.uniform(0, 255, (8, 128, 256)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xs = par.shard_image(xb, mesh, **axes3)
    for swt in (False, True):
        c_sh = par.dwt3d(xs, w, 1, mesh, swt=swt, backend="fma",
                         **axes3)
        assert all(t.dtype == jnp.bfloat16 for t in jax.tree.leaves(c_sh))
        y = par.idwt3d(c_sh, w, (8, 128, 256), mesh, swt=swt,
                       backend="fma", **axes3)
        assert y.dtype == jnp.bfloat16
        assert float(jnp.abs(y.astype(jnp.float32) - x).max()) < 8.0


def test_sharded_denoise_step_3d_jits(mesh, rng):
    from pdwt_tpu.models.denoiser import sharded_denoise_step_3d

    axes3 = dict(dep_axis="data", row_axis="row", col_axis="col")
    x = rng.standard_normal((16, 32, 32)).astype(np.float32)
    xs = par.shard_image(x, mesh, **axes3)

    @jax.jit
    def step(v):
        return sharded_denoise_step_3d(v, "db4", 2, 1.0, mesh, **axes3)

    out, n1 = step(xs)
    assert out.shape == x.shape
    assert np.isfinite(float(n1))
    out0, _ = jax.jit(lambda v: sharded_denoise_step_3d(
        v, "db4", 2, 0.0, mesh, **axes3))(xs)
    assert float(jnp.abs(out0 - x).max()) < 5e-5


@pytest.mark.slow
def test_sharded_pallas_odd_unsharded_axes(mesh, rng, monkeypatch):
    """Odd sizes on UNSHARDED axes flow through the local level
    compositions: per-level sizes must follow the conv spec's round-up
    (shapes.div2), not a floor shift (regression: the depth/row size
    tables fed floor sizes to the inverse synthesis out_len)."""
    w = get_wavelet("db4")

    # 2D: odd rows, row axis unsharded, cols sharded
    x2 = rng.standard_normal((4, 63, 128)).astype(np.float32)
    ax2 = dict(data_axis="data", col_axis="col")
    xs2 = par.shard_image(jnp.asarray(x2), mesh, **ax2)
    c2 = par.dwt2d(xs2, w, 2, mesh, backend="fma", **ax2)
    c2_ref = sep.dwt2d(jnp.asarray(x2), w, 2, backend="gather")
    assert _max_err(c2, c2_ref) < 1e-4
    y2 = par.idwt2d(c2, w, (63, 128), mesh, backend="fma", **ax2)
    assert y2.shape == x2.shape
    assert float(jnp.abs(y2 - jnp.asarray(x2)).max()) < 1e-4

    # 3D: odd depth, depth axis unsharded, rows/cols sharded
    from pdwt_tpu.core import separable3d as sep3

    x3 = rng.standard_normal((7, 64, 128)).astype(np.float32)
    ax3 = dict(row_axis="row", col_axis="col")
    xs3 = par.shard_image(jnp.asarray(x3), mesh, **ax3)
    c3 = par.dwt3d(xs3, w, 2, mesh, backend="fma", **ax3)
    c3_ref = sep3.dwt3d(jnp.asarray(x3), w, 2, backend="gather")
    assert _max_err(c3, c3_ref) < 1e-4
    y3 = par.idwt3d(c3, w, (7, 64, 128), mesh, backend="fma", **ax3)
    assert y3.shape == x3.shape
    assert float(jnp.abs(y3 - jnp.asarray(x3)).max()) < 1e-4


def test_data_parallel_packets_and_anisotropic(rng):
    """The new transforms are batch-parallel: under a data-axis
    sharding, wp2d / wp_reconstruct / fs_dwt / fs_idwt run sharded
    (jit keeps the batch axis distributed) and match single-device
    results bit-for-bit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pdwt_tpu.core import anisotropic as A
    from pdwt_tpu.core import packets as PK
    from pdwt_tpu.filters import get_wavelet

    w = get_wavelet("db3")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("data",))
    x = jnp.asarray(rng.standard_normal((8, 32, 48)), jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))

    pk_ref = PK.wp2d(x, w, 2)
    leaves, _ = PK.best_basis(pk_ref, "shannon")
    f = jax.jit(lambda v: PK.wp_reconstruct(PK.wp2d(v, w, 2), leaves, w))
    y = f(xs)
    assert y.sharding.spec == P("data"), y.sharding
    np.testing.assert_array_equal(np.asarray(y), np.asarray(f(x)))

    g = jax.jit(lambda v: A.fs_idwt(A.fs_dwt(v, w, (2, 1)), w,
                                    (32, 48), (2, 1)))
    ys = g(xs)
    np.testing.assert_array_equal(np.asarray(ys), np.asarray(g(x)))


@pytest.mark.parametrize("backend", [None, "fma"])
@pytest.mark.slow
def test_sharded_anisotropic_matches_single_device(mesh, rng, backend):
    """Spatially sharded fs_dwt/fs_idwt: each axis pass exchanges its
    ring halo, the pack/unpack relayouts happen on the global arrays —
    result identical to the single-device anisotropic transform."""
    from pdwt_tpu.core import anisotropic as A

    w = get_wavelet("db4")
    lv = (2, 1)
    x = rng.standard_normal((4, 64, 128)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)

    y_sh = par.fs_dwt(xs, w, lv, mesh, axes=("row", "col"),
                      data_axis="data", backend=backend)
    y_ref = A.fs_dwt(jnp.asarray(x), w, lv,
                     backend=backend)
    assert y_sh.shape == y_ref.shape
    assert _max_err(y_sh, y_ref) < (1e-5 if backend == "fma" else 1e-12)

    r_sh = par.fs_idwt(y_sh, w, (64, 128), lv, mesh, axes=("row", "col"),
                       data_axis="data", backend=backend)
    assert float(jnp.abs(r_sh - jnp.asarray(x)).max()) < 5e-5


@pytest.mark.slow
def test_sharded_anisotropic_mixed_axes(mesh, rng):
    """Unsharded (odd-size) axis + sharded axis + a skipped (level-0)
    leading axis all compose; halo rides only the sharded ring."""
    from pdwt_tpu.core import anisotropic as A

    w = get_wavelet("db3")
    x = rng.standard_normal((2, 45, 128)).astype(np.float32)
    xs = par.shard_image(x, mesh, data_axis="data", col_axis="col")

    lv = (1, 2)
    y_sh = par.fs_dwt(xs, w, lv, mesh, axes=(None, "col"),
                      data_axis="data")
    y_ref = A.fs_dwt(jnp.asarray(x), w, lv)
    assert _max_err(y_sh, y_ref) < 1e-12

    r_sh = par.fs_idwt(y_sh, w, (45, 128), lv, mesh, axes=(None, "col"),
                       data_axis="data")
    assert float(jnp.abs(r_sh - jnp.asarray(x)).max()) < 5e-5


@pytest.mark.slow
def test_sharded_packets_match_single_device(mesh, rng):
    """Spatially sharded wavelet packets: per-depth ring-halo batched
    single-level DWTs (node axis rides batch) — the full tree, the
    best-basis reconstruction, and the full-tree inverse all match
    single-device results."""
    from pdwt_tpu.core import packets as PK
    from pdwt_tpu.parallel import packets as PPK

    w = get_wavelet("db3")
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    xs = par.shard_image(x, mesh, **AXES)

    pk_sh = PPK.wp2d(xs, w, 2, mesh, **AXES)
    pk_ref = PK.wp2d(jnp.asarray(x), w, 2)
    assert _max_err(list(pk_sh.nodes), list(pk_ref.nodes)) == 0.0

    leaves, cost = PK.best_basis(pk_sh, "shannon")
    leaves_ref, cost_ref = PK.best_basis(pk_ref, "shannon")
    assert leaves == leaves_ref
    y_sh = PPK.wp_reconstruct(pk_sh, leaves, w, mesh, **AXES)
    y_ref = PK.wp_reconstruct(pk_ref, leaves_ref, w)
    assert _max_err(y_sh, y_ref) == 0.0
    assert float(jnp.abs(y_sh - jnp.asarray(x)).max()) < 5e-5

    full = PPK.iwp2d(pk_sh.nodes[-1], w, (64, 128), mesh, **AXES)
    assert float(jnp.abs(full - jnp.asarray(x)).max()) < 5e-5


@pytest.mark.slow
def test_sharded_packets_1d_and_3d(mesh, rng):
    from pdwt_tpu.core import packets as PK
    from pdwt_tpu.parallel import packets as PPK

    w = get_wavelet("db2")
    # batched 1D, signal axis on the col ring
    s = rng.standard_normal((4, 256)).astype(np.float32)
    ss = par.shard_image(s, mesh, data_axis="data", col_axis="col")
    pk = PPK.wp1d(ss, w, 3, mesh, data_axis="data", col_axis="col")
    pk_ref = PK.wp1d(jnp.asarray(s), w, 3)
    assert _max_err(list(pk.nodes), list(pk_ref.nodes)) == 0.0
    y = PPK.iwp1d(pk.nodes[-1], w, 256, mesh, data_axis="data",
                  col_axis="col")
    assert float(jnp.abs(y - jnp.asarray(s)).max()) < 5e-5

    # volume over (row, col) rings, depth local
    v = rng.standard_normal((16, 32, 64)).astype(np.float32)
    ax3 = dict(row_axis="row", col_axis="col")
    vs = par.shard_image(v, mesh, **ax3)
    pk3 = PPK.wp3d(vs, w, 2, mesh, **ax3)
    pk3_ref = PK.wp3d(jnp.asarray(v), w, 2)
    assert _max_err(list(pk3.nodes), list(pk3_ref.nodes)) == 0.0
    leaves, _ = PK.best_basis(pk3, "l1")
    y3 = PPK.wp_reconstruct(pk3, leaves, w, mesh, **ax3)
    assert float(jnp.abs(y3 - jnp.asarray(v)).max()) < 5e-5


@pytest.mark.skipif(os.environ.get("PDWT_TPU_MULTIHOST") != "1",
                    reason="opt-in: spawns 2 jax.distributed processes "
                           "(PDWT_TPU_MULTIHOST=1); the same script runs "
                           "standalone as tools/multihost_smoke.py")
def test_multihost_two_process_smoke():
    """parallel.init_distributed + a GLOBAL 2-process mesh: one sharded
    SWT denoise step whose ring halos cross the process boundary,
    asserted bit-identical to the single-process step."""
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(__file__), "..", "tools",
                          "multihost_smoke.py")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIHOST SMOKE OK (2 processes)" in out.stdout
