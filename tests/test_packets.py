"""Wavelet packets + best basis (beyond the reference: PDWT stops at
the pyramid transform)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu import ops
from pdwt_tpu.core import packets as P
from pdwt_tpu.core import separable as S
from pdwt_tpu.filters import get_wavelet


@pytest.mark.parametrize("wname,shape,levels", [
    ("db4", (64, 64), 2),
    ("sym6", (48, 80), 2),      # non-dyadic
    ("db2", (37, 53), 3),       # odd sizes at every depth
    ("bior3.5", (64, 64), 2),
])
def test_wp2d_roundtrip(rng, wname, shape, levels):
    w = get_wavelet(wname)
    x = jnp.asarray(rng.standard_normal(shape))
    pk = P.wp2d(x, w, levels)
    assert pk.levels == levels
    assert pk.nodes[levels].shape[-3] == 4 ** levels
    y = P.iwp2d(pk.nodes[levels], w, shape)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-8)


def test_wp2d_depth1_equals_dwt_level(rng):
    """Depth-1 packet nodes are exactly the level-1 DWT subbands in
    (a, h, v, d) order; the a-recursion chain equals the DWT approx."""
    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((64, 96)))
    pk = P.wp2d(x, w, 3)
    c = S.dwt2d(x, w, 3)
    h1, v1, d1 = c.details[0]
    np.testing.assert_allclose(np.asarray(pk.nodes[1][1]), np.asarray(h1),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(pk.nodes[1][2]), np.asarray(v1),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(pk.nodes[1][3]), np.asarray(d1),
                               atol=1e-10)
    # node 0 at depth j = j-level approximation
    np.testing.assert_allclose(np.asarray(pk.nodes[3][0]),
                               np.asarray(c.approx), atol=1e-10)


def test_wp1d_roundtrip_batched(rng):
    w = get_wavelet("db5")
    x = jnp.asarray(rng.standard_normal((3, 101)))
    pk = P.wp1d(x, w, 3)
    y = P.iwp1d(pk.nodes[3], w, 101)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-8)


def test_best_basis_partition_and_reconstruct(rng):
    w = get_wavelet("db4")
    x = jnp.asarray(rng.standard_normal((64, 64)))
    pk = P.wp2d(x, w, 3)
    for cost in ("shannon", "logenergy", "l1"):
        leaves, total = P.best_basis(pk, cost)
        # disjoint cover: the leaf supports tile the unit interval^2
        area = sum(4.0 ** -j for j, _ in leaves)
        assert abs(area - 1.0) < 1e-12, leaves
        y = P.wp_reconstruct(pk, leaves, w)
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-8)
    # threshold cost
    leaves, total = P.best_basis(pk, "threshold", thresh=0.5)
    assert total <= 64 * 64 + 1e-9


def test_best_basis_prefers_packets_for_high_frequency(rng):
    """A near-Nyquist oscillation concentrates in packet nodes the
    pyramid DWT never isolates — best basis must split a detail node
    (leaf deeper than depth 1 outside the a-chain) and beat both the
    root and the pyramid in cost."""
    w = get_wavelet("db8")
    n = 128
    t = np.arange(n)
    sig = np.cos(np.pi * 0.53 * t)[:, None] * np.cos(np.pi * 0.51 * t)[None, :]
    x = jnp.asarray(sig)
    pk = P.wp2d(x, w, 3)
    leaves, total = P.best_basis(pk, "shannon")
    assert any(j >= 2 and i % 4 != 0 and i >= 4 for j, i in leaves), leaves
    costs = P.wp_costs(pk, "shannon")
    root_cost = float(costs[0][0])
    assert total < root_cost
    y = P.wp_reconstruct(pk, leaves, w)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-8)


def test_wp_reconstruct_full_depth_and_mapfn(rng):
    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((32, 32)))
    pk = P.wp2d(x, w, 2)
    full = tuple((2, i) for i in range(16))
    y = P.wp_reconstruct(pk, full, w)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-9)
    # map_fn thresholds every leaf except the a-chain
    from pdwt_tpu.ops.threshold import _soft

    def mfn(v, j, i):
        return v if i == 0 else _soft(v, 0.3)

    y2 = P.wp_reconstruct(pk, full, w, map_fn=mfn)
    assert float(jnp.abs(y2 - x).max()) > 0  # something was shrunk
    # identity map_fn on the trivial basis returns the image
    y3 = P.wp_reconstruct(pk, ((0, 0),), w)
    np.testing.assert_allclose(np.asarray(y3), np.asarray(x), atol=1e-12)


def test_wp_reconstruct_jits_and_grads(rng):
    w = get_wavelet("db2")
    x = jnp.asarray(rng.standard_normal((32, 32)), jnp.float32)
    pk = P.wp2d(x, w, 2)
    leaves, _ = P.best_basis(pk, "shannon")

    def loss(img):
        p = P.wp2d(img, w, 2)
        y = P.wp_reconstruct(p, leaves, w)
        return jnp.sum(y * y)

    g = jax.jit(jax.grad(loss))(x)
    # d/dx sum((Wx)^-1 W x)^2 with perfect reconstruction = 2x
    np.testing.assert_allclose(np.asarray(g), 2 * np.asarray(x),
                               rtol=1e-3, atol=1e-3)


def test_wp_errors(rng):
    w = get_wavelet("db2")
    x = jnp.asarray(rng.standard_normal((32, 32)))
    pk = P.wp2d(x, w, 2)
    with pytest.raises(ValueError, match="not tile|cover"):
        P.wp_reconstruct(pk, ((1, 0), (1, 1)), w)  # missing v, d
    with pytest.raises(ValueError, match="overlapping|not tile|cover"):
        P.wp_reconstruct(pk, tuple([(0, 0)] + [(1, i) for i in range(4)]),
                         w)
    with pytest.raises(ValueError, match="power of 4"):
        P.iwp2d(pk.nodes[2][..., :8, :, :], w, (32, 32))
    with pytest.raises(ValueError, match="unknown cost"):
        P.best_basis(pk, "nope")


def test_wp2d_interpret_pallas_matches_xla(rng, monkeypatch):
    """The packet composition on the fma formulation matches the xla
    formulation."""
    w = get_wavelet("db4")
    x = jnp.asarray(rng.standard_normal((64, 128)), jnp.float32)
    pa = P.wp2d(x, w, 2, backend="fma")
    xa = P.wp2d(x, w, 2, backend="xla")
    np.testing.assert_allclose(np.asarray(pa.nodes[2]),
                               np.asarray(xa.nodes[2]), atol=1e-4)
    y = P.iwp2d(pa.nodes[2], w, (64, 128), backend="fma")
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-4)


def test_packet_denoise_model(rng):
    from pdwt_tpu.models import packet_denoise

    clean = np.zeros((64, 64), np.float32)
    clean[16:48, 16:48] = 100.0
    noisy = jnp.asarray(clean + rng.standard_normal((64, 64)) * 10.0,
                        jnp.float32)
    den = packet_denoise(noisy, "db4", 3, 30.0)
    mse_n = float(jnp.mean((noisy - clean) ** 2))
    mse_d = float(jnp.mean((den - clean) ** 2))
    assert mse_d < 0.5 * mse_n, (mse_d, mse_n)


def test_wp3d_roundtrip_and_best_basis(rng):
    """3D packets: full roundtrip, pyramid-chain equality, best-basis
    cover + reconstruction (odd sizes included)."""
    from pdwt_tpu.core import separable3d as S3

    w = get_wavelet("db3")
    x = jnp.asarray(rng.standard_normal((12, 20, 28)))
    pk = P.wp3d(x, w, 2)
    assert pk.nodes[2].shape[-4] == 64
    y = P.iwp3d(pk.nodes[2], w, (12, 20, 28))
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-8)
    # node 0 chain = pyramid approx; children 1..7 = DETAIL_KEYS_3D order
    c = S3.dwt3d(x, w, 2)
    np.testing.assert_allclose(np.asarray(pk.nodes[2][0]),
                               np.asarray(c.approx), atol=1e-10)
    for k in range(7):
        np.testing.assert_allclose(np.asarray(pk.nodes[1][k + 1]),
                                   np.asarray(c.details[0][k]), atol=1e-10)
    leaves, total = P.best_basis(pk, "shannon")
    assert abs(sum(8.0 ** -j for j, _ in leaves) - 1.0) < 1e-12
    y2 = P.wp_reconstruct(pk, leaves, w)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(x), atol=1e-8)
    with pytest.raises(ValueError, match="power of 8"):
        P.iwp3d(pk.nodes[1][..., :4, :, :, :], w, (12, 20, 28))


def test_packet_denoise_auto_beta():
    from pdwt_tpu.models import packet_denoise

    # own seeded generator: the session-scoped rng fixture makes the
    # draw depend on test ORDER, and this MSE bound is marginal enough
    # (0.58-0.62x across samples) that an unlucky sample flips it
    rng = np.random.default_rng(2026)
    clean = np.zeros((64, 64), np.float32)
    clean[16:48, 16:48] = 100.0
    noisy = jnp.asarray(clean + rng.standard_normal((64, 64)) * 10.0,
                        jnp.float32)
    den = packet_denoise(noisy, "db4", 3)  # beta=None -> universal
    mse_n = float(jnp.mean((noisy - clean) ** 2))
    mse_d = float(jnp.mean((den - clean) ** 2))
    assert mse_d < 0.6 * mse_n, (mse_d, mse_n)


def test_wavelet_packets_facade(rng):
    """Stateful WaveletPackets facade: forward / best_basis /
    fused-threshold reconstruct / node access, 2D and 1D."""
    from pdwt_tpu import WaveletPackets
    from pdwt_tpu.ops.threshold import _soft

    img = np.asarray(rng.standard_normal((64, 64)) * 10, np.float32)
    WP = WaveletPackets(img, wname="db4", levels=3)
    assert "not decomposed" in repr(WP)
    WP.forward()
    leaves, cost = WP.best_basis("shannon")
    assert "leaf basis" in repr(WP)
    rec = WP.reconstruct()
    np.testing.assert_allclose(np.asarray(rec), img, atol=1e-4)
    # fused threshold inside reconstruction == manual map_fn
    den = WP.reconstruct(beta=5.0)
    ref = P.wp_reconstruct(WP.packets, leaves, WP.wavelet,
                           map_fn=lambda v, j, i:
                           v if i == 0 else _soft(v, 5.0))
    np.testing.assert_allclose(np.asarray(den), np.asarray(ref),
                               atol=1e-5)
    # node access matches the packets pytree; costs shapes
    np.testing.assert_array_equal(WP.get_node(1, 2),
                                  np.asarray(WP.packets.nodes[1][2]))
    cs = WP.costs("l1")
    assert [len(c) for c in cs] == [1, 4, 16, 64]

    # 1D + full-tree reconstruct without best_basis
    sig = np.asarray(rng.standard_normal((2, 128)), np.float32)
    W1 = WaveletPackets(sig, wname="db2", levels=2, ndim=1)
    W1.forward()
    rec1 = W1.reconstruct()
    np.testing.assert_allclose(np.asarray(rec1), sig, atol=1e-4)

    with pytest.raises(ValueError):
        WaveletPackets(img, levels=0)
    with pytest.raises(ValueError):
        WaveletPackets(img, ndim=4)
    with pytest.raises(ValueError):
        WaveletPackets(img, wname="db2", levels=1).reconstruct()
