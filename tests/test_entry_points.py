"""What every transform entry point accepts and refuses: the two
precision tiers, the removed tiers, and the removed ``pallas`` backend;
plus where the persistent compile cache lands."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu import Wavelets
from pdwt_tpu.core import nonseparable as NS
from pdwt_tpu.core import separable as S
from pdwt_tpu.core import separable3d as S3
from pdwt_tpu.filters import get_wavelet, quad_filters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = get_wavelet("db2")
Q = quad_filters(W.dec_lo, W.dec_hi)
QI = quad_filters(W.rec_lo, W.rec_hi)
X2 = np.random.default_rng(3).uniform(0, 255, (16, 16)).astype(np.float32)
X3 = np.random.default_rng(4).uniform(0, 255, (8, 8, 8)).astype(np.float32)


def _c2(swt=False):
    return (S.swt2d if swt else S.dwt2d)(jnp.asarray(X2), W, 2)


def _c1(swt=False):
    return (S.swt1d if swt else S.dwt1d)(jnp.asarray(X2), W, 2)


def _c3(swt=False):
    return (S3.swt3d if swt else S3.dwt3d)(jnp.asarray(X3), W, 1)


#: every documented transform entry point that takes ``precision=``,
#: as (name, call(precision=...))
ENTRY_POINTS = {
    "dwt2d": lambda **k: S.dwt2d(jnp.asarray(X2), W, 2, **k),
    "idwt2d": lambda **k: S.idwt2d(_c2(), W, (16, 16), **k),
    "swt2d": lambda **k: S.swt2d(jnp.asarray(X2), W, 2, **k),
    "iswt2d": lambda **k: S.iswt2d(_c2(True), W, **k),
    "iswt2d_denoise": lambda **k: S.iswt2d_denoise(_c2(True), W, 1.0, **k),
    "dwt1d": lambda **k: S.dwt1d(jnp.asarray(X2), W, 2, **k),
    "idwt1d": lambda **k: S.idwt1d(_c1(), W, 16, **k),
    "swt1d": lambda **k: S.swt1d(jnp.asarray(X2), W, 2, **k),
    "iswt1d": lambda **k: S.iswt1d(_c1(True), W, **k),
    "dwt3d": lambda **k: S3.dwt3d(jnp.asarray(X3), W, 1, **k),
    "idwt3d": lambda **k: S3.idwt3d(_c3(), W, (8, 8, 8), **k),
    "swt3d": lambda **k: S3.swt3d(jnp.asarray(X3), W, 1, **k),
    "iswt3d": lambda **k: S3.iswt3d(_c3(True), W, **k),
    "iswt3d_denoise": lambda **k: S3.iswt3d_denoise(_c3(True), W, 1.0, **k),
    "dwt2d_ns": lambda **k: NS.dwt2d_ns(jnp.asarray(X2), Q, 2, **k),
    "idwt2d_ns": lambda **k: NS.idwt2d_ns(NS.dwt2d_ns(jnp.asarray(X2), Q, 2),
                                          QI, (16, 16), **k),
    "swt2d_ns": lambda **k: NS.swt2d_ns(jnp.asarray(X2), Q, 2, **k),
    "iswt2d_ns": lambda **k: NS.iswt2d_ns(NS.swt2d_ns(jnp.asarray(X2), Q, 2),
                                          QI, **k),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_accepts_exact(name):
    out = ENTRY_POINTS[name](precision="exact")
    assert all(np.isfinite(np.asarray(t)).all()
               for t in jax.tree_util.tree_leaves(out))


@pytest.mark.parametrize("tier", ["mixed", "bf16-balanced", "bf16-accurate"])
@pytest.mark.parametrize("name", ["dwt2d", "swt2d", "dwt1d", "dwt3d",
                                  "dwt2d_ns", "facade"])
def test_removed_tier_raises(name, tier):
    with pytest.raises(ValueError, match="unknown precision tier"):
        if name == "facade":
            Wavelets(X2, wname="db2", levels=2, precision=tier)
        else:
            ENTRY_POINTS[name](precision=tier)


PALLAS_CALLS = {
    "dwt2d": lambda: S.dwt2d(jnp.asarray(X2), W, 2, backend="pallas"),
    "idwt2d": lambda: S.idwt2d(_c2(), W, (16, 16), backend="pallas"),
    "swt2d": lambda: S.swt2d(jnp.asarray(X2), W, 2, backend="pallas"),
    "iswt2d": lambda: S.iswt2d(_c2(True), W, backend="pallas"),
    "dwt1d": lambda: S.dwt1d(jnp.asarray(X2), W, 2, backend="pallas"),
    "swt1d": lambda: S.swt1d(jnp.asarray(X2), W, 2, backend="pallas"),
    "dwt3d": lambda: S3.dwt3d(jnp.asarray(X3), W, 1, backend="pallas"),
    "swt3d": lambda: S3.swt3d(jnp.asarray(X3), W, 1, backend="pallas"),
    "facade": lambda: Wavelets(X2, wname="db2", levels=2,
                               backend="pallas").forward(),
    "symmetric mode": lambda: S.dwt2d(jnp.asarray(X2), W, 2,
                                      mode="symmetric", backend="pallas"),
}


@pytest.mark.parametrize("name", sorted(PALLAS_CALLS))
def test_pallas_backend_raises(name):
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        PALLAS_CALLS[name]()


def test_bf16_fast_needs_bf16_arrays():
    with pytest.raises(ValueError, match="bf16-fast"):
        S.dwt2d(jnp.asarray(X2), W, 2, precision="bf16-fast")
    with pytest.raises(ValueError, match="exact"):
        S.dwt2d(jnp.asarray(X2, jnp.bfloat16), W, 2, precision="exact")


# --- compile cache ---------------------------------------------------------

_CACHE_PROBE = """
import jax, jax.numpy as jnp
from pdwt_tpu.utils import cache
path = cache.enable_compile_cache(min_compile_secs=0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
print(cache.REPO_CACHE_DIR)
"""


def _probe(env):
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_compile_cache_follows_env(tmp_path):
    d = str(tmp_path / "cc")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=d)
    path, configured, repo_dir = _probe(env)
    assert path == configured == d
    assert repo_dir == os.path.join(ROOT, ".jax_cache")
    assert os.listdir(d), "nothing was cached in JAX_COMPILATION_CACHE_DIR"


def test_compile_cache_defaults_to_repo():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    path, configured, repo_dir = _probe(env)
    assert path == configured == repo_dir == os.path.join(ROOT, ".jax_cache")
