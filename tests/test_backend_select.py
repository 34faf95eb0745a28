"""Formulation selection: the explicit ``backend=`` argument, the
``PDWT_TPU_BACKEND`` / ``set_default_backend`` override, and the
per-platform default of :func:`conv.default_formulation`."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdwt_tpu.core import conv
from pdwt_tpu.core import separable as sep
from pdwt_tpu.filters import get_wavelet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_default_backend():
    prev = conv._default_backend
    yield
    conv._default_backend = prev


def _count_gather(monkeypatch):
    calls = []
    orig = conv._gather_corr

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(conv, "_gather_corr", spy)
    return calls


def test_default_backend_override_reaches_transforms(monkeypatch):
    calls = _count_gather(monkeypatch)
    conv.set_default_backend("gather")
    w = get_wavelet("db2")
    x = np.random.default_rng(0).standard_normal((16, 16))
    sep.dwt2d(x, w, 1)  # backend=None must resolve to the override
    assert len(calls) == 2  # one gather correlation per pass


def test_env_var_seeds_default_backend():
    # conv reads the env var at import; the setter is the runtime
    # equivalent — both feed the same _default_backend.
    conv.set_default_backend("fma")
    assert conv.get_default_backend() == "fma"
    assert conv.resolve_backend(None) == "fma"
    conv.set_default_backend(None)
    assert conv.get_default_backend() == conv.default_formulation(
        jax.default_backend())


def test_pallas_override_accepted_and_mapped():
    """The Pallas kernels are gone: "pallas" is an unknown backend for
    the setter, the override and the explicit argument alike."""
    with pytest.raises(ValueError, match="unknown backend"):
        conv.set_default_backend("pallas")
    conv._default_backend = "pallas"  # what PDWT_TPU_BACKEND=pallas gives
    with pytest.raises(ValueError, match="unknown backend"):
        conv.get_default_backend()
    conv._default_backend = None
    with pytest.raises(ValueError, match="unknown backend"):
        conv.resolve_backend("pallas")


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        conv.set_default_backend("cuda")


def test_explicit_kwarg_beats_override(monkeypatch):
    calls = _count_gather(monkeypatch)
    conv.set_default_backend("gather")
    assert conv.resolve_backend("fma") == "fma"
    w = get_wavelet("db2")
    x = np.random.default_rng(0).standard_normal((16, 16))
    sep.dwt2d(x, w, 1, backend="fma")
    assert not calls


def test_mxu_modes_interpret(rng):
    """The bf16-fast tier on both device formulations: bf16 arrays in,
    bf16 subbands out, within bf16 rounding of the f32 oracle; the
    removed 'mixed' tier raises instead of computing something else."""
    w = get_wavelet("db7")
    x = jnp.asarray(
        np.random.default_rng(1).uniform(0, 255, (128, 128)), jnp.float32)
    cg = sep.dwt2d(x, w, 1, backend="gather")
    for be in ("xla", "fma"):
        cb = sep.dwt2d(x.astype(jnp.bfloat16), w, 1, backend=be,
                       precision="bf16-fast")
        assert all(t.dtype == jnp.bfloat16 for t in jax.tree.leaves(cb))
        rel = max(float(jnp.abs(a.astype(jnp.float32) - b).max())
                  for a, b in zip(jax.tree.leaves(cb), jax.tree.leaves(cg)))
        rel /= float(jnp.abs(cg.approx).max())
        assert rel < 1e-2
        yb = sep.idwt2d(cb, w, (128, 128), backend=be)
        assert yb.dtype == jnp.bfloat16
        assert float(jnp.abs(yb.astype(jnp.float32) - x).max()) < 3.0
    with pytest.raises(ValueError, match="unknown precision"):
        sep.dwt2d(x, w, 1, precision="mixed")


# --- the per-platform default ---------------------------------------------

@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_default_formulation_per_platform(monkeypatch, platform):
    expected = {"cpu": "xla", "gpu": conv._PLATFORM_DEFAULT["gpu"]}[platform]
    assert expected in ("xla", "fma")
    assert conv.default_formulation(platform) == expected
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    conv._default_backend = None
    assert conv.get_default_backend() == expected
    assert conv.resolve_backend(None) == expected


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_default_formulation_unknown_platform_raises(monkeypatch, platform):
    with pytest.raises(ValueError, match=platform):
        conv.default_formulation(platform)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    conv._default_backend = None
    with pytest.raises(ValueError, match="no default wavelet formulation"):
        sep.dwt2d(jnp.zeros((8, 8)), get_wavelet("db2"), 1)


def test_override_wins_on_unknown_platform(monkeypatch):
    """An explicit override needs no platform default."""
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    conv.set_default_backend("fma")
    assert conv.get_default_backend() == "fma"


@pytest.mark.parametrize("value,ok", [("fma", True), ("xla", True),
                                      ("gather", True), ("pallas", False)])
def test_env_var_values(value, ok):
    """PDWT_TPU_BACKEND at import: the three formulations are taken; the
    removed "pallas" raises at the first transform."""
    code = ("import numpy as np\n"
            "from pdwt_tpu.core import conv, separable as sep\n"
            "from pdwt_tpu.filters import get_wavelet\n"
            "print(conv._default_backend)\n"
            "sep.dwt2d(np.zeros((8, 8), np.float32), get_wavelet('db2'), 1)\n"
            "print(conv.get_default_backend())\n")
    env = dict(os.environ, PDWT_TPU_BACKEND=value, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    if ok:
        assert r.returncode == 0, r.stderr
        assert r.stdout.split() == [value, value]
    else:
        assert r.returncode != 0
        assert "unknown backend 'pallas'" in r.stderr
