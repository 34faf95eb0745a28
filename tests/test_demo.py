"""Demo CLI parity (reference: src/demo.cpp scenarios)."""
import os
import subprocess
import sys

import numpy as np
import pytest


@pytest.fixture()
def image_dat(tmp_path, rng):
    img = (rng.standard_normal((64, 64)) * 50 + 128).astype(np.float32)
    p = tmp_path / "img.dat"
    img.tofile(p)
    return str(p), img


def _run(args):
    return subprocess.run(
        [sys.executable, "-m", "pdwt_tpu.demo", *args],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": os.environ.get("HOME", "")},
    )


def test_demo_scenario2_perfect_reconstruction(tmp_path, image_dat):
    path, img = image_dat
    out = str(tmp_path / "res.dat")
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "2",
              "--wavelet", "db4", "--levels", "2", "--out", out])
    assert r.returncode == 0, r.stderr
    assert "max |reconstruction - input|" in r.stdout
    rec = np.fromfile(out, dtype=np.float32).reshape(64, 64)
    assert np.abs(rec - img).max() < 1e-2


def test_demo_scenario3_threshold(tmp_path, image_dat):
    path, _ = image_dat
    out = str(tmp_path / "res.dat")
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "3",
              "--wavelet", "db2", "--levels", "2", "--beta", "30",
              "--out", out])
    assert r.returncode == 0, r.stderr
    assert "soft threshold" in r.stdout


def test_demo_native_engine(tmp_path, image_dat):
    from pdwt_tpu import native
    if not native.is_available():
        pytest.skip("native toolchain unavailable")
    path, img = image_dat
    out = str(tmp_path / "res.dat")
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "2",
              "--wavelet", "sym8", "--levels", "2", "--native",
              "--out", out])
    assert r.returncode == 0, r.stderr
    rec = np.fromfile(out, dtype=np.float32).reshape(64, 64)
    assert np.abs(rec - img).max() < 1e-2


def test_demo_precision_flag(tmp_path, image_dat):
    """--precision bf16 runs the serving mode end-to-end through the CLI
    (round 3); reconstruction stays within the bf16 contract."""
    path, img = image_dat
    out = str(tmp_path / "res.dat")
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "2",
              "--wavelet", "db2", "--levels", "2", "--precision", "bf16",
              "--out", out])
    assert r.returncode == 0, r.stderr
    rec = np.fromfile(out, dtype=np.float32).reshape(64, 64)
    assert np.abs(rec - img).max() < 5.0


def test_demo_3d_volume(tmp_path, rng):
    """--nd routes a raw volume through the 3D facade path (and the
    native 3D engine with --native); reconstruction is exact."""
    vol = (rng.standard_normal((8, 32, 32)) * 50 + 128).astype(np.float32)
    path = str(tmp_path / "vol.dat")
    vol.tofile(path)
    for extra in ([], ["--native"]):
        if extra:
            from pdwt_tpu import native
            if not native.is_available():
                pytest.skip("native toolchain unavailable")
        out = str(tmp_path / "res3.dat")
        r = _run([path, "--nd", "8", "--nr", "32", "--nc", "32",
                  "--scenario", "2", "--wavelet", "db2", "--levels", "2",
                  "--out", out, *extra])
        assert r.returncode == 0, r.stderr
        rec = np.fromfile(out, dtype=np.float32).reshape(8, 32, 32)
        assert np.abs(rec - vol).max() < 1e-2


def test_demo_auto_beta(tmp_path, image_dat):
    """--auto-beta picks the threshold from the data (scenario 3)."""
    path, img = image_dat
    for ab in ("universal", "bayes"):
        out = str(tmp_path / f"res_{ab}.dat")
        r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "3",
                  "--wavelet", "db3", "--levels", "3",
                  "--auto-beta", ab, "--out", out])
        assert r.returncode == 0, r.stderr
        assert ("BayesShrink" in r.stdout) == (ab == "bayes")
        rec = np.fromfile(out, dtype=np.float32).reshape(64, 64)
        assert np.isfinite(rec).all()
    # --native rejects --auto-beta
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "3",
              "--auto-beta", "bayes", "--native"])
    assert r.returncode != 0


def test_demo_scenario4_packet_denoise(tmp_path, image_dat):
    path, img = image_dat
    out = str(tmp_path / "res4.dat")
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "4",
              "--wavelet", "db3", "--levels", "3", "--auto-beta",
              "universal", "--out", out])
    assert r.returncode == 0, r.stderr
    assert "best-basis packet denoise" in r.stdout
    rec = np.fromfile(out, dtype=np.float32).reshape(64, 64)
    assert np.isfinite(rec).all()
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "4",
              "--native"])
    assert r.returncode != 0


def test_demo_scenario5_starlet_denoise(tmp_path, image_dat):
    path, img = image_dat
    out = str(tmp_path / "res5.dat")
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "5",
              "--levels", "3", "--out", out])
    assert r.returncode == 0, r.stderr
    assert "starlet k-sigma auto denoise" in r.stdout
    rec = np.fromfile(out, dtype=np.float32).reshape(64, 64)
    assert np.isfinite(rec).all()
    assert np.abs(rec - img).max() > 0
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "5",
              "--native"])
    assert r.returncode != 0


def test_demo_scenario6_dtcwt_denoise(tmp_path, image_dat):
    path, img = image_dat
    out = str(tmp_path / "res6.dat")
    r = _run([path, "--nr", "64", "--nc", "64", "--scenario", "6",
              "--levels", "3", "--out", out])
    assert r.returncode == 0, r.stderr
    assert "dual-tree complex magnitude denoise" in r.stdout
    rec = np.fromfile(out, dtype=np.float32).reshape(64, 64)
    assert np.isfinite(rec).all()
