"""chip_smoke.py on the CPU: it refuses to run without a GPU, and every
phase it runs on the card passes here at a tiny size (the card runs the
same functions at the sizes in ``SIZES["full"]``)."""
import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run(ROOT, SCRIPT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "platform 'cpu'" in r.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    r = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("name", ["dwt2d", "swt2d", "batch1d", "vol", "ns",
                                  "pywt", "ista"])
def test_phase_tiny(smoke, name, capsys):
    smoke.run_phases([name], smoke.SIZES["tiny"], seed=0)
    out = capsys.readouterr().out
    assert f"phase {name}" in out and "FAIL" not in out
    assert "memory_analysis" in out and "compile" in out


def test_phase_failure_raises(smoke, monkeypatch, capsys):
    """A check outside its bound ends the run (no phase continues)."""
    monkeypatch.setattr(smoke, "REL_BOUND", 0.0)
    with pytest.raises(smoke.CheckFailed, match="phase vol"):
        smoke.run_phases(["vol", "ns"], smoke.SIZES["tiny"], seed=0)
    assert "phase ns" not in capsys.readouterr().out


def test_ab_tiny(smoke, capsys):
    out = smoke.ab(smoke.SIZES["tiny"], seed=0, runs=2)
    assert set(out) == {"dwt2d", "swt2d", "batch1d", "vol", "depth", "haar"}
    assert set(out["dwt2d"]) == {"xla", "fma"}
    assert all(t > 0 for v in out.values() for t in v.values())


def test_multi_gpu_tiny(smoke, capsys):
    """The four-device path on four of the virtual CPU devices."""
    smoke.multi_gpu(smoke.SIZES["tiny"], seed=0)
    out = capsys.readouterr().out
    assert out.count("shards on 4 of 4 devices") == 2
