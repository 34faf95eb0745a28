"""Every cell end to end on the CPU at a tiny size, the command's
refusals, a cell added as new files only, and ``correct`` coming out
false when the timed path is broken underneath."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench import harness  # noqa: E402

# the smallest sizes at which the facade keeps every level asked for
TINY = {"dwt2d_db7_8192": (448, 416), "swt2d_db7_4096": (112, 104)}
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
CELLS = {w["name"]: w["config"] for w in SPEC["workloads"]}


def _run(cell, tmp_path, *, trace=0, seed=5, root=ROOT, shape=None):
    args = ["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
            "--trace", str(trace)]
    bench = harness.Bench(root)
    return harness.run(args, root=root, allow_cpu=True, cache=False,
                       shape=shape or TINY[bench.cell(cell)["config"]],
                       trace_dir=str(tmp_path / "trace"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_end_to_end(cell, trace, tmp_path):
    r = _run(cell, tmp_path, trace=trace, seed=2**31 + 7)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    bench = harness.Bench(ROOT)
    if trace:
        allowed = {m["name"] for m in bench.metrics_for("per_layer", cell)}
        assert set(r["metrics"]) <= allowed
    else:
        want = {m["name"] for m in bench.metrics_for("end_to_end", cell)}
        assert set(r["metrics"]) == want
        assert all(v["value"] > 0 for k, v in r["metrics"].items()
                   if k != "peak_mem_gb")
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])


def test_same_seed_same_inputs():
    from bench import generator

    bench = harness.Bench(ROOT)
    cfg = bench.config("dwt2d_db7_8192")
    cfg["shape"] = [32, 32]
    mix = bench.traffic("host_io")
    a = generator.make_pool(cfg, mix, 2**40 + 3)
    b = generator.make_pool(cfg, mix, 2**40 + 3)
    c = generator.make_pool(cfg, mix, 2**40 + 4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])


def _command(cwd, *extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "dwt2d_db7_8192.stepwise", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_command_refuses_the_cpu():
    r = _command(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs a GPU" in r.stderr


def test_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__", ".*"))
    r = _command(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_a_new_config_mix_and_metric_are_new_files(tmp_path):
    """Adds a configuration, a traffic mix and a per-layer metric as new
    files and new entries in a copy of the benchmark, and runs the new
    cell; no file that was there changes but BENCHMARK.json."""
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".*"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((tmp_path / "bench/configs/dwt2d_db7_8192.json")
                     .read_text())
    cfg.update(name="dwt2d_db4_tiny", wavelet="db4", levels=2,
               facade={"wname": "db4", "levels": 2, "do_swt": False})
    (tmp_path / "bench/configs/dwt2d_db4_tiny.json").write_text(
        json.dumps(cfg))
    shutil.copy(tmp_path / "bench/configs/dwt2d_db7_8192.py",
                tmp_path / "bench/configs/dwt2d_db4_tiny.py")
    (tmp_path / "bench/traffic/norm_only.json").write_text(json.dumps({
        "name": "norm_only", "loop": "closed", "callers": 1,
        "input": "device", "after": {},
        "calls": [{"call": "set_image", "args": ["$input"]},
                  {"call": "forward"},
                  {"call": "soft_threshold", "args": ["$beta"]},
                  {"call": "norm1", "as": "norm1"}]}))
    (tmp_path / "bench/metrics/steps_traced.py").write_text(
        "def read(ctx):\n"
        "    return None if ctx.trace is None else len(ctx.trace.steps)\n")
    spec["configs"].append({"name": "dwt2d_db4_tiny", "source": "https://x",
                            "file": "bench/configs/dwt2d_db4_tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dwt2d_db4_tiny.norm_only",
                              "config": "dwt2d_db4_tiny",
                              "traffic": "norm_only", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "Facade", "moves": "mpix_s",
                              "workloads": ["dwt2d_db4_tiny.norm_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    r = _run("dwt2d_db4_tiny.norm_only", tmp_path, trace=1,
             root=str(tmp_path), shape=(64, 64))
    assert r["correct"] is True and set(r["checks"]) == {"norm1_rel_err"}
    assert r["metrics"]["steps_traced"]["value"] >= 1
    after = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())


def _broken(monkeypatch, fault):
    """Break the timed path underneath the harness."""
    from pdwt_tpu.api import Wavelets

    if fault == "state unchanged":
        # the synthesis hands back the image it was given
        monkeypatch.setattr(Wavelets, "inverse", lambda self: self.d_image)
        monkeypatch.setattr(
            Wavelets, "run_denoise",
            lambda self, beta: (self.d_image, 0.0 * self.d_image.sum()))
    elif fault == "threshold skipped":
        monkeypatch.setattr(Wavelets, "soft_threshold", lambda self, b: None)
        real = Wavelets.run_denoise
        monkeypatch.setattr(Wavelets, "run_denoise",
                            lambda self, beta: real(self, 0.0))
    elif fault == "answer altered":
        real_norm, real_inv, real_den = (Wavelets.norm1, Wavelets.inverse,
                                         Wavelets.run_denoise)
        monkeypatch.setattr(Wavelets, "norm1",
                            lambda self: real_norm(self) * (1 + 1e-4))
        monkeypatch.setattr(Wavelets, "inverse",
                            lambda self: real_inv(self).at[3, 5].add(1.0))

        def den(self, beta):
            y, n1 = real_den(self, beta)
            return y.at[3, 5].add(1.0), n1 * (1 + 1e-4)
        monkeypatch.setattr(Wavelets, "run_denoise", den)


@pytest.mark.parametrize("fault", ["state unchanged", "threshold skipped",
                                   "answer altered"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_broken_path_is_not_correct(cell, fault, monkeypatch, tmp_path):
    _broken(monkeypatch, fault)
    r = _run(cell, tmp_path, seed=9)
    assert r["correct"] is False, r["checks"]
    assert r["failed"] >= 1
