"""BENCHMARK.json: the names, units and limits it must keep, and every
name resolving to its files."""
import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench import harness  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj"
                   r"|head|expansion|per_tok")
ENTRIES = [(kind, e["name"]) for kind in KEYS for e in SPEC[kind]]


def _entry(kind, name):
    return next(e for e in SPEC[kind] if e["name"] == name)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128


def test_run_seconds_fit_a_full_check():
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    cells = 24  # what later PRs may grow to
    assert 1200 + cells * 2 * 90 + (2 + 14 * cells) * (r + 60) <= 43200


@pytest.mark.parametrize("kind,name", ENTRIES)
def test_entry_keys_and_names(kind, name):
    e = _entry(kind, name)
    extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
    assert KEYS[kind] <= set(e) <= KEYS[kind] | extra
    assert NAME.match(e["name"])
    names = [x["name"] for x in SPEC[kind]]
    assert names.count(name) == 1
    if "unit" in e:
        assert UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
    for k in ("why", "layer", "source"):
        if k in e:
            assert _line(e[k])


@pytest.mark.parametrize("name", [e["name"] for e in SPEC["end_to_end"]])
def test_end_to_end(name):
    e = _entry("end_to_end", name)
    assert e["source"] in ("host_clock", "device_trace")
    assert 0.01 <= e["bound"] <= 0.25
    for cell in e.get("workloads", []):
        _entry("workloads", cell)


def test_setup_s_is_an_end_to_end_metric():
    e = _entry("end_to_end", "setup_s")
    assert e["unit"] == "s" and e["better"] == "lower" and e["bound"] <= 0.25


@pytest.mark.parametrize("name", [e["name"] for e in SPEC["per_layer"]])
def test_per_layer(name):
    e = _entry("per_layer", name)
    assert e["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    moved = _entry("end_to_end", e["moves"])
    e2e_cells = moved.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for cell in e.get("workloads", []):
        _entry("workloads", cell)
        assert cell in e2e_cells
    # a layer keeps one spelling across its metrics
    assert "\n" not in e["layer"]
    assert callable(harness.Bench(ROOT).reader(name))


def test_layers_spelled_alike():
    by_lower = {}
    for e in SPEC["per_layer"]:
        by_lower.setdefault(e["layer"].lower(), set()).add(e["layer"])
    assert all(len(v) == 1 for v in by_lower.values())


@pytest.mark.parametrize("name", [e["name"] for e in SPEC["configs"]])
def test_config_files(name):
    e = _entry("configs", name)
    assert e["source"].startswith("https://")
    assert e["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    assert [c["file"] for c in SPEC["configs"]].count(e["file"]) == 1
    assert len(e["reduced"]) <= 16
    for k in e["reduced"]:
        assert NAME.match(k) and not WIDTH.search(k)
    bench = harness.Bench(ROOT)
    cfg = bench.config(name)
    assert cfg["name"] == name
    assert set(cfg["limits"]) >= {"image_rel_err", "norm1_rel_err"}
    mod = bench.config_module(name)
    for fn in ("work", "reference", "control"):
        assert callable(getattr(mod, fn))
    assert any(w["config"] == name for w in SPEC["workloads"])


@pytest.mark.parametrize("name", [e["name"] for e in SPEC["workloads"]])
def test_cells(name):
    w = _entry("workloads", name)
    _entry("configs", w["config"])
    assert NAME.match(w["traffic"])
    mix = harness.Bench(ROOT).traffic(w["traffic"])
    assert mix["name"] == w["traffic"] and mix["loop"] == "closed"
    assert w["chips"] in (1, 4)
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1
    bench = harness.Bench(ROOT)
    e2e = [m["name"] for m in bench.metrics_for("end_to_end", name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.metrics_for("per_layer", name)


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_files_are_named_from_names():
    for p in SPEC["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
            for f in files:
                if f.endswith(".pyc"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
