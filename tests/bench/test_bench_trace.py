"""The trace reduction, on a small trace recorded on an H100: three
steps each of ``stepwise`` (512x512), ``host_io`` (512x512) and
``fused`` (SWT, 256x256), in that order."""
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench import harness  # noqa: E402
from bench import trace as tr  # noqa: E402

SMALL = os.path.join(ROOT, "bench", "testdata", "small.xplane.pb")
MIXES = {"stepwise": 0, "host_io": 3, "fused": 6}


@pytest.fixture(scope="module")
def red():
    return tr.reduce(SMALL)


def _mix(red, name):
    i = MIXES[name]
    return tr.Reduction(red.steps[i:i + 3], red.devices, red.spans,
                        red.executions, red.allocations)


def test_union_and_merge():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert tr.union(iv) == 4
    assert tr.merged(iv) == [[0, 3], [5, 6]]
    assert tr.union([]) == 0


def test_reads_planes_steps_and_spans(red):
    assert len(red.steps) == 9
    assert list(red.devices) == ["/device:GPU:0"]
    names = {s[2] for s in red.spans}
    assert {"bench.forward", "bench.inverse", "bench.get_image",
            "bench.run_denoise", "bench.set_image"} <= names
    assert "GPU_0_bfc" in red.allocations


@pytest.mark.parametrize("mix,programs", [("stepwise", 4), ("host_io", 4),
                                          ("fused", 1)])
def test_programs_per_step(red, mix, programs):
    assert _mix(red, mix).executions_per_step() == programs


def test_copies_apart_from_kernels(red):
    dev = red.devices["/device:GPU:0"]
    assert dev.copies and dev.kernels
    assert all(name.startswith("Memcpy") for _, _, name in dev.copies)
    # host_io moves its image both ways; the resident mixes move scalars
    big = _mix(red, "host_io").copy_ns()
    assert big > 10 * _mix(red, "stepwise").copy_ns()
    assert big > 10 * _mix(red, "fused").copy_ns()


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_busy_idle_and_memory(red, mix):
    r = _mix(red, mix)
    busy = r.busy_ns()
    assert 0 < r.kernel_ns() <= busy < r.window_ns
    assert busy <= r.kernel_ns() + r.copy_ns()
    assert r.transient_bytes() > 0
    ops = r.top_ops()
    assert 0 < len(ops) <= 10
    assert [s for _, s in ops] == sorted((s for _, s in ops), reverse=True)
    gaps = r.idle_gaps()
    assert 0 < len(gaps) <= 10
    idle = sum(s for _, s in gaps)
    assert idle == pytest.approx((r.window_ns - busy) / 1e9, rel=1e-6)
    assert all(w.startswith("bench.") or w == "between steps"
               for w, _ in gaps)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_readers(red, mix):
    bench = harness.Bench(ROOT)
    r = _mix(red, mix)
    cfg = bench.config("dwt2d_db7_8192")
    cfg["shape"] = [512, 512]
    ctx = SimpleNamespace(trace=r, peaks=bench.peaks()["NVIDIA H100 80GB HBM3"],
                          work=bench.config_module(cfg["name"]).work(cfg))
    got = {m: bench.reader(m)(ctx) for m in
           ("programs_per_step", "device_ms", "idle_share", "transfer_ms",
            "transient_mb", "passes_roofline")}
    assert got["programs_per_step"] == r.executions_per_step()
    assert got["device_ms"] == pytest.approx(r.kernel_ns() / 3 / 1e6)
    assert 0 < got["idle_share"] < 100
    assert 0 <= got["passes_roofline"] <= 100
    assert got["transient_mb"] > 0


def test_readers_find_nothing_without_a_trace():
    bench = harness.Bench(ROOT)
    ctx = SimpleNamespace(trace=None, peaks=None, work=None)
    for m in bench.spec["per_layer"]:
        assert bench.reader(m["name"])(ctx) is None
    empty = tr.Reduction([(0, 10)], {}, [], [], {})
    ctx = SimpleNamespace(trace=empty, peaks=None, work=None)
    for m in bench.spec["per_layer"]:
        assert bench.reader(m["name"])(ctx) is None
