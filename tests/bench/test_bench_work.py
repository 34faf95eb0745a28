"""The irreducible work of each configuration, pinned to the worked
values, and the roofline share that it sets."""
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench import harness  # noqa: E402
from bench import trace as tr  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"

# config: (bytes per step, FLOPs per step, least time in ms, bound by)
WORKED = {
    "dwt2d_db7_8192": (536_870_912, 10.01e9, 0.160, "bandwidth"),
    "swt2d_db7_4096": (134_217_728, 16.91e9, 0.252, "compute"),
}


@pytest.fixture(scope="module")
def bench():
    return harness.Bench(ROOT)


@pytest.mark.parametrize("name", sorted(WORKED))
def test_worked_values(bench, name):
    cfg = bench.config(name)
    work = bench.config_module(name).work(cfg)
    nbytes, flops, least_ms, bound = WORKED[name]
    peaks = bench.peaks()[H100]
    assert work["bytes"] == nbytes
    assert work["flops"] == pytest.approx(flops, rel=1e-3)
    t_bw = work["bytes"] / peaks["hbm_bytes_per_s"]
    t_fl = work["flops"] / peaks["fp32_flops_per_s"]
    assert max(t_bw, t_fl) * 1e3 == pytest.approx(least_ms, abs=5e-4)
    assert (t_bw > t_fl) == (bound == "bandwidth")


def test_textbook_counts():
    from bench import reference

    # 2*hlen multiply-adds per input sample per decimated 2D level,
    # 6*hlen per undecimated level, synthesis the same again
    one = {"shape": [64, 64], "wavelet": "db2", "dtype": "float32",
           "levels": 1}
    w = reference.work2d(dict(one, transform="dwt2d"))
    assert w == {"bytes": 2 * 64 * 64 * 4, "flops": 2 * 2 * 2 * 4 * 64 * 64}
    w = reference.work2d(dict(one, transform="swt2d", levels=2))
    assert w["flops"] == 2 * 2 * 6 * 4 * 64 * 64 * 2


def test_peak_table_has_its_source(bench):
    for kind, p in bench.peaks().items():
        assert p["hbm_bytes_per_s"] > 0 and p["fp32_flops_per_s"] > 0
        assert "data sheet" in p["source"]


@pytest.mark.parametrize("name", sorted(WORKED))
def test_roofline_reads_the_work_not_the_implementation(bench, name):
    """The same device time gives the same share whatever the trace's
    kernels are called or how many there are, and a step that took
    exactly the least time reads 100%."""
    cfg = bench.config(name)
    work = bench.config_module(name).work(cfg)
    peaks = bench.peaks()[H100]
    least_ns = 1e9 * max(work["bytes"] / peaks["hbm_bytes_per_s"],
                         work["flops"] / peaks["fp32_flops_per_s"])
    read = bench.reader("passes_roofline")

    def share(kernels):
        dev = tr.Device(kernels=kernels)
        red = tr.Reduction([(0, 10 * least_ns)], {"/device:GPU:0": dev},
                           [], [], {})
        return read(SimpleNamespace(trace=red, work=work, peaks=peaks))

    one = share([(0, least_ns, "fused")])
    many = share([(i * least_ns / 4, (i + 1) * least_ns / 4, f"k{i}")
                  for i in range(4)])
    assert one == pytest.approx(100.0) and many == pytest.approx(100.0)
    assert share([(0, 2 * least_ns, "slow")]) == pytest.approx(50.0)
