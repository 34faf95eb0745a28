"""The benchmark's float64 reference against the repository's NumPy
oracle and filter bank, and its control failing the limits."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import np_oracle  # noqa: E402
from bench import generator, harness, reference  # noqa: E402

TINY = {"dwt2d_db7_8192": (224, 192), "swt2d_db7_4096": (112, 96)}


@pytest.mark.parametrize("name", ["db2", "db4", "db7", "db10"])
def test_filters_match_the_bank(name):
    from pdwt_tpu.filters import get_wavelet

    w, f = get_wavelet(name), reference.filters(name)
    for k in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_allclose(f[k], getattr(w, k), rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", ["db4", "db7"])
def test_one_level_matches_the_oracle(name):
    f = reference.filters(name)
    x = np.random.default_rng(1).uniform(0, 255, (48, 40))
    a, det = reference.forward2d(x, f, 1)
    want = np_oracle.dwt2_level(x, f["dec_lo"], f["dec_hi"])
    for got, ref in zip((a,) + det[0], want):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    y = np_oracle.idwt2_level(*want, f["rec_lo"], f["rec_hi"], x.shape)
    np.testing.assert_allclose(reference.inverse2d(a, det, f), y, atol=1e-9)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_swt_level_matches_the_oracle(level):
    f = reference.filters("db7")
    x = np.random.default_rng(2).uniform(0, 255, (40, 48))
    lo, hi = reference._analysis(x, f, 1, 1 << (level - 1))
    want = np_oracle.swt1_level(x, f["dec_lo"], f["dec_hi"], level)
    np.testing.assert_allclose(lo, want[0], atol=1e-9)
    np.testing.assert_allclose(hi, want[1], atol=1e-9)
    back = reference._synthesis(lo, hi, f, 1, 1 << (level - 1))
    np.testing.assert_allclose(
        back, np_oracle.iswt1_level(lo, hi, f["rec_lo"], f["rec_hi"], level),
        atol=1e-9)


@pytest.mark.parametrize("swt", [False, True])
def test_roundtrip(swt):
    f = reference.filters("db7")
    x = np.random.default_rng(3).uniform(0, 255, (128, 96))
    a, det = reference.forward2d(x, f, 3, swt)
    np.testing.assert_allclose(reference.inverse2d(a, det, f, swt), x,
                               atol=1e-9)


@pytest.mark.parametrize("cell", ["dwt2d_db7_8192.stepwise",
                                  "swt2d_db7_4096.fused",
                                  "dwt2d_db7_8192.host_io"])
@pytest.mark.parametrize("seed", [11, 2**33 + 12, 13])
def test_control_is_not_correct(cell, seed):
    """The reference at the control's precision, in the program's place,
    fails at least one of the cell's limits on every seed."""
    bench = harness.Bench(ROOT)
    w = bench.cell(cell)
    cfg, mod, mix = (bench.config(w["config"]),
                     bench.config_module(w["config"]),
                     bench.traffic(w["traffic"]))
    cfg["shape"] = list(TINY[w["config"]])
    pool = [np.asarray(x) for x in generator.make_pool(cfg, mix, seed)]
    n = cfg["pool"]
    plan = harness.check_plan(cfg, seed, 3 * n + 1)
    answers = {i: mod.control(cfg, pool[i])
               for i in {plan["sample"], plan["last"] % n}}
    outs = {k: harness.pick(mix, answers[k % n]) for k in plan["steps"]}
    checks = harness.compare(cfg, harness.references(cfg, mod, pool, plan),
                             outs, plan)
    assert checks
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    # and the reference in the program's place passes every limit
    refs = {i: mod.reference(cfg, pool[i]) for i in answers}
    outs = {k: harness.pick(mix, refs[k % n]) for k in plan["steps"]}
    checks = harness.compare(cfg, refs, outs, plan)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
