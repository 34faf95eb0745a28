"""Smoke test of the main path on one GPU, at the sizes users run.

    python chip_smoke.py               # every phase, one GPU
    python chip_smoke.py --ab          # formulation timings (xla vs fma,
                                       # haar butterflies)
    python chip_smoke.py --multi-gpu   # sharded steps on four GPUs,
                                       # each against the same step on one

Every phase drives a public entry point on data drawn from ``--seed``
(uniform on [0, 255]) and compares it with an independent host
reference: the native float64 engine (``pdwt_tpu.native``, built from
``cpp/`` at first use) or the NumPy oracle of ``tests/np_oracle.py``.
For each phase it prints the error of every subband next to its bound,
the reconstruction error, ``memory_analysis()`` of the compiled steps,
the device's peak memory and the compile seconds (set-up time).

Bounds: per subband, max |device - reference| <= 1e-5 * max |reference|
(float32 at ``Precision.HIGHEST``; TF32 would miss it by ~100x);
reconstruction <= 1e-3 absolute on [0, 255] data; the bf16-fast tier
<= 2e-2 of the largest coefficient of the float32 transform of the same
bf16-cast input.
cuDNN picks its algorithms by autotuning, so the last bits can differ
between runs; the bounds leave room for that.

Runs only on a GPU.  Any failed check ends the run with a non-zero exit
and without the result line.  The last line of stdout is one JSON
object naming the device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import np_oracle  # noqa: E402
from pdwt_tpu import Wavelets, models  # noqa: E402
from pdwt_tpu.core import conv  # noqa: E402
from pdwt_tpu.core import separable as sep  # noqa: E402
from pdwt_tpu.core import separable3d as sep3  # noqa: E402
from pdwt_tpu.filters import get_wavelet, quad_filters  # noqa: E402
from pdwt_tpu.native import lib as native  # noqa: E402
from pdwt_tpu.utils import enable_compile_cache, interop  # noqa: E402

REL_BOUND = 1e-5      # per subband, relative to max |reference|
RECON_BOUND = 1e-3    # absolute, on [0, 255] data
BF16_BOUND = 2e-2     # bf16-fast vs float32 of the same bf16 input

#: Sizes of the phases: ``full`` runs on the card by default,
#: ``tiny`` exercises the same code on the CPU in the tests.
SIZES = {
    "full": dict(dwt2d=(8192, 8192), swt2d=(4096, 4096),
                 batch1d=(16384, 4096), vol=(256, 1024, 1024),
                 ns=(4096, 4096), pywt=(8192, 8192), ista=(4096, 4096),
                 mg_vol=(512, 2048, 2048), mg_img=(16384, 16384)),
    # the smallest sizes at which the facade keeps every requested level
    "tiny": dict(dwt2d=(448, 416), swt2d=(112, 104), batch1d=(8, 240),
                 vol=(28, 32, 36), ns=(112, 104), pywt=(96, 80),
                 ista=(128, 112), mg_vol=(16, 32, 32), mg_img=(64, 64)),
}


class CheckFailed(AssertionError):
    pass


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def compile_seconds():
    """Yields a one-element list that sums the backend compile seconds
    of the programs compiled inside the block."""
    total = [0.0]

    def on_event(name, secs, **_):
        if name == "/jax/core/compile/backend_compile_duration":
            total[0] += secs

    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        yield total
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)


def say(*a):
    print(*a, flush=True)


def _leaves(tree):
    return [np.asarray(t, np.float64) for t in jax.tree_util.tree_leaves(tree)]


def compare(name, dev, ref, *, bound=None, whole=False):
    """Per-leaf max |dev - ref| relative to max |ref| of that leaf, or of
    the whole pytree with ``whole=True``; returns the failures."""
    bound = REL_BOUND if bound is None else bound
    bad = []
    d_leaves, r_leaves = _leaves(dev), _leaves(ref)
    if len(d_leaves) != len(r_leaves):
        raise CheckFailed(f"{name}: {len(d_leaves)} subbands, reference "
                          f"has {len(r_leaves)}")
    top = max(float(np.abs(r).max()) for r in r_leaves)
    for i, (d, r) in enumerate(zip(d_leaves, r_leaves)):
        if d.shape != r.shape:
            raise CheckFailed(f"{name}[{i}]: shape {d.shape} vs {r.shape}")
        scale = (top if whole else float(np.abs(r).max())) or 1.0
        err = float(np.abs(d - r).max()) / scale
        ok = np.isfinite(d).all() and err <= bound
        say(f"  {name}[{i}] {d.shape}: max|dev-ref|/max|ref"
            f"{' over all subbands' if whole else ''}| = {err:.3e} "
            f"(bound {bound:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{name}[{i}]")
    return bad


def recon(name, dev, ref, *, bound=None):
    bound = RECON_BOUND if bound is None else bound
    d = np.asarray(dev, np.float64)
    err = float(np.abs(d - np.asarray(ref, np.float64)).max())
    ok = d.shape == np.shape(ref) and np.isfinite(d).all() and err <= bound
    say(f"  {name}: reconstruction max|dev-ref| = {err:.3e} "
        f"(bound {bound:.0e}) {'ok' if ok else 'FAIL'}")
    return [] if ok else [name]


def scalar(name, dev, ref, *, bound=None):
    bound = REL_BOUND if bound is None else bound
    err = abs(float(dev) - float(ref)) / max(abs(float(ref)), 1e-30)
    ok = np.isfinite(float(dev)) and err <= bound
    say(f"  {name}: dev {float(dev):.9e} ref {float(ref):.9e} rel "
        f"{err:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAIL'}")
    return [] if ok else [name]


def memory(name, jitted, *args):
    """memory_analysis() of a jitted step (reuses its compiled program)."""
    m = jitted.lower(*args).compile().memory_analysis()
    say(f"  {name} memory_analysis: argument {m.argument_size_in_bytes} B, "
        f"output {m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
        f"generated code {m.generated_code_size_in_bytes} B")


def facade_memory(W, kind, *args):
    """memory_analysis() of the facade's compiled ``kind`` program."""
    fns = [f for k, f in W._jit_cache.items() if k[0] == kind]
    memory(f"Wavelets.{kind}", fns[0], *args)


def device_peak(dev=None):
    stats = (dev or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def uniform(seed, shape):
    return np.random.default_rng(seed).uniform(0.0, 255.0, shape).astype(
        np.float32)


def _native64():
    native.set_dtype(np.float64)
    return native


# ---------------------------------------------------------------------------
# host references (independent of the code under test)
# ---------------------------------------------------------------------------

def ref_dwt2d(x, beta):
    nat = _native64()
    w = get_wavelet("db7")
    c = nat.dwt2d(x, w, 5)
    ct = type(c)(c.approx, tuple(tuple(nat.soft_threshold(b, beta)
                                       for b in lvl) for lvl in c.details))
    n1 = sum(nat.norm1(t) for t in jax.tree_util.tree_leaves(ct))
    return c, ct, n1, nat.idwt2d(ct, w, x.shape)


def _along(fn, axis, *arrs, rows=256):
    """Apply the 1D oracle ``fn`` (trailing axis) along ``axis`` of 2D
    arrays, ``rows`` lines at a time on contiguous copies; returns its
    output (or tuple of outputs) moved back to ``axis``."""
    arrs = [np.ascontiguousarray(np.moveaxis(a, axis, -1)) for a in arrs]
    with ThreadPoolExecutor(8) as pool:  # NumPy releases the GIL here
        parts = list(pool.map(lambda i: fn(*(a[i:i + rows] for a in arrs)),
                              range(0, arrs[0].shape[0], rows)))
    join = lambda p: np.moveaxis(np.concatenate(p, axis=0), -1, axis)
    if isinstance(parts[0], tuple):
        return tuple(join(p) for p in zip(*parts))
    return join(parts)


def _swt2_level(x, w, level):
    fwd = lambda t: np_oracle.swt1_level(t, w.dec_lo, w.dec_hi, level)
    lo_x, hi_x = _along(fwd, -1, x)
    a, h = _along(fwd, 0, lo_x)
    v, d = _along(fwd, 0, hi_x)
    return a, h, v, d


def _iswt2_level(a, h, v, d, w, level):
    inv = lambda lo, hi: np_oracle.iswt1_level(lo, hi, w.rec_lo, w.rec_hi,
                                               level)
    t0 = _along(inv, 0, a, h)
    t1 = _along(inv, 0, v, d)
    return _along(inv, -1, t0, t1)


def ref_swt2d(x, beta, levels=3):
    w = get_wavelet("db7")
    a = x.astype(np.float64)
    details = []
    for lvl in range(1, levels + 1):
        a, h, v, d = _swt2_level(a, w, lvl)
        details.append((h, v, d))
    c = sep.Coeffs2D(a, tuple(details))
    soft = lambda t: np.sign(t) * np.maximum(np.abs(t) - beta, 0.0)
    y = a
    for lvl in range(levels, 0, -1):
        h, v, d = (soft(t) for t in details[lvl - 1])
        y = _iswt2_level(y, h, v, d, w, lvl)
    return c, y


def ref_batch1d(x, beta):
    nat = _native64()
    w = get_wavelet("sym8")
    c = nat.dwt1d(x, w, 4)
    ct = type(c)(c.approx, tuple(nat.soft_threshold(t, beta)
                                 for t in c.details))
    n1 = sum(nat.norm1(t) for t in jax.tree_util.tree_leaves(ct))
    return c, ct, n1, nat.idwt1d(ct, w, x.shape[-1])


def ref_vol(x):
    return _native64().dwt3d(x, get_wavelet("db4"), 2)


def ref_ns(x):
    w = get_wavelet("db7")
    return _native64().dwt2d_ns(x, quad_filters(w.dec_lo, w.dec_hi), 3)


def ref_pywt(x, levels=5):
    w = get_wavelet("db7")
    a = x.astype(np.float64)
    levels_out = []
    for _ in range(levels):
        a, h, v, d = np_oracle.dwt2_level_mode(a, w.dec_lo, w.dec_hi,
                                               "symmetric")
        levels_out.append((h, v, d))
    return [a] + levels_out[::-1]


def ref_ista_first_objective(y, lam):
    nat = _native64()
    w = get_wavelet("db7")
    c = nat.dwt2d(y, w, 4)
    details = tuple(tuple(nat.soft_threshold(b, lam) for b in lvl)
                    for lvl in c.details)
    x1 = nat.idwt2d(type(c)(c.approx, details), w, y.shape)
    l1 = sum(np.abs(b).sum() for lvl in details for b in lvl)
    return 0.5 * float(np.square(x1 - y.astype(np.float64)).sum()) + lam * l1


# ---------------------------------------------------------------------------
# phases: each takes its input and its reference's future
# ---------------------------------------------------------------------------

def phase_dwt2d(x, ref, beta=20.0):
    """2D DWT denoise: Wavelets db7 5 levels, forward -> soft_threshold ->
    norm1 -> inverse; plus the bf16-fast tier of the forward."""
    W = Wavelets(x, wname="db7", levels=5)
    xd = W.d_image
    c = W.forward()
    W.soft_threshold(beta)
    ct = W.coeffs
    n1 = W.norm1()
    y = W.inverse()
    c_ref, ct_ref, n1_ref, y_ref = ref.result()
    bad = compare("coeffs", c, c_ref)
    bad += compare("thresholded", ct, ct_ref)
    bad += scalar("norm1", n1, n1_ref)
    bad += recon("inverse", y, y_ref)
    facade_memory(W, "fwd", xd, 0, 0, 0)
    facade_memory(W, "inv", ct, 0, 0, 0)

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    cb = Wavelets(xb, wname="db7", levels=5, dtype=jnp.bfloat16).forward()
    cf = Wavelets(xb.astype(jnp.float32), wname="db7", levels=5).forward()
    # every bf16 subband, the approximation chain included, is rounded
    # to bf16 at each level, so the bound is relative to the largest
    # coefficient of the transform
    bad += compare("bf16-fast coeffs", cb, cf, bound=BF16_BOUND,
                   whole=True)
    return bad


def phase_swt2d(x, ref, beta=20.0):
    """Translation-invariant SWT denoise: Wavelets db7 3 levels with cycle
    spinning.  SWT commutes with circular shifts, so the coefficients of
    the shifted image, shifted back, equal the unshifted reference."""
    W = Wavelets(x, wname="db7", levels=3, do_swt=True,
                 do_cycle_spinning=True)
    xd = W.d_image
    c = W.forward()
    sr, sc = W.current_shift_r, W.current_shift_c
    say(f"  cycle-spinning shift ({sr}, {sc})")
    W.soft_threshold(beta)
    ct = W.coeffs
    n1 = W.norm1()
    y = W.inverse()
    c_ref, y_ref = ref.result()
    unshift = lambda t: np.roll(np.asarray(t), (-sr, -sc), axis=(0, 1))
    bad = compare("coeffs", jax.tree_util.tree_map(unshift, c), c_ref)
    bad += [] if np.isfinite(n1) else ["norm1"]
    bad += recon("denoised", y, y_ref)
    facade_memory(W, "fwd", xd, 0, sr, sc)
    facade_memory(W, "inv", ct, 0, sr, sc)
    return bad


def phase_batch1d(x, ref, beta=10.0):
    """Batched 1D denoise: Wavelets sym8 4 levels over the rows."""
    W = Wavelets(x, wname="sym8", levels=4, ndim=1)
    xd = W.d_image
    c = W.forward()
    W.soft_threshold(beta)
    ct = W.coeffs
    n1 = W.norm1()
    y = W.inverse()
    c_ref, ct_ref, n1_ref, y_ref = ref.result()
    bad = compare("coeffs", c, c_ref)
    bad += compare("thresholded", ct, ct_ref)
    bad += scalar("norm1", n1, n1_ref)
    bad += recon("inverse", y, y_ref)
    facade_memory(W, "fwd", xd, 0, 0, 0)
    facade_memory(W, "inv", ct, 0, 0, 0)
    return bad


def phase_vol(x, ref):
    """3D volume: Wavelets db4 2 levels, forward -> inverse."""
    W = Wavelets(x, wname="db4", levels=2)
    xd = W.d_image
    c = W.forward()
    y = W.inverse()
    bad = compare("coeffs", c, ref.result())
    bad += recon("roundtrip", y, x)
    facade_memory(W, "fwd", xd, 0, 0, 0)
    facade_memory(W, "inv", c, 0, 0, 0)
    return bad


def phase_ns(x, ref):
    """Non-separable 2D DWT: Wavelets db7 quads, 3 levels."""
    W = Wavelets(x, wname="db7", levels=3, do_separable=False)
    xd = W.d_image
    c = W.forward()
    y = W.inverse()
    bad = compare("coeffs", c, ref.result())
    bad += recon("roundtrip", y, x)
    facade_memory(W, "fwd", xd, 0, 0, 0)
    facade_memory(W, "inv", c, 0, 0, 0)
    return bad


def phase_pywt(x, ref):
    """pywt drop-in with pywt's default mode: wavedec2/waverec2
    (mode="symmetric"), db7, 5 levels, each as one jitted step."""
    dec = jax.jit(partial(interop.wavedec2, wavelet="db7",
                          mode="symmetric", level=5))
    rec = jax.jit(partial(interop.waverec2, wavelet="db7",
                          mode="symmetric"))
    xd = jnp.asarray(x)
    c = dec(xd)
    y = rec(c)
    bad = compare("coeffs", c, ref.result())
    bad += recon("roundtrip", y, x)
    memory("wavedec2", dec, xd)
    memory("waverec2", rec, c)
    return bad


def phase_ista(y, ref, lam=15.0, iters=10):
    """Inverse problem: models.ista (FISTA, identity operator), db7
    4 levels.  With an orthogonal periodized wavelet the first iterate is
    already the minimiser, so the trace may only move by float32
    roundoff (1e-6 of the objective)."""
    step = jax.jit(partial(models.ista, wav="db7", levels=4, lam=lam,
                           iters=iters))
    yd = jnp.asarray(y)
    xs, trace = step(yd)
    tr = np.asarray(trace, np.float64)
    say(f"  objective trace: {tr.tolist()}")
    bad = [] if np.isfinite(tr).all() and np.isfinite(
        np.asarray(xs)).all() else ["ista finite"]
    rises = np.diff(tr).max(initial=0.0)
    ok = rises <= 1e-6 * abs(tr[0])
    say(f"  largest rise {rises:.3e} (bound {1e-6 * abs(tr[0]):.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    bad += [] if ok else ["ista non-increasing"]
    bad += scalar("first objective", tr[0], ref.result())
    memory("ista", step, yd)
    return bad


PHASES = {
    # name (also its key in SIZES): (seed offset, reference, device phase)
    "dwt2d": (0, partial(ref_dwt2d, beta=20.0), phase_dwt2d),
    "swt2d": (1, partial(ref_swt2d, beta=20.0), phase_swt2d),
    "batch1d": (2, partial(ref_batch1d, beta=10.0), phase_batch1d),
    "vol": (3, ref_vol, phase_vol),
    "ns": (4, ref_ns, phase_ns),
    "pywt": (5, ref_pywt, phase_pywt),
    "ista": (6, partial(ref_ista_first_objective, lam=15.0), phase_ista),
}


def run_phases(names, sizes, seed, workers=len(PHASES)):
    """Run phases in order; the host references run in a thread pool
    meanwhile.  Raises CheckFailed at the first phase with a failure."""
    inputs = {n: uniform(seed + PHASES[n][0], sizes[n]) for n in names}
    _native64().norm1(np.zeros(1))  # build the library before the threads
    with ThreadPoolExecutor(workers) as pool:
        refs = {n: pool.submit(PHASES[n][1], inputs[n]) for n in names}
        for n in names:
            phase = PHASES[n][2]
            doc = " ".join(phase.__doc__.split("\n\n")[0].split())
            say(f"phase {n}: {sizes[n]} {doc}")
            t0 = time.perf_counter()
            with compile_seconds() as comp:
                bad = phase(inputs[n], refs[n])
            say(f"  compile {comp[0]:.2f} s (set-up); phase "
                f"wall {time.perf_counter() - t0:.2f} s; device peak "
                f"{device_peak()} B")
            if bad:
                for f in refs.values():
                    f.cancel()
                raise CheckFailed(f"phase {n}: failed {bad}")


# ---------------------------------------------------------------------------
# --ab: formulation timings on the card
# ---------------------------------------------------------------------------

def _alternate(fns, runs=10):
    """Host-clock seconds of each zero-arg ``fns[k]`` (which ends in a
    device sync), after one warm-up each, in the order a, b, b, a;
    returns the median per key."""
    keys = list(fns)
    for k in keys:
        fns[k]()
    order = keys + keys[::-1]
    times = {k: [] for k in keys}
    for _ in range(runs // 2):
        for k in order:
            t0 = time.perf_counter()
            fns[k]()
            times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def _facade_run(W, xd, beta):
    def run():
        W.set_image(xd)
        W.forward()
        if beta is not None:
            W.soft_threshold(beta)
            W.norm1()
        W.inverse().block_until_ready()
    return run


def ab(sizes, seed, runs=10):
    """Median host-clock seconds, xla vs fma, of the facade steps of the
    2D DWT, SWT, batched 1D and 3D phases and of one 3D depth pass
    (analysis + synthesis); and of the haar butterflies (core.haar) vs
    the generic passes."""
    out = {}
    cases = {
        "dwt2d": (sizes["dwt2d"], dict(wname="db7", levels=5), 20.0),
        "swt2d": (sizes["swt2d"], dict(wname="db7", levels=3, do_swt=True,
                                       do_cycle_spinning=True), 20.0),
        "batch1d": (sizes["batch1d"], dict(wname="sym8", levels=4,
                                           ndim=1), 10.0),
        "vol": (sizes["vol"], dict(wname="db4", levels=2), None),
    }
    for name, (shape, kw, beta) in cases.items():
        xd = jnp.asarray(uniform(seed, shape))
        fns = {b: _facade_run(Wavelets(xd, backend=b, **kw), xd, beta)
               for b in ("xla", "fma")}
        out[name] = _alternate(fns, runs)
        say(f"ab {name} {shape}: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in out[name].items()))

    w4 = get_wavelet("db4")
    vol = jnp.asarray(uniform(seed, sizes["vol"]))[None, None]
    d = vol.shape[2]

    def depth_pass(b):
        def f(v):
            z = conv.analysis_pass(v, (w4.dec_lo, w4.dec_hi), axis=-3,
                                   backend=b)
            return conv.synthesis_pass(z, (w4.rec_lo, w4.rec_hi), axis=-3,
                                       out_len=d, backend=b)
        return jax.jit(f)

    jitted = {b: depth_pass(b) for b in ("xla", "fma")}
    for k, f in jitted.items():
        err = float(jnp.abs(f(vol) - vol).max())
        say(f"ab depth {k}: roundtrip error {err:.3e}")
        if not err <= RECON_BOUND:
            raise CheckFailed(f"depth pass {k}: roundtrip error {err}")
    out["depth"] = _alternate(
        {k: (lambda f=f: f(vol).block_until_ready())
         for k, f in jitted.items()}, runs)
    say("ab depth pass " + str(sizes["vol"]) + ": " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in out["depth"].items()))

    from pdwt_tpu.core import haar
    wh = get_wavelet("haar")
    img = jnp.asarray(uniform(seed, sizes["dwt2d"]))
    shape = img.shape
    hsteps = {
        "butterfly": lambda v: haar.haar_idwt2d(haar.haar_dwt2d(v, 5),
                                                shape),
        "xla": lambda v: sep.idwt2d(sep.dwt2d(v, wh, 5, backend="xla"), wh,
                                    shape, backend="xla"),
        "fma": lambda v: sep.idwt2d(sep.dwt2d(v, wh, 5, backend="fma"), wh,
                                    shape, backend="fma"),
    }
    hj = {k: jax.jit(f) for k, f in hsteps.items()}
    out["haar"] = _alternate(
        {k: (lambda f=f: f(img).block_until_ready()) for k, f in hj.items()},
        runs)
    say("ab haar 5-level roundtrip " + str(shape) + ": " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in out["haar"].items()))
    say("ab summary " + json.dumps(
        {k: {kk: round(vv * 1e3, 4) for kk, vv in v.items()}
         for k, v in out.items()}))
    return out


# ---------------------------------------------------------------------------
# --multi-gpu: the sharded steps against the same step on one card
# ---------------------------------------------------------------------------

def _max_diff(a, b, dev):
    """max |a - b| over the leaves, computed on ``dev`` one leaf at a
    time (so one device never holds a second copy of a whole pytree)."""
    diff = jax.jit(lambda x, y: jnp.abs(x - y).max())
    return max(float(diff(jax.device_put(x, dev), jax.device_put(y, dev)))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


def _spread(name, tree, devices):
    """Fail if the sharded result is not spread over every device."""
    used = set()
    for leaf in jax.tree_util.tree_leaves(tree):
        used |= {s.device for s in leaf.addressable_shards}
    peaks = [device_peak(d) for d in devices]
    say(f"  {name}: shards on {len(used)} of {len(devices)} devices; "
        f"per-device peak {peaks} B")
    if used != set(devices):
        raise CheckFailed(f"{name}: result on {len(used)} devices only")


def multi_gpu(sizes, seed):
    """par.dwt3d/idwt3d (db4, 2 levels) sharded 4-way over depth, and
    models.sharded_denoise_step(swt=True) (db7, 3 levels) sharded 2x2
    over rows x cols, each against the same step on one device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pdwt_tpu import parallel as par
    from pdwt_tpu.parallel import make_mesh

    devices = jax.devices()[:4]
    if len(devices) != 4:
        raise CheckFailed(f"--multi-gpu needs 4 devices, found "
                          f"{len(jax.devices())}")
    one = jax.devices()[0]
    w4, w7 = get_wavelet("db4"), get_wavelet("db7")
    key = jax.random.key(seed)
    bad = []

    # the sharded steps first, so the per-device peaks are theirs alone
    mesh = make_mesh((4,), ("dep",), devices=devices)
    shape = sizes["mg_vol"]
    vol = jax.jit(lambda k: jax.random.uniform(k, shape, jnp.float32, 0, 255),
                  out_shardings=NamedSharding(mesh, P("dep")))(key)
    fwd = jax.jit(lambda v: par.dwt3d(v, w4, 2, mesh, dep_axis="dep"))
    inv = jax.jit(lambda c: par.idwt3d(c, w4, shape, mesh, dep_axis="dep"))
    c_sh = fwd(vol)
    y_sh = inv(c_sh)
    say(f"multi-gpu 3D {shape}: par.dwt3d/idwt3d db4 2 levels, depth x4")
    _spread("dwt3d coeffs", c_sh, devices)
    memory("par.dwt3d", fwd, vol)
    memory("par.idwt3d", inv, c_sh)

    mesh2 = make_mesh((2, 2), ("row", "col"), devices=devices)
    shape2 = sizes["mg_img"]
    img = jax.jit(lambda k: jax.random.uniform(k, shape2, jnp.float32, 0, 255),
                  out_shardings=NamedSharding(mesh2, P("row", "col")))(key)
    step = jax.jit(lambda x: models.sharded_denoise_step(
        x, w7, 3, 20.0, mesh2, row_axis="row", col_axis="col", swt=True))
    out_sh, n_sh = step(img)
    say(f"multi-gpu SWT denoise {shape2}: models.sharded_denoise_step "
        f"db7 3 levels, rows x cols 2 x 2")
    _spread("denoised", out_sh, devices)
    memory("sharded_denoise_step", step, img)

    # the same steps on one device
    vol1 = jax.device_put(vol, one)
    fwd1 = jax.jit(lambda v: sep3.dwt3d(v, w4, 2))
    inv1 = jax.jit(lambda c: sep3.idwt3d(c, w4, shape))
    c1 = fwd1(vol1)
    dc = _max_diff(c_sh, c1, one)
    scale = max(float(jnp.abs(t).max()) for t in jax.tree_util.tree_leaves(c1))
    y1 = inv1(c1)
    dy = _max_diff(y_sh, y1, one)
    er = _max_diff(y1, vol1, one)
    say(f"3D sharded vs one device: coeffs max|diff| {dc:.3e}, inverse "
        f"max|diff| {dy:.3e} (bit-identical: {dc == 0 and dy == 0}); "
        f"one-device roundtrip error {er:.3e}")
    if not (dc <= REL_BOUND * scale and dy <= RECON_BOUND
            and er <= RECON_BOUND):
        bad.append("3D sharded vs one device")
    del c_sh, y_sh, c1, y1  # one device holds a whole 3D step at a time
    t3 = _alternate({"4 devices": lambda: inv(fwd(vol)).block_until_ready(),
                     "1 device": lambda: inv1(fwd1(vol1)).block_until_ready()},
                    runs=4)
    say("3D forward+inverse median host-clock: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in t3.items()))
    del vol, vol1

    img1 = jax.device_put(img, one)
    step1 = jax.jit(lambda x: models.denoise_step(
        x, None, w7, 3, 20.0, swt=True))
    out1, n1 = step1(img1)
    do = _max_diff(out_sh, out1, one)
    dn = abs(float(n_sh) - float(n1)) / abs(float(n1))
    say(f"SWT denoise sharded vs one device: denoised max|diff| {do:.3e}, "
        f"norm1 rel diff {dn:.3e} (bit-identical: {do == 0 and dn == 0})")
    if not (do <= RECON_BOUND and dn <= REL_BOUND):
        bad.append("SWT denoise sharded vs one device")
    del out_sh, out1
    t2 = _alternate({"4 devices": lambda: step(img)[0].block_until_ready(),
                     "1 device": lambda: step1(img1)[0].block_until_ready()},
                    runs=4)
    say("SWT denoise step median host-clock: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in t2.items()))
    if bad:
        raise CheckFailed(f"multi-gpu: failed {bad}")


# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, read by nvidia-smi in a child
    process (which never imports JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    g = p.add_mutually_exclusive_group()
    g.add_argument("--ab", action="store_true",
                   help="time the formulations instead of the phases")
    g.add_argument("--multi-gpu", action="store_true",
                   help="run the sharded steps on four GPUs only")
    args = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    say(f"card: {card_line()}")
    say(f"compile cache: {enable_compile_cache()}")
    say(f"jax {jax.__version__}; default formulation "
        f"{conv.get_default_backend()}; devices {len(jax.devices())} x "
        f"{dev.device_kind}")
    sizes = SIZES["full"]
    if args.ab:
        ab(sizes, args.seed)
    elif args.multi_gpu:
        multi_gpu(sizes, args.seed)
    else:
        run_phases(list(PHASES), sizes, args.seed)
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
