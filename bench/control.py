"""The control of the comparison that decides ``correct``.

The configurations state float32 at the ``exact`` tier (every product
at full float32 precision).  The control is the plain reference put in
the program's place and computed one step lower: float32 on the device
with every filter product taken as three bfloat16 products
(``hi*hi + hi*lo + lo*hi``, the ``high`` precision of a float32 matrix
unit, ``BF16_BF16_F32_X3``), the step that a tensor-core formulation of
the passes would tempt.  Its answers have to come out as not correct.

    python3 bench/control.py --workload <cell> --seeds 1 2 3

prints, for each seed, every number the cell compares, for the
control's answers and beside the limit, on the pool images the cell
draws from that seed.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from bench import reference  # noqa: E402


def _parts(w):
    """bfloat16 high and low parts of a float32 value, as float32."""
    hi = w.astype(jnp.bfloat16).astype(jnp.float32)
    return hi, (w - hi).astype(jnp.bfloat16).astype(jnp.float32)


def _corr(x, taps, axis, step, m):
    """reference._corr in float32, products in three bfloat16 passes."""
    n = x.shape[axis]
    lo = min(o for _, o in taps)
    hi = max(o for _, o in taps)
    span = step * (m - 1) + 1
    xp = jnp.take(x, np.arange(lo, hi + span) % n, axis=axis)
    xh, xl = _parts(xp)
    acc = None
    for w, o in taps:
        wh, wl = _parts(jnp.float32(w))
        cut = lambda a: lax.slice_in_dim(a, o - lo, o - lo + span, step, axis)
        th, tl = cut(xh), cut(xl)
        term = th * wh + (th * wl + tl * wh)
        acc = term if acc is None else acc + term
    return acc


class Bf16x3:
    xp = jnp
    corr = staticmethod(_corr)


@functools.lru_cache(maxsize=8)
def _program(cfg_json, image):
    cfg = json.loads(cfg_json)
    return jax.jit(lambda v: reference.denoise2d(v, cfg, image=image,
                                                 ops=Bf16x3))


def denoise2d(x, cfg, *, image=True):
    """The reference's denoise step at the control's precision, one
    jitted program on the default device; NumPy results."""
    fn = _program(json.dumps(cfg, sort_keys=True), image)
    out = jax.device_get(fn(jnp.asarray(x, jnp.float32)))
    out["norm1"] = float(out["norm1"])
    return out


def main(argv=None) -> int:
    from bench import generator, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = harness.Bench(harness.ROOT)
    cell = bench.cell(args.workload)
    cfg, mod, mix = bench.config(cell["config"]), bench.config_module(
        cell["config"]), bench.traffic(cell["traffic"])
    harness.say(f"control of {args.workload}: {jax.devices()[0].device_kind}")
    failed_all = True
    n = cfg["pool"]
    for seed in args.seeds:
        pool = [np.asarray(x) for x in generator.make_pool(cfg, mix, seed)]
        # as many steps as a window holds, at least two passes of the pool
        plan = harness.check_plan(cfg, seed, 8 * n + seed % n)
        answers = {i: mod.control(cfg, pool[i], image=(i == plan["last"] % n))
                   for i in {plan["sample"], plan["last"] % n}}
        outs = {k: harness.pick(mix, answers[k % n]) for k in plan["steps"]}
        refs = harness.references(cfg, mod, pool, plan)
        checks = harness.compare(cfg, refs, outs, plan)
        bad = [k for k, v in checks.items() if not v["value"] <= v["limit"]]
        failed_all &= bool(bad)
        harness.say(f"seed {seed}: " + json.dumps(checks)
                    + f" -> {'not correct' if bad else 'CORRECT'}")
    harness.say("control fails on every seed" if failed_all
                else "CONTROL PASSED ON SOME SEED")
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
