"""The one general load generator: a traffic mix is data.

A mix (``bench/traffic/<name>.json``) names where the inputs live
(``"input": "device"`` or ``"host"``) and the calls of one step on the
system's facade, ``pdwt_tpu.Wavelets``, built from the configuration's
``"facade"`` arguments.  Each call is ``{"call": <method>, "args":
[...], "as": <output name or list of names>}``; an argument ``"$input"``
is the step's pool image and ``"$<key>"`` is the configuration's value
of ``<key>``.  ``"after"`` maps output names to facade attributes read
once the step's calls are made.  A step ends when everything it
returned is ready on the device.

Every mix is a closed loop with one caller: step ``k`` is sent when
step ``k - 1`` has returned, and reads pool image ``k mod pool``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def key_for(seed: int):
    """A threefry key from any non-negative whole number (more than 32
    bits are welcome)."""
    words = np.random.SeedSequence(seed).generate_state(2, np.uint32)
    return jax.random.wrap_key_data(jnp.asarray(words), impl="threefry2x32")


def make_pool(cfg: dict, mix: dict, seed: int, devices=None) -> list:
    """``cfg["pool"]`` images uniform on [0, 255], drawn on the device
    from ``seed`` one at a time (so the pool is never held twice), and
    copied to host memory when the mix feeds host arrays."""
    shape = tuple(cfg["shape"])
    dtype = jnp.dtype(cfg["dtype"])
    draw = jax.jit(lambda k, i: jax.random.uniform(
        jax.random.fold_in(k, i), shape, dtype, 0.0, 255.0))
    key = key_for(seed)
    pool = []
    for i in range(cfg["pool"]):
        img = draw(key, i)
        if mix["input"] == "host":
            img = np.asarray(img)
        else:
            img.block_until_ready()
        pool.append(img)
    return pool


class Caller:
    """The one caller of a closed loop: makes the mix's calls on one
    facade; ``step(k)`` returns the step's named outputs, ready."""

    def __init__(self, cfg: dict, mix: dict, pool: list):
        from pdwt_tpu import Wavelets

        self.cfg, self.mix, self.pool = cfg, mix, pool
        self.facade = Wavelets(pool[0], **cfg["facade"])
        self.calls = [(c["call"], c.get("args", []), c.get("as"))
                      for c in mix["calls"]]

    def _arg(self, a, k):
        if isinstance(a, str) and a.startswith("$"):
            return (self.pool[k % len(self.pool)] if a == "$input"
                    else self.cfg[a[1:]])
        return a

    def step(self, k: int) -> dict:
        out = {}
        with jax.profiler.StepTraceAnnotation("bench.step", step_num=k):
            for name, args, as_ in self.calls:
                with jax.profiler.TraceAnnotation("bench." + name):
                    r = getattr(self.facade, name)(
                        *(self._arg(a, k) for a in args))
                if isinstance(as_, str):
                    out[as_] = r
                elif as_:
                    out.update(zip(as_, r))
            for name, attr in self.mix.get("after", {}).items():
                out[name] = getattr(self.facade, attr)
            jax.block_until_ready(out)
        return out
