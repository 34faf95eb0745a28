"""Profiling / timing utilities.

The reference has no profiling machinery (SURVEY.md §5).  Two tools:

* :func:`device_time` — per-op device seconds.  Each dispatch adds a
  fixed host-side cost that swamps sub-millisecond kernels; chaining the
  op M times inside one jitted ``fori_loop`` and differencing two M
  values cancels every fixed cost.
* :func:`trace` — context manager around ``jax.profiler`` emitting a
  Perfetto/XProf trace directory.
"""
from __future__ import annotations

import contextlib
import time


def device_time(fn, arg, *, K: int = 8, M1: int = 1, M2: int = 5,
                reps: int = 8) -> float:
    """Pure device seconds per ``fn(x) -> x``-shaped call (slope method).

    The two loop sizes are sampled INTERLEAVED and the slope uses the
    minimum of each, so a slow phase of the host or device affects both
    alike."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def make(M):
        @jax.jit
        def lp(x):
            def body(_, v):
                for _ in range(M):
                    v = fn(v)
                return v
            return lax.fori_loop(0, K, body, x)

        float(jnp.sum(lp(arg)))  # compile + warm
        return lp

    lp1, lp2 = make(M1), make(M2)
    t1 = t2 = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(jnp.sum(lp1(arg)))
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(jnp.sum(lp2(arg)))
        t2 = min(t2, time.perf_counter() - t0)
    return (t2 - t1) / (K * (M2 - M1))


def device_time_any(fn, *args, K: int = 24, M1: int = 1, M2: int = 4,
                    reps: int = 3) -> float:
    """Slope-method device time for a shape-changing ``fn(*args)``.

    Chains calls by perturbing every input with a tiny scalar probe of
    the previous output — forcing sequential execution without
    requiring ``fn`` to be an endomorphism.  The M factor is unrolled
    (program size scales with M) but the K factor is a ``fori_loop``
    over the fixed-shape (inputs, probe) carry, so K can be large
    enough to divide dispatch jitter down to ~10 us without blowing up
    compile time.  The probe adds one elementwise add per input per
    iteration, so results slightly overestimate cheap ops."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def probe(out):
        leaves = jax.tree_util.tree_leaves(out)
        return sum(jnp.real(l.ravel()[0]).astype(jnp.float32)
                   for l in leaves) * 1e-30

    def make(M):
        @jax.jit
        def lp(*xs):
            def body(_, carry):
                s = carry[-1]
                vs = carry[:-1]
                for _ in range(M):
                    out = fn(*jax.tree_util.tree_map(
                        lambda x: x + s.astype(x.dtype), vs))
                    s = probe(out)
                return vs + (s,)

            return lax.fori_loop(0, K, body,
                                 tuple(xs) + (jnp.float32(0.0),))[-1]

        float(lp(*args))  # compile + warm
        return lp

    lp1, lp2 = make(M1), make(M2)
    t1 = t2 = float("inf")
    for _ in range(max(reps, 6)):  # interleaved min-of-samples per M
        t0 = time.perf_counter()
        float(lp1(*args))
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(lp2(*args))
        t2 = min(t2, time.perf_counter() - t0)
    return (t2 - t1) / (K * (M2 - M1))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace("dir"): run()`` -> XProf trace."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
