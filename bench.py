"""Benchmark harness — headline config of BASELINE.json.

Measures Mpix/s for the 2D db7 5-level forward+inverse DWT on a
2048x2048 float32 image (the BASELINE.json headline config) on the
accelerator JAX selects, plus the same roundtrip on bf16 arrays and the
translation-invariant SWT denoise step (SWT forward + threshold +
inverse, the reference's demo scenario 3).

Methodology: each step is chained M times inside a jitted
``lax.fori_loop`` body and timed for two different M; the slope removes
the fixed dispatch and loop-iteration cost (utils/profiling.py).

A failing phase ends the run with a non-zero exit.  Prints exactly one
JSON line on stdout, naming the device; diagnostics go to stderr.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

N = 2048
LEVELS = 5
WNAME = "db7"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    import jax

    from pdwt_tpu.utils import device_time, enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    wav = get_wavelet(WNAME)
    rng = np.random.default_rng(0)
    # [0,255] uniform: the range BASELINE.md's accuracy targets (and the
    # reference's own haar figure, src/haar.cu:190-192) are stated on.
    img = jnp.asarray(rng.uniform(0.0, 255.0, (N, N)), dtype=jnp.float32)

    def roundtrip(x):
        c = sep.dwt2d(x, wav, LEVELS)
        return sep.idwt2d(c, wav, (N, N))

    t0 = time.perf_counter()
    out = jax.jit(roundtrip)(img)
    out.block_until_ready()
    log(f"compile+first run: {time.perf_counter() - t0:.2f}s")
    err = float(jnp.max(jnp.abs(out - img)))
    log(f"max recon error on [0,255]-scale data: {err:.3e}")
    t = device_time(roundtrip, img)
    mpix_s = (N * N) / t / 1e6
    log(f"device time per roundtrip: {t*1e3:.3f} ms")

    # the bf16-fast tier: bf16 arrays, f32 accumulation
    imgb = img.astype(jnp.bfloat16)
    outb = jax.jit(roundtrip)(imgb)
    errb = float(jnp.max(jnp.abs(outb.astype(jnp.float32)
                                 - imgb.astype(jnp.float32))))
    tb = device_time(roundtrip, imgb)
    log(f"bf16 roundtrip: {tb*1e3:.3f} ms, err {errb:.3f}")

    # translation-invariant SWT denoise step
    M = 1024
    x1 = jnp.asarray(rng.uniform(0, 255, (M, M)), jnp.float32)

    def ti(v):
        c = sep.swt2d(v, wav, 3)
        return sep.iswt2d_denoise(c, wav, 10.0, mode="soft")

    jax.block_until_ready(jax.jit(ti)(x1))
    tt = device_time(ti, x1)
    log(f"TI step: {tt*1e3:.3f} ms")

    print(json.dumps({
        "metric": f"Mpix/s, 2D {WNAME} {LEVELS}-level fwd+inv ({N}x{N})",
        "value": round(mpix_s, 1),
        "unit": "Mpix/s",
        "max_recon_error": err,
        "bf16_mpix_s": round((N * N) / tb / 1e6, 1),
        "bf16_max_recon_error": errb,
        "ti_swt_mpix_s": round(M * M / tt / 1e6, 1),
        "device": device,
    }))


if __name__ == "__main__":
    main()
