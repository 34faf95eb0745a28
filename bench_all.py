"""Benchmark sweep over the five BASELINE.json configs.

Prints one JSON line per config (stderr diagnostics).  ``bench.py`` stays
the single-line headline harness the driver runs; this is the full sweep
for the record.

Optional argv substrings filter which configs run (case-insensitive
match against the config name), e.g. ``python bench_all.py 3D WP2D``
runs only the volume and packet configs.  Every printed line names the
device (platform, kind, count).
"""
from __future__ import annotations

import json
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    import jax

    from pdwt_tpu.utils import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from pdwt_tpu import ops
    from pdwt_tpu.core import separable as sep
    from pdwt_tpu.filters import get_wavelet, quad_filters
    from pdwt_tpu.core import nonseparable as ns
    from pdwt_tpu.models.denoiser import denoise_step
    from pdwt_tpu.utils import device_time, device_time_any

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    results = []
    filters = [f.lower() for f in sys.argv[1:]]

    def want(name):
        return not filters or any(f in name.lower() for f in filters)

    # lazy input arrays: a filtered run does not build inputs for the
    # configs it skips, so record() takes thunks and this memo keeps base
    # arrays shared across configs
    _arrays = {}

    def arr(shape, dtype=None, seed=0):
        def make():
            key = (shape, str(dtype), seed)
            if key not in _arrays:
                g = np.random.default_rng(seed)
                _arrays[key] = jnp.asarray(g.standard_normal(shape),
                                           dtype or jnp.float32)
            return _arrays[key]
        return make

    def record(name, pixels, fn, arg, **kw):
        if not want(name):
            return
        if callable(arg):
            arg = arg()
        t = device_time(fn, arg, **kw)
        rate = pixels / t / 1e6
        results.append({"config": name, "value": round(rate, 1),
                        "unit": "Mpix/s", "ms": round(t * 1e3, 3),
                        "device": device})
        log(f"{name}: {t*1e3:.3f} ms = {rate:.0f} Mpix/s")

    # 1. haar 2D single-level fwd+inv, 512x512
    img512 = arr((512, 512))
    wh = get_wavelet("haar")
    # tiny config: widen the loop sizes so the slope rises above the
    # dispatch jitter
    record("haar 2D 1-level fwd+inv 512x512", 512 * 512,
           lambda x: sep.idwt2d(sep.dwt2d(x, wh, 1), wh, (512, 512)),
           img512, K=32, M2=17)

    # 2. separable db7 2D 5-level fwd+inv, 2048x2048
    img = arr((2048, 2048))
    w7 = get_wavelet("db7")
    record("db7 2D 5-level fwd+inv 2048x2048", 2048 * 2048,
           lambda x: sep.idwt2d(sep.dwt2d(x, w7, 5), w7, (2048, 2048)), img)

    # 3. batched 1D sym8 (1024 x 4096) + soft_threshold + norm1 + inverse
    w8 = get_wavelet("sym8")
    sig = arr((1024, 4096))

    def cfg3(x):
        c = sep.dwt1d(x, w8, 4)
        c = ops.soft_threshold(c, 0.1)
        n = ops.norm1(c)
        return sep.idwt1d(c, w8, 4096) + 0 * n

    record("batched 1D sym8 4-level denoise 1024x4096", 1024 * 4096,
           cfg3, sig)

    # 4. SWT 2D 3-level with random-shift denoising (full TI step)
    img1k = arr((1024, 1024))
    key = jax.random.key(0)

    def cfg4(x):
        out, _ = denoise_step(x, key, "db7", 3, 1.0, swt=True)
        return out

    record("SWT db7 2D 3-level TI denoise step 1024x1024", 1024 * 1024,
           cfg4, img1k)

    # 5. non-separable DWT with custom (outer-product) filters
    qf = quad_filters(w7.dec_lo, w7.dec_hi)
    qi = quad_filters(w7.rec_lo, w7.rec_hi)
    record("non-separable db7 2D 5-level fwd+inv 2048x2048", 2048 * 2048,
           lambda x: ns.idwt2d_ns(ns.dwt2d_ns(x, qf, 5), qi,
                                  (2048, 2048)), img)

    # 5b. genuinely-2D (rank-3) user quads through the rank-decomposed
    # separable-sum path (timing config: synthetic quads, fwd+inv cost
    # only — PR needs a biorthogonal 2D design)
    rq = np.zeros((4, 8, 8))
    g = np.random.default_rng(1)
    for _ in range(3):
        rq += np.einsum("si,j->sij", g.standard_normal((4, 8)),
                        g.standard_normal(8))
    rq /= np.abs(rq).sum(axis=(1, 2), keepdims=True)
    record("non-separable RANK-3 quad 2D 2-level fwd+inv 1024x1024",
           1024 * 1024,
           lambda x: ns.idwt2d_ns(ns.dwt2d_ns(x, rq, 2), rq,
                                  (1024, 1024)), img1k)

    # 6. 3D volume roundtrip (beyond the reference: no 3D there)
    from pdwt_tpu.core import separable3d as sep3

    w4 = get_wavelet("db4")
    vol = arr((128, 512, 512))
    record("3D db4 2-level fwd+inv 128x512x512", 128 * 512 * 512,
           lambda x: sep3.idwt3d(sep3.dwt3d(x, w4, 2), w4,
                                 (128, 512, 512)), vol)

    # 7. 3D SWT TI-denoise step (threshold-then-inverse +
    # thresholded_norm1 — the volume analogue of config 4)
    from pdwt_tpu.models.denoiser import denoise_step_3d

    vol7 = arr((64, 512, 512))

    def cfg7(x):
        out, _ = denoise_step_3d(x, key, "db4", 2, 1.0, swt=True)
        return out

    record("3D SWT db4 2-level TI denoise step 64x512x512",
           64 * 512 * 512, cfg7, vol7)

    # 8. full wavelet-packet decomposition (beyond the reference): every
    # depth transforms ALL nodes in one batched level call, so
    # per-pixel work is depth-proportional (no decimation decay)
    from pdwt_tpu.core import packets as pk_mod

    record("WP2D db7 3-depth full packet fwd+inv 2048x2048", 2048 * 2048,
           lambda x: pk_mod.iwp2d(pk_mod.wp2d(x, w7, 3).nodes[3], w7,
                                  (2048, 2048)), img)

    # 8b. starlet (isotropic à-trous) denoise: 4 full-res B3 smoothing
    # levels + thresholds + gen-2 reconstruction
    from pdwt_tpu.core import starlet_denoise

    record("starlet gen2 4-level denoise 2048x2048", 2048 * 2048,
           lambda x: starlet_denoise(x, 4, 1.0), img)

    # 8c. dual-tree complex WT: 4 row/col tree combos per level
    from pdwt_tpu.core import dtcwt2d, idtcwt2d

    record("DTCWT 2D 4-level fwd+inv 2048x2048", 2048 * 2048,
           lambda x: idtcwt2d(dtcwt2d(x, 4), (2048, 2048)), img)

    # 9. continuous wavelet transform (beyond the reference): batched
    # FFT + broadcast scale bank — measures XLA's FFT path
    from pdwt_tpu.core import cwt as cwt_fn  # the function (module: core.continuous)
    from pdwt_tpu.core import log_scales

    scales9 = log_scales(4096, dj=0.25)  # 45 scales
    if want("CWT"):
        sig9 = arr((64, 4096))()
        # the scaleogram changes shape (adds the scale axis), so the
        # endomorphism slope timer cannot chain it — use the
        # probe-chained variant built for shape-changing ops
        t9 = device_time_any(lambda x: jnp.abs(cwt_fn(x, scales9)) ** 2,
                             sig9)
        results.append({"config": f"CWT morlet {len(scales9)}-scale "
                                  "64x4096",
                        "value": round(64 * 4096 / t9 / 1e6, 1),
                        "unit": "Mpix/s", "ms": round(t9 * 1e3, 3),
                        "device": device})
        log(f"CWT morlet {len(scales9)}-scale 64x4096: {t9*1e3:.3f} ms = "
            f"{64 * 4096 / t9 / 1e6:.0f} Mpix/s")

    # 9b. oriented 2D Morlet scaleogram (fft2 + (scale,angle) bank)
    if want("CWT2D"):
        from pdwt_tpu.core import cwt2d as cwt2d_fn

        scales9b = np.asarray([2.0, 4.0, 8.0, 16.0])
        img9b = arr((512, 512))()
        t9b = device_time_any(
            lambda x: jnp.abs(cwt2d_fn(x, scales9b)) ** 2, img9b)
        results.append({"config": "CWT2D morlet 4-scale 4-angle 512x512",
                        "value": round(512 * 512 / t9b / 1e6, 1),
                        "unit": "Mpix/s", "ms": round(t9b * 1e3, 3),
                        "device": device})
        log(f"CWT2D morlet 4-scale 4-angle 512x512: {t9b*1e3:.3f} ms")

    # 10. pywt boundary mode on the decimated DWT: the extension is
    # materialised per pass, so this measures its cost against config 2
    record("db7 2D 5-level fwd+inv 2048x2048 [symmetric]", 2048 * 2048,
           lambda x: sep.idwt2d(sep.dwt2d(x, w7, 5, mode="symmetric"),
                                w7, (2048, 2048), mode="symmetric"), img)

    # bf16-fast tier variants of the headline configs: bf16 arrays,
    # f32 accumulation
    imgb = lambda: img().astype(jnp.bfloat16)
    record("db7 2D 5-level fwd+inv 2048x2048 [bf16]", 2048 * 2048,
           lambda x: sep.idwt2d(sep.dwt2d(x, w7, 5), w7, (2048, 2048)),
           imgb)

    sigb = lambda: sig().astype(jnp.bfloat16)

    def cfg3b(x):
        c = sep.dwt1d(x, w8, 4)
        c = ops.soft_threshold(c, 0.1)
        n = ops.norm1(c)
        return sep.idwt1d(c, w8, 4096) + 0 * n.astype(x.dtype)

    record("batched 1D sym8 4-level denoise 1024x4096 [bf16]", 1024 * 4096,
           cfg3b, sigb)

    img1kb = lambda: img1k().astype(jnp.bfloat16)

    def cfg4b(x):
        out, _ = denoise_step(x, key, "db7", 3, 1.0, swt=True)
        return out

    record("SWT db7 2D 3-level TI denoise step 1024x1024 [bf16]",
           1024 * 1024, cfg4b, img1kb)

    volb = lambda: vol().astype(jnp.bfloat16)
    record("3D db4 2-level fwd+inv 128x512x512 [bf16]", 128 * 512 * 512,
           lambda x: sep3.idwt3d(sep3.dwt3d(x, w4, 2), w4,
                                 (128, 512, 512)), volb)

    vol7b = lambda: vol7().astype(jnp.bfloat16)
    record("3D SWT db4 2-level TI denoise step 64x512x512 [bf16]",
           64 * 512 * 512, cfg7, vol7b)

    # packets in bf16: the node axis is the level's batch, so the tree
    # keeps its per-pixel work at every depth
    record("WP2D db7 3-depth full packet fwd+inv 2048x2048 [bf16]",
           2048 * 2048,
           lambda x: pk_mod.iwp2d(pk_mod.wp2d(x, w7, 3).nodes[3], w7,
                                  (2048, 2048)).astype(jnp.bfloat16),
           imgb)

    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
