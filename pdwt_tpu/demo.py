"""Demo CLI — capability parity with the reference demo
(reference: src/demo.cpp): loads a raw .dat image, runs one of three
scenarios, writes res.dat.

    python -m pdwt_tpu.demo image.dat --nr 512 --nc 512 --scenario 2 \
        --wavelet db7 --levels 5 [--swt] [--nonseparable] \
        [--cycle-spinning] [--beta 90]

Scenarios (reference: src/demo.cpp:13-16):
  1  forward only (writes the approximation subband)
  2  forward + inverse: perfect reconstruction check.  Like the
     reference, the image is overwritten with a dummy array before the
     inverse so the reconstruction provably comes from the coefficients
     alone (reference: src/demo.cpp:208-214).
  3  forward + soft threshold(beta) + inverse (sparse denoising)
  4  best-basis wavelet-packet denoise (beyond the reference; 2D JAX
     engine; --auto-beta any != none picks the threshold from the data)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("image", help="raw float32 .dat file")
    p.add_argument("--nr", type=int, required=True)
    p.add_argument("--nc", type=int, required=True)
    p.add_argument("--nd", type=int, default=0,
                   help="depth for a 3D volume (.dat holds nd*nr*nc "
                        "float32); 0 = 2D image (beyond the reference: "
                        "it has no 3D)")
    p.add_argument("--scenario", type=int, default=2,
                   choices=(1, 2, 3, 4, 5, 6))
    p.add_argument("--wavelet", default="haar")
    p.add_argument("--levels", type=int, default=1)
    p.add_argument("--swt", action="store_true")
    p.add_argument("--nonseparable", action="store_true")
    p.add_argument("--cycle-spinning", action="store_true")
    p.add_argument("--beta", type=float, default=90.0)
    p.add_argument("--auto-beta", default="none",
                   choices=("none", "universal", "bayes"),
                   help="scenario 3: pick the threshold from the data "
                        "(VisuShrink universal scalar / BayesShrink "
                        "per-band) instead of --beta (JAX engine only; "
                        "beyond the reference, whose demo hard-codes "
                        "beta — src/demo.cpp:38)")
    p.add_argument("--out", default="res.dat")
    p.add_argument("--native", action="store_true",
                   help="use the C++ CPU engine instead of JAX")
    p.add_argument("--mode", default="periodization",
                   help="boundary extension: periodization "
                        "(reference scheme) or any pywt mode — zero, "
                        "constant, symmetric, reflect, periodic, smooth, "
                        "antisymmetric, antireflect (DWT only)")
    p.add_argument("--precision", default="exact",
                   choices=("exact", "bf16"),
                   help="compute tier: exact = float32 at full "
                        "precision, bf16 = bf16 arrays with float32 "
                        "accumulation")
    p.add_argument("--interactive", action="store_true",
                   help="prompt for the configuration like the reference "
                        "demo does when run without arguments "
                        "(reference: src/demo.cpp:48-78)")
    args = p.parse_args(argv)

    if args.mode != "periodization" and (args.native or args.swt
                                         or args.nonseparable):
        p.error("--mode (pywt boundary extensions) applies to the "
                "separable decimated DWT on the JAX engine; the native "
                "C++ engine, SWT and non-separable paths are "
                "periodization-only")

    if args.interactive:
        def ask(label, default, cast):
            raw = input(f"{label} [{default}]: ").strip()
            try:
                return cast(raw) if raw else default
            except ValueError:
                print(f"  invalid value {raw!r}; keeping {default}")
                return default

        print("Interactive configuration (empty line keeps the default)")
        args.scenario = ask("Scenario (1=fwd, 2=fwd+inv, 3=fwd+thresh+inv, 4=packets, 5=starlet, 6=dual-tree)",
                            args.scenario, int)
        args.wavelet = ask("Wavelet name", args.wavelet, str)
        args.levels = ask("Number of levels", args.levels, int)
        args.swt = bool(ask("Use SWT (0/1)", int(args.swt), int))
        args.cycle_spinning = bool(
            ask("Use cycle spinning (0/1)", int(args.cycle_spinning), int))
        if args.scenario == 3:
            args.beta = ask("Threshold beta", args.beta, float)

    if args.auto_beta != "none" and args.native:
        p.error("--auto-beta needs the JAX engine (drop --native)")

    from pdwt_tpu.utils import read_dat, write_dat

    shape = ((args.nd, args.nr, args.nc) if args.nd
             else (args.nr, args.nc))
    img = read_dat(args.image, shape)

    if args.scenario == 6:
        if args.native or args.nd:
            p.error("scenario 6 (dual-tree denoise) needs the 2D JAX "
                    "engine")
        import jax.numpy as jnp

        from pdwt_tpu.core import dtcwt_auto_denoise

        rec = np.asarray(dtcwt_auto_denoise(jnp.asarray(img), args.levels),
                         dtype=np.float32)
        print("dual-tree complex magnitude denoise applied "
              f"({args.levels} levels, 6 oriented bands)")
        err = float(np.abs(rec - img).max())
        print(f"max |denoised - input| = {err:.3e} (expected nonzero)")
        write_dat(args.out, rec)
        print(f"result written to {args.out}")
        return 0

    if args.scenario == 5:
        if args.native:
            p.error("scenario 5 (starlet denoise) needs the JAX engine")
        import jax.numpy as jnp

        from pdwt_tpu.models import starlet_auto_denoise

        rec = np.asarray(starlet_auto_denoise(jnp.asarray(img),
                                              args.levels,
                                              ndim=3 if args.nd else 2),
                         dtype=np.float32)
        print("starlet k-sigma auto denoise applied "
              f"({args.levels} isotropic scales)")
        err = float(np.abs(rec - img).max())
        print(f"max |denoised - input| = {err:.3e} (expected nonzero)")
        write_dat(args.out, rec)
        print(f"result written to {args.out}")
        return 0

    if args.scenario == 4:
        if args.native or args.nd:
            p.error("scenario 4 (packet denoise) needs the 2D JAX engine")
        import jax.numpy as jnp

        from pdwt_tpu.models import packet_denoise

        beta = None if args.auto_beta != "none" else args.beta
        rec = np.asarray(packet_denoise(jnp.asarray(img), args.wavelet,
                                        args.levels, beta),
                         dtype=np.float32)
        which = "universal (auto)" if beta is None else f"{beta:g}"
        print(f"best-basis packet denoise applied (beta = {which})")
        err = float(np.abs(rec - img).max())
        print(f"max |denoised - input| = {err:.3e} (expected nonzero)")
        write_dat(args.out, rec)
        print(f"result written to {args.out}")
        return 0

    if args.native:
        from pdwt_tpu import native
        from pdwt_tpu.filters import get_wavelet

        w = get_wavelet(args.wavelet)
        fwd = native.dwt3d if args.nd else native.dwt2d
        inv = native.idwt3d if args.nd else native.idwt2d
        coeffs = fwd(img, w, args.levels, swt=args.swt)
        print(f"forward done (native): {args.wavelet}, {args.levels} levels")
        if args.scenario == 1:
            write_dat(args.out, coeffs.approx)
            print(f"approximation written to {args.out}")
            return 0
        if args.scenario == 3:
            det = tuple(
                tuple(native.soft_threshold(b, args.beta) for b in lvl)
                for lvl in coeffs.details)
            coeffs = type(coeffs)(coeffs.approx, det)
        rec = inv(coeffs, w, shape, swt=args.swt)
    else:
        from pdwt_tpu import Wavelets

        tier = {"exact": "exact", "bf16": "bf16-fast"}[args.precision]
        W = Wavelets(img, wname=args.wavelet, levels=args.levels,
                     do_swt=args.swt,
                     do_separable=not args.nonseparable,
                     do_cycle_spinning=args.cycle_spinning,
                     mode=args.mode,
                     precision=tier)
        W.print_informations()
        W.forward()
        print(f"norm1(coeffs) = {W.norm1():.6e}")
        if args.scenario == 1:
            write_dat(args.out, W.get_coeff(0))
            print(f"approximation written to {args.out}")
            return 0
        if args.scenario == 3:
            if args.auto_beta == "bayes":
                sigma = W.noise_sigma()
                W.bayes_shrink()
                print(f"BayesShrink applied (sigma~{sigma:.4g}); "
                      f"norm1 = {W.norm1():.6e}")
            else:
                beta = (W.universal_threshold()
                        if args.auto_beta == "universal"
                        else args.beta)
                W.soft_threshold(beta)
                print(f"soft threshold beta={beta:.6g} applied; "
                      f"norm1 = {W.norm1():.6e}")
        # prove reconstruction comes from the coefficients alone
        # (reference: src/demo.cpp:208-214)
        W.set_image(np.zeros_like(img))
        rec = np.asarray(W.inverse(), dtype=np.float32)

    err = float(np.abs(rec - img).max())
    note = " (thresholded: expected nonzero)" if args.scenario == 3 else ""
    print(f"max |reconstruction - input| = {err:.3e}{note}")
    write_dat(args.out, rec)
    print(f"result written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
