"""Precision tiers of the transforms.

==============  ========  ===============================================
tier            arrays    compute
==============  ========  ===============================================
``exact``       f32/f64   every conv and einsum at ``Precision.HIGHEST``
                          (no TF32 on GPUs): float32 roundoff
``bf16-fast``   bf16      each pass widens its bf16 input to float32,
                          accumulates in float32 and rounds its output
                          to bf16: every coefficient (the approximation
                          chain included) and the reconstruction are bf16
==============  ========  ===============================================

The tier follows from the array dtype; ``precision=`` (per ``Wavelets``
instance or per call on the core transforms) states which one the
caller expects, and a tier that does not match the arrays raises
instead of computing something else.
"""
from __future__ import annotations

import functools
from typing import Optional

TIERS = ("exact", "bf16-fast")


def check_tier(tier: str) -> str:
    if tier not in TIERS:
        raise ValueError(f"unknown precision tier {tier!r}; expected one of "
                         f"{TIERS}")
    return tier


def takes_precision(fn):
    """Add a ``precision=`` keyword to a transform entry point, checked
    against the input dtypes: ``bf16-fast`` needs bf16 arrays among the
    inputs, ``exact`` needs none.  ``None`` skips the check."""

    @functools.wraps(fn)
    def wrapper(*args, precision: Optional[str] = None, **kwargs):
        if precision is None:
            return fn(*args, **kwargs)
        check_tier(precision)
        import jax
        import jax.numpy as jnp

        has_bf16 = any(
            getattr(leaf, "dtype", None) == jnp.bfloat16
            for leaf in jax.tree_util.tree_leaves(args))
        if (precision == "bf16-fast") != has_bf16:
            raise ValueError(
                f"precision {precision!r} does not match the input "
                f"dtypes ({'some' if has_bf16 else 'no'} bfloat16 "
                "arrays): 'bf16-fast' needs bf16 arrays, 'exact' needs "
                "float arrays")
        return fn(*args, **kwargs)

    doc = wrapper.__doc__ or ""
    wrapper.__doc__ = doc + (
        "\n\n    ``precision=`` states the compute tier of this call "
        "(core/precision.py): 'exact' or 'bf16-fast'.\n    ")
    return wrapper


def tier_for(dtype_name: str, tier: Optional[str]) -> str:
    """Validate/resolve a tier against an array dtype (the facade's
    constructor contract): bf16 arrays take ``bf16-fast``, f32/f64 take
    ``exact``."""
    if tier is not None:
        check_tier(tier)
    if dtype_name == "bfloat16":
        if tier not in (None, "bf16-fast"):
            raise ValueError(
                f"precision {tier!r} needs float32 arrays; bf16 arrays "
                "take 'bf16-fast' (cast to float32 for 'exact')")
        return "bf16-fast"
    if tier == "bf16-fast":
        raise ValueError(
            f"precision {tier!r} needs bfloat16 arrays (pass "
            "dtype=jnp.bfloat16 or leave dtype unset)")
    return "exact"
