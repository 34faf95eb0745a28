"""Wavelet-regularized inverse-problem solvers (ISTA / FISTA).

This is the workload the reference library exists for: sparse
regularization with wavelets (reference: README.md:9-10 "can be used for
wavelet-regularized inverse problems"; the README's own example is an
iterative soft-threshold + norm1 loop, reference: README.md:91-103).
The reference provides only the building blocks (forward/inverse/
threshold/norms) and leaves the loop to the user, with one cuBLAS host
round-trip per norm; here the WHOLE solver compiles to a single XLA
program via ``lax.scan`` — per-iteration: gradient step through the
(linear, adjoint-differentiable) transform, proximal threshold, optional
Nesterov momentum — with no host synchronization at all.

solve(op, y, ...) minimizes  ½‖op(x) − y‖² + λ‖W x‖₁  over images x,
where ``op`` is any jittable linear operator (identity = denoising;
a blur = deconvolution; a masked FFT = inpainting/CS-MRI, ...).
The wavelet transform is linear, so JAX differentiates it exactly
(the VJP of each filter pass is its adjoint).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .. import ops
from ..core import separable as sep_core
from ..filters import Wavelet, get_wavelet


def _resolve(wav) -> Wavelet:
    return get_wavelet(wav) if isinstance(wav, str) else wav


def ista(
    y: jnp.ndarray,
    op: Optional[Callable] = None,
    op_t: Optional[Callable] = None,
    *,
    wav="db7",
    levels: int = 4,
    lam: float = 1.0,
    step: float = 1.0,
    iters: int = 50,
    fista: bool = True,
    x0: Optional[jnp.ndarray] = None,
    backend: Optional[str] = None,
    reg: str = "l1",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(F)ISTA in the analysis formulation with an orthogonal-ish W:
    the proximal step is computed in the wavelet domain
    (x ← W⁻¹ soft(W(v − step·opᵀ(op(v) − y)), step·λ)).

    ``op``/``op_t`` default to the identity (pure denoising).  Returns
    ``(x, objective_trace)`` with one objective value per iteration
    (computed on-device; no host sync inside the loop).

    ``reg="l1"`` is λ‖Wx‖₁ with the soft-threshold prox; ``reg="group"``
    is the group lasso λ·L2,1 over cross-subband detail groups with the
    joint-shrinkage prox (ops.group_soft_threshold / ops.norm_l21 — the
    reference TODO.txt's "group-lasso" wish).  Both regularizers act on
    the DETAIL subbands only (the approximation passes through the prox
    unthresholded), and the objective trace measures exactly that
    function — the approximation is excluded from its λ·R term."""
    if reg not in ("l1", "group"):
        raise ValueError(f"reg must be 'l1' or 'group', got {reg!r}")
    wav = _resolve(wav)
    nr, nc = y.shape[-2:]
    if op is None:
        op = lambda x: x
        if op_t is None:
            op_t = op  # identity: trivially self-adjoint
    elif op_t is None:
        # A missing adjoint silently computes a wrong gradient for any
        # non-self-adjoint operator; derive it instead of guessing (op is
        # linear by the problem statement; x0/y fixes the primal shape).
        import jax as _jax

        _op_t = _jax.linear_transpose(op, y if x0 is None else x0)
        op_t = lambda r: _op_t(r)[0]

    def w_fwd(x):
        return sep_core.dwt2d(x, wav, levels, backend=backend)

    def w_inv(c):
        return sep_core.idwt2d(c, wav, (nr, nc), backend=backend)

    x_init = y if x0 is None else x0

    def body(carry, _):
        x, v, t = carry
        r = op(v) - y
        grad = op_t(r)
        c = w_fwd(v - step * grad)
        c = (ops.soft_threshold(c, step * lam) if reg == "l1"
             else ops.group_soft_threshold(c, step * lam))
        x_new = w_inv(c)
        if fista:
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            v_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        else:
            t_new = t
            v_new = x_new
        if reg == "l1":
            rterm = sum(jnp.sum(jnp.abs(t))
                        for lvl in c.details
                        for t in (lvl if isinstance(lvl, tuple)
                                  else (lvl,)))
        else:
            from ..ops.norms import _group_norms

            rterm = sum(jnp.sum(_group_norms(c, i, False))
                        for i in range(c.levels))
        obj = 0.5 * jnp.sum(jnp.square(op(x_new) - y)) + lam * rterm
        return (x_new, v_new, t_new), obj

    (x, _, _), trace = lax.scan(
        body, (x_init, x_init, jnp.asarray(1.0, y.dtype)), None,
        length=iters)
    return x, trace
