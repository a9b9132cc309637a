"""Boxed LCP solvers (projected Gauss-Seidel; batched under vmap).

JAX replacement of the reference's LCP layer
(`dart/constraint/PGSLCPSolver.cpp` † and ODE's `dSolveLCP` Dantzig,
`dart/external/odelcpsolver/lcp.cpp` † — SURVEY.md §2.4 "LCP solvers").

Problem:  find lam in [lo', hi'] with  w = A lam + b  satisfying the boxed
complementarity conditions, where rows with findex >= 0 have friction-coupled
bounds lo' = -mu * lam[findex], hi' = +mu * lam[findex] (the ODE `findex`
convention the reference uses for the friction pyramid).

The sweep is a `lax.fori_loop` over rows inside a `lax.fori_loop` over
iterations; under vmap every scalar op is one elementwise op over the env
batch.  Row order is static => deterministic.

`findex` and `mu` are static per row (numpy arrays) — the row layout is
fixed at trace time by the constraint assembler.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.backend import use_kernel


def pgs_solve(A, b, lo, hi, findex, mu, active, iters: int = 30,
              lam0=None, omega: float = 1.0):
    """Solve the boxed LCP for one env.

    A: (m, m); b, lo, hi, active: (m,) arrays; findex: length-m numpy int
    array (-1 = plain bounds); mu: (m,) friction coefficients for
    findex-coupled rows.  Inactive rows are pinned to lam = 0.
    Returns lam (m,).
    """
    m = A.shape[-1]
    if m == 0:
        return jnp.zeros((0,), dtype=A.dtype)
    findex = np.asarray(findex)
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    inv_diag = jnp.where(diag > 1e-12, 1.0 / jnp.maximum(diag, 1e-12), 0.0)
    # SOR: omega > 1 over-relaxes each projected update (kept stable by the
    # projection; convergence-tested in tests/test_contact_cap.py tuning)
    inv_diag = inv_diag * jnp.asarray(omega, dtype=A.dtype)
    lam_init = jnp.zeros(m, dtype=A.dtype) if lam0 is None else lam0

    # dynamic row indexing keeps the program size O(1) in m; row order
    # is still the static 0..m-1 order => deterministic
    fidx = jnp.asarray(np.maximum(findex, 0), dtype=jnp.int32)
    has_f = jnp.asarray(
        (findex >= 0).astype(np.float32), dtype=A.dtype
    )
    big = jnp.asarray(1e20, dtype=A.dtype)

    def row_update(i, lam):
        Ai = jax.lax.dynamic_index_in_dim(A, i, axis=0, keepdims=False)
        w_i = Ai @ lam + b[i]
        new = lam[i] - w_i * inv_diag[i]
        bound = mu[i] * lam[fidx[i]] * has_f[i] + big * (1.0 - has_f[i])
        lo_i = jnp.maximum(lo[i], -bound)
        hi_i = jnp.minimum(hi[i], bound)
        new = jnp.clip(new, lo_i, hi_i) * active[i]
        return lam.at[i].set(new)

    def sweep(_, lam):
        return jax.lax.fori_loop(0, m, row_update, lam)

    return jax.lax.fori_loop(0, iters, sweep, lam_init)


def make_pgs_solver(findex, iters: int, omega: float = 1.0):
    """Boxed-LCP solver for ONE env that redirects a vmapped batch to the
    Pallas kernel (lcp/pallas_pgs.py) — on the GPU the whole (B, m, m)
    batch is solved in one kernel launch; on the CPU, for f64 and
    unbatched the XLA loop above runs (dartenv_tpu.backend.use_kernel).
    DARTENV_NO_PGS_KERNEL=1 keeps the XLA loop everywhere (the A/B
    switch the benchmark measures the kernel with)."""
    findex = np.asarray(findex)
    kernel_ok = not os.environ.get("DARTENV_NO_PGS_KERNEL")

    @jax.custom_batching.custom_vmap
    def solve(A, b, lo, hi, mu, active, lam0):
        return pgs_solve(A, b, lo, hi, findex, mu, active, iters=iters,
                         omega=omega, lam0=lam0)

    @solve.def_vmap
    def _batched(axis_size, in_batched, *args):
        # broadcast env-constant operands (bounds/friction) to the batch
        args = [
            a if bat else jnp.broadcast_to(a, (axis_size,) + a.shape)
            for a, bat in zip(args, in_batched)
        ]
        A, b, lo, hi, mu, active, lam0 = args
        if kernel_ok and use_kernel(A.dtype):
            from dartenv_tpu.lcp.pallas_pgs import pgs_solve_pallas

            out = pgs_solve_pallas(A, b, lo, hi, findex, mu, active,
                                   iters=iters, omega=omega, lam0=lam0)
        else:
            out = jax.vmap(
                lambda Ai, bi, loi, hii, mui, acti, l0i: pgs_solve(
                    Ai, bi, loi, hii, findex, mui, acti, iters=iters,
                    omega=omega, lam0=l0i,
                )
            )(A, b, lo, hi, mu, active, lam0)
        return out, True

    return solve
