"""Pallas kernel (GPU, through Triton): batched boxed-LCP projected
Gauss-Seidel.

The XLA formulation (lcp/pgs.py) runs the sweep as fori(iters) x
fori(m rows) while-loops, each trip at least one kernel launch on the
GPU.  This kernel runs the whole warm-started sweep loop for a tile of
TB envs in one launch, one env per thread.

Layout: env-minor, like the fused kernels (dynamics/pallas_dynamics.py
`env_tile_call`).  The m rows are padded to mp, the next power of two,
because every Triton load has a power-of-two size: a row of A is one
(mp, TB) load, and lam is carried as one (mp, TB) value.  Pad rows have
active = 0, a unit diagonal and zero bounds, and the sweep never visits
them, so their lam stays pinned at 0.  Row order is static, the same
0..m-1 order as the XLA sweep.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from dartenv_tpu.dynamics.pallas_dynamics import TB, env_tile_call


def padded_rows(m: int) -> int:
    """The power-of-two row count the kernel works in."""
    return 1 << max(0, int(m) - 1).bit_length()


def _pgs_kernel(A_ref, b_ref, lo_ref, hi_ref, mu_ref, act_ref, invd_ref,
                lam0_ref, lam_ref, *res_ref, m: int, findex, iters: int):
    mp = lam0_ref.shape[0]
    fidx = np.maximum(findex, 0)
    has_f = findex >= 0
    rows = jax.lax.broadcasted_iota(jnp.int32, (mp, TB), 0)

    def row(lam, i):
        return jnp.sum(jnp.where(rows == i, lam, 0.0), axis=0)

    def A_row(i):
        return A_ref[pl.ds(i * mp, mp)]

    b = [b_ref[i] for i in range(m)]
    lo = [lo_ref[i] for i in range(m)]
    hi = [hi_ref[i] for i in range(m)]
    mu = [mu_ref[i] for i in range(m)]
    act = [act_ref[i] for i in range(m)]
    invd = [invd_ref[i] for i in range(m)]

    def sweep(_, lam):
        for i in range(m):
            w = jnp.sum(A_row(i) * lam, axis=0) + b[i]
            new = row(lam, i) - w * invd[i]
            if has_f[i]:
                bound = mu[i] * row(lam, int(fidx[i]))
                lo_i = jnp.maximum(lo[i], -bound)
                hi_i = jnp.minimum(hi[i], bound)
            else:
                lo_i, hi_i = lo[i], hi[i]
            new = jnp.clip(new, lo_i, hi_i) * act[i]
            lam = jnp.where(rows == i, new[None, :], lam)
        return lam

    lam = jax.lax.fori_loop(0, iters, sweep, lam0_ref[...])
    lam_ref[...] = lam

    if res_ref:
        # fused normalized complementarity residual (same metric as
        # lcp.hybrid.comp_residual) while A's rows are still in cache
        (res_out,) = res_ref
        scale = jnp.maximum(1.0, jnp.max(jnp.abs(lam), axis=0))  # (TB,)
        eps = 1e-6 * scale + 1e-9
        res = jnp.zeros_like(scale)
        for i in range(m):
            w = jnp.sum(A_row(i) * lam, axis=0) + b[i]
            li = row(lam, i)
            if has_f[i]:
                bound = mu[i] * jnp.abs(row(lam, int(fidx[i])))
                lo_e = jnp.maximum(lo[i], -bound)
                hi_e = jnp.minimum(hi[i], bound)
            else:
                lo_e, hi_e = lo[i], hi[i]
            at_lo = li <= lo_e + eps
            at_hi = li >= hi_e - eps
            r_i = jnp.where(jnp.logical_and(at_lo, at_hi), 0.0,
                            jnp.where(at_lo, -w,
                                      jnp.where(at_hi, w, jnp.abs(w))))
            r_i = jnp.maximum(r_i, jnp.maximum(lo_e - li, li - hi_e))
            res = jnp.maximum(res, jnp.where(act[i] > 0.5, r_i, 0.0))
        res_out[0] = res / scale


def pgs_solve_pallas(A, b, lo, hi, findex, mu, active, iters: int = 30,
                     omega: float = 1.0, lam0=None,
                     interpret: bool = False,
                     return_residual: bool = False):
    """Batched solve.  A: (B, m, m); b/lo/hi/mu/active: (B, m); findex is a
    static numpy (m,) array.  Returns lam (B, m), and with
    return_residual also the (B,) normalized residual of lam."""
    B, m = b.shape
    dtype = A.dtype
    if m == 0:
        return jnp.zeros((B, 0), dtype=dtype)
    if lam0 is None:
        lam0 = jnp.zeros_like(b)
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    inv_diag = jnp.where(diag > 1e-12, 1.0 / jnp.maximum(diag, 1e-12),
                         jnp.zeros((), dtype))
    inv_diag = inv_diag * jnp.asarray(omega, dtype=dtype)  # SOR step scale

    mp = padded_rows(m)
    pr = mp - m
    A_p = jnp.pad(A, ((0, 0), (0, pr), (0, pr)))
    A_p = A_p + jnp.diag(jnp.concatenate(
        [jnp.zeros(m, dtype), jnp.ones(pr, dtype)]))
    vecs = [jnp.pad(v, ((0, 0), (0, pr)))
            for v in (b, lo, hi, mu, active, inv_diag, lam0)]
    kernel = functools.partial(_pgs_kernel, m=m,
                               findex=np.asarray(findex), iters=iters)
    outs = env_tile_call(
        kernel, [A_p.reshape(B, mp * mp)] + vecs,
        [mp, 1] if return_residual else [mp], dtype,
        name="dartenv_pgs", interpret=interpret)
    lam = outs[0][:, :m]
    if return_residual:
        return lam, outs[1][:, 0]
    return lam
