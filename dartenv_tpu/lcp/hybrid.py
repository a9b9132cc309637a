"""Hybrid LCP solve: batched PGS + exact-solver escalation of the worst
envs (VERDICT.md round 2 order #3).

The reference's contact solver is the exact ODE Dantzig (`dSolveLCP`,
`dart/external/odelcpsolver/lcp.cpp` †) — every problem gets a
complementarity point at solver precision.  This framework's throughput
path is iterative PGS (lcp/pgs.py + the Pallas kernel), whose residual
envelope is excellent in the median but has a fat tail on degenerate
contact states (e.g. hopper's two-point landings — docs/SOLVERS.md
residual study: max 8.8e-2, iteration-independent).

The hybrid restores the exact solver's worst-case behavior at a small
fixed cost: after the batched PGS solve,

  1. compute every env's normalized complementarity residual — one
     batched matvec (A @ lam + b) plus elementwise tests,
  2. rank envs by residual and take the worst K = ceil(escalate_frac * B)
     (static K => static shapes; top_k),
  3. re-solve only those K with the block-principal-pivoting exact path
     (lcp/dantzig.py), warm-started from their PGS point,
  4. keep whichever point has the lower residual, and only where the PGS
     residual actually exceeded `escalate_tol`.

Offenders the fixed K misses in a substep keep their (carried,
warm-started) impulses and rank first at the next substep, so persistent
degeneracies clear within a substep or two.  For an UNBATCHED solve the
escalation is a `lax.cond` — the facade / single-env path simply gets the
exact re-solve whenever PGS leaves residual above tolerance.

Sharding note: under `shard_map` the batch rule sees each device's env
shard, so the worst-K selection is PER DEVICE (total capacity K_total =
ceil(frac * B_shard) * n_devices == ceil(frac * B), selection locality
per shard).  This keeps the step free of cross-device collectives — the
framework's core scaling invariant (docs/SCALING.md) — at the cost that
a sharded and an unsharded run may escalate *different* envs when
offenders cluster on one device; both still satisfy the residual
envelope, and the next-substep ranking property cleans up any shard
whose offenders exceeded its local capacity.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.backend import use_kernel
from dartenv_tpu.lcp.pgs import pgs_solve


def comp_residual(A, b, x, lo, hi, findex, mu, active):
    """Normalized max complementarity violation at x's own friction-bound
    fixed point over active rows.

    Mirrors scripts/pgs_residual_study.comp_residual (the committed study
    metric) in jnp; leading batch axes broadcast.  Returns (...,) scalars
    normalized by max(1, |x|_inf) per problem.
    """
    findex = np.asarray(findex)
    fidx = jnp.asarray(np.maximum(findex, 0))
    has_f = jnp.asarray((findex >= 0).astype(np.float32), dtype=x.dtype)
    big = jnp.asarray(1e20, dtype=x.dtype)
    bd = mu * jnp.abs(jnp.take(x, fidx, axis=-1)) * has_f + big * (1 - has_f)
    lo_e = jnp.maximum(lo, -bd)
    hi_e = jnp.minimum(hi, bd)
    # mul+reduce, not einsum: a default-precision einsum may run in a
    # reduced-precision matrix unit (TF32 on the GPU) and the residual
    # then misranks envs (math/linalg._pmm note)
    w = jnp.sum(A * x[..., None, :], axis=-1) + b
    scale = jnp.maximum(1.0, jnp.max(jnp.abs(x), axis=-1, keepdims=True))
    eps = 1e-6 * scale + 1e-9
    at_lo = x <= lo_e + eps
    at_hi = x >= hi_e - eps
    pinned = at_lo & at_hi
    res = jnp.where(pinned, 0.0,
                    jnp.where(at_lo, -w,
                              jnp.where(at_hi, w, jnp.abs(w))))
    res = jnp.maximum(res, jnp.maximum(lo_e - x, x - hi_e))
    res = jnp.where(active > 0.5, res, 0.0)
    return jnp.max(res / scale, axis=-1)


def make_hybrid_solver(findex, iters: int, omega: float = 1.0,
                       escalate_frac: float = 0.0,
                       escalate_tol: float = 1e-6,
                       escalate_iters: int = 8,
                       escalate_kmax: int = 128,
                       escalate_iters2: int = 0,
                       escalate_refine: int = -1,
                       escalate_ref64: int = 0,
                       escalate_ref: int = 0):
    """Boxed-LCP solver for ONE env with batch redirection (like
    lcp.pgs.make_pgs_solver) plus exact-solver escalation when
    escalate_frac > 0.

    escalate_iters: block-pivot budget for the re-solve.  The exact path
    is warm-started from the PGS point, whose free/clamped partition is
    already nearly correct, so a short refinement reaches solver precision
    and the full cold-start budget is serial latency paid for nothing.

    The batched PGS takes the Pallas kernel where
    dartenv_tpu.backend.use_kernel says so, unless DARTENV_NO_PGS_KERNEL
    is set; the escalation re-solve is always the vmapped XLA
    block-pivoting solver.
    """
    findex = np.asarray(findex)
    kernel_ok = not os.environ.get("DARTENV_NO_PGS_KERNEL")

    from dartenv_tpu.lcp.dantzig import make_exact_solver

    _exact_solver = make_exact_solver(
        findex, iters=escalate_iters, polish_iters=3,
        refine_iters=None if escalate_refine < 0 else escalate_refine)
    # tier-2 (escalate_iters2 > 0): COLD re-solve at a deeper budget for
    # rows the warm tier-1 refinement could not converge — warm-starting
    # from a bad PGS point can poison the pivot-set sequence in ways a
    # cold start escapes (round-4 adjudication, docs/SOLVERS.md)
    _exact_solver2 = (make_exact_solver(findex, iters=escalate_iters2,
                                        polish_iters=6)
                      if escalate_iters2 > 0 else None)
    # mixed-precision f64-residual refinement of the escalated batch
    # (lcp/dantzig.refine_mixed); needs x64, silently inert otherwise
    _ref64 = (int(escalate_ref64)
              if jax.config.jax_enable_x64 else 0)
    # compensated double-float fallback tier: same refinement, no x64
    # requirement (lcp/dantzig.refine_compensated); ref64 wins when both
    # are available (the studies' cross-check mode)
    _refc = 0 if _ref64 > 0 else int(escalate_ref)

    def _exact(A, b, lo, hi, mu, active, lam_ws):
        # polish_iters=3: the block-pivot loop's final clip projects onto
        # bounds evaluated at the DAMPED impulse source; a few PGS sweeps
        # re-project every row against its own friction bound so the
        # returned point is exactly box-consistent (without them the f64
        # complementarity metric sees epsilon-off-bound rows as interior
        # and charges the full |w|).
        return _exact_solver(A, b, lo, hi, mu, active, lam_ws)

    @jax.custom_batching.custom_vmap
    def solve(A, b, lo, hi, mu, active, lam0):
        lam = pgs_solve(A, b, lo, hi, findex, mu, active, iters=iters,
                        omega=omega, lam0=lam0)
        if escalate_frac <= 0.0 or lam.shape[-1] == 0:
            return lam
        res = comp_residual(A, b, lam, lo, hi, findex, mu, active)

        def escalate(_):
            lam_ex = _exact(A, b, lo, hi, mu, active, lam)
            res_ex = comp_residual(A, b, lam_ex, lo, hi, findex, mu,
                                   active)
            best = jnp.where(res_ex < res, lam_ex, lam)
            if _exact_solver2 is None:
                return best
            res_best = jnp.minimum(res_ex, res)

            def tier2(_):
                lam_c = _exact_solver2(A, b, lo, hi, mu, active,
                                       jnp.zeros_like(b))
                res_c = comp_residual(A, b, lam_c, lo, hi, findex, mu,
                                      active)
                return jnp.where(res_c < res_best, lam_c, best)

            return jax.lax.cond(res_best > escalate_tol, tier2,
                                lambda _: best, None)

        return jax.lax.cond(res > escalate_tol, escalate, lambda _: lam,
                            None)

    @solve.def_vmap
    def _batched(axis_size, in_batched, *args):
        args = [
            a if bat else jnp.broadcast_to(a, (axis_size,) + a.shape)
            for a, bat in zip(args, in_batched)
        ]
        A, b, lo, hi, mu, active, lam0 = args
        esc = escalate_frac > 0.0 and b.shape[-1] > 0
        nres = None
        if kernel_ok and use_kernel(A.dtype):
            from dartenv_tpu.lcp.pallas_pgs import pgs_solve_pallas

            if esc:
                # residual fused into the kernel (no second pass over
                # the Delassus blocks in device memory)
                lam, nres = pgs_solve_pallas(
                    A, b, lo, hi, findex, mu, active, iters=iters,
                    omega=omega, lam0=lam0, return_residual=True)
            else:
                lam = pgs_solve_pallas(A, b, lo, hi, findex, mu, active,
                                       iters=iters, omega=omega,
                                       lam0=lam0)
        else:
            lam = jax.vmap(
                lambda Ai, bi, loi, hii, mui, acti, l0i: pgs_solve(
                    Ai, bi, loi, hii, findex, mui, acti, iters=iters,
                    omega=omega, lam0=l0i,
                )
            )(A, b, lo, hi, mu, active, lam0)
        if not esc:
            return lam, True

        B = axis_size
        # kmax caps K: capacity beyond it costs real wall clock for
        # coverage the next-substep ranking already provides
        K = min(B, escalate_kmax, max(1, int(np.ceil(B * escalate_frac))))
        if nres is None:
            nres = comp_residual(A, b, lam, lo, hi, findex, mu,
                                 active)  # (B,)
        worst, idx = jax.lax.top_k(nres, K)
        # the six (B, m)-shaped operands are gathered as ONE packed
        # concat + slice
        m = b.shape[-1]
        packed = jnp.concatenate([b, lo, hi, mu, active, lam], axis=1)
        pk = jnp.take(packed, idx, axis=0)
        bk, lok, hik, muk, actk, lamk = [
            pk[:, i * m:(i + 1) * m] for i in range(6)]
        Ak = jnp.take(A, idx, axis=0)
        lam_ex = jax.vmap(_exact)(Ak, bk, lok, hik, muk, actk, lamk)
        res_ex = comp_residual(Ak, bk, lam_ex, lok, hik, findex, muk, actk)
        take = (worst > escalate_tol) & (res_ex < worst)
        lam_new = jnp.where(take[:, None], lam_ex, lamk)
        if _exact_solver2 is not None:
            # tier 2: cold deep re-solve; keep it only where the kept
            # tier-1 point still exceeds tol AND the cold point is better
            res_kept = jnp.where(take, res_ex, worst)
            lam_c = jax.vmap(_exact_solver2)(Ak, bk, lok, hik, muk, actk,
                                             jnp.zeros_like(bk))
            res_c = comp_residual(Ak, bk, lam_c, lok, hik, findex, muk,
                                  actk)
            take2 = (res_kept > escalate_tol) & (res_c < res_kept)
            lam_new = jnp.where(take2[:, None], lam_c, lam_new)
        if _ref64 > 0 or _refc > 0:
            from dartenv_tpu.lcp.dantzig import (
                refine_compensated, refine_mixed)

            rf, rp = ((refine_mixed, _ref64) if _ref64 > 0
                      else (refine_compensated, _refc))
            res_cur = comp_residual(Ak, bk, lam_new, lok, hik, findex,
                                    muk, actk)
            lam_r = rf(Ak, bk, lok, hik, findex, muk, actk,
                       lam_new, passes=rp)
            res_r = comp_residual(Ak, bk, lam_r, lok, hik, findex, muk,
                                  actk)
            takeR = (res_cur > escalate_tol) & (res_r < res_cur)
            lam_new = jnp.where(takeR[:, None], lam_r, lam_new)
        return lam.at[idx].set(lam_new), True

    return solve
