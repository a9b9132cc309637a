"""Pivoting boxed-LCP solver: block principal pivoting (Dantzig-class).

The reference's default contact solver is ODE's `dSolveLCP` Dantzig
principal pivoting (`dart/external/odelcpsolver/lcp.cpp` † — SURVEY.md
§2.4/§7 "hardest port").  Classic Dantzig drives one variable at a time
with incremental factorization — hostile to fixed-shape SPMD.  This module
implements the *block* principal pivoting method (Judice-Pires family) for
the same boxed LCP with ODE `findex` friction coupling:

  repeat (fixed budget):
    1. x on the clamped sets takes its bound; the free set F solves
       A_FF x_F = -(b_F + A_F,clamped x_clamped)   (masked dense solve)
    2. w = A x + b; move rows between sets:
       F rows outside [lo, hi] -> clamped; clamped rows with in-pointing
       w -> F
    3. friction bounds refresh from the current normal impulses

Each iteration is one batched masked Cholesky solve — dense work with a
static trip count (compare: PGS does m_rows * iters sequential row
updates).  Like `dSolveLCP`, the result is an
*exact* complementarity point when the set sequence converges (typical in
<= 8 iterations for these contact problems); a PGS polish pass cleans up
rare non-converged envs.

All shapes static; per-env solve vmapped/batched.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.math.linalg import solve_psd
from dartenv_tpu.lcp.pgs import pgs_solve

# set labels
_FREE = 0
_AT_LO = 1
_AT_HI = 2


def dantzig_solve(A, b, lo, hi, findex, mu, active, iters: int = 24,
                  polish_iters: int = 10, lam0=None,
                  refine_iters=None):
    """Solve one boxed LCP by block principal pivoting.

    A: (m, m) SPD(+cfm); b, lo, hi, mu, active: (m,); findex: static numpy
    (m,) with -1 for plain rows.  `lam0` (m,) warm-starts the pivot sets
    from the previous substep's impulses (persistent contacts keep nearly
    the same free/clamped partition, so the set sequence closes in 1-2
    iterations instead of the cold-start budget).  Returns lam (m,).

    findex bounds are refreshed from a DAMPED impulse source (xb below):
    the undamped map x -> solve(bounds(x)) oscillates on sliding contacts
    (spectral radius near 1); averaging converges in ~10-20 iterations to
    the exact friction fixed point (matching native/lcp_dantzig.cpp, which
    uses the same damping).
    """
    m = A.shape[-1]
    dtype = A.dtype
    if m == 0:
        return jnp.zeros((0,), dtype=dtype)
    findex = np.asarray(findex)
    fidx = jnp.asarray(np.maximum(findex, 0), dtype=jnp.int32)
    has_f = jnp.asarray((findex >= 0).astype(np.float32), dtype=dtype)

    eye = jnp.eye(m, dtype=dtype)
    big = jnp.asarray(1e20, dtype=dtype)

    def bounds(x):
        """findex-coupled boxes from current normal impulses.

        |x[fidx]|, not x[fidx]: a transiently negative normal impulse must
        not invert the friction box (lo > hi); native/lcp_dantzig.cpp
        uses the same abs, so the golden cross-checks iterate the
        identical set map."""
        fb = mu * jnp.abs(x[fidx]) * has_f + big * (1.0 - has_f)
        lo_i = jnp.maximum(lo, -fb)
        hi_i = jnp.minimum(hi, fb)
        # inactive rows are pinned to [0, 0]
        lo_i = lo_i * active
        hi_i = hi_i * active
        return lo_i, hi_i

    def body(_, carry):
        x, xb, state = carry
        lo_i, hi_i = bounds(xb)
        free = (state == _FREE) & (active > 0.5)
        fmask = free.astype(dtype)
        x_fixed = jnp.where(state == _AT_LO, lo_i,
                            jnp.where(state == _AT_HI, hi_i, 0.0))
        x_fixed = x_fixed * active * (1.0 - fmask)
        rhs = -(b + A @ x_fixed) * fmask
        # masked SPD solve: non-free rows/cols replaced by identity
        Am = (A * fmask[:, None] * fmask[None, :]
              + jnp.diag(1.0 - fmask))
        x_free = solve_psd(Am, rhs, eps=1e-12) * fmask
        x_new = x_free + x_fixed
        w = A @ x_new + b
        # set transitions
        below = x_new < lo_i - 1e-10
        above = x_new > hi_i + 1e-10
        state = jnp.where(free & below, _AT_LO, state)
        state = jnp.where(free & above, _AT_HI, state)
        state = jnp.where((state == _AT_LO) & (w < -1e-10), _FREE, state)
        state = jnp.where((state == _AT_HI) & (w > 1e-10), _FREE, state)
        # project x onto the box for robustness between iterations
        x_new = jnp.clip(x_new, lo_i, hi_i)
        xb = 0.5 * (xb + x_new)        # damped bound source (see docstring)
        return (x_new, xb, state)

    if lam0 is None:
        x0 = jnp.zeros(m, dtype=dtype)
        # start with every active row clamped at lo (normals at 0 -> natural
        # cold start: only violated normals enter the free set)
        w0 = b
        state0 = jnp.where(
            (lo == 0.0) & (w0 < 0.0), _FREE, _AT_LO
        ).astype(jnp.int32)
        xb0 = x0
    else:
        # warm start: seed the partition from the previous impulses —
        # strictly interior rows are FREE, rows sitting on a bound stay
        # clamped there (friction bounds evaluated at lam0's normals)
        lo_w, hi_w = bounds(lam0)
        x0 = jnp.clip(lam0, lo_w, hi_w)
        at_lo = x0 <= lo_w + 1e-12
        at_hi = x0 >= hi_w - 1e-12
        state0 = jnp.where(at_hi, _AT_HI,
                           jnp.where(at_lo, _AT_LO, _FREE)).astype(jnp.int32)
        # rows clamped at a bound but being pushed off it re-open
        w0 = A @ x0 + b
        state0 = jnp.where((state0 == _AT_LO) & (w0 < 0.0), _FREE, state0)
        state0 = jnp.where((state0 == _AT_HI) & (w0 > 0.0), _FREE, state0)
        xb0 = x0
    x, xb, state = jax.lax.fori_loop(0, iters, body, (x0, xb0, state0))
    # refinement at the fixed point: a few UNDAMPED iterations (bound
    # source = the iterate itself).  From the damped loop's near-converged
    # point this contracts the residual to solver precision; starting
    # undamped from scratch would oscillate (see docstring).
    def body_exact(_, carry):
        x, _, state = carry
        return body(_, (x, x, state))

    n_refine = max(iters // 3, 6) if refine_iters is None else refine_iters
    x, xb, state = jax.lax.fori_loop(0, n_refine, body_exact,
                                     (x, x, state))
    # polish: a few PGS sweeps fix any env whose set sequence didn't close
    if polish_iters > 0:
        x = pgs_solve(A, b, lo, hi, findex, mu, active,
                      iters=polish_iters, lam0=x)
    return x


# ---------------------------------------------------------------------------
# double-float (compensated f32) residual refinement
# ---------------------------------------------------------------------------

_SPLIT_F32 = 4097.0        # 2^12 + 1: Dekker split, 24-bit mantissa
_SPLIT_F64 = 134217729.0   # 2^27 + 1: Dekker split, 53-bit mantissa


def _two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _two_prod(a, b):
    """Dekker two-prod: p + e == a * b exactly (p = fl(a*b)).

    No FMA primitive is exposed through XLA, so the error term comes
    from Dekker mantissa splitting; all six ops are IEEE-rounded
    elementwise ops, which the identity requires.  The split
    constant is mantissa-width-dependent (the CPU f64 validation mode
    routes the same production tier)."""
    split = _SPLIT_F64 if a.dtype == jnp.float64 else _SPLIT_F32
    p = a * b
    ca = split * a
    ah = ca - (ca - a)
    al = a - ah
    cb = split * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _comp_matvec_add(A, x, b):
    """fl2(b + A @ x): compensated row sums, f32 in / f32 out.

    Each product enters as an exact (p, e) pair and the running sum
    carries a Neumaier correction, so the returned value is the true
    real-arithmetic result of the F32 INPUTS rounded once — the same
    quantity refine_mixed gets from casting those inputs to f64
    (double-float carries ~2^-48 vs f64's 2^-52; both are far below
    the ~1e-7 the correction solve needs).  The j-loop is a static
    unroll (m <= ~50, arrays are the escalated (K, m) batch — this
    runs once per substep outside the kernels)."""
    m = A.shape[-1]
    s = jnp.broadcast_to(b, A.shape[:-1]).astype(A.dtype)
    c = jnp.zeros_like(s)
    for j in range(m):
        p, pe = _two_prod(A[..., :, j], x[..., j][..., None])
        s, se = _two_sum(s, p)
        c = c + (se + pe)
    return s + c


def comp_residual_ff(A, b, x, lo, hi, findex, mu, active):
    """hybrid.comp_residual with the w = A x + b contraction computed in
    compensated f32 (see _comp_matvec_add) — the residual IS a
    catastrophic cancellation, so the naive f32 sum floors at
    ~eps32 * ||A|| ||x|| and misjudges refined points below ~1e-6."""
    findex = np.asarray(findex)
    fidx = jnp.asarray(np.maximum(findex, 0))
    has_f = jnp.asarray((findex >= 0).astype(np.float32), dtype=x.dtype)
    big = jnp.asarray(1e20, dtype=x.dtype)
    bd = mu * jnp.abs(jnp.take(x, fidx, axis=-1)) * has_f \
        + big * (1 - has_f)
    lo_e = jnp.maximum(lo, -bd)
    hi_e = jnp.minimum(hi, bd)
    w = _comp_matvec_add(A, x, b)
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


def refine_compensated(A, b, lo, hi, findex, mu, active, x,
                       passes: int = 2):
    """refine_mixed without the x64 requirement: the f32 BPP plateau on
    ill-conditioned operators is set by the residual's cancellation, and
    a double-float residual recovers it in PLAIN f32 mode — so this is
    the production default (SolverConfig.escalate_ref), usable by every
    f32 caller, while refine_mixed remains the x64 cross-check.

    Same structure: free-set partition at x's own friction-bound fixed
    sets, compensated residual of the free-set linear system, f32
    correction solve on the masked operator, monotone keep-best
    acceptance judged by the compensated residual (a wrong partition
    diverges; it must never worsen the point)."""
    from dartenv_tpu.math.linalg import solve_psd

    findex_np = np.asarray(findex)
    fidx = jnp.asarray(np.maximum(findex_np, 0))
    dtype = A.dtype
    has_f = jnp.asarray((findex_np >= 0).astype(np.float32), dtype=dtype)
    big = jnp.asarray(1e20, dtype)
    eye = jnp.eye(A.shape[-1], dtype=dtype)
    actb = active > 0.5

    def resid(xx):
        return comp_residual_ff(A, b, xx, lo, hi, findex_np, mu, active)

    best_x = x
    best_r = resid(x)
    for _ in range(passes):
        bd = (mu * jnp.abs(jnp.take(x, fidx, axis=-1)) * has_f
              + big * (1.0 - has_f))
        lo_e = jnp.maximum(lo, -bd) * active
        hi_e = jnp.minimum(hi, bd) * active
        scale = jnp.maximum(1.0, jnp.max(jnp.abs(x), axis=-1,
                                         keepdims=True))
        eps = 1e-6 * scale
        at_lo = x <= lo_e + eps
        at_hi = x >= hi_e - eps
        free = actb & ~at_lo & ~at_hi
        fm = free.astype(dtype)
        x_fix = jnp.where(at_hi, hi_e,
                          jnp.where(at_lo, lo_e, 0.0)) * active * (1 - fm)
        xa = x * fm + x_fix
        r = -_comp_matvec_add(A, xa, b) * fm
        Am = (A * fm[..., :, None] * fm[..., None, :]
              + eye * (1.0 - fm)[..., None, :])
        d = solve_psd(Am, r, eps=1e-12) * fm
        x = jnp.clip(xa + d, lo_e, hi_e)
        r_new = resid(x)
        better = r_new < best_r
        bx = better[..., None] if x.ndim > better.ndim else better
        best_x = jnp.where(bx, x, best_x)
        best_r = jnp.minimum(r_new, best_r)
    return best_x


def refine_mixed(A, b, lo, hi, findex, mu, active, x, passes: int = 2):
    """Mixed-precision iterative refinement of a boxed-LCP point at its
    own friction-bound fixed sets: f64 RESIDUAL, f32 correction SOLVE.

    The f32 BPP plateau on ill-conditioned operators (humanwalker's
    m=47: residual ~ kappa * eps_f32 ~ 1e-2-class while the f64 golden
    reaches 1e-14 — docs/SOLVERS.md "Residual tails, adjudicated") is
    set by the free-set solve's rounding.  Classic mixed-precision
    refinement lifts it: compute r = -(b + A x) on the free rows in f64
    — pure elementwise mul+reduce — then solve the correction on the SAME f32 masked operator and
    re-project.  Friction boxes are refreshed from the refined normals
    each pass.  Requires jax_enable_x64; leading batch axes broadcast.
    """
    from dartenv_tpu.lcp.hybrid import comp_residual

    findex = np.asarray(findex)
    fidx = jnp.asarray(np.maximum(findex, 0))
    f64 = jnp.float64
    has_f = jnp.asarray((findex >= 0).astype(np.float64), dtype=f64)
    dtype = A.dtype
    A64 = A.astype(f64)
    b64 = b.astype(f64)
    lo64, hi64 = lo.astype(f64), hi.astype(f64)
    mu64 = mu.astype(f64)
    act64 = active.astype(f64)
    actb = act64 > 0.5
    x64 = x.astype(f64)
    big = jnp.asarray(1e20, f64)
    eye = jnp.eye(A.shape[-1], dtype=dtype)

    def resid(xx):
        return comp_residual(A64, b64, xx, lo64, hi64, findex, mu64,
                             act64)

    # monotone (keep-best) refinement: a wrong free-set partition makes
    # the correction DIVERGE (measured on humanwalker offenders: 6e-4 ->
    # 4.1 when the production point's active set is off), so each pass
    # is accepted per-problem only when the residual actually drops.
    # Candidates are judged AFTER rounding to the f32 output dtype: the
    # iterate's f64 residual can beat the input while its f32 rounding
    # does not (rounding re-injects ~kappa*eps32), and the caller only
    # ever sees the rounded point.
    best_x = x64
    best_r = resid(x64)
    if dtype != f64:
        def _round_trip(xx):
            return xx.astype(dtype).astype(f64)
    else:
        def _round_trip(xx):
            return xx
    for _ in range(passes):
        bd = (mu64 * jnp.abs(jnp.take(x64, fidx, axis=-1)) * has_f
              + big * (1.0 - has_f))
        lo_e = jnp.maximum(lo64, -bd) * act64
        hi_e = jnp.minimum(hi64, bd) * act64
        scale = jnp.maximum(1.0, jnp.max(jnp.abs(x64), axis=-1,
                                         keepdims=True))
        eps = 1e-6 * scale
        at_lo = x64 <= lo_e + eps
        at_hi = x64 >= hi_e - eps
        free = actb & ~at_lo & ~at_hi
        fm = free.astype(f64)
        x_fix = jnp.where(at_hi, hi_e,
                          jnp.where(at_lo, lo_e, 0.0)) * act64 * (1 - fm)
        xa = x64 * fm + x_fix
        # the f64 residual of the free-set linear system (elementwise)
        r = -(b64 + jnp.sum(A64 * xa[..., None, :], axis=-1)) * fm
        fm32 = fm.astype(dtype)
        Am = (A * fm32[..., :, None] * fm32[..., None, :]
              + eye * (1.0 - fm32)[..., None, :])
        d = solve_psd(Am, r.astype(dtype), eps=1e-12) * fm32
        x64 = jnp.clip(xa + d.astype(f64), lo_e, hi_e)
        cand = _round_trip(x64)
        r_new = resid(cand)
        better = r_new < best_r
        bx = better[..., None] if x64.ndim > better.ndim else better
        best_x = jnp.where(bx, cand, best_x)
        best_r = jnp.minimum(r_new, best_r)
    return best_x.astype(dtype)


def make_exact_solver(findex, iters: int = 24, polish_iters: int = 10,
                      refine_iters=None):
    """Exact boxed-LCP solver for ONE env (block principal pivoting).

    Used by the production `solver="dantzig"` mode and by the hybrid
    escalation (lcp/hybrid.py), which vmaps it over its K-env re-solve
    batch: a vmapped batch runs the XLA formulation on every backend.
    """
    findex = np.asarray(findex)

    def solve(A, b, lo, hi, mu, active, lam0):
        return dantzig_solve(A, b, lo, hi, findex, mu, active,
                             iters=iters, polish_iters=polish_iters,
                             lam0=lam0, refine_iters=refine_iters)

    return solve
