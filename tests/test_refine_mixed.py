"""Mixed-precision LCP refinement (lcp/dantzig.refine_mixed — round 5).

The f32 BPP residual plateau on ill-conditioned operators is the
free-set solve's rounding (docs/SOLVERS.md "Residual tails,
adjudicated": humanwalker offenders are f64-solvable to 1e-14 while f32
plateaus 1e-2-class).  refine_mixed computes the residual in f64
(elementwise mul+reduce) and the
correction in f32, with per-problem keep-best acceptance.  Pins:
monotonicity (never worse than the input point) and a real accuracy
lift on conditioned problems with correct active sets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dartenv_tpu.lcp.dantzig import dantzig_solve, refine_mixed
from dartenv_tpu.lcp.hybrid import comp_residual


def _make_lcp(rng, m=20, cond=3e4, n_con=4):
    """Ill-conditioned boxed LCP with findex friction coupling,
    engine-realistic: CFM-class diagonal regularization and moderate
    conditioning (the engine's Delassus operators carry cfm=1e-5 and
    physical scaling — a cond-1e6 raw random SPD leaves even the f64
    BPP unconverged and tests nothing real)."""
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    ev = np.logspace(0, np.log10(cond), m)
    A = (Q * ev) @ Q.T
    A = 0.5 * (A + A.T)
    A += 1e-5 * np.trace(A) / m * np.eye(m)
    b = rng.standard_normal(m) * 2.0
    findex = -np.ones(m, dtype=np.int64)
    # engine row families only: unilateral rows (normals/limits, lo=0)
    # and findex-coupled friction rows — dantzig_solve's cold start has
    # no notion of bilateral +-inf rows (the engine never builds them)
    lo = np.zeros(m)
    hi = np.full(m, 1e20)
    mu = np.zeros(m)
    for c in range(n_con):
        i = 3 * c
        findex[i + 1] = i
        findex[i + 2] = i
        lo[i + 1] = lo[i + 2] = -1e20
        mu[i + 1] = mu[i + 2] = 0.8
        b[i] = -abs(b[i])          # push normals active
    active = np.ones(m)
    return A, b, lo, hi, findex, mu, active


def _r64(A, b, x, lo, hi, findex, mu, act):
    """f64 residual wrt the F32-ROUNDED problem data — the problem the
    production solver (and refine_mixed's keep-best) actually sees; the
    engine assembles A/b in f32."""
    f = lambda v: jnp.asarray(
        np.asarray(np.asarray(v, np.float32), np.float64))
    fx = lambda v: jnp.asarray(np.asarray(v, np.float64))
    return float(comp_residual(f(A), f(b), fx(x), f(lo), f(hi),
                               findex, f(mu), f(act)))


def test_refine_mixed_monotone_and_lifts_plateau():
    """Two properties, matching the production adjudication findings:
    (1) MONOTONE: never meaningfully worse than the input point,
    whatever its active set (keep-best, judged after f32 rounding);
    (2) LIFT: where the f32 BPP solve plateaus well ABOVE the f32
    representation floor (r_floor = residual of the f64 solution
    rounded to f32) with the CORRECT active set — the exact regime of
    humanwalker's 'f32 precision ceiling' offenders — refinement must
    recover (near) the floor."""
    rng = np.random.default_rng(0)
    lifted = 0
    best_lift = 0.0
    for trial in range(14):
        A, b, lo, hi, findex, mu, act = _make_lcp(rng)
        f32 = lambda v: jnp.asarray(np.asarray(v), jnp.float32)
        f64 = lambda v: jnp.asarray(np.asarray(v), jnp.float64)
        x64 = dantzig_solve(f64(A), f64(b), f64(lo), f64(hi), findex,
                            f64(mu), f64(act), iters=40, polish_iters=10)
        x_floor = jnp.asarray(np.asarray(x64, np.float32))
        r_floor = _r64(A, b, x_floor, lo, hi, findex, mu, act)
        # monotone from the floor point itself (can't be improved)
        xr = refine_mixed(f32(A), f32(b), f32(lo), f32(hi), findex,
                          f32(mu), f32(act), x_floor, passes=3)
        rr = _r64(A, b, xr, lo, hi, findex, mu, act)
        assert rr <= max(r_floor * 1.05, r_floor + 1e-6), \
            (trial, r_floor, rr)
        # f32 BPP point: monotone always; lift when plateaued above the
        # floor with matching sets
        x32 = dantzig_solve(f32(A), f32(b), f32(lo), f32(hi), findex,
                            f32(mu), f32(act), iters=24, polish_iters=6)
        r32 = _r64(A, b, x32, lo, hi, findex, mu, act)
        xr2 = refine_mixed(f32(A), f32(b), f32(lo), f32(hi), findex,
                           f32(mu), f32(act), x32, passes=3)
        rr2 = _r64(A, b, xr2, lo, hi, findex, mu, act)
        assert rr2 <= max(r32 * 1.05, r32 + 1e-6), (trial, r32, rr2)
        if rr2 < 0.8 * r32:
            lifted += 1
            best_lift = max(best_lift, r32 / max(rr2, 1e-30))
    # deterministic seed-0 pin: on this problem set the refinement lifts
    # a solid fraction of the BPP points (8/14 measured), several by
    # 10-100x; trials whose partition is wrong are keep-best-rejected
    # (refined == r32 exactly) rather than worsened — that selectivity
    # is the property that makes the production tier safe
    assert lifted >= 6, lifted
    assert best_lift >= 10.0, best_lift


def test_refine_mixed_batched_matches_per_problem():
    """Leading batch axis broadcasts identically to per-problem calls."""
    rng = np.random.default_rng(3)
    probs = [_make_lcp(rng) for _ in range(4)]
    f32 = lambda v: jnp.asarray(np.asarray(v), jnp.float32)
    xs = [dantzig_solve(f32(A), f32(b), f32(lo), f32(hi), fin, f32(mu),
                        f32(act), iters=24, polish_iters=6)
          for A, b, lo, hi, fin, mu, act in probs]
    fin = probs[0][4]
    stack = lambda i: jnp.stack([f32(p[i]) for p in probs])
    xb = refine_mixed(stack(0), stack(1), stack(2), stack(3), fin,
                      stack(5), stack(6), jnp.stack(xs), passes=2)
    for e, (A, b, lo, hi, _, mu, act) in enumerate(probs):
        xe = refine_mixed(f32(A), f32(b), f32(lo), f32(hi), fin,
                          f32(mu), f32(act), xs[e], passes=2)
        np.testing.assert_allclose(np.asarray(xb[e]), np.asarray(xe),
                                   rtol=1e-6, atol=1e-7)


def test_hybrid_solver_ref64_tier_improves_envelope():
    """The escalate_ref64 knob through make_hybrid_solver's batched
    path: with a starved PGS + shallow tier-1, the refined envelope
    must dominate the unrefined one and never regress per problem."""
    from dartenv_tpu.lcp.hybrid import make_hybrid_solver

    rng = np.random.default_rng(7)
    probs = [_make_lcp(rng) for _ in range(8)]
    fin = probs[0][4]
    f32 = lambda v: jnp.asarray(np.asarray(v), jnp.float32)
    stack = lambda i: jnp.stack([f32(p[i]) for p in probs])
    args = (stack(0), stack(1), stack(2), stack(3), stack(5), stack(6),
            jnp.zeros((8, probs[0][0].shape[0]), jnp.float32))

    def envelope(ref64):
        solver = make_hybrid_solver(
            fin, iters=5, escalate_frac=1.0, escalate_tol=1e-9,
            escalate_iters=8, escalate_ref64=ref64)
        lam = jax.vmap(solver)(*args)
        return np.asarray([
            _r64(p[0], p[1], np.asarray(lam[e]), p[2], p[3], fin, p[5],
                 p[6]) for e, p in enumerate(probs)])

    r0 = envelope(0)
    r2 = envelope(2)
    assert np.all(r2 <= np.maximum(r0 * 1.05, r0 + 1e-6)), (r0, r2)
    sel = r0 > 1e-6
    assert sel.any(), r0
    # at least one problem lifted hard and none regressed
    assert (r2[sel] / r0[sel]).min() < 0.2, (r0, r2)


def test_refine_compensated_matches_mixed_lift():
    """The x64-free production tier (refine_compensated, double-float
    residual in plain f32) must deliver refine_mixed's properties:
    monotone keep-best, and the same plateau lift on the same problems
    — the compensated w = A x + b agrees with the f64 of the f32
    inputs to ~2^-48, so the two tiers should accept the same
    corrections."""
    from dartenv_tpu.lcp.dantzig import refine_compensated

    rng = np.random.default_rng(0)
    lifted = 0
    best_lift = 0.0
    for trial in range(14):
        A, b, lo, hi, findex, mu, act = _make_lcp(rng)
        f32 = lambda v: jnp.asarray(np.asarray(v), jnp.float32)
        x32 = dantzig_solve(f32(A), f32(b), f32(lo), f32(hi), findex,
                            f32(mu), f32(act), iters=24, polish_iters=6)
        r32 = _r64(A, b, x32, lo, hi, findex, mu, act)
        xr = refine_compensated(f32(A), f32(b), f32(lo), f32(hi),
                                findex, f32(mu), f32(act), x32,
                                passes=3)
        rr = _r64(A, b, xr, lo, hi, findex, mu, act)
        assert rr <= max(r32 * 1.05, r32 + 1e-6), (trial, r32, rr)
        if rr < 0.8 * r32:
            lifted += 1
            best_lift = max(best_lift, r32 / max(rr, 1e-30))
    assert lifted >= 6, lifted
    assert best_lift >= 10.0, best_lift


def test_comp_matvec_add_beats_naive_f32():
    """The double-float contraction recovers the f64-of-f32-inputs
    value through a catastrophic cancellation where the naive f32 sum
    floors at ~eps32 * ||terms||."""
    from dartenv_tpu.lcp.dantzig import _comp_matvec_add

    rng = np.random.default_rng(1)
    K, m = 8, 24
    Q = rng.normal(size=(K, m, m))
    ev = 10.0 ** rng.uniform(-5, 2, (K, m))
    A = jnp.asarray(np.einsum("kij,kj,klj->kil", Q, ev, Q), jnp.float32)
    x = jnp.asarray(rng.normal(size=(K, m)), jnp.float32)
    b = jnp.asarray(
        -np.einsum("kij,kj->ki", np.asarray(A, np.float64),
                   np.asarray(x, np.float64)), jnp.float32)
    w64 = np.einsum("kij,kj->ki", np.asarray(A, np.float64),
                    np.asarray(x, np.float64)) + np.asarray(b, np.float64)
    w_ff = np.asarray(jax.jit(_comp_matvec_add)(A, x, b), np.float64)
    w_naive = np.asarray(jnp.sum(A * x[:, None, :], axis=-1) + b,
                         np.float64)
    assert np.abs(w_ff - w64).max() < 1e-9
    assert np.abs(w_naive - w64).max() > 1e-6  # the gap being closed
