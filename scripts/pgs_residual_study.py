#!/usr/bin/env python
"""PGS iteration-count study on contact-rich env states (default PGS
iteration counts should rest on a measured residual envelope).

Drives seeded production-mode (f32, warm-started) rollouts of the
contact-heavy tasks, captures every substep's boxed LCP + the engine's own
PGS solution at several iteration budgets, and reports complementarity
residuals normalized by the impulse scale.  The committed findings live in
docs/SOLVERS.md; tests/test_pgs_residuals.py asserts the production
configuration stays within the studied envelope.

Usage: python scripts/pgs_residual_study.py [--env walker2d] [--substeps 600]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# The study is host-loop heavy (one LCP capture round-trip per substep),
# so it defaults to the local CPU backend unless the user explicitly asks
# for the device.
if "--device" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp


def comp_residual(A, b, x, lo, hi, findex, mu, active):
    """Max complementarity violation at x's own friction-bound fixed point,
    over active rows (vectorized version of tests/test_exact_solver.py)."""
    lo, hi = lo.copy(), hi.copy()
    fmask = findex >= 0
    if fmask.any():
        bd = mu[fmask] * np.abs(x[findex[fmask]])
        lo[fmask] = np.maximum(lo[fmask], -bd)
        hi[fmask] = np.minimum(hi[fmask], bd)
    w = A @ x + b
    at_lo = x <= lo + 1e-9
    at_hi = x >= hi - 1e-9
    interior = ~(at_lo | at_hi)
    pinned = at_lo & at_hi
    res = np.where(pinned, 0.0,
                   np.where(at_lo, -w,
                            np.where(at_hi, w, np.abs(w))))
    res = np.maximum(res, np.maximum(lo - x, x - hi))
    res = np.where(active > 0.5, res, 0.0)
    return float(res.max(initial=0.0))


def study(env: str, substeps: int, iters_grid, seed=0, pgs_iters=None,
          escalate_iters=None):
    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.engine.world import init_state, make_lcp_capture, \
        make_sim_step
    from dartenv_tpu.lcp.pgs import pgs_solve

    task = make_task(env, dtype=jnp.float32)
    model = task.model
    from dartenv_tpu.envs.base import with_solver
    if pgs_iters is not None:
        model = with_solver(model, pgs_iters=pgs_iters)
    if escalate_iters is not None:
        model = with_solver(model, escalate_iters=escalate_iters)
    step = jax.jit(make_sim_step(model))
    capture = jax.jit(make_lcp_capture(model))
    torque = {"walker2d": 100.0, "hopper": 200.0, "humanwalker": 100.0,
              "dog": 60.0, "walker3d": 100.0}.get(env, 50.0)

    state = init_state(model, warm_start=True)
    rng = np.random.default_rng(seed)
    tau = jnp.zeros(model.n, dtype=jnp.float32)

    residuals = {it: [] for it in iters_grid}
    prod_res = []
    n_contact = 0
    findex_np = None
    for k in range(substeps):
        if k % task.frame_skip == 0:
            a = rng.uniform(-1.0, 1.0, model.n - 3)
            tau = jnp.zeros(model.n, dtype=jnp.float32).at[3:].set(
                jnp.asarray(a, dtype=jnp.float32) * torque)
        prob = capture(state, tau)
        A = np.asarray(prob["A"], dtype=np.float64)
        b = np.asarray(prob["b"], dtype=np.float64)
        active = np.asarray(prob["active"]) > 0.5
        lo = np.where(active, np.asarray(prob["lo"], np.float64), 0.0)
        hi = np.where(active, np.asarray(prob["hi"], np.float64), 0.0)
        mu = np.asarray(prob["mu"], dtype=np.float64)
        findex_np = np.asarray(prob["findex"])
        lam_prod = np.asarray(prob["lam"], dtype=np.float64)
        # grid solves are COLD-started (zeros): the conservative envelope.
        # production (prob["lam"]) is warm-started via state.lam.
        lam0 = jnp.zeros_like(prob["b"])

        scale = max(1.0, np.abs(lam_prod).max())
        if np.abs(lam_prod).max() <= 1e-9:
            state, _ = step(state, tau)
            continue
        n_contact += 1
        prod_res.append(
            comp_residual(A, b, lam_prod, lo, hi, findex_np, mu,
                          active.astype(np.float64)) / scale)
        for it in iters_grid:
            lam_it = np.asarray(pgs_solve(
                prob["A"], prob["b"], prob["lo"], prob["hi"], findex_np,
                prob["mu"], prob["active"], iters=it,
                omega=model.solver.pgs_omega, lam0=lam0),
                dtype=np.float64)
            s = max(1.0, np.abs(lam_it).max())
            residuals[it].append(
                comp_residual(A, b, lam_it, lo, hi, findex_np, mu,
                              active.astype(np.float64)) / s)
        state, _ = step(state, tau)

    print(f"\n== {env}: {n_contact}/{substeps} contact substeps, "
          f"production pgs_iters={model.solver.pgs_iters}, "
          f"warm-started ==")
    pr = np.asarray(prod_res)
    print(f"production: median={np.median(pr):.2e} p95="
          f"{np.percentile(pr, 95):.2e} max={pr.max():.2e}")
    for it in iters_grid:
        r = np.asarray(residuals[it])
        print(f"iters={it:3d}: median={np.median(r):.2e} "
              f"p95={np.percentile(r, 95):.2e} max={r.max():.2e}")
    return pr, residuals


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--env", default=None,
                   help="single env (default: walker2d + hopper)")
    p.add_argument("--substeps", type=int, default=600)
    p.add_argument("--iters", default="5,10,20,30,50")
    p.add_argument("--device", action="store_true",
                   help="run on the default JAX device instead of CPU")
    p.add_argument("--pgs_iters", type=int, default=None,
                   help="override the production PGS iteration budget")
    p.add_argument("--escalate_iters", type=int, default=None,
                   help="override the escalation pivot budget")
    args = p.parse_args()
    grid = [int(x) for x in args.iters.split(",")]
    envs = [args.env] if args.env else ["walker2d", "hopper"]
    for e in envs:
        study(e, args.substeps, grid, pgs_iters=args.pgs_iters,
              escalate_iters=args.escalate_iters)
