"""Exact (Dantzig-class) LCP as a production path: impulse-level
equivalence vs the native C++ Dantzig golden on contact-rich rollouts.

VERDICT.md round 1, item 1: the reference's default contact solver is ODE
Dantzig principal pivoting (`dart/external/odelcpsolver/lcp.cpp` †,
SURVEY.md §2.4/§7).  These tests drive walker2d and hopper through 1,000+
contact-rich f64 substeps with the JAX block-principal-pivoting solver
(lcp/dantzig.py) selected as the per-task production solver
(make_*_task(lcp_solver="dantzig")) and hand the engine's OWN assembled
boxed LCP (engine.world.make_lcp_capture) to the independent C++ golden
(native/lcp_dantzig.cpp), comparing impulse-for-impulse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dartenv_tpu import native
from dartenv_tpu.engine.world import init_state, make_lcp_capture, \
    make_sim_step

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable")


def _comp_residual(A, b, x, lo, hi, findex, mu):
    """Complementarity residual at x's own friction-bound fixed point."""
    lo, hi = lo.copy(), hi.copy()
    for i in range(len(b)):
        if findex[i] >= 0:
            bd = mu[i] * abs(x[findex[i]])
            lo[i], hi[i] = max(lo[i], -bd), min(hi[i], bd)
    w = A @ x + b
    res = 0.0
    for i in range(len(b)):
        at_lo = x[i] <= lo[i] + 1e-9
        at_hi = x[i] >= hi[i] - 1e-9
        if at_lo and at_hi:
            pass                       # pinned row: any w is complementary
        elif at_lo:
            res = max(res, -w[i])
        elif at_hi:
            res = max(res, w[i])
        else:
            res = max(res, abs(w[i]))
        res = max(res, lo[i] - x[i], x[i] - hi[i])
    return res


def _rollout_and_compare(task, n_substeps, torque_scale, seed=0,
                         min_contact_frac=0.25):
    """Step the engine (cold-start, f64, exact solver) and cross-check the
    per-substep LCP solution against the C++ golden.

    Pass criteria: >= 99% of substeps match impulse-for-impulse.  The rare
    exceptions must be GENUINE friction-LCP multiplicity (findex problems
    are non-unique on degenerate redundant-contact manifolds — even ODE's
    answer there depends on pivot order †): both sides must then be valid
    complementarity points (residual < 1e-4) whose velocity outcomes agree
    (|A (lam_jax - lam_cpp)| < 1e-2)."""
    model = task.model
    assert model.solver.solver == "dantzig"
    step = jax.jit(make_sim_step(model))
    capture = jax.jit(make_lcp_capture(model))
    layout_findex = None

    # cold start = reference semantics (no warm-start carry), so the JAX
    # and C++ solves see byte-identical problems with no history
    state = init_state(model, warm_start=False)
    rng = np.random.default_rng(seed)
    tau = jnp.zeros(model.n, dtype=jnp.float64)

    n_contact_steps = 0
    n_impulse_mismatch = 0
    worst_dq = 0.0
    for k in range(n_substeps):
        if k % task.frame_skip == 0:
            a = rng.uniform(-1.0, 1.0, model.n - 3)
            tau = jnp.zeros(model.n, dtype=jnp.float64).at[3:].set(
                jnp.asarray(a) * torque_scale)
        prob = capture(state, tau)
        A = np.asarray(prob["A"])
        b = np.asarray(prob["b"])
        active = np.asarray(prob["active"]) > 0.5
        lo = np.where(active, np.asarray(prob["lo"]), 0.0)
        hi = np.where(active, np.asarray(prob["hi"]), 0.0)
        mu = np.asarray(prob["mu"])
        findex = np.asarray(prob["findex"])
        lam_jax = np.asarray(prob["lam"])

        x_cpp, _, bad = native.lcp_solve(A, b, lo, hi, findex, mu)
        assert bad == 0, f"substep {k}: C++ golden failed"
        scale = max(1.0, np.abs(x_cpp).max())
        if np.any(np.abs(x_cpp) > 1e-12):
            n_contact_steps += 1
        if not np.allclose(lam_jax, x_cpp, atol=1e-7 * scale, rtol=1e-6):
            n_impulse_mismatch += 1
            # allowed ONLY for genuine multiplicity: both solutions must be
            # valid complementarity points with the same velocity outcome
            res_jax = _comp_residual(A, b, lam_jax, lo, hi, findex, mu)
            res_cpp = _comp_residual(A, b, x_cpp, lo, hi, findex, mu)
            gap = float(np.max(np.abs(A @ (lam_jax - x_cpp))))
            worst_dq = max(worst_dq, gap)
            assert res_jax < 1e-4 * scale and res_cpp < 1e-4 * scale, (
                f"substep {k}: non-converged solve "
                f"(res_jax={res_jax:.3e} res_cpp={res_cpp:.3e})")
            assert gap < 1e-2, (
                f"substep {k}: velocity outcomes diverge (gap={gap:.3e})")
        state, _ = step(state, tau)

    contact_frac = n_contact_steps / n_substeps
    assert contact_frac >= min_contact_frac, (
        f"rollout not contact-rich: only {contact_frac:.0%} of substeps "
        "had nonzero impulses")
    # impulse-for-impulse on >= 99% of substeps
    assert n_impulse_mismatch <= n_substeps // 100, (
        f"{n_impulse_mismatch}/{n_substeps} substeps disagree with the "
        f"C++ Dantzig golden (worst constraint-velocity gap {worst_dq:.3e})")


def test_walker2d_dantzig_matches_cpp_golden():
    from dartenv_tpu.envs.walker2d import make_walker2d_task

    task = make_walker2d_task(dtype=jnp.float64, lcp_solver="dantzig")
    _rollout_and_compare(task, n_substeps=1000, torque_scale=100.0)


def test_hopper_dantzig_matches_cpp_golden():
    from dartenv_tpu.envs.hopper import make_hopper_task

    task = make_hopper_task(dtype=jnp.float64, lcp_solver="dantzig")
    _rollout_and_compare(task, n_substeps=1000, torque_scale=200.0)


def test_dantzig_env_production_path():
    """The exact solver runs as the per-task production path: jitted,
    vmapped env stepping end-to-end with plausible physics."""
    from dartenv_tpu.envs.walker2d import make_walker2d_task
    from dartenv_tpu.parallel.vec_env import VecEnv

    task = make_walker2d_task(dtype=jnp.float32, lcp_solver="dantzig")
    vec = VecEnv(task, num_envs=32, max_episode_steps=100)
    state, obs = vec.reset(jax.random.PRNGKey(0))
    step = jax.jit(vec.step)
    a = jnp.zeros((32, task.action_size), dtype=jnp.float32)
    for _ in range(20):
        state, obs, r, d, info = step(state, a)
    assert bool(jnp.all(jnp.isfinite(obs)))
    # standing under zero torque: heights stay physical (no blow-up)
    assert bool(jnp.all(jnp.abs(state.sim.q) < 50.0))


def test_dantzig_warm_start_consistency():
    """Warm-started exact solves land on the same solution as cold solves
    (the warm start only changes the pivot path, not the fixed point)."""
    from dartenv_tpu.lcp.dantzig import dantzig_solve

    rng = np.random.default_rng(3)
    for trial in range(10):
        m = 9
        G = rng.standard_normal((m, m))
        A = jnp.asarray(G @ G.T + 0.5 * np.eye(m))
        b = jnp.asarray(rng.standard_normal(m))
        lo = np.zeros(m)
        hi = np.full(m, 1e20)
        findex = -np.ones(m, dtype=np.int64)
        for k_ in range(m // 3):
            for t in (1, 2):
                findex[3 * k_ + t] = 3 * k_
                lo[3 * k_ + t], hi[3 * k_ + t] = -1e20, 1e20
        mu = jnp.full(m, 0.7)
        act = jnp.ones(m)
        lo, hi = jnp.asarray(lo), jnp.asarray(hi)
        cold = dantzig_solve(A, b, lo, hi, findex, mu, act)
        # warm start from a perturbed copy of the solution
        lam0 = cold + 0.01 * jnp.asarray(rng.standard_normal(m))
        warm = dantzig_solve(A, b, lo, hi, findex, mu, act, lam0=lam0)
        np.testing.assert_allclose(np.asarray(warm), np.asarray(cold),
                                   atol=1e-6, rtol=1e-5)


def test_batched_exact_solver_matches_cpp_golden_on_engine_problems():
    """The vmapped exact solver (make_exact_solver, the escalation's
    K-env batch path) solves ENGINE-captured boxed LCPs to the same
    complementarity points as the C++ golden — the same adjudication
    rules as the per-problem tests above, on one batched call."""
    from dartenv_tpu.envs.walker2d import make_walker2d_task
    from dartenv_tpu.lcp.dantzig import make_exact_solver

    task = make_walker2d_task(dtype=jnp.float64, lcp_solver="dantzig")
    model = task.model
    step = jax.jit(make_sim_step(model))
    capture = jax.jit(make_lcp_capture(model))
    state = init_state(model, warm_start=False)
    rng = np.random.default_rng(7)
    tau = jnp.zeros(model.n, dtype=jnp.float64)

    probs = []
    for k in range(240):
        if k % task.frame_skip == 0:
            a = rng.uniform(-1.0, 1.0, model.n - 3)
            tau = jnp.zeros(model.n, dtype=jnp.float64).at[3:].set(
                jnp.asarray(a) * 100.0)
        prob = capture(state, tau)
        if float(jnp.sum(prob["active"])) > 0:
            probs.append({k2: np.asarray(v) for k2, v in prob.items()
                          if k2 != "findex"}
                         | {"findex": np.asarray(prob["findex"])})
        state, _ = step(state, tau)
    assert len(probs) > 40, "rollout not contact-rich"

    findex = probs[0]["findex"]
    stack = lambda key: jnp.asarray(np.stack([p[key] for p in probs]))
    lam_pal = np.asarray(jax.vmap(make_exact_solver(findex))(
        stack("A"), stack("b"), stack("lo"), stack("hi"), stack("mu"),
        stack("active"), jnp.zeros_like(stack("b"))))

    n_mismatch = 0
    for i, p in enumerate(probs):
        active = p["active"] > 0.5
        lo = np.where(active, p["lo"], 0.0)
        hi = np.where(active, p["hi"], 0.0)
        x_cpp, _, bad = native.lcp_solve(
            p["A"], p["b"], lo, hi, findex, p["mu"])
        assert bad == 0
        scale = max(1.0, np.abs(x_cpp).max())
        if not np.allclose(lam_pal[i], x_cpp, atol=1e-7 * scale,
                           rtol=1e-6):
            n_mismatch += 1
            res_pal = _comp_residual(p["A"], p["b"], lam_pal[i], lo, hi,
                                     findex, p["mu"])
            res_cpp = _comp_residual(p["A"], p["b"], x_cpp, lo, hi,
                                     findex, p["mu"])
            gap = float(np.max(np.abs(p["A"] @ (lam_pal[i] - x_cpp))))
            assert res_pal < 1e-4 * scale and res_cpp < 1e-4 * scale, (
                f"problem {i}: non-converged (pal={res_pal:.3e} "
                f"cpp={res_cpp:.3e})")
            assert gap < 1e-2, f"problem {i}: velocity gap {gap:.3e}"
    assert n_mismatch <= max(2, len(probs) // 50), (
        f"{n_mismatch}/{len(probs)} captured problems disagree with the "
        "C++ golden")
