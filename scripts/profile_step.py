"""Phase-level cost decomposition of an env substep on the GPU.
(Kernel-vs-XLA end to end: scripts/kernel_ab.py.)

Times scan-100 loops of ablated substeps to attribute cost:
  full        — production sim_step
  no_solve    — dynamics + collision + assembly, PGS replaced by zeros
  no_constr   — dynamics only (skip collision + constraints)
  fd_only     — batched forward dynamics (ABA) alone
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

# ablation programs are compile-heavy; cache them persistently (same
# cache the bench harness uses)
from dartenv_tpu.backend import enable_compile_cache
enable_compile_cache()

from dartenv_tpu.dynamics import batched
from dartenv_tpu.engine.constraints import (
    assemble_rows, build_layout, solve_constraints,
)
from dartenv_tpu.engine.world import SimState, integrate_positions
from dartenv_tpu.collision.narrowphase import collide
from dartenv_tpu.bench.throughput import make_task


def timed(fn, state, tau, iters=3):
    out = fn(state, tau)
    jax.block_until_ready(out)
    best = 1e9
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(state, tau)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def main(batch=4096, nsteps=100, env="walker2d"):
    task = make_task(env, dtype=jnp.float32)
    model = task.model
    layout = build_layout(model)
    dt = model.dt
    print(f"LCP rows m={layout.m} contacts={layout.contact_slots} "
          f"limits={len(layout.limit_dofs)} fric={len(layout.friction_dofs)}")

    # production dynamics phase: the fused Pallas kernel on GPU f32
    # batches (set DARTENV_NO_DYN_KERNEL=1 to attribute the kernel's
    # contribution by profiling the XLA phase instead)
    from dartenv_tpu.dynamics.pallas_dynamics import make_dynamics_phase
    dyn_phase = make_dynamics_phase(model, dt)

    def dynamics(q, dq, tau):
        if dyn_phase is not None:
            return dyn_phase(q, dq, tau)
        kin = batched.bkin(model, q, dq)
        ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt, None)
        return dq + dt * ddq, M, kin.phi, kin.R_w, kin.p_w

    def substep(state, tau, mode):
        q, dq = state.q, state.dq
        dq_star, M, phi, R_w, p_w = dynamics(q, dq, tau)
        if mode == "fd_only":
            return SimState(q=q, dq=dq_star, time=state.time + dt)
        if mode == "no_constr":
            q_new = integrate_positions(model, q, dq_star, dt)
            return SimState(q=q_new, dq=dq_star, time=state.time + dt)
        contacts = collide(model, R_w, p_w)
        if mode == "no_lcp":
            # assembly + A-build via the PRODUCTION path (assemble_lcp —
            # the large-n models use the Schur inverse, NOT the batched
            # XLA cholesky, which is ~100x off and would make this
            # ablation slower than `full`), but lam = 0 (isolates the
            # solver cost)
            from dartenv_tpu.engine.constraints import assemble_lcp
            A, b, lo, hi, act, mu, fidx, MinvJt, sel = assemble_lcp(
                model, layout, phi, M, q, dq, dq_star, contacts, dt)
            dq_plus = dq_star + MinvJt @ (0.0 * b + 1e-12 * A[:, 0])
            return SimState(q=integrate_positions(model, q, dq_plus, dt),
                            dq=dq_plus, time=state.time + dt)
        if mode == "no_collide_cost":
            dq_plus = dq_star + 1e-12 * contacts.depth.sum()
            return SimState(q=integrate_positions(model, q, dq_plus, dt),
                            dq=dq_plus, time=state.time + dt)
        if mode == "no_solve":
            # assembly cost without the pallas solve: touch the rows
            from dartenv_tpu.engine import constraints as C
            import jax.numpy as jnp2
            dq_plus, lam = solve_constraints(
                model, layout, phi, M, q, dq, dq_star, contacts, dt,
            )
            del lam
            # cheat: use dq_star (assembly still executed via dq_plus dep?)
            return SimState(q=integrate_positions(model, q, dq_star, dt),
                            dq=dq_star + 0 * dq_plus,
                            time=state.time + dt)
        if mode == "no_escalate":
            # production PGS without the hybrid exact-escalation pass
            import dataclasses as _dc
            m2 = model.replace(solver=_dc.replace(model.solver,
                                                  escalate_frac=0.0))
            dq_plus, _ = solve_constraints(
                m2, layout, phi, M, q, dq, dq_star, contacts, dt,
            )
            return SimState(q=integrate_positions(model, q, dq_plus, dt),
                            dq=dq_plus, time=state.time + dt)
        dq_plus, _ = solve_constraints(
            model, layout, phi, M, q, dq, dq_star, contacts, dt,
        )
        q_new = integrate_positions(model, q, dq_plus, dt)
        return SimState(q=q_new, dq=dq_plus, time=state.time + dt)

    results = {}
    for mode in ["no_constr", "no_collide_cost", "no_lcp", "no_escalate",
                 "full"]:
        step_b = jax.vmap(lambda s, t, mode=mode: substep(s, t, mode))

        def rollout(state, tau, step_b=step_b):
            def body(st, _):
                return step_b(st, tau), ()
            st, _ = jax.lax.scan(body, state, None, length=nsteps)
            return st.q

        fn = jax.jit(rollout)
        q0 = jnp.tile(model.q_init[None], (batch, 1))
        dq0 = jnp.zeros_like(q0)
        state = SimState(q=q0, dq=dq0,
                         time=jnp.zeros((batch,), dtype=q0.dtype))
        tau = jnp.zeros((batch, model.n), dtype=q0.dtype)
        t = timed(fn, state, tau)
        per = t / (batch * nsteps) * 1e9
        results[mode] = t
        print(f"{mode:10s}: {t*1e3:8.2f} ms  ({per:7.1f} ns/env-substep)")
    print(f"constraints total: {(results['full']-results['no_constr'])*1e3:.2f} ms")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=4096)
    ap.add_argument("--env", default="walker2d")
    ap.add_argument("--nsteps", type=int, default=100)
    a = ap.parse_args()
    main(batch=a.batch, nsteps=a.nsteps, env=a.env)
