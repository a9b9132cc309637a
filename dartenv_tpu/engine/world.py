"""The simulation step: a JAX `World::step`.

Replicates the reference's canonical op order exactly
(`dart/simulation/World.cpp:~100-200` †, SURVEY.md §3.2):

  1. smooth forward dynamics (implicit spring/damping)      [ABA/CRB]
  2. integrate velocities        dq* = dq + dt * ddq
  3. collision detection at the *current* positions
  4. constraint solve (contacts + joint limits) -> impulses -> dq+
  5. integrate positions with dq+ (exp-map for ball/free joints)
  6. time += dt

but as ONE pure jittable function per model — zero host crossings per step
(the reference pays ~2 Python->SWIG->C++ crossings per substep, §3.2).
Batching: `jax.vmap(step)`; sharding: shard_map over the env mesh
(dartenv_tpu.parallel).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from dartenv_tpu.collision.narrowphase import Contacts, collide
from dartenv_tpu.dynamics import batched
from dartenv_tpu.dynamics.joints import integrate_joint_position
from dartenv_tpu.engine.constraints import build_layout, solve_constraints
from dartenv_tpu.model.skel_model import SkelModel


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimState:
    """Full simulation state — the reference's checkpoint primitive is
    exactly (q, dq) (`state_vector()` †, SURVEY.md §5.4); as a pytree it is
    trivially checkpointable and vmappable."""

    q: Any
    dq: Any
    time: Any
    # previous-substep LCP impulses (m,), or None to disable warm starting.
    # Impulses are strongly correlated across substeps (persistent
    # contacts), so seeding PGS with them roughly halves the sweeps needed
    # for the same residual.  The reference's ODE-lineage solver family
    # warm-starts the same way; None keeps the reference's cold-start
    # semantics for validation.
    lam: Any = None

    def state_vector(self):
        """concat(q, dq) — parity with DartEnv.state_vector() †."""
        return jnp.concatenate([self.q, self.dq], axis=-1)


def init_state(model: SkelModel, dtype=None, warm_start: bool = True
               ) -> SimState:
    q = model.q_init if dtype is None else model.q_init.astype(dtype)
    dq = model.dq_init if dtype is None else model.dq_init.astype(dtype)
    lam = None
    if warm_start:
        from dartenv_tpu.engine.constraints import build_layout
        lam = jnp.zeros((build_layout(model).m,), dtype=q.dtype)
    return SimState(q=q, dq=dq, time=jnp.zeros((), dtype=q.dtype), lam=lam)


def integrate_positions(model: SkelModel, q, dq, dt):
    return batched.integrate_positions(model, q, dq, dt)


def make_sim_step(model: SkelModel, return_impulses: bool = False) -> Callable:
    """Build the single-substep function for a model.

    Returns step(state, tau, f_ext_world=None) -> (state', Contacts), or
    (state', (Contacts, lam)) with the LCP impulse vector when
    `return_impulses` (used by the OO facade's collision_result † and the
    validation tracer; the production env path keeps the lean signature).
    `tau` is the full-dof generalized force vector (root dofs zeroed by the
    env layer, matching the reference's set_forces semantics †).
    """
    layout = build_layout(model)
    dt = model.dt
    # fused Pallas dynamics phase (dynamics/pallas_dynamics.py): a vmapped
    # f32 batch on the GPU runs the whole phase in one kernel; the
    # single-env / CPU / f64 sides of the custom_vmap run the exact
    # batched.py path below.  None when the model has unsupported joints.
    from dartenv_tpu.dynamics.pallas_dynamics import make_dynamics_phase
    dyn_phase = make_dynamics_phase(model, dt)

    def step(state: SimState, tau, f_ext_world=None, servo_target=None):
        # every contraction in the physics trace runs at HIGHEST matmul
        # precision: a default-precision f32 dot_general may run in TF32
        # on the GPU's tensor cores (about three decimal digits), which
        # is 1e-2-class per-substep error vs CPU-f64 on this path.  The
        # Pallas kernels are unaffected (elementwise mul/add only).
        with jax.default_matmul_precision("highest"):
            return _step(state, tau, f_ext_world, servo_target)

    def _step(state: SimState, tau, f_ext_world=None, servo_target=None):
        # named scopes give per-phase attribution in jax.profiler/XProf
        # traces (SURVEY.md §5.1 — the reference has no profiling hooks)
        q, dq = state.q, state.dq
        with jax.named_scope("dynamics"):
            if dyn_phase is not None and f_ext_world is None:
                dq_star, M, phi, R_w, p_w = dyn_phase(q, dq, tau)
            else:
                kin = batched.bkin(model, q, dq)
                ddq, M = batched.forward_dynamics(model, kin, q, dq, tau,
                                                  dt, f_ext_world)
                dq_star = dq + dt * ddq
                phi, R_w, p_w = kin.phi, kin.R_w, kin.p_w
        with jax.named_scope("collision"):
            contacts = collide(model, R_w, p_w)
        with jax.named_scope("constraints"):
            dq_plus, lam = solve_constraints(
                model, layout, phi, M, q, dq, dq_star, contacts, dt,
                lam_prev=state.lam, servo_target=servo_target,
            )
        with jax.named_scope("integrate"):
            q_new = integrate_positions(model, q, dq_plus, dt)
        out = (contacts, lam) if return_impulses else contacts
        lam_carry = lam if state.lam is not None else None
        return SimState(q=q_new, dq=dq_plus, time=state.time + dt,
                        lam=lam_carry), out

    return step


def make_lcp_capture(model: SkelModel) -> Callable:
    """Debug/validation hook: (state, tau) -> dict with the exact boxed LCP
    the constraint solver sees this substep (post active-set compaction)
    plus the engine's own solution.

    Used by tests/test_exact_solver.py to hand the identical problem to the
    native C++ Dantzig golden (native/lcp_dantzig.cpp) and compare impulses
    — the strongest reference-free equivalence check for the solver spine
    (VERDICT.md round 1, item 1).
    """
    from dartenv_tpu.engine.constraints import assemble_lcp

    layout = build_layout(model)
    dt = model.dt

    def capture(state: SimState, tau):
        with jax.default_matmul_precision("highest"):
            return _capture(state, tau)

    def _capture(state: SimState, tau):
        q, dq = state.q, state.dq
        kin = batched.bkin(model, q, dq)
        ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt, None)
        dq_star = dq + dt * ddq
        contacts = collide(model, kin.R_w, kin.p_w)
        A, b, lo, hi, active, mu, findex, MinvJt, sel = assemble_lcp(
            model, layout, kin.phi, M, q, dq, dq_star, contacts, dt
        )
        lam_prev = state.lam
        if lam_prev is not None:
            lam0 = sel @ lam_prev if sel is not None else lam_prev
            lam0 = lam0 * active
        else:
            lam0 = None
        from dartenv_tpu.engine.constraints import run_lcp_solver

        lam = run_lcp_solver(model.solver, findex, A, b, lo, hi, mu,
                             active, lam0)
        return dict(A=A, b=b, lo=lo, hi=hi, active=active, mu=mu,
                    findex=findex, lam=lam, dq_star=dq_star,
                    dq_plus=dq_star + MinvJt @ lam)

    return capture


def make_do_simulation(model: SkelModel, frame_skip: int,
                       return_impulses: bool = False) -> Callable:
    """frame_skip substeps with the same tau (reference:
    DartEnv.do_simulation † — same tau each substep, SURVEY.md §2.2)."""
    step = make_sim_step(model, return_impulses=return_impulses)

    def do_sim(state: SimState, tau, f_ext_world=None, servo_target=None):
        if frame_skip == 1:
            return step(state, tau, f_ext_world, servo_target)
        # larger trip counts: scan to keep compile time/program size bounded
        def body(st, _):
            st2, c2 = step(st, tau, f_ext_world, servo_target)
            return st2, c2

        st, cs = jax.lax.scan(body, state, None, length=frame_skip)
        out = jax.tree_util.tree_map(lambda x: x[-1], cs)
        # contact-cap overflow is reported as the max over the substeps
        # (the last substep alone could mask a mid-step overflow)
        contacts = out[0] if return_impulses else out
        contacts = dataclasses.replace(
            contacts, overflow=jnp.max(
                (cs[0] if return_impulses else cs).overflow, axis=0))
        out = (contacts, out[1]) if return_impulses else contacts
        return st, out

    return do_sim
