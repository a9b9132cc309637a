"""Constraint assembly: contacts + joint limits + joint Coulomb friction
-> one boxed LCP per env — fully vectorized over constraint rows.

JAX replacement of the reference's constraint layer
(`dart/constraint/ConstraintSolver.cpp` †, `ContactConstraint.cpp` †,
`JointLimitConstraint.cpp` †, `JointCoulombFrictionConstraint` † —
SURVEY.md §2.4).  Differences from the reference's architecture, by design:

* no constrained-island grouping — each env is one robot, the LCP covers
  all rows, inactive ones masked (SURVEY.md §2.4: "islands unnecessary");
* A = J M^-1 J^T is assembled densely from the mass matrix instead of
  DART's per-column unit-impulse tests — identical operator, expressed as
  a few batched einsums (slot layout is static, so the whole assembly is
  array-shaped: no per-row Python graphs).

Row semantics mirror the reference's ODE-style rows:
* contact normal row: lam >= 0, target velocity =
    max(restitution * (-v_n), erp * max(depth - allowance, 0)/dt capped at
    max_erv) (ContactConstraint ERP/CFM/allowance semantics ‡);
* two friction rows per contact with findex coupling (friction pyramid),
  tangents from a deterministic basis of the normal
  (getTangentBasisMatrixODE † analogue);
* joint-limit row per limited dof, sign-flipped into ">=0, lam>=0" form
  (JointLimitConstraint †, activated on violation);
* Coulomb joint-friction row per dof with dof_friction > 0:
  |impulse| <= friction_force * dt.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.collision.narrowphase import Contacts, slot_layout
from dartenv_tpu.math.linalg import chol, chol_solve, inv_psd, _UNROLL_MAX
from dartenv_tpu.model.skel_model import SkelModel
from dartenv_tpu.lcp.pgs import make_pgs_solver, pgs_solve


def tangent_basis(n):
    """Deterministic tangent frame for unit normals n (..., 3)."""
    ex = jnp.zeros_like(n).at[..., 0].set(1.0)
    ez = jnp.zeros_like(n).at[..., 2].set(1.0)
    ref = jnp.where(jnp.abs(n[..., :1]) < 0.9, ex, ez)
    t1 = jnp.cross(n, ref)
    t1 = t1 / jnp.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = jnp.cross(n, t1)
    return t1, t2


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Static structure of the LCP (host-side, built once per model).

    Row order: [3 per contact slot (n, t1, t2)] ++ [limit rows] ++
    [dof friction rows] ++ [servo motor rows].
    """

    m: int
    contact_slots: int
    limit_dofs: tuple
    friction_dofs: tuple
    servo_dofs: tuple
    findex: np.ndarray       # (m,)
    slot_body: tuple         # body_a per slot
    slot_mask: np.ndarray    # (ns, n) SIGNED ancestor mask per slot:
                             # +mask(body_a) - mask(body_b); world slots have
                             # body_b = -1 (zero contribution) — common
                             # ancestors of a self pair cancel exactly, as
                             # they move both bodies with the same twist
    lim_onehot: np.ndarray   # (nl, n)
    fr_onehot: np.ndarray    # (nf, n)
    sv_onehot: np.ndarray    # (nsv, n)


def build_layout(model: SkelModel) -> RowLayout:
    slot_body, slot_body_b, _ = slot_layout(model)
    ns = len(slot_body)
    n = model.n
    limited = np.asarray(model.limited) > 0.5
    limit_dofs = tuple(int(d) for d in np.nonzero(limited)[0])
    fr = np.asarray(model.dof_friction) > 0.0
    friction_dofs = tuple(int(d) for d in np.nonzero(fr)[0])
    if model.servo_flimit is not None:
        sv = np.asarray(model.servo_flimit) > 0.0
        servo_dofs = tuple(int(d) for d in np.nonzero(sv)[0])
    else:
        servo_dofs = ()
    m = 3 * ns + len(limit_dofs) + len(friction_dofs) + len(servo_dofs)
    findex = -np.ones(m, dtype=np.int64)
    for s in range(ns):
        findex[3 * s + 1] = 3 * s
        findex[3 * s + 2] = 3 * s
    amask = np.asarray(model.ancestor_mask)
    if ns:
        slot_mask = amask[np.asarray(slot_body, dtype=np.int64)].copy()
        for s, bb in enumerate(slot_body_b):
            if bb >= 0:
                slot_mask[s] -= amask[bb]
    else:
        slot_mask = np.zeros((0, n))
    lim_onehot = np.zeros((len(limit_dofs), n))
    for i, d in enumerate(limit_dofs):
        lim_onehot[i, d] = 1.0
    fr_onehot = np.zeros((len(friction_dofs), n))
    for i, d in enumerate(friction_dofs):
        fr_onehot[i, d] = 1.0
    sv_onehot = np.zeros((len(servo_dofs), n))
    for i, d in enumerate(servo_dofs):
        sv_onehot[i, d] = 1.0
    return RowLayout(
        m=m, contact_slots=ns, limit_dofs=limit_dofs,
        friction_dofs=friction_dofs, servo_dofs=servo_dofs,
        findex=findex, slot_body=slot_body,
        slot_mask=slot_mask, lim_onehot=lim_onehot, fr_onehot=fr_onehot,
        sv_onehot=sv_onehot,
    )


def assemble_rows(model: SkelModel, layout: RowLayout, phi, q,
                  dq_before, dq_star, contacts: Contacts, dt,
                  servo_target=None):
    """Vectorized (J, b, lo, hi, active, mu) for the full row stack.

    servo_target: (n,) commanded dof velocities for servo rows (reference:
    Joint::setCommand with SERVO actuator †), or None for zero commands.
    """
    n = model.n
    dtype = dq_star.dtype
    cfg = model.solver
    big = jnp.asarray(1e20, dtype=dtype)
    Js, bs, los, his, acts, mus = [], [], [], [], [], []

    ns = layout.contact_slots
    if ns:
        w_cols, v_cols = phi[:, :3], phi[:, 3:]
        p = contacts.pos                                     # (ns, 3)
        mask = jnp.asarray(layout.slot_mask, dtype=dtype)    # (ns, n)
        cols = (v_cols[None, :, :]
                + jnp.cross(jnp.broadcast_to(w_cols[None, :, :],
                                             (ns, n, 3)),
                            p[:, None, :])) * mask[:, :, None]
        nrm = contacts.normal
        t1, t2 = tangent_basis(nrm)
        D = jnp.stack([nrm, t1, t2], axis=1)                 # (ns, 3, 3)
        Jc = jnp.einsum("sdk,snk->sdn", D, cols)             # (ns, 3, n)
        v_star = jnp.einsum("sdn,n->sd", Jc, dq_star)        # (ns, 3)
        v_n_before = jnp.einsum("sn,n->s", Jc[:, 0, :], dq_before)
        bounce = contacts.restitution * jnp.maximum(-v_n_before, 0.0)
        erp_push = jnp.minimum(
            cfg.erp * jnp.maximum(contacts.depth - cfg.allowance, 0.0)
            / dt,
            cfg.max_erv,
        )
        desired = jnp.maximum(bounce, erp_push)
        b_c = v_star.at[:, 0].add(-desired).reshape(3 * ns)
        act_c = jnp.repeat(contacts.active, 3)
        lo_c = jnp.tile(jnp.asarray([0.0, -1.0, -1.0], dtype) * big, ns)
        hi_c = jnp.full((3 * ns,), 1.0, dtype) * big
        mu_c = jnp.stack(
            [jnp.zeros_like(contacts.friction),
             contacts.friction, contacts.friction], axis=1
        ).reshape(3 * ns)
        Js.append(Jc.reshape(3 * ns, n))
        bs.append(b_c)
        los.append(lo_c)
        his.append(hi_c)
        acts.append(act_c)
        mus.append(mu_c)

    nl = len(layout.limit_dofs)
    if nl:
        ld = np.asarray(layout.limit_dofs, dtype=np.int64)
        lo_v = model.q_lower[ld] - q[ld]
        hi_v = q[ld] - model.q_upper[ld]
        high_active = hi_v > 0.0
        active_l = ((lo_v > 0.0) | high_active).astype(dtype) \
            * model.limited[ld]
        sign = jnp.where(high_active, -1.0, 1.0).astype(dtype)
        viol = jnp.maximum(jnp.maximum(lo_v, hi_v), 0.0)
        target = jnp.minimum(cfg.joint_erp * viol / dt, cfg.max_erv)
        J_l = sign[:, None] * jnp.asarray(layout.lim_onehot, dtype=dtype)
        Js.append(J_l)
        bs.append(sign * dq_star[ld] - target)
        los.append(jnp.zeros(nl, dtype))
        his.append(jnp.full((nl,), 1.0, dtype) * big)
        acts.append(active_l)
        mus.append(jnp.zeros(nl, dtype))

    nf = len(layout.friction_dofs)
    if nf:
        fd = np.asarray(layout.friction_dofs, dtype=np.int64)
        bound = model.dof_friction[fd] * dt
        Js.append(jnp.asarray(layout.fr_onehot, dtype=dtype))
        bs.append(dq_star[fd])
        los.append(-bound)
        his.append(bound)
        acts.append(jnp.ones(nf, dtype))
        mus.append(jnp.zeros(nf, dtype))

    nsv = len(layout.servo_dofs)
    if nsv:
        # servo motor rows (ServoMotorConstraint †): drive dq[d] to the
        # commanded velocity, impulse boxed to +-force_limit * dt
        sd = np.asarray(layout.servo_dofs, dtype=np.int64)
        sbound = model.servo_flimit[sd] * dt
        cmd = (jnp.zeros(nsv, dtype) if servo_target is None
               else servo_target[sd])
        Js.append(jnp.asarray(layout.sv_onehot, dtype=dtype))
        bs.append(dq_star[sd] - cmd)
        los.append(-sbound)
        his.append(sbound)
        acts.append(jnp.ones(nsv, dtype))
        mus.append(jnp.zeros(nsv, dtype))

    J = jnp.concatenate(Js, axis=0)
    return (J, jnp.concatenate(bs), jnp.concatenate(los),
            jnp.concatenate(his), jnp.concatenate(acts),
            jnp.concatenate(mus))


def assemble_lcp(model: SkelModel, layout: RowLayout, phi,
                 M, q, dq_before, dq_star, contacts: Contacts, dt,
                 servo_target=None):
    """Assemble the full per-env boxed LCP as the solver sees it.

    Returns (A, b, lo, hi, active, mu, findex, MinvJt, sel) where
    `findex` is the static (possibly compacted) friction-index array and
    `sel` the (m_c, m) compaction one-hot (None when contact_cap is off).
    Exposed so validation can hand the identical problem to the native C++
    Dantzig golden (native/lcp_dantzig.cpp) for impulse-level cross-checks.
    """
    m = layout.m
    dtype = dq_star.dtype
    cfg = model.solver

    J, b, lo, hi, active, mu = assemble_rows(
        model, layout, phi, q, dq_before, dq_star, contacts, dt,
        servo_target=servo_target,
    )

    # ---- active-set compaction (contact_cap) ----------------------------
    # The reference assembles LCP rows only for contacts that actually
    # collided (ConstraintSolver †); with static XLA shapes we instead
    # gather the best `cap` slots (active first, then deepest) and solve
    # the small dense system — identical result whenever the number of
    # simultaneously active slots fits the cap.
    ns = layout.contact_slots
    cap = int(cfg.contact_cap)
    findex = layout.findex
    sel = None
    if cap and 0 < cap < ns:
        score = contacts.active * 1e4 + contacts.depth
        _, slot_idx = jax.lax.top_k(score, cap)        # (cap,)
        # restore original slot order: PGS is order-dependent, so the
        # capped sweep must visit surviving rows in the uncapped order to
        # reproduce the uncapped solution exactly
        slot_idx = jnp.sort(slot_idx)
        crow = (slot_idx[:, None] * 3
                + jnp.arange(3, dtype=slot_idx.dtype)[None, :]).reshape(-1)
        tail = jnp.arange(3 * ns, m, dtype=slot_idx.dtype)
        row_sel = jnp.concatenate([crow, tail])
        # selection as a one-hot matrix: S @ x is a dense contraction, no
        # dynamic gather on the hot path
        m_c = row_sel.shape[0]
        sel = (row_sel[:, None]
               == jnp.arange(m, dtype=row_sel.dtype)[None, :]).astype(dtype)
        J = sel @ J
        b, lo, hi = sel @ b, sel @ lo, sel @ hi
        active, mu = sel @ active, sel @ mu
        # compacted findex is static: (n, t1, t2) blocks then plain tail
        n_tail = m - 3 * ns
        findex = np.concatenate([
            np.stack([-np.ones(cap, np.int64),
                      3 * np.arange(cap),
                      3 * np.arange(cap)], axis=1).reshape(-1),
            -np.ones(n_tail, np.int64),
        ])
        m = 3 * cap + n_tail

    if model.n > _UNROLL_MAX:
        # large models (humanoid n=29): XLA's batched cholesky/triangular
        # solves are ~100x off speed-of-light under the batch-minor
        # layouts this program runs in — build A from the explicit Schur
        # inverse instead (pure matmuls; see math/linalg.inv_psd)
        from dartenv_tpu.math.linalg import _pmm
        MinvJt = _pmm(inv_psd(M, eps=1e-10), J.T)   # (n, m), full-f32
    else:
        L = chol(M, eps=1e-10)
        MinvJt = chol_solve(L, J.T)            # (n, m)
    A = J @ MinvJt
    A = A + cfg.cfm * jnp.eye(m, dtype=dtype)
    # mask inactive rows out of the operator so they can't pollute pivots
    A = A * active[:, None] * active[None, :] + jnp.diag(1.0 - active)
    return A, b, lo, hi, active, mu, findex, MinvJt, sel


def run_lcp_solver(cfg, findex, A, b, lo, hi, mu, active, lam0):
    """Dispatch the assembled boxed LCP to the configured solver.

    Single entry point shared by solve_constraints and the validation
    capture (engine/world.make_lcp_capture), so the residual study / the
    golden cross-checks measure exactly the production solve — including
    hybrid escalation when cfg.escalate_frac > 0 (docs/SOLVERS.md).
    """
    if cfg.solver == "dantzig":
        from dartenv_tpu.lcp.dantzig import make_exact_solver

        solver = make_exact_solver(findex)
        return solver(A, b, lo, hi, mu, active,
                      jnp.zeros_like(b) if lam0 is None else lam0)
    if cfg.escalate_frac > 0.0:
        from dartenv_tpu.lcp.hybrid import make_hybrid_solver

        solver = make_hybrid_solver(findex, iters=cfg.pgs_iters,
                                    omega=cfg.pgs_omega,
                                    escalate_frac=cfg.escalate_frac,
                                    escalate_tol=cfg.escalate_tol,
                                    escalate_iters=cfg.escalate_iters,
                                    escalate_kmax=cfg.escalate_kmax,
                                    escalate_iters2=cfg.escalate_iters2,
                                    escalate_refine=cfg.escalate_refine,
                                    escalate_ref64=cfg.escalate_ref64,
                                    escalate_ref=cfg.escalate_ref)
    else:
        solver = make_pgs_solver(findex, iters=cfg.pgs_iters,
                                 omega=cfg.pgs_omega)
    return solver(A, b, lo, hi, mu, active,
                  jnp.zeros_like(b) if lam0 is None else lam0)


def solve_constraints(model: SkelModel, layout: RowLayout, phi,
                      M, q, dq_before, dq_star, contacts: Contacts, dt,
                      lam_prev=None, servo_target=None):
    """Assemble + solve the per-env boxed LCP; returns (dq_plus, lam).

    phi: (n, 6) world-frame dof columns (BKin.phi).
    dq_before: velocities at collision time (for restitution),
    dq_star:   post-smooth-dynamics predicted velocities.
    lam_prev:  (layout.m,) impulses from the previous substep to warm-start
               the solver (both PGS and the block-pivot exact path), or
               None for a cold start (reference semantics for validation).
    """
    if layout.m == 0:
        return dq_star, jnp.zeros((0,), dtype=dq_star.dtype)
    cfg = model.solver

    A, b, lo, hi, active, mu, findex, MinvJt, sel = assemble_lcp(
        model, layout, phi, M, q, dq_before, dq_star, contacts, dt,
        servo_target=servo_target,
    )

    if lam_prev is not None:
        lam0 = sel @ lam_prev if sel is not None else lam_prev
        # warm-started impulses must respect the current active set
        lam0 = lam0 * active
    else:
        lam0 = None

    lam = run_lcp_solver(cfg, findex, A, b, lo, hi, mu, active, lam0)
    dq_plus = dq_star + MinvJt @ lam
    if sel is not None:
        lam = sel.T @ lam          # scatter back to the full row stack
    return dq_plus, lam
