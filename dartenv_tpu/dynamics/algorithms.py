"""Articulated-body dynamics algorithms: FK, ABA, CRBA, RNEA.

JAX replacement of the reference's recursive Lie-group dynamics
(`dart/dynamics/Skeleton.cpp` †: computeForwardDynamics / updateMassMatrix /
computeInverseDynamics; `BodyNode.cpp` †: updateArtInertia / updateBiasForce
— SURVEY.md §2.4, §3.2).  All functions here are single-environment and pure;
batching comes from `jax.vmap` outside, which turns every tiny per-body op
into one elementwise op over the env axis (the idiomatic batched layout — the
env batch is the vector axis; the body recursion unrolls at trace time since
topology is static Python data).

Implicit joint spring/damping is folded into the solve with the timestep,
matching the reference's implicit scheme ‡ (GenericJoint
ProjArtInertiaImplicit): D += dt*d + dt^2*k and the spring force uses
-k (q - q0 + dt*dq).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from dartenv_tpu.math import spatial as sp
from dartenv_tpu.math.linalg import solve_psd
from dartenv_tpu.dynamics.joints import joint_kinematics
from dartenv_tpu.model.skel_model import SkelModel


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Kin:
    """Forward-kinematics cache for one configuration (single env)."""

    R_w: Any    # (nb, 3, 3) body orientation in world
    p_w: Any    # (nb, 3) body origin in world
    E: Any      # (nb, 3, 3) parent->child motion-transform rotation (R_rel^T)
    r: Any      # (nb, 3)   child origin in parent frame
    S: Any      # (n, 6)    per-dof motion subspace columns, child body frame
    Sdot: Any   # (n, 6)    d/dt of S (velocity-product term)
    v: Any      # (nb, 6)   body spatial velocity, body frame


def _joint_slices(model: SkelModel):
    return [
        (i, model.q_start[i], model.q_start[i] + model.ndof[i])
        for i in range(model.nb)
    ]


def fk(model: SkelModel, q, dq) -> Kin:
    """Forward kinematics + velocities (reference call-stack analogue:
    Skeleton position/velocity update inside World::step †)."""
    R_w, p_w, E, r, v = [], [], [], [], []
    S_rows = []
    Sd_rows = []
    for i, a, b in _joint_slices(model):
        qj, dqj = q[a:b], dq[a:b]
        Rj, pj, Sj, Sdj = joint_kinematics(
            model.joint_type[i], model.axes[i], qj, dqj
        )
        # T_rel = T_pj o T_joint o inv(T_cj)
        R1, p1 = sp.t_compose(model.pj_rot[i], model.pj_pos[i], Rj, pj)
        cj_inv_R, cj_inv_p = sp.t_inv(model.cj_rot[i], model.cj_pos[i])
        R_rel, p_rel = sp.t_compose(R1, p1, cj_inv_R, cj_inv_p)
        # motion subspace into child body frame: S_body = Ad_{T_cj} S_joint
        cjR, cjp = model.cj_rot[i], model.cj_pos[i]

        def _ad(cols):
            w, vl = cols[:3, :], cols[3:, :]
            wb = cjR @ w
            vb = cjR @ vl + jnp.cross(cjp[:, None], wb, axis=0)
            return jnp.concatenate([wb, vb], axis=0)

        Sb, Sdb = _ad(Sj), _ad(Sdj)
        Ei = R_rel.T
        ri = p_rel
        par = model.parent[i]
        if par < 0:
            Rwi, pwi = R_rel, p_rel
            v_par = jnp.zeros(6, dtype=q.dtype)
        else:
            Rwi = R_w[par] @ R_rel
            pwi = p_w[par] + R_w[par] @ p_rel
            v_par = v[par]
        vi = sp.xmotion_apply(Ei, ri, v_par) + Sb @ dqj
        R_w.append(Rwi)
        p_w.append(pwi)
        E.append(Ei)
        r.append(ri)
        v.append(vi)
        S_rows.append(Sb.T)
        Sd_rows.append(Sdb.T)
    return Kin(
        R_w=jnp.stack(R_w),
        p_w=jnp.stack(p_w),
        E=jnp.stack(E),
        r=jnp.stack(r),
        S=jnp.concatenate(S_rows, axis=0) if S_rows else jnp.zeros((0, 6)),
        Sdot=jnp.concatenate(Sd_rows, axis=0) if Sd_rows else jnp.zeros((0, 6)),
        v=jnp.stack(v),
    )


def fk_positions(model: SkelModel, q):
    """Pose-only forward kinematics: (R_w (nb,3,3), p_w (nb,3)).

    Cheaper than `fk` when only world poses are needed (obs/reward
    functions); XLA CSE merges it with the step's own FK where possible.
    """
    zeros = jnp.zeros_like(q)
    R_w, p_w = [], []
    for i, a, b in _joint_slices(model):
        qj = q[a:b]
        Rj, pj, _S, _Sd = joint_kinematics(
            model.joint_type[i], model.axes[i], qj, zeros[a:b]
        )
        R1, p1 = sp.t_compose(model.pj_rot[i], model.pj_pos[i], Rj, pj)
        cj_inv_R, cj_inv_p = sp.t_inv(model.cj_rot[i], model.cj_pos[i])
        R_rel, p_rel = sp.t_compose(R1, p1, cj_inv_R, cj_inv_p)
        par = model.parent[i]
        if par < 0:
            R_w.append(R_rel)
            p_w.append(p_rel)
        else:
            R_w.append(R_w[par] @ R_rel)
            p_w.append(p_w[par] + R_w[par] @ p_rel)
    return jnp.stack(R_w), jnp.stack(p_w)


def body_point_world(model: SkelModel, q, body: int, offset):
    """World position of a body-frame point (e.g. a fingertip)."""
    R_w, p_w = fk_positions(model, q)
    return p_w[body] + R_w[body] @ jnp.asarray(offset, dtype=q.dtype)


def _body_inertias(model: SkelModel):
    return sp.spatial_inertia(model.mass, model.com, model.inertia)


def _fext_body(model: SkelModel, kin: Kin, f_ext_world):
    """External [torque; force] in world coords APPLIED AT EACH BODY ORIGIN
    (reference add_ext_force † semantics) -> body-frame spatial force."""
    if f_ext_world is None:
        return None
    n, fl = f_ext_world[..., :3], f_ext_world[..., 3:]
    Rt = jnp.swapaxes(kin.R_w, -1, -2)
    fb = jnp.einsum("bij,bj->bi", Rt, fl)
    nb = jnp.einsum("bij,bj->bi", Rt, n)
    return jnp.concatenate([nb, fb], axis=-1)


def _bias_c(model: SkelModel, kin: Kin, dq):
    """Velocity-product acceleration c_i = crm(v_i) S dq + Sdot dq per body."""
    cs = []
    for i, a, b in _joint_slices(model):
        Sb = kin.S[a:b].T
        Sdb = kin.Sdot[a:b].T
        vJ = Sb @ dq[a:b]
        cs.append(sp.crm(kin.v[i], vJ) + Sdb @ dq[a:b])
    return cs


def aba(model: SkelModel, kin: Kin, q, dq, tau, dt,
        f_ext_world=None):
    """Articulated Body Algorithm (O(n)) with implicit spring/damping.

    Mirrors the reference pass structure (BodyNode::updateArtInertia /
    updateBiasForce tip->root, updateAccelerationFD root->tip †).
    Returns ddq (n,).
    """
    nb = model.nb
    dtype = q.dtype
    I = _body_inertias(model)
    fext_b = _fext_body(model, kin, f_ext_world)
    c = _bias_c(model, kin, dq)

    IA = [I[i] for i in range(nb)]
    pA = []
    for i in range(nb):
        p_i = sp.crf(kin.v[i], sp.inertia_mul(I[i], kin.v[i]))
        if fext_b is not None:
            p_i = p_i - fext_b[i]
        pA.append(p_i)

    # implicit spring/damper generalized forces
    d = model.damping
    k = model.spring_stiff
    tau_total = (
        tau
        - d * dq
        - k * (q - model.rest_pos + dt * dq)
    )

    U, Dinv_list, u_list = [None] * nb, [None] * nb, [None] * nb
    slices = _joint_slices(model)
    for i, a, b in reversed(slices):
        Sb = kin.S[a:b].T                      # (6, nd)
        nd = b - a
        Ui = IA[i] @ Sb                        # (6, nd)
        Di = Sb.T @ Ui
        if nd > 0:
            Di = Di + jnp.diag(dt * d[a:b] + dt * dt * k[a:b])
            Dinv = jnp.linalg.inv(
                Di + 1e-12 * jnp.eye(nd, dtype=dtype)
            ) if nd > 1 else 1.0 / Di
            ui = tau_total[a:b] - Sb.T @ pA[i]
        else:
            Dinv = jnp.zeros((0, 0), dtype=dtype)
            ui = jnp.zeros((0,), dtype=dtype)
        U[i], Dinv_list[i], u_list[i] = Ui, Dinv, ui
        par = model.parent[i]
        if par >= 0:
            if nd > 0:
                Ia = IA[i] - Ui @ (Dinv @ Ui.T)
                pa = pA[i] + Ia @ c[i] + Ui @ (Dinv @ ui)
            else:
                Ia = IA[i]
                pa = pA[i] + Ia @ c[i]
            X = sp.xmotion_mat(kin.E[i], kin.r[i])
            IA[par] = IA[par] + X.T @ Ia @ X
            pA[par] = pA[par] + X.T @ pa

    g = model.gravity
    a_base = jnp.concatenate([jnp.zeros(3, dtype=dtype), -g])
    acc = [None] * nb
    ddq = jnp.zeros_like(q)
    for i, a, b in slices:
        par = model.parent[i]
        a_par = a_base if par < 0 else acc[par]
        a_prime = sp.xmotion_apply(kin.E[i], kin.r[i], a_par) + c[i]
        nd = b - a
        if nd > 0:
            qdd = Dinv_list[i] @ (u_list[i] - U[i].T @ a_prime)
            ddq = ddq.at[a:b].set(qdd)
            acc[i] = a_prime + kin.S[a:b].T @ qdd
        else:
            acc[i] = a_prime
    return ddq


def crba(model: SkelModel, kin: Kin):
    """Composite Rigid Body Algorithm: joint-space mass matrix M (n, n)
    (reference: Skeleton::updateMassMatrix †)."""
    n = model.n
    nb = model.nb
    I = _body_inertias(model)
    Ic = [I[i] for i in range(nb)]
    X = [sp.xmotion_mat(kin.E[i], kin.r[i]) for i in range(nb)]
    for i in reversed(range(nb)):
        par = model.parent[i]
        if par >= 0:
            Ic[par] = Ic[par] + X[i].T @ Ic[i] @ X[i]
    M = jnp.zeros((n, n), dtype=kin.S.dtype)
    slices = _joint_slices(model)
    for i, a, b in slices:
        if b == a:
            continue
        Sb = kin.S[a:b].T
        F = Ic[i] @ Sb                       # (6, nd)
        M = M.at[a:b, a:b].set(Sb.T @ F)
        j = i
        while model.parent[j] >= 0:
            F = X[j].T @ F
            j = model.parent[j]
            ja, jb = model.q_start[j], model.q_start[j] + model.ndof[j]
            if jb > ja:
                Sj = kin.S[ja:jb].T
                blk = F.T @ Sj               # (nd_i, nd_j)
                M = M.at[a:b, ja:jb].set(blk)
                M = M.at[ja:jb, a:b].set(blk.T)
    return M


def rnea_bias(model: SkelModel, kin: Kin, dq, f_ext_world=None):
    """Generalized bias forces C(q, dq) (Coriolis + gravity - external),
    i.e. inverse dynamics with ddq = 0 (reference:
    Skeleton::computeInverseDynamics / updateBiasForce †).
    Satisfies: M @ ddq + C = tau  for unconstrained motion (no
    spring/damping terms — those are handled by the caller)."""
    nb = model.nb
    dtype = dq.dtype
    I = _body_inertias(model)
    fext_b = _fext_body(model, kin, f_ext_world)
    c = _bias_c(model, kin, dq)
    g = model.gravity
    a_base = jnp.concatenate([jnp.zeros(3, dtype=dtype), -g])

    acc = [None] * nb
    f = [None] * nb
    slices = _joint_slices(model)
    for i, a, b in slices:
        par = model.parent[i]
        a_par = a_base if par < 0 else acc[par]
        acc[i] = sp.xmotion_apply(kin.E[i], kin.r[i], a_par) + c[i]
        f_i = sp.inertia_mul(I[i], acc[i]) + sp.crf(
            kin.v[i], sp.inertia_mul(I[i], kin.v[i])
        )
        if fext_b is not None:
            f_i = f_i - fext_b[i]
        f[i] = f_i

    C = jnp.zeros(model.n, dtype=dtype)
    for i, a, b in reversed(slices):
        if b > a:
            Sb = kin.S[a:b].T
            C = C.at[a:b].set(Sb.T @ f[i])
        par = model.parent[i]
        if par >= 0:
            f[par] = f[par] + sp.xforce_inv_apply(kin.E[i], kin.r[i], f[i])


    return C


def forward_dynamics_crb(model: SkelModel, kin: Kin, q, dq, tau, dt,
                         f_ext_world=None):
    """Forward dynamics via (M + dt*D + dt^2*K) ddq = tau_total - C.

    Same implicit spring/damper scheme as `aba`; returns (ddq, M) so the
    constraint solver can reuse M.  This is the production path: M is needed
    for the contact Delassus operator anyway, and dense (n<=32) ops batch
    perfectly under vmap.
    """
    M = crba(model, kin)
    C = rnea_bias(model, kin, dq, f_ext_world)
    d, k = model.damping, model.spring_stiff
    tau_total = tau - d * dq - k * (q - model.rest_pos + dt * dq) - C
    Mi = M + jnp.diag(dt * d + dt * dt * k)
    ddq = solve_psd(Mi, tau_total, eps=1e-10)
    return ddq, M
