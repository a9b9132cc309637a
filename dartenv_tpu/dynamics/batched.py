"""Production dynamics core: body-batched, compile-size O(1) in topology.

This is the batch-first formulation of the smooth dynamics (the readable
per-body reference implementation lives in `algorithms.py` and the two are
cross-checked in tests).  Design rules, learned the hard way (the per-body
unrolled graphs sent XLA's fusion pass into the weeds):

* joints are processed in static *type groups*, each group vectorized over
  its joints (one rodrigues/exp per group, not per joint);
* the only sequential structure, the kinematic tree recursion, is ONE
  `lax.scan` over topologically-ordered bodies with dynamic parent gather
  — compile size is independent of body count;
* per-joint ragged dof access is eliminated with `segment_sum` over the
  static dof->body map (vJ, cJ per body);
* the mass matrix and bias forces are assembled as dense einsums over
  world-frame body Jacobians:  M = sum_b J_b I_b^w J_b^T,
  C = sum_b J_b f_b^w — a handful of large batched contractions
  instead of hundreds of 3x3/6x6 chains.

Reference parity: same quantities as `Skeleton::computeForwardDynamics` /
`updateMassMatrix` † (SURVEY.md §2.4) — M, C, ddq with DART's implicit
joint spring/damping scheme ‡.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.math import spatial as sp
from dartenv_tpu.math.linalg import chol, chol_solve, solve_psd
from dartenv_tpu.model.skel_model import (
    BALL, EULER, FREE, PLANAR, PRISMATIC, REVOLUTE, SCREW, SkelModel,
    TRANSLATIONAL, UNIVERSAL, WELD,
)


def _mm(a, b):
    """Batched matmul as mul+reduce (fusion-friendly tiny matrices)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _mv(a, v):
    return jnp.sum(a * v[..., None, :], axis=-1)


# ---------------------------------------------------------------------------
# static model indexing (host side, hashable per model)
# ---------------------------------------------------------------------------

class BatchedIndex:
    """Precomputed static index sets for one topology."""

    def __init__(self, model: SkelModel):
        self.nb = model.nb
        self.n = model.n
        jt = np.asarray(model.joint_type)
        self.groups: Dict[int, np.ndarray] = {}
        for t in sorted(set(model.joint_type)):
            self.groups[int(t)] = np.nonzero(jt == t)[0]
        self.parent = np.asarray(model.parent, dtype=np.int32)
        self.dof_body = np.asarray(model.dof_body_index(), dtype=np.int32)
        # per-joint first dof (for grouped q gathers)
        self.q_start = np.asarray(model.q_start, dtype=np.int32)
        self.ndof = np.asarray(model.ndof, dtype=np.int32)


# keyed by the full topology tuple (NOT its hash: two models whose key
# tuples hash-collide must not share a BatchedIndex — wrong physics)
_INDEX_CACHE: Dict[tuple, BatchedIndex] = {}


def get_index(model: SkelModel) -> BatchedIndex:
    key = (model.nb, model.parent, model.joint_type, model.q_start)
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = BatchedIndex(model)
    return _INDEX_CACHE[key]


# ---------------------------------------------------------------------------
# grouped joint kinematics: (R_rel, p_rel) per body, S rows per dof
# ---------------------------------------------------------------------------

def _rod(axes, angles):
    """Batched rodrigues: axes (g, 3), angles (g,) -> (g, 3, 3)."""
    return sp.so3_exp(axes * angles[..., None])


def joint_S(model: SkelModel, q):
    """S rows (n, 6) in the JOINT frame, as a pure function of q (for jvp).

    Rows for each dof in dof order.  Types whose S depends on q
    (euler / universal / planar) get exact derivatives via jvp upstream.
    """
    idx = get_index(model)
    n = model.n
    dtype = q.dtype
    S = jnp.zeros((n, 6), dtype=dtype)

    for t, joints in idx.groups.items():
        if len(joints) == 0 or t == WELD:
            continue
        ax = model.axes[joints]               # (g, 3, 3)
        qs = idx.q_start[joints]
        if t == REVOLUTE:
            rows = jnp.concatenate(
                [ax[:, 0], jnp.zeros_like(ax[:, 0])], axis=-1
            )
            S = S.at[qs].set(rows)
        elif t == PRISMATIC:
            rows = jnp.concatenate(
                [jnp.zeros_like(ax[:, 0]), ax[:, 0]], axis=-1
            )
            S = S.at[qs].set(rows)
        elif t == SCREW:
            # axes[1] = pitch/(2*pi) * axis (skel_model.SCREW convention)
            rows = jnp.concatenate([ax[:, 0], ax[:, 1]], axis=-1)
            S = S.at[qs].set(rows)
        elif t == UNIVERSAL:
            q1 = q[qs + 1]
            R2 = _rod(ax[:, 1], q1)
            z = jnp.zeros_like(ax[:, 0])
            s1 = jnp.concatenate([_mv(jnp.swapaxes(R2, -1, -2), ax[:, 0]),
                                  z], axis=-1)
            s2 = jnp.concatenate([ax[:, 1], z], axis=-1)
            S = S.at[qs].set(s1).at[qs + 1].set(s2)
        elif t == EULER:
            q1, q2 = q[qs + 1], q[qs + 2]
            R2 = _rod(ax[:, 1], q1)
            R3 = _rod(ax[:, 2], q2)
            R2t = jnp.swapaxes(R2, -1, -2)
            R3t = jnp.swapaxes(R3, -1, -2)
            z = jnp.zeros_like(ax[:, 0])
            s1 = jnp.concatenate([_mv(R3t, _mv(R2t, ax[:, 0])), z], axis=-1)
            s2 = jnp.concatenate([_mv(R3t, ax[:, 1]), z], axis=-1)
            s3 = jnp.concatenate([ax[:, 2], z], axis=-1)
            S = S.at[qs].set(s1).at[qs + 1].set(s2).at[qs + 2].set(s3)
        elif t == PLANAR:
            th = q[qs + 2]
            R = _rod(ax[:, 2], th)
            Rt = jnp.swapaxes(R, -1, -2)
            z = jnp.zeros_like(ax[:, 0])
            s1 = jnp.concatenate([z, _mv(Rt, ax[:, 0])], axis=-1)
            s2 = jnp.concatenate([z, _mv(Rt, ax[:, 1])], axis=-1)
            s3 = jnp.concatenate([ax[:, 2], z], axis=-1)
            S = S.at[qs].set(s1).at[qs + 1].set(s2).at[qs + 2].set(s3)
        elif t == BALL:
            eye = jnp.broadcast_to(
                jnp.concatenate([jnp.eye(3, dtype=dtype),
                                 jnp.zeros((3, 3), dtype)], axis=1),
                (len(joints), 3, 6),
            )
            for k in range(3):
                S = S.at[qs + k].set(eye[:, k])
        elif t == TRANSLATIONAL:
            eye = jnp.broadcast_to(
                jnp.concatenate([jnp.zeros((3, 3), dtype),
                                 jnp.eye(3, dtype=dtype)], axis=1),
                (len(joints), 3, 6),
            )
            for k in range(3):
                S = S.at[qs + k].set(eye[:, k])
        elif t == FREE:
            eye6 = jnp.broadcast_to(jnp.eye(6, dtype=dtype),
                                    (len(joints), 6, 6))
            for k in range(6):
                S = S.at[qs + k].set(eye6[:, k])
        else:
            raise NotImplementedError(t)
    return S


def joint_transforms(model: SkelModel, q):
    """(R_rel, p_rel) per body: child pose in parent body frame, grouped."""
    idx = get_index(model)
    nb, dtype = model.nb, q.dtype
    Rj = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (nb, 3, 3))
    pj = jnp.zeros((nb, 3), dtype=dtype)

    for t, joints in idx.groups.items():
        if len(joints) == 0 or t == WELD:
            continue
        ax = model.axes[joints]
        qs = idx.q_start[joints]
        if t == REVOLUTE:
            Rj = Rj.at[joints].set(_rod(ax[:, 0], q[qs]))
        elif t == PRISMATIC:
            pj = pj.at[joints].set(ax[:, 0] * q[qs][:, None])
        elif t == SCREW:
            Rj = Rj.at[joints].set(_rod(ax[:, 0], q[qs]))
            pj = pj.at[joints].set(ax[:, 1] * q[qs][:, None])
        elif t == UNIVERSAL:
            Rj = Rj.at[joints].set(
                _mm(_rod(ax[:, 0], q[qs]), _rod(ax[:, 1], q[qs + 1]))
            )
        elif t == EULER:
            Rj = Rj.at[joints].set(_mm(
                _rod(ax[:, 0], q[qs]),
                _mm(_rod(ax[:, 1], q[qs + 1]), _rod(ax[:, 2], q[qs + 2])),
            ))
        elif t == PLANAR:
            Rj = Rj.at[joints].set(_rod(ax[:, 2], q[qs + 2]))
            pj = pj.at[joints].set(
                ax[:, 0] * q[qs][:, None] + ax[:, 1] * q[qs + 1][:, None]
            )
        elif t == BALL:
            w = jnp.stack([q[qs], q[qs + 1], q[qs + 2]], axis=-1)
            Rj = Rj.at[joints].set(sp.so3_exp(w))
        elif t == TRANSLATIONAL:
            p = jnp.stack([q[qs], q[qs + 1], q[qs + 2]], axis=-1)
            pj = pj.at[joints].set(p)
        elif t == FREE:
            w = jnp.stack([q[qs], q[qs + 1], q[qs + 2]], axis=-1)
            p = jnp.stack([q[qs + 3], q[qs + 4], q[qs + 5]], axis=-1)
            Rj = Rj.at[joints].set(sp.so3_exp(w))
            pj = pj.at[joints].set(p)
        else:
            raise NotImplementedError(t)

    # T_rel = T_pj o T_joint o inv(T_cj), all (nb, ...) batched
    R1 = _mm(model.pj_rot, Rj)
    p1 = model.pj_pos + _mv(model.pj_rot, pj)
    cj_R_inv = jnp.swapaxes(model.cj_rot, -1, -2)
    cj_p_inv = -_mv(cj_R_inv, model.cj_pos)
    R_rel = _mm(R1, cj_R_inv)
    p_rel = p1 + _mv(R1, cj_p_inv)
    return R_rel, p_rel


def dof_S_child(model: SkelModel, q, dq):
    """S and S-dot rows (n, 6) in the CHILD body frame; exact S-dot by jvp
    (tangent = dq; manifold joints have constant S so the q-dot/twist
    mismatch is irrelevant)."""
    idx = get_index(model)
    S_j, Sdot_j = jax.jvp(lambda qq: joint_S(model, qq), (q,), (dq,))
    # Ad_{T_cj} per dof: gather the owning joint's cj transform
    cjR = model.cj_rot[idx.dof_body]     # (n, 3, 3)
    cjp = model.cj_pos[idx.dof_body]     # (n, 3)

    def ad(cols):
        w, v = cols[..., :3], cols[..., 3:]
        wb = _mv(cjR, w)
        vb = _mv(cjR, v) + jnp.cross(cjp, wb)
        return jnp.concatenate([wb, vb], axis=-1)

    return ad(S_j), ad(Sdot_j)


# ---------------------------------------------------------------------------
# forward kinematics + velocity/bias recursion (ONE scan over bodies)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BKin:
    R_w: Any     # (nb, 3, 3)
    p_w: Any     # (nb, 3)
    E: Any       # (nb, 3, 3) = R_rel^T
    r: Any       # (nb, 3)   = p_rel
    S: Any       # (n, 6) child-frame dof columns
    Sdot: Any    # (n, 6)
    v: Any       # (nb, 6) body spatial velocity (body frame)
    a_bias: Any  # (nb, 6) bias acceleration incl. gravity (body frame)
    phi: Any     # (n, 6) world-frame dof columns at world origin


def bkin(model: SkelModel, q, dq) -> BKin:
    idx = get_index(model)
    nb, n, dtype = model.nb, model.n, q.dtype

    R_rel, p_rel = joint_transforms(model, q)
    S, Sdot = dof_S_child(model, q, dq)

    dof_body = jnp.asarray(idx.dof_body)
    vJ = jax.ops.segment_sum(S * dq[:, None], dof_body, nb)     # (nb, 6)
    cJ = jax.ops.segment_sum(Sdot * dq[:, None], dof_body, nb)  # (nb, 6)

    E = jnp.swapaxes(R_rel, -1, -2)
    parent = jnp.asarray(idx.parent)
    g = model.gravity
    a_base = jnp.concatenate([jnp.zeros(3, dtype=dtype), -g])

    def body_fn(carry, i):
        R_w, p_w, v, a = carry
        par = parent[i]
        has_par = (par >= 0)
        pi = jnp.maximum(par, 0)
        Rp = jnp.where(has_par, R_w[pi], jnp.eye(3, dtype=dtype))
        pp = jnp.where(has_par, p_w[pi], jnp.zeros(3, dtype=dtype))
        v_par = jnp.where(has_par, v[pi], jnp.zeros(6, dtype=dtype))
        a_par = jnp.where(has_par, a[pi], a_base)

        Ri = _mm(Rp, R_rel[i])
        pw_i = pp + _mv(Rp, p_rel[i])
        v_i = sp.xmotion_apply(E[i], p_rel[i], v_par) + vJ[i]
        a_i = (sp.xmotion_apply(E[i], p_rel[i], a_par)
               + sp.crm(v_i, vJ[i]) + cJ[i])
        R_w = R_w.at[i].set(Ri)
        p_w = p_w.at[i].set(pw_i)
        v = v.at[i].set(v_i)
        a = a.at[i].set(a_i)
        return (R_w, p_w, v, a), None

    init = (
        jnp.zeros((nb, 3, 3), dtype=dtype),
        jnp.zeros((nb, 3), dtype=dtype),
        jnp.zeros((nb, 6), dtype=dtype),
        jnp.zeros((nb, 6), dtype=dtype),
    )
    (R_w, p_w, v, a_bias), _ = jax.lax.scan(
        body_fn, init, jnp.arange(nb)
    )

    # world-frame dof columns at world origin
    Rb = R_w[dof_body]
    pb = p_w[dof_body]
    w_cols = _mv(Rb, S[:, :3])
    v_cols = _mv(Rb, S[:, 3:]) + jnp.cross(pb, w_cols)
    phi = jnp.concatenate([w_cols, v_cols], axis=-1)

    return BKin(R_w=R_w, p_w=p_w, E=E, r=p_rel, S=S, Sdot=Sdot,
                v=v, a_bias=a_bias, phi=phi)


# ---------------------------------------------------------------------------
# mass matrix, bias forces, forward dynamics — dense einsums
# ---------------------------------------------------------------------------

def _body_inertias(model: SkelModel):
    return sp.spatial_inertia(model.mass, model.com, model.inertia)


def world_jacobians(model: SkelModel, kin: BKin):
    """(nb, n, 6) masked world-frame body Jacobians."""
    return kin.phi[None, :, :] * model.ancestor_mask[:, :, None]


def mass_matrix(model: SkelModel, kin: BKin):
    """M = sum_b J_b I_b^w J_b^T (world-frame assembly).

    Assembled at highest matmul precision: default-f32 matmuls may run
    in a reduced-precision matrix unit (TF32 on the GPU) and the resulting M can lose positive-definiteness (NaN
    Cholesky downstream).
    """
    I_b = _body_inertias(model)                     # (nb, 6, 6) body frame
    # push to world origin: I_w = X^T I X with X = motion world->body,
    # X built from E = R_w^T, r = p_w
    X = sp.xmotion_mat(jnp.swapaxes(kin.R_w, -1, -2), kin.p_w)
    # mul+reduce contractions: full-f32 math (a default-precision
    # einsum may run in TF32 on the GPU and the resulting M can lose
    # positive-definiteness -> NaN Cholesky downstream)
    IX = jnp.sum(I_b[..., :, :, None] * X[..., None, :, :], axis=-2)
    I_w = jnp.sum(X[..., :, :, None] * IX[..., :, None, :], axis=-3)
    J = world_jacobians(model, kin)                 # (nb, n, 6)
    JI = jnp.sum(J[..., :, :, None] * I_w[..., None, :, :], axis=-2)
    M = jnp.sum(JI[..., :, None, :] * J[..., None, :, :], axis=(-4, -1))
    return 0.5 * (M + M.T)


def bias_forces(model: SkelModel, kin: BKin, f_ext_world=None):
    """C(q, dq): gravity + Coriolis/centrifugal - external, via
    C = sum_b J_b f_b^w with body-frame Newton-Euler f_b.

    f_ext_world: (nb, 6) [torque; force] in world coords applied at each
    body origin (reference add_ext_force † semantics)."""
    I_b = _body_inertias(model)
    f_body = (sp.inertia_mul(I_b, kin.a_bias)
              + sp.crf(kin.v, sp.inertia_mul(I_b, kin.v)))
    # body frame -> world (force transform inverse): E=R_w^T, r=p_w
    f_w = sp.xforce_inv_apply(jnp.swapaxes(kin.R_w, -1, -2), kin.p_w,
                              f_body)
    if f_ext_world is not None:
        n_ext, f_ext = f_ext_world[..., :3], f_ext_world[..., 3:]
        # shift to world origin for the J^T contraction
        n0 = n_ext + jnp.cross(kin.p_w, f_ext)
        f_w = f_w - jnp.concatenate([n0, f_ext], axis=-1)
    J = world_jacobians(model, kin)
    return jnp.einsum("bni,bi->n", J, f_w)


def integrate_positions(model: SkelModel, q, dq, dt):
    """Batched semi-implicit position update; exp-map for ball/free groups
    (reference: Joint::integratePositions † with SO(3)/SE(3) overrides ‡)."""
    idx = get_index(model)
    q_new = q + dq * dt
    for t in (BALL, FREE):
        joints = idx.groups.get(t, np.zeros(0, np.int64))
        if len(joints) == 0:
            continue
        qs = idx.q_start[joints]
        w = jnp.stack([q[qs], q[qs + 1], q[qs + 2]], axis=-1)
        dw = jnp.stack([dq[qs], dq[qs + 1], dq[qs + 2]], axis=-1)
        quat = sp.quat_mul(sp.so3_exp_quat(w), sp.so3_exp_quat(dw * dt))
        w_new = sp.so3_log_quat(quat)
        for k in range(3):
            q_new = q_new.at[qs + k].set(w_new[:, k])
        if t == FREE:
            p = jnp.stack([q[qs + 3], q[qs + 4], q[qs + 5]], axis=-1)
            v = jnp.stack([dq[qs + 3], dq[qs + 4], dq[qs + 5]], axis=-1)
            R_old = sp.so3_exp(w)
            p_new = p + _mv(R_old, v) * dt
            for k in range(3):
                q_new = q_new.at[qs + 3 + k].set(p_new[:, k])
    return q_new


def forward_dynamics(model: SkelModel, kin: BKin, q, dq, tau, dt,
                     f_ext_world=None):
    """(ddq, M): implicit spring/damper scheme identical to the reference
    formulation in algorithms.forward_dynamics_crb."""
    M = mass_matrix(model, kin)
    C = bias_forces(model, kin, f_ext_world)
    d, k = model.damping, model.spring_stiff
    tau_total = tau - d * dq - k * (q - model.rest_pos + dt * dq) - C
    Mi = M + jnp.diag(dt * d + dt * dt * k)
    ddq = solve_psd(Mi, tau_total, eps=1e-10)
    return ddq, M
