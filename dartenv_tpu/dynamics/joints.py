"""Joint models: transforms, motion subspaces, position integration.

JAX counterpart of the reference's joint hierarchy
(`dart/dynamics/GenericJoint.hpp` / `*Joint.cpp` † — SURVEY.md §2.4 row
"Joint hierarchy").  Each joint type is a pure function
    (axes, q) -> (R, p, S)
with R, p the joint transform (pose of the child joint frame in the parent
joint frame) and S the (6, nd) motion subspace *in the joint frame*.
Velocity-product terms (S-dot) are obtained exactly by jax.jvp of S, so no
hand-derived dS/dt is needed (and constant-S joints get zeros for free).

For BALL and FREE joints the generalized velocities are the body twist
(DART convention †): S is constant and position integration composes on the
manifold via the exp map.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from dartenv_tpu.math import spatial as sp
from dartenv_tpu.model.skel_model import (
    BALL, EULER, FREE, PLANAR, PRISMATIC, REVOLUTE, SCREW, TRANSLATIONAL,
    UNIVERSAL, WELD,
)


def _rot(axis, angle):
    """Rotation matrix about a unit axis (Rodrigues)."""
    return sp.so3_exp(axis * angle[..., None])


def _weld(axes, q):
    eye = jnp.eye(3, dtype=axes.dtype)
    return eye, jnp.zeros(3, dtype=axes.dtype), jnp.zeros((6, 0), axes.dtype)


def _revolute(axes, q):
    a = axes[0]
    R = _rot(a, q[0])
    S = jnp.concatenate([a, jnp.zeros_like(a)])[:, None]
    return R, jnp.zeros(3, dtype=axes.dtype), S


def _prismatic(axes, q):
    a = axes[0]
    eye = jnp.eye(3, dtype=axes.dtype)
    S = jnp.concatenate([jnp.zeros_like(a), a])[:, None]
    return eye, a * q[0], S


def _screw(axes, q):
    """Screw joint (reference: `dart/dynamics/ScrewJoint.cpp` †): rotation
    about axes[0] with coupled translation axes[1]*q, where by convention
    axes[1] = thread_pitch/(2*pi) * axes[0] (set by the parser/builder).
    S = [a; pitch_vec] is constant in the joint frame."""
    a = axes[0]
    R = _rot(a, q[0])
    S = jnp.concatenate([a, axes[1]])[:, None]
    return R, axes[1] * q[0], S


def _universal(axes, q):
    a1, a2 = axes[0], axes[1]
    R1 = _rot(a1, q[0])
    R2 = _rot(a2, q[1])
    z3 = jnp.zeros(3, dtype=axes.dtype)
    s1 = jnp.concatenate([R2.T @ a1, z3])
    s2 = jnp.concatenate([a2, z3])
    return R1 @ R2, z3, jnp.stack([s1, s2], axis=-1)


def _euler(axes, q):
    e1, e2, e3 = axes[0], axes[1], axes[2]
    R1, R2, R3 = _rot(e1, q[0]), _rot(e2, q[1]), _rot(e3, q[2])
    z3 = jnp.zeros(3, dtype=axes.dtype)
    s1 = jnp.concatenate([R3.T @ (R2.T @ e1), z3])
    s2 = jnp.concatenate([R3.T @ e2, z3])
    s3 = jnp.concatenate([e3, z3])
    return R1 @ R2 @ R3, z3, jnp.stack([s1, s2, s3], axis=-1)


def _ball(axes, q):
    R = sp.so3_exp(q[:3])
    S = jnp.concatenate(
        [jnp.eye(3, dtype=axes.dtype), jnp.zeros((3, 3), axes.dtype)], axis=0
    )
    return R, jnp.zeros(3, dtype=axes.dtype), S


def _translational(axes, q):
    eye = jnp.eye(3, dtype=axes.dtype)
    S = jnp.concatenate([jnp.zeros((3, 3), axes.dtype), eye], axis=0)
    return eye, q[:3], S


def _planar(axes, q):
    e1, e2, er = axes[0], axes[1], axes[2]
    R = _rot(er, q[2])
    p = e1 * q[0] + e2 * q[1]
    z3 = jnp.zeros(3, dtype=axes.dtype)
    s1 = jnp.concatenate([z3, R.T @ e1])
    s2 = jnp.concatenate([z3, R.T @ e2])
    s3 = jnp.concatenate([er, z3])
    return R, p, jnp.stack([s1, s2, s3], axis=-1)


def _free(axes, q):
    R = sp.so3_exp(q[:3])
    return R, q[3:6], jnp.eye(6, dtype=axes.dtype)


JOINT_FNS: Dict[int, Callable] = {
    WELD: _weld,
    REVOLUTE: _revolute,
    PRISMATIC: _prismatic,
    UNIVERSAL: _universal,
    EULER: _euler,
    BALL: _ball,
    TRANSLATIONAL: _translational,
    PLANAR: _planar,
    FREE: _free,
    SCREW: _screw,
}

# joint types whose generalized velocity is a body twist, not q-dot
_MANIFOLD = (BALL, FREE)


def joint_kinematics(jtype: int, axes, qj, dqj) -> Tuple:
    """Returns (R, p, S, Sdot) for one joint.  S-dot via exact jvp; for
    manifold joints (ball/free) S is constant so Sdot = 0."""
    fn = JOINT_FNS[jtype]
    if jtype in _MANIFOLD or jtype in (WELD, REVOLUTE, PRISMATIC,
                                       TRANSLATIONAL, SCREW):
        R, p, S = fn(axes, qj)
        return R, p, S, jnp.zeros_like(S)
    (R, p, S), (_, _, Sdot) = jax.jvp(lambda qq: fn(axes, qq), (qj,), (dqj,))
    return R, p, S, Sdot


def integrate_joint_position(jtype: int, qj, dqj, dt):
    """Semi-implicit position update q <- q (+) dq*dt, on the manifold for
    ball/free joints (reference: Joint::integratePositions †, with
    FreeJoint/BallJoint SE(3)/SO(3) exp-map overrides ‡)."""
    if jtype == BALL:
        quat = sp.quat_mul(sp.so3_exp_quat(qj[:3]), sp.so3_exp_quat(dqj * dt))
        return sp.so3_log_quat(quat)
    if jtype == FREE:
        w, v = dqj[:3], dqj[3:]
        R_old = sp.so3_exp(qj[:3])
        quat = sp.quat_mul(sp.so3_exp_quat(qj[:3]), sp.so3_exp_quat(w * dt))
        p = qj[3:] + (R_old @ v) * dt
        return jnp.concatenate([sp.so3_log_quat(quat), p])
    return qj + dqj * dt
