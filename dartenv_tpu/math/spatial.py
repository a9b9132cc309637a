"""Spatial (screw) algebra for batched articulated dynamics.

Batch-first replacement for the reference's Eigen-based spatial math
(`dart/math/Geometry.cpp` †: `expMap`, `AdT`, `dAdT` — see SURVEY.md §2.4).
Everything here is pure jax.numpy on small fixed shapes, written to be
`vmap`-ped over an environment batch axis: per-env ops are tiny (3-vectors,
quaternions, 6-vectors, 6x6 blocks) and the batch axis supplies the
data parallelism.

Conventions (Featherstone / RBDA, matching DART's Lie-group form):
  * spatial motion vector v = [omega; v_lin]  (angular on top)
  * spatial force  vector f = [n; f_lin]      (moment on top)
  * a Pluecker transform from frame A to frame B is stored structurally as
    (E, r): E = 3x3 rotation taking A-coordinates to B-coordinates,
    r = origin of B expressed in A coordinates.  Dense form:
        X  (motion) = [[E, 0], [-E r^, E]]
        X* (force)  = [[E, -E r^], [0, E]]
  * quaternions are wxyz, scalar first.

All functions broadcast over leading batch axes.
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-9


# ---------------------------------------------------------------------------
# 3-vector helpers
# ---------------------------------------------------------------------------

def skew(v):
    """Skew-symmetric matrix v^ such that v^ w = v x w.  v: (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def cross(a, b):
    return jnp.cross(a, b)


# ---------------------------------------------------------------------------
# Quaternions (wxyz)
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q, v):
    """Rotate vector v by quaternion q (active rotation)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r00 = 1.0 - 2.0 * (yy + zz)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (xx + zz)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (xx + yy)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def quat_from_axis_angle(axis, angle):
    half = 0.5 * angle
    s = jnp.sin(half)
    return jnp.concatenate(
        [jnp.cos(half)[..., None], axis * s[..., None]], axis=-1
    )


# ---------------------------------------------------------------------------
# SO(3) exponential / logarithm (rotation-vector <-> rotation)
# ---------------------------------------------------------------------------

def so3_exp_quat(w):
    """exp: so(3) rotation vector -> unit quaternion, Taylor-safe at 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    # sin(t/2)/t with Taylor fallback 1/2 - t^2/48
    s_over = jnp.where(
        small, 0.5 - theta2 / 48.0, jnp.sin(0.5 * theta) / theta
    )
    c = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(0.5 * theta))
    return jnp.concatenate([c[..., None], w * s_over[..., None]], axis=-1)


def so3_exp(w):
    """exp: rotation vector -> 3x3 rotation matrix (Rodrigues, Taylor-safe)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = skew(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log_quat(q):
    """log: unit quaternion -> rotation vector, Taylor-safe near identity."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # take the short geodesic
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = jnp.sum(v * v, axis=-1)
    vn = jnp.sqrt(vn2 + _EPS * _EPS)
    angle = 2.0 * jnp.arctan2(vn, w)
    small = vn2 < 1e-12
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 0.5), angle / vn)
    return v * scale[..., None]


def so3_log(R):
    """log: 3x3 rotation matrix -> rotation vector."""
    return so3_log_quat(mat_to_quat(R))


def mat_to_quat(R):
    """Rotation matrix -> quaternion (Shepperd-style, branchless)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate constructions, pick the numerically best
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) * 0.5
    k0 = 0.25 / jnp.maximum(qw0, _EPS)
    c0 = jnp.stack([qw0, (m21 - m12) * k0, (m02 - m20) * k0,
                    (m10 - m01) * k0], axis=-1)

    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    k1 = 0.25 / jnp.maximum(qx1, _EPS)
    c1 = jnp.stack([(m21 - m12) * k1, qx1, (m01 + m10) * k1,
                    (m02 + m20) * k1], axis=-1)

    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    k2 = 0.25 / jnp.maximum(qy2, _EPS)
    c2 = jnp.stack([(m02 - m20) * k2, (m01 + m10) * k2, qy2,
                    (m12 + m21) * k2], axis=-1)

    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    k3 = 0.25 / jnp.maximum(qz3, _EPS)
    c3 = jnp.stack([(m10 - m01) * k3, (m02 + m20) * k3,
                    (m12 + m21) * k3, qz3], axis=-1)

    cond0 = (tr > m00) & (tr > m11) & (tr > m22)
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = jnp.where(
        cond0[..., None],
        c0,
        jnp.where(cond1[..., None], c1, jnp.where(cond2[..., None], c2, c3)),
    )
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# Rigid transforms (R, p): pose of a child frame in a parent frame
# ---------------------------------------------------------------------------

def t_compose(Ra, pa, Rb, pb):
    """(Ra,pa) o (Rb,pb): pose of C in A given B-in-A and C-in-B."""
    return Ra @ Rb, pa + jnp.einsum("...ij,...j->...i", Ra, pb)


def t_inv(R, p):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, p)


def t_apply(R, p, x):
    """Apply transform to a point."""
    return jnp.einsum("...ij,...j->...i", R, x) + p


# ---------------------------------------------------------------------------
# Pluecker transforms in structural (E, r) form.
#   Given child pose (R, p) in the parent frame, the motion transform taking
#   parent-frame spatial vectors to child-frame ones has E = R^T, r = p.
# ---------------------------------------------------------------------------

def xmotion_apply(E, r, v):
    """[E,0; -E r^, E] v  for motion vector v = [w; vl]."""
    w, vl = v[..., :3], v[..., 3:]
    wE = jnp.einsum("...ij,...j->...i", E, w)
    vE = jnp.einsum("...ij,...j->...i", E, vl - jnp.cross(r, w))
    return jnp.concatenate([wE, vE], axis=-1)


def xmotion_inv_apply(E, r, v):
    """Inverse motion transform: child-frame v back to parent frame."""
    w, vl = v[..., :3], v[..., 3:]
    Et = jnp.swapaxes(E, -1, -2)
    wP = jnp.einsum("...ij,...j->...i", Et, w)
    vP = jnp.einsum("...ij,...j->...i", Et, vl) + jnp.cross(r, wP)
    return jnp.concatenate([wP, vP], axis=-1)


def xforce_apply(E, r, f):
    """[E, -E r^; 0, E] f  for force vector f = [n; fl]."""
    n, fl = f[..., :3], f[..., 3:]
    fE = jnp.einsum("...ij,...j->...i", E, fl)
    nE = jnp.einsum("...ij,...j->...i", E, n - jnp.cross(r, fl))
    return jnp.concatenate([nE, fE], axis=-1)


def xforce_inv_apply(E, r, f):
    """Inverse force transform (child frame back to parent frame)."""
    n, fl = f[..., :3], f[..., 3:]
    Et = jnp.swapaxes(E, -1, -2)
    fP = jnp.einsum("...ij,...j->...i", Et, fl)
    nP = jnp.einsum("...ij,...j->...i", Et, n) + jnp.cross(r, fP)
    return jnp.concatenate([nP, fP], axis=-1)


def xmotion_mat(E, r):
    """Dense 6x6 motion transform [[E,0],[-E r^,E]]."""
    z = jnp.zeros_like(E)
    top = jnp.concatenate([E, z], axis=-1)
    bot = jnp.concatenate([-E @ skew(r), E], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def xforce_mat(E, r):
    """Dense 6x6 force transform [[E,-E r^],[0,E]] = (X^-1)^T."""
    z = jnp.zeros_like(E)
    top = jnp.concatenate([E, -E @ skew(r)], axis=-1)
    bot = jnp.concatenate([z, E], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# ---------------------------------------------------------------------------
# Spatial cross products
# ---------------------------------------------------------------------------

def crm(v, m):
    """Motion cross product  v x m  (both motion vectors)."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return jnp.concatenate(
        [jnp.cross(w, mw), jnp.cross(w, ml) + jnp.cross(vl, mw)], axis=-1
    )


def crf(v, f):
    """Force cross product  v x* f  (motion x force)."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return jnp.concatenate(
        [jnp.cross(w, n) + jnp.cross(vl, fl), jnp.cross(w, fl)], axis=-1
    )


# ---------------------------------------------------------------------------
# Spatial inertia
# ---------------------------------------------------------------------------

def spatial_inertia(mass, com, inertia_com):
    """Dense 6x6 spatial inertia about the body-frame origin.

    mass: (...,), com: (..., 3) — COM offset in body frame,
    inertia_com: (..., 3, 3) — rotational inertia about the COM.
    I = [[Ic + m c^ c^T, m c^], [m c^T, m 1]]
    """
    c = skew(com)
    ct = jnp.swapaxes(c, -1, -2)
    m = mass[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=com.dtype), c.shape)
    top = jnp.concatenate([inertia_com + m * (c @ ct), m * c], axis=-1)
    bot = jnp.concatenate([m * ct, m * eye], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def inertia_mul(I, v):
    """I @ v for 6x6 inertia and motion vector."""
    return jnp.einsum("...ij,...j->...i", I, v)
