"""Pallas kernel (GPU, through Triton): the fused smooth-dynamics phase.

The XLA formulation (dynamics/batched.py) runs the kinematic tree as a
`lax.scan` over bodies with dynamic gathers, and every phase boundary
materializes (B, nb, 3, 3)/(B, n, 6) intermediates in device memory.
This kernel computes the ENTIRE phase — joint transforms, the kinematic
tree recursion, world Jacobian columns, mass matrix, bias forces, and the
implicit-scheme forward-dynamics solve — in one launch, one env per GPU
thread:

  * the env batch is laid out env-minor, (field, B), and a program takes
    one tile of `TB` envs; every per-env scalar is a (TB,) vector, so
    each thread of the warp carries one env through straight-line code;
  * ALL model data (topology, joint frames, axes, inertias) is static and
    baked into the kernel as Python floats, through a tiny constant-
    folding scalar algebra (`_mul`/`_add` below) that eliminates every
    multiply-by-0/1 at trace time — identity joint frames, axis-aligned
    axes and zero COMs cost nothing;
  * the tree recursion is a static unroll over bodies with STATIC parent
    indices;
  * the mass matrix uses the world-origin composite form
    M[i,j] = sum_b phi_i^T I_w(b) phi_j over STATIC ancestor-pair
    sparsity, with I_w built structurally from (m, d, R Ic R^T)
    (d = world COM) instead of a dense 6x6 congruence;
  * the n x n SPD solve is the same unrolled Cholesky as math/linalg.chol
    (eps=1e-10, sqrt(max(s, 1e-30)) — numerics-identical policy).

Boundary contract (identical quantities to the XLA phase in
engine/world.make_sim_step): (q, dq, tau) -> (dq_star, M, phi, R_w, p_w).
Collision, constraint assembly, the PGS/hybrid LCP kernels and position
integration stay outside, unchanged.

Joint coverage: REVOLUTE, PRISMATIC, PLANAR, TRANSLATIONAL, WELD, FREE,
BALL, UNIVERSAL, EULER, SCREW — every type the engine supports.
`make_dynamics_phase` returns a custom_vmap'd callable whose single-env /
CPU / f64 paths run the exact dynamics/batched.py code (so validation
semantics are untouched); only a vmapped f32 batch on the GPU dispatches
to the kernel (dartenv_tpu.backend.use_kernel decides).

Reference parity: same quantities as `Skeleton::computeForwardDynamics` /
`updateMassMatrix` † (SURVEY.md §2.4) with DART's implicit joint
spring/damping scheme ‡, matching dynamics/batched.forward_dynamics.
"""
from __future__ import annotations

import functools
from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from dartenv_tpu.model.skel_model import (
    BALL, EULER, FREE, PLANAR, PRISMATIC, REVOLUTE, SCREW, SkelModel,
    TRANSLATIONAL, UNIVERSAL, WELD,
)

# The straight-line kernel grows roughly with n^3: walker2d (n=9) traces
# to 2.4k ops and compiles with its rollout in about 100 s on an H100,
# while humanwalker (n=29) traces to 29.7k ops, more than a 25.8k-op
# kernel that had not finished compiling after 420 s.  Larger models
# keep the XLA phase.
KERNEL_MAX_DOFS = 12

# One env per thread: a program is one warp over TB envs.  Per-env live
# state runs to hundreds of registers, so a thread holds one env and
# small tiles spread a B=4096 batch over 128 programs (132 SMs).
TB = 32
NUM_WARPS = 1


def _x64_safe_kernel(kernel, dtype):
    """Trace `kernel` with x64 disabled when the process has it on.

    With jax_enable_x64, Python float literals inside the trace are
    weak-f64, so `jnp.where(c, -1.0, 1.0)` / `jnp.clip(x, 0.0, 1e20)`
    would promote the f32 kernel arithmetic to f64 and store mismatched
    dtypes.  Re-tracing the body under `jax.enable_x64(False)` keeps
    every literal weak-f32 without touching the direct `_trace_env`
    f64 validation path (which never goes through pallas_call).  x64 stays available OUTSIDE the kernel for the
    mixed-precision escalation tier (lcp/dantzig.refine_mixed)."""
    if not jax.config.jax_enable_x64 or dtype == jnp.float64:
        return kernel

    def wrapped(*refs):
        with jax.enable_x64(False):
            kernel(*refs)

    return wrapped


# ---------------------------------------------------------------------------
# constant-folding scalar algebra: values are Python floats (static model
# constants) or (TB,) jnp vectors (per-env runtime values).  Multiplies
# by static 0/1 and additions of static 0 vanish at trace time, so
# identity joint frames / sparse axes / zero COMs generate no ops.
# ---------------------------------------------------------------------------

def _st(x) -> bool:
    return isinstance(x, (int, float))


def _mul(a, b):
    if _st(a) and _st(b):
        return a * b
    if _st(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
    if _st(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def _add(a, b):
    if _st(a) and _st(b):
        return a + b
    if _st(a) and a == 0.0:
        return b
    if _st(b) and b == 0.0:
        return a
    return a + b


def _sub(a, b):
    if _st(a) and _st(b):
        return a - b
    if _st(b) and b == 0.0:
        return a
    if _st(a) and a == 0.0:
        return _neg(b)
    return a - b


def _neg(a):
    if _st(a):
        return -a
    return -a


def _dot(u, v):
    s = 0.0
    for a, b in zip(u, v):
        s = _add(s, _mul(a, b))
    return s


def _sc(v, s):
    return [_mul(x, s) for x in v]


def _vadd(u, v):
    return [_add(a, b) for a, b in zip(u, v)]


def _vsub(u, v):
    return [_sub(a, b) for a, b in zip(u, v)]


def _cross(u, v):
    return [
        _sub(_mul(u[1], v[2]), _mul(u[2], v[1])),
        _sub(_mul(u[2], v[0]), _mul(u[0], v[2])),
        _sub(_mul(u[0], v[1]), _mul(u[1], v[0])),
    ]


def _m3v(M, v):
    return [_dot(row, v) for row in M]


def _m3tv(M, v):
    """M^T v."""
    return [_dot([M[0][j], M[1][j], M[2][j]], v) for j in range(3)]


def _m3m(A, B):
    return [[_dot(A[i], [B[0][j], B[1][j], B[2][j]]) for j in range(3)]
            for i in range(3)]


def _m3t(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def _np3(a) -> List[List[float]]:
    return [[float(a[i, j]) for j in range(3)] for i in range(3)]


def _npv(a) -> List[float]:
    return [float(x) for x in a]


_EYE3 = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]


def _unitize(u: List[float]) -> Tuple[List[float], float]:
    """Split a static axis into (unit axis, norm); batched._rod uses
    so3_exp(axis * q), so a non-unit axis scales the angle."""
    nrm = float(np.sqrt(sum(x * x for x in u)))
    if nrm < 1e-12:
        return [0.0, 0.0, 0.0], 0.0
    return [x / nrm for x in u], nrm


def _rod_static_axis(u: List[float], s, c):
    """Rodrigues for a STATIC unit axis u and runtime sin/cos blocks:
    R = I + s K + (1-c) K^2, K = skew(u) — entries affine in (s, 1-c)."""
    K = [[0.0, -u[2], u[1]], [u[2], 0.0, -u[0]], [-u[1], u[0], 0.0]]
    K2 = [[sum(K[i][k] * K[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    omc = _sub(1.0, c)
    return [[_add(_add(_EYE3[i][j], _mul(K[i][j], s)),
                  _mul(K2[i][j], omc)) for j in range(3)] for i in range(3)]


def _rot_static_vec(u: List[float], a: List[float], s, c):
    """rod(u, theta) @ a for STATIC unit axis u and static vector a:
    c*a + s*(u x a) + (1-c)*(u.a)*u   (exact, no orthogonality assumed)."""
    w = _cross(u, a)          # static floats
    d = sum(ui * ai for ui, ai in zip(u, a))
    return [
        _add(_add(_mul(c, a[k]), _mul(s, w[k])),
             _mul(_sub(1.0, c), d * u[k]))
        for k in range(3)
    ]


def _rot_static_vec_dot(u: List[float], a: List[float], s, c, thdot):
    """d/dt of _rot_static_vec at theta(t): thdot * (-s*a + c*(u x a) +
    s*(u.a)*u)."""
    w = _cross(u, a)
    d = sum(ui * ai for ui, ai in zip(u, a))
    return [
        _mul(thdot,
             _add(_add(_mul(_neg(s), a[k]), _mul(c, w[k])),
                  _mul(s, d * u[k])))
        for k in range(3)
    ]


def _rot_runtime_vec(u: List[float], g, s, c):
    """rod(u, theta) @ g for STATIC axis u, RUNTIME vector g."""
    w = _cross(u, g)
    d = _dot([u[0], u[1], u[2]], g)
    return [
        _add(_add(_mul(c, g[k]), _mul(s, w[k])),
             _mul(_sub(1.0, c), _mul(d, u[k])))
        for k in range(3)
    ]


def _so3_exp_runtime(w):
    """Rodrigues for a RUNTIME rotation vector (FREE/BALL joints),
    Taylor-safe at 0 — mirrors math/spatial.so3_exp."""
    t2 = _add(_add(_mul(w[0], w[0]), _mul(w[1], w[1])), _mul(w[2], w[2]))
    theta = jnp.sqrt(t2 + 1e-18)
    small = t2 < 1e-12
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(theta)) / t2)
    K = [[0.0, _neg(w[2]), w[1]], [w[2], 0.0, _neg(w[0])],
         [_neg(w[1]), w[0], 0.0]]
    K2 = _m3m(K, K)
    return [[_add(_add(_EYE3[i][j], _mul(a, K[i][j])), _mul(b, K2[i][j]))
             for j in range(3)] for i in range(3)]


# ---------------------------------------------------------------------------
# spatial helpers on [w(3); v(3)] 6-vectors of blocks
# ---------------------------------------------------------------------------

def _xmotion_apply(E, r, v6):
    """[E,0; -E r^, E] v — math/spatial.xmotion_apply."""
    w, vl = v6[:3], v6[3:]
    wE = _m3v(E, w)
    vE = _m3v(E, _vsub(vl, _cross(r, w)))
    return wE + vE


def _crm(v6, m6):
    w, vl = v6[:3], v6[3:]
    mw, ml = m6[:3], m6[3:]
    return _cross(w, mw) + _vadd(_cross(w, ml), _cross(vl, mw))


def _crf(v6, f6):
    w, vl = v6[:3], v6[3:]
    n, fl = f6[:3], f6[3:]
    return _vadd(_cross(w, n), _cross(vl, fl)) + _cross(w, fl)


# ---------------------------------------------------------------------------
# static model digest
# ---------------------------------------------------------------------------

_SUPPORTED = {WELD, REVOLUTE, PRISMATIC, UNIVERSAL, EULER, BALL,
              TRANSLATIONAL, PLANAR, FREE, SCREW}

def supported(model: SkelModel) -> bool:
    return (set(model.joint_type) <= _SUPPORTED
            and model.nb >= 1)


class _Static:
    """Per-model static data as plain floats (hashable per model id)."""

    def __init__(self, model: SkelModel):
        self.nb, self.n = model.nb, model.n
        self.parent = [int(p) for p in model.parent]
        self.jt = [int(t) for t in model.joint_type]
        self.q_start = [int(q) for q in model.q_start]
        self.ndof = [int(d) for d in model.ndof]
        self.pj_rot = [_np3(np.asarray(model.pj_rot[b])) for b in range(self.nb)]
        self.pj_pos = [_npv(np.asarray(model.pj_pos[b])) for b in range(self.nb)]
        cj_rot = [np.asarray(model.cj_rot[b], dtype=np.float64)
                  for b in range(self.nb)]
        cj_pos = [np.asarray(model.cj_pos[b], dtype=np.float64)
                  for b in range(self.nb)]
        self.cj_rot = [_np3(R) for R in cj_rot]
        self.cj_pos = [_npv(p) for p in cj_pos]
        # inv(T_cj) applied on the right: R_rel = R1 @ cj_rot^T,
        # p_rel = p1 + R1 @ (-cj_rot^T cj_pos)
        self.cji_rot = [_np3(R.T) for R in cj_rot]
        self.cji_pos = [_npv(-(R.T @ p)) for R, p in zip(cj_rot, cj_pos)]
        self.axes = [np.asarray(model.axes[b], dtype=np.float64)
                     for b in range(self.nb)]
        self.mass = [float(np.asarray(model.mass)[b]) for b in range(self.nb)]
        self.com = [_npv(np.asarray(model.com[b])) for b in range(self.nb)]
        self.inertia = [_np3(np.asarray(model.inertia[b]))
                        for b in range(self.nb)]
        self.gravity = _npv(np.asarray(model.gravity))
        self.damping = _npv(np.asarray(model.damping))
        self.spring = _npv(np.asarray(model.spring_stiff))
        self.rest = _npv(np.asarray(model.rest_pos))
        # children lists for subtree force accumulation (leaf -> root)
        self.children: List[List[int]] = [[] for _ in range(self.nb)]
        for b, p in enumerate(self.parent):
            if p >= 0:
                self.children[p].append(b)
        # ancestor dof lists per body (for the Jacobian/M sparsity)
        self.body_dofs: List[List[int]] = []
        for b in range(self.nb):
            dofs: List[int] = []
            bb = b
            while bb >= 0:
                dofs = list(range(self.q_start[bb],
                                  self.q_start[bb] + self.ndof[bb])) + dofs
                bb = self.parent[bb]
            self.body_dofs.append(dofs)
        self.dof_body = [0] * self.n
        for b in range(self.nb):
            for d in range(self.q_start[b], self.q_start[b] + self.ndof[b]):
                self.dof_body[d] = b


def _ad_cj(st: _Static, b: int, row6):
    """Ad_{T_cj}: joint-frame S column -> child-body frame
    (dynamics/batched.dof_S_child's `ad`)."""
    cjR, cjp = st.cj_rot[b], st.cj_pos[b]
    w, v = row6[:3], row6[3:]
    wb = _m3v(cjR, w)
    vb = _vadd(_m3v(cjR, v), _cross(cjp, wb))
    return wb + vb


def _joint_kin(st: _Static, b: int, q, dq):
    """Joint b's (R_j, p_j, S_rows, Sdot_rows) in the JOINT frame.

    q, dq: full dof lists of blocks.  S rows follow dof order (ndof rows
    of 6 entries); static rows come out as float lists (folded later).
    Mirrors dynamics/batched.joint_S / joint_transforms exactly, with the
    jvp-derived S-dot rows written out analytically.
    """
    t = st.jt[b]
    qs = st.q_start[b]
    ax = st.axes[b]
    z3 = [0.0, 0.0, 0.0]
    eye = _EYE3

    def sincos(row: int, d: int):
        """(unit axis, sin, cos, scaled rate) for rotation so3_exp(ax*q):
        a non-unit static axis scales the effective angle (batched._rod)."""
        u, nrm = _unitize(_npv(ax[row]))
        th = _mul(nrm, q[d])
        return u, jnp.sin(th), jnp.cos(th), _mul(nrm, dq[d])

    if t == WELD:
        return eye, list(z3), [], []
    if t == REVOLUTE:
        u, s, c, _ = sincos(0, qs)
        R = _rod_static_axis(u, s, c)
        return R, list(z3), [_npv(ax[0]) + z3], [[0.0] * 6]
    if t == PRISMATIC:
        u = _npv(ax[0])
        return eye, _sc(u, q[qs]), [z3 + u], [[0.0] * 6]
    if t == SCREW:
        u, s, c, _ = sincos(0, qs)
        pu = _npv(ax[1])
        R = _rod_static_axis(u, s, c)
        return R, _sc(pu, q[qs]), [_npv(ax[0]) + pu], [[0.0] * 6]
    if t == UNIVERSAL:
        a0, a1 = _npv(ax[0]), _npv(ax[1])
        u0, s0, c0, _ = sincos(0, qs)
        u1, s1, c1, r1 = sincos(1, qs + 1)
        R = _m3m(_rod_static_axis(u0, s0, c0), _rod_static_axis(u1, s1, c1))
        # S (batched.joint_S): s_a = R2^T a0 (rotate a0 by -q1 about u1),
        # s_b = a1
        sa = _rot_static_vec(u1, a0, _neg(s1), c1)
        sa_d = _rot_static_vec_dot(u1, a0, _neg(s1), c1, _neg(r1))
        return R, list(z3), [sa + z3, a1 + z3], [sa_d + z3, [0.0] * 6]
    if t == EULER:
        a0, a1, a2 = _npv(ax[0]), _npv(ax[1]), _npv(ax[2])
        u0, s0, c0, _ = sincos(0, qs)
        u1, s1, c1, r1 = sincos(1, qs + 1)
        u2, s2, c2, r2 = sincos(2, qs + 2)
        R = _m3m(_rod_static_axis(u0, s0, c0),
                 _m3m(_rod_static_axis(u1, s1, c1),
                      _rod_static_axis(u2, s2, c2)))
        # S rows (batched.joint_S): s1 = R3^T R2^T a0, s2 = R3^T a1,
        # s3 = a2  (R2 = rod(a1, q1), R3 = rod(a2, q2))
        g = _rot_static_vec(u1, a0, _neg(s1), c1)          # R2^T a0
        gd = _rot_static_vec_dot(u1, a0, _neg(s1), c1, _neg(r1))
        h = _rot_runtime_vec(u2, g, _neg(s2), c2)          # R3^T g
        # dh = R3^T gd + q2dot * (-u2 x h)
        hd = _vadd(_rot_runtime_vec(u2, gd, _neg(s2), c2),
                   _sc(_cross([_neg(x) for x in u2], h), r2))
        sb = _rot_static_vec(u2, a1, _neg(s2), c2)         # R3^T a1
        sbd = _rot_static_vec_dot(u2, a1, _neg(s2), c2, _neg(r2))
        return (R, list(z3),
                [h + z3, sb + z3, a2 + z3],
                [hd + z3, sbd + z3, [0.0] * 6])
    if t == BALL:
        w = [q[qs], q[qs + 1], q[qs + 2]]
        R = _so3_exp_runtime(w)
        S = [[1.0, 0.0, 0.0] + z3, [0.0, 1.0, 0.0] + z3,
             [0.0, 0.0, 1.0] + z3]
        return R, list(z3), S, [[0.0] * 6] * 3
    if t == TRANSLATIONAL:
        p = [q[qs], q[qs + 1], q[qs + 2]]
        S = [z3 + [1.0, 0.0, 0.0], z3 + [0.0, 1.0, 0.0],
             z3 + [0.0, 0.0, 1.0]]
        return eye, p, S, [[0.0] * 6] * 3
    if t == PLANAR:
        a0, a1, a2 = _npv(ax[0]), _npv(ax[1]), _npv(ax[2])
        u2, s, c, r2 = sincos(2, qs + 2)
        R = _rod_static_axis(u2, s, c)
        p = _vadd(_sc(a0, q[qs]), _sc(a1, q[qs + 1]))
        # S (batched.joint_S): s1 = [0, R^T a0], s2 = [0, R^T a1],
        # s3 = [a2, 0]
        r0 = _rot_static_vec(u2, a0, _neg(s), c)
        r1 = _rot_static_vec(u2, a1, _neg(s), c)
        r0d = _rot_static_vec_dot(u2, a0, _neg(s), c, _neg(r2))
        r1d = _rot_static_vec_dot(u2, a1, _neg(s), c, _neg(r2))
        return (R, p,
                [z3 + r0, z3 + r1, a2 + z3],
                [z3 + r0d, z3 + r1d, [0.0] * 6])
    if t == FREE:
        w = [q[qs], q[qs + 1], q[qs + 2]]
        p = [q[qs + 3], q[qs + 4], q[qs + 5]]
        R = _so3_exp_runtime(w)
        S = []
        for k in range(6):
            row = [0.0] * 6
            row[k] = 1.0
            S.append(row)
        return R, p, S, [[0.0] * 6] * 6
    raise NotImplementedError(t)


def _trace_env(st: _Static, dt: float, q, dq, tau):
    """The full dynamics phase for one env (all values are blocks or
    static floats).  Returns (dq_star[n], M[n][n], phi[n][6],
    R_w[nb]3x3, p_w[nb][3])."""
    nb, n = st.nb, st.n

    # ---- joint transforms + child-frame S rows -------------------------
    R_rel: List[Any] = [None] * nb
    p_rel: List[Any] = [None] * nb
    S: List[Any] = [None] * n          # child-frame rows (6 entries)
    Sd: List[Any] = [None] * n
    for b in range(nb):
        Rj, pj, Sj, Sdj = _joint_kin(st, b, q, dq)
        R1 = _m3m(st.pj_rot[b], Rj)
        p1 = _vadd(st.pj_pos[b], _m3v(st.pj_rot[b], pj))
        R_rel[b] = _m3m(R1, st.cji_rot[b])
        p_rel[b] = _vadd(p1, _m3v(R1, st.cji_pos[b]))
        for k in range(st.ndof[b]):
            d = st.q_start[b] + k
            S[d] = _ad_cj(st, b, Sj[k])
            Sd[d] = _ad_cj(st, b, Sdj[k])

    # ---- tree recursion (static unroll, static parents) ----------------
    g = st.gravity
    a_base = [0.0, 0.0, 0.0, -g[0], -g[1], -g[2]]
    R_w: List[Any] = [None] * nb
    p_w: List[Any] = [None] * nb
    v: List[Any] = [None] * nb
    a_bias: List[Any] = [None] * nb
    for b in range(nb):
        E = _m3t(R_rel[b])
        r = p_rel[b]
        vJ = [0.0] * 6
        cJ = [0.0] * 6
        for k in range(st.ndof[b]):
            d = st.q_start[b] + k
            vJ = _vadd(vJ, _sc(S[d], dq[d]))
            cJ = _vadd(cJ, _sc(Sd[d], dq[d]))
        par = st.parent[b]
        if par < 0:
            R_w[b] = R_rel[b]
            p_w[b] = r
            v[b] = vJ
            a_bias[b] = _vadd(_xmotion_apply(E, r, a_base),
                              _vadd(_crm(v[b], vJ), cJ))
        else:
            R_w[b] = _m3m(R_w[par], R_rel[b])
            p_w[b] = _vadd(p_w[par], _m3v(R_w[par], r))
            v[b] = _vadd(_xmotion_apply(E, r, v[par]), vJ)
            a_bias[b] = _vadd(_xmotion_apply(E, r, a_bias[par]),
                              _vadd(_crm(v[b], vJ), cJ))

    # ---- world-frame dof columns at the world origin -------------------
    phi: List[Any] = [None] * n
    for d in range(n):
        b = st.dof_body[d]
        w = _m3v(R_w[b], S[d][:3])
        vl = _vadd(_m3v(R_w[b], S[d][3:]), _cross(p_w[b], w))
        phi[d] = w + vl

    # ---- mass matrix: M[i,j] = sum_b phi_i . (I_w(b) phi_j) ------------
    # I_w(b) about the world origin, built structurally from the world COM
    # d_b = p_w + R_w c and Ic_w = R_w Ic R_w^T:
    #   I_w phi = [Ic_w w + m d x u ; m u],  u = v - d x w
    # (identical operator to batched.mass_matrix's X^T I X assembly).
    M = [[0.0] * n for _ in range(n)]
    f_grav_acc: List[Any] = [None] * nb
    for b in range(nb):
        m_b = st.mass[b]
        d_w = _vadd(p_w[b], _m3v(R_w[b], st.com[b]))
        IcR = _m3m(R_w[b], st.inertia[b])
        Ic_w = _m3m(IcR, _m3t(R_w[b]))
        dofs = st.body_dofs[b]
        F = {}
        for j in dofs:
            wj, vj = phi[j][:3], phi[j][3:]
            u = _vsub(vj, _cross(d_w, wj))
            Fang = _vadd(_m3v(Ic_w, wj), _sc(_cross(d_w, u), m_b))
            Flin = _sc(u, m_b)
            F[j] = Fang + Flin
        for ji, j in enumerate(dofs):
            for i in dofs[: ji + 1]:
                M[i][j] = _add(M[i][j], _dot(phi[i], F[j]))

    # ---- bias forces ----------------------------------------------------
    # body-frame Newton-Euler f = I_b a_bias + v x* (I_b v), then to world
    # via the inverse force transform, accumulated leaf -> root; then
    # C[i] = phi_i . f_subtree(body_i)  (== J^T f of batched.bias_forces).
    f_w: List[Any] = [None] * nb

    def _I_mul(b, v6):
        # body-frame spatial inertia times motion vector (structural):
        # [Ic w - m c x (c x w) + m c x v ; m v - m c x w]
        m_b, c = st.mass[b], st.com[b]
        w, vl = v6[:3], v6[3:]
        Icw = _m3v(st.inertia[b], w)
        cxw = _cross(c, w)
        top = _vadd(Icw,
                    _sc(_cross(c, _vsub(vl, cxw)), m_b))
        bot = _sc(_vsub(vl, cxw), m_b)
        return top + bot

    for b in range(nb):
        f_body = _vadd(_I_mul(b, a_bias[b]), _crf(v[b], _I_mul(b, v[b])))
        # inverse force transform with (E = R_w^T, r = p_w):
        # fP = R_w f_l ; nP = R_w n + p_w x fP
        fl = _m3v(R_w[b], f_body[3:])
        nl = _vadd(_m3v(R_w[b], f_body[:3]), _cross(p_w[b], fl))
        f_w[b] = nl + fl
    f_sub = [None] * nb
    for b in range(nb - 1, -1, -1):
        acc = f_w[b]
        for ch in st.children[b]:
            acc = _vadd(acc, f_sub[ch])
        f_sub[b] = acc
    C = [0.0] * n
    for d in range(n):
        C[d] = _dot(phi[d], f_sub[st.dof_body[d]])

    # ---- implicit-scheme forward dynamics ------------------------------
    # tau_total = tau - d dq - k (q - rest + dt dq) - C;
    # (M + diag(dt d + dt^2 k)) ddq = tau_total   (batched.forward_dynamics)
    rhs = [None] * n
    Mi = [[M[min(i, j)][max(i, j)] for j in range(n)] for i in range(n)]
    for d in range(n):
        # fold-safe forms (no `!= 0.0` guards): static zeros vanish
        # through _mul/_add folding
        t_d = _sub(tau[d], C[d])
        t_d = _sub(t_d, _mul(st.damping[d], dq[d]))
        t_d = _sub(t_d, _mul(st.spring[d],
                             _add(_sub(q[d], st.rest[d]),
                                  _mul(dt, dq[d]))))
        rhs[d] = t_d
        Mi[d][d] = _add(Mi[d][d],
                        _add(_mul(dt, st.damping[d]),
                             _mul(dt * dt, st.spring[d])))

    ddq = _chol_solve_env(Mi, rhs, n, eps=1e-10)
    dq_star = [_add(dq[d], _mul(dt, ddq[d])) for d in range(n)]
    return dq_star, M, phi, R_w, p_w


def _chol_solve_env(A, b, n, eps):
    """Unrolled Cholesky + substitution over scalar blocks — the same
    recurrence (and eps / max(s, 1e-30) guards) as math/linalg.chol."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            if j == i:
                s = _add(s, eps)
            for k in range(j):
                s = _sub(s, _mul(L[i][k], L[j][k]))
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = _sub(s, _mul(L[i][k], y[k]))
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = _sub(s, _mul(L[k][i], x[k]))
        x[i] = s / L[i][i]
    return x


# ---------------------------------------------------------------------------
# the kernel + pallas_call wrapper
# ---------------------------------------------------------------------------

def _blk(x, dtype):
    """Materialize a scalar-or-vector value as a (TB,) vector.

    Constant folding can also leave 0-d jnp arrays (e.g. jnp.maximum of
    two static floats in a flat-snake contact row) — broadcast those
    too, or the kernel ref write rejects the () shape."""
    if _st(x):
        return jnp.full((TB,), x, dtype=dtype)
    if getattr(x, "ndim", 1) == 0:
        return jnp.broadcast_to(jnp.asarray(x, dtype), (TB,))
    return x


def env_tile_call(kernel, ins, out_rows, dtype, name: str,
                  interpret: bool = False):
    """Run `kernel` over the env batch in tiles of TB envs.

    ins: (B, k) arrays; out_rows: the row count k of each (B, k) output.
    Operands are laid out env-minor, (k, Bp), with B padded up to a
    multiple of TB by copies of env 0 (a well-posed state, so the pad
    lanes compute finite garbage that is sliced away).  Each program
    gets (k, TB) blocks: `ref[r]` is one field of its TB envs, a
    power-of-two load as the Triton route requires.  Returns the
    outputs as (B, k) arrays."""
    B = ins[0].shape[0]
    G = -(-B // TB)
    pad = G * TB - B

    def to_minor(x):
        if pad:
            x = jnp.concatenate(
                [x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])])
        return x.T

    def spec(k):
        return pl.BlockSpec((k, TB), lambda i: (0, i))

    outs = pl.pallas_call(
        _x64_safe_kernel(kernel, dtype),
        grid=(G,),
        in_specs=[spec(x.shape[1]) for x in ins],
        out_specs=tuple(spec(k) for k in out_rows),
        out_shape=tuple(jax.ShapeDtypeStruct((k, G * TB), dtype)
                        for k in out_rows),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name=name,
    )(*[to_minor(x) for x in ins])
    return [o[:, :B].T for o in outs]


def _dyn_kernel(q_ref, dq_ref, tau_ref, dqs_ref, M_ref, phi_ref, Rw_ref,
                pw_ref, *, st: _Static, dt: float):
    n, nb = st.n, st.nb
    dtype = q_ref.dtype
    q = [q_ref[d] for d in range(n)]
    dq = [dq_ref[d] for d in range(n)]
    tau = [tau_ref[d] for d in range(n)]
    dq_star, M, phi, R_w, p_w = _trace_env(st, dt, q, dq, tau)
    for d in range(n):
        dqs_ref[d] = _blk(dq_star[d], dtype)
    for i in range(n):
        for j in range(n):
            # full symmetric write (upper entries computed; mirror lower)
            M_ref[i * n + j] = _blk(M[min(i, j)][max(i, j)], dtype)
    for d in range(n):
        for k in range(6):
            phi_ref[d * 6 + k] = _blk(phi[d][k], dtype)
    for b in range(nb):
        for i in range(3):
            for j in range(3):
                Rw_ref[b * 9 + i * 3 + j] = _blk(R_w[b][i][j], dtype)
        for i in range(3):
            pw_ref[b * 3 + i] = _blk(p_w[b][i], dtype)


def dynamics_pallas(model: SkelModel, q, dq, tau, interpret: bool = False,
                    st: Optional["_Static"] = None):
    """Batched fused dynamics phase.  q/dq/tau: (B, n) f32.

    Returns (dq_star (B, n), M (B, n, n), phi (B, n, 6),
    R_w (B, nb, 3, 3), p_w (B, nb, 3)) — the exact boundary quantities of
    the XLA phase in engine/world.make_sim_step.

    `st` must be prebuilt (outside any trace) when calling from traced
    code: _Static reads the model arrays host-side, which is illegal on
    tracers (make_dynamics_phase builds it at construction time).
    """
    if st is None:
        st = _Static(model)
    n, nb = st.n, st.nb
    B = q.shape[0]
    kernel = functools.partial(_dyn_kernel, st=st, dt=float(model.dt))
    dqs, M, phi, Rw, pw = env_tile_call(
        kernel, [q, dq, tau], [n, n * n, n * 6, nb * 9, nb * 3], q.dtype,
        name="dartenv_dynamics", interpret=interpret)
    return (dqs, M.reshape(B, n, n), phi.reshape(B, n, 6),
            Rw.reshape(B, nb, 3, 3), pw.reshape(B, nb, 3))


# ---------------------------------------------------------------------------
# engine integration: custom_vmap redirect
# ---------------------------------------------------------------------------

def make_dynamics_phase(model: SkelModel, dt: float,
                        interpret: bool = False):
    """(q, dq, tau) -> (dq_star, M, phi, R_w, p_w) with GPU batch
    redirection.  Single-env / CPU / f64 calls run the exact
    dynamics/batched.py path; a vmapped f32 batch on the GPU runs the
    fused Pallas kernel (dartenv_tpu.backend.use_kernel).  Returns None
    when the kernel does not serve the model (caller keeps the XLA
    phase): unsupported joints, more than KERNEL_MAX_DOFS dofs, a traced
    model, or DARTENV_NO_DYN_KERNEL set."""
    import os

    if not supported(model) or os.environ.get("DARTENV_NO_DYN_KERNEL"):
        # DARTENV_NO_DYN_KERNEL=1: A/B switch — keep the inline XLA phase
        return None
    if model.n > KERNEL_MAX_DOFS:
        return None
    if any(isinstance(leaf, jax.core.Tracer)
           for leaf in jax.tree_util.tree_leaves(model)):
        # traced / per-env-batched model (domain randomization): the
        # kernel bakes model VALUES as static constants, so it cannot
        # serve this path — keep XLA
        return None

    from dartenv_tpu.backend import use_kernel
    from dartenv_tpu.dynamics import batched

    # host-side read of the model arrays — must happen HERE, outside any
    # trace (make_sim_step runs at env-construction time)
    st = _Static(model)

    def _xla_single(q, dq, tau):
        kin = batched.bkin(model, q, dq)
        ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt, None)
        return dq + dt * ddq, M, kin.phi, kin.R_w, kin.p_w

    @jax.custom_batching.custom_vmap
    def dyn(q, dq, tau):
        return _xla_single(q, dq, tau)

    @dyn.def_vmap
    def _batched_rule(axis_size, in_batched, q, dq, tau):
        q, dq, tau = [
            a if bat else jnp.broadcast_to(a, (axis_size,) + a.shape)
            for a, bat in zip((q, dq, tau), in_batched)
        ]
        if (interpret and q.dtype == jnp.float32) or use_kernel(q.dtype):
            out = dynamics_pallas(model, q, dq, tau, st=st,
                                  interpret=interpret)
        else:
            out = jax.vmap(_xla_single)(q, dq, tau)
        return out, (True,) * 5

    return dyn
