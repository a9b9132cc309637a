"""SkelModel: the static articulated-model pytree.

JAX replacement for the reference's model objects
(`dart/dynamics/Skeleton.cpp` † object graph + `dart/utils/SkelParser.cpp` †
output — SURVEY.md §2.4): instead of a C++ object graph reached through SWIG,
the whole model is one frozen dataclass of arrays (leaves) and Python ints /
tuples (static metadata).  Topology is static so tree loops unroll at trace
time; numeric leaves (masses, inertias, limits, shape sizes, contact params)
are arrays so they may carry a leading env axis for domain randomization
while staying jit-safe (SURVEY.md §2.5 "Batched model params").

Everything is in the y-up convention of the reference's .skel files
(gravity -9.81 y †).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import numpy as np
import jax.numpy as jnp


# --- joint types (mirror of the reference's joint hierarchy,
#     `dart/dynamics/*Joint.cpp` †: Weld/Revolute/Prismatic/Screw/Universal/
#     Euler/Ball/Translational/Planar/Free) ---
WELD = 0
REVOLUTE = 1
PRISMATIC = 2
UNIVERSAL = 3
EULER = 4          # XYZ order; axes rows give the three axes
BALL = 5           # q = so(3) exp coords, dq = body angular velocity
TRANSLATIONAL = 6
PLANAR = 7         # dofs [t1, t2, rot]; axes rows [e1, e2, e_rot]
FREE = 8           # q = [so(3) exp coords, xyz], dq = body twist [w, v]
SCREW = 9          # rotation about axes[0] + coupled translation; convention:
                   # axes[1] = thread_pitch/(2*pi) * axes[0]

JOINT_NDOF = {
    WELD: 0,
    REVOLUTE: 1,
    PRISMATIC: 1,
    UNIVERSAL: 2,
    EULER: 3,
    BALL: 3,
    TRANSLATIONAL: 3,
    PLANAR: 3,
    FREE: 6,
    SCREW: 1,
}

# geometry types
GEOM_SPHERE = 0
GEOM_CAPSULE = 1    # size = (radius, half_length, 0); axis = local z
GEOM_BOX = 2        # size = half extents (3,)
GEOM_CYLINDER = 3   # size = (radius, half_height, 0); axis = local z
GEOM_ELLIPSOID = 4  # size = semi-axes (3,) along local axes
GEOM_MESH = 5       # convex vertex cloud; verts in SkelModel.mesh_verts
                    # indexed by the static geom_mesh table (size unused)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Constraint-solver constants (reference: `dart/constraint/
    ContactConstraint.cpp` † DART_ERP/DART_CFM/... — values marked ‡ in
    SURVEY.md, re-verify on reference availability)."""

    erp: float = dataclasses.field(default=0.01, metadata=dict(static=True))
    cfm: float = dataclasses.field(default=1e-5, metadata=dict(static=True))
    max_erv: float = dataclasses.field(default=10.0, metadata=dict(static=True))
    allowance: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    # joint-limit rows use their own erp in DART ‡
    joint_erp: float = dataclasses.field(default=0.01, metadata=dict(static=True))
    pgs_iters: int = dataclasses.field(default=30, metadata=dict(static=True))
    # SOR over-relaxation for the PGS sweeps (1.0 = plain Gauss-Seidel)
    pgs_omega: float = dataclasses.field(default=1.0, metadata=dict(static=True))
    solver: str = dataclasses.field(default="pgs", metadata=dict(static=True))
    contact_eps: float = dataclasses.field(default=1e-6, metadata=dict(static=True))
    # Active-set compaction: solve the LCP over only the `contact_cap`
    # best contact slots (active-first, deepest-first).  The reference's
    # island/active-row assembly (ConstraintSolver † builds rows only for
    # COLLIDING contacts) made the LCP small; under fixed XLA shapes the
    # equivalent is this static cap.  0 disables.  Semantics are identical
    # whenever <= contact_cap slots are simultaneously active (the usual
    # case: the capsule/box feet of these tasks yield 2-4 points).
    contact_cap: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Hybrid residual escalation (VERDICT.md r2 order #3): after the PGS
    # solve, the worst ceil(escalate_frac * B) envs by normalized
    # complementarity residual are re-solved with the exact block-pivoting
    # path (lcp/dantzig.py) and the better point is kept.  The reference
    # needs no such hybrid — its default solver IS the exact Dantzig
    # (`dSolveLCP` †); here PGS is the throughput path and escalation
    # restores the exact solver's worst-case guarantees at ~frac of its
    # cost.  0.0 disables.  Envs below `escalate_tol` never escalate.
    escalate_frac: float = dataclasses.field(
        default=0.0, metadata=dict(static=True))
    escalate_tol: float = dataclasses.field(
        default=1e-6, metadata=dict(static=True))
    # pivot iterations for the escalation re-solve: it starts from the
    # PGS point (nearly-correct active set), so a short refinement
    # suffices — the cold-start budget (24+polish) costs ~5x more wall
    # clock for no extra accuracy (docs/SOLVERS.md escalation study)
    escalate_iters: int = dataclasses.field(
        default=8, metadata=dict(static=True))
    # cap on the escalation batch K: a semantic bound on the re-solve's
    # capacity per substep (offenders beyond it rank first at the next
    # substep).  Its value is not yet derived from a GPU measurement.
    escalate_kmax: int = dataclasses.field(
        default=128, metadata=dict(static=True))
    # Undamped refinement pivots for the tier-1 escalation re-solve.
    # -1 = the solver's legacy formula max(iters//3, 6).  The re-solve
    # is a SERIAL pivot chain, and a warm-started refinement rarely needs
    # the full depth — the committed per-task values are the knees of
    # the CPU residual study (docs/SOLVERS.md).
    escalate_refine: int = dataclasses.field(
        default=-1, metadata=dict(static=True))
    # Two-tier escalation: when > 0, rows of the
    # escalated K batch still above escalate_tol after the warm tier-1
    # re-solve get a SECOND, COLD re-solve at this pivot budget (the
    # round-4 adjudication showed a cold start fixes offenders the
    # warm-from-a-bad-PGS-point pivot sequence cannot).  0 disables.
    escalate_iters2: int = dataclasses.field(
        default=0, metadata=dict(static=True))
    # Mixed-precision refinement passes applied to the escalated K batch:
    # f64 RESIDUAL + f32 correction solve at the point's own
    # friction-bound fixed sets (lcp/dantzig.refine_mixed).  Breaks the
    # f32 BPP precision ceiling on ill-conditioned operators (humanwalker
    # m=47: offenders f64-solvable to 1e-14 while f32 plateaus 1e-2-class
    # — docs/SOLVERS.md "Residual tails, adjudicated") WITHOUT f64
    # factorizations.  Requires jax_enable_x64; silently inert
    # otherwise.  0 disables.
    escalate_ref64: int = dataclasses.field(
        default=0, metadata=dict(static=True))
    # Compensated (double-float) refinement passes for the escalated K
    # batch (round 5): the SAME mixed-precision refinement as
    # escalate_ref64, with the residual computed by Dekker/Knuth
    # double-float f32 arithmetic (lcp/dantzig.refine_compensated) —
    # agrees with the f64-of-f32-inputs residual to ~2^-48 and needs NO
    # jax_enable_x64, so it is the production default tier.  When both
    # are set and x64 is on, ref64 wins (the studies' cross-check mode).
    # 0 disables.
    escalate_ref: int = dataclasses.field(
        default=0, metadata=dict(static=True))


def _static(default=None):
    return dataclasses.field(default=default, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SkelModel:
    """One articulated robot + static world geometry, as pure data.

    Bodies are topologically ordered (parent index < body index, root
    parent = -1).  Each body has exactly one inboard joint; `n` generalized
    coordinates with nq == nv == n (exp-map coordinates for ball/free).
    """

    # ---- static topology (python data, hashable) ----
    nb: int = _static(0)                       # number of bodies
    n: int = _static(0)                        # number of dofs
    parent: Tuple[int, ...] = _static(())      # (nb,) parent body index
    joint_type: Tuple[int, ...] = _static(())  # (nb,)
    q_start: Tuple[int, ...] = _static(())     # (nb,) first dof of joint i
    ndof: Tuple[int, ...] = _static(())        # (nb,)
    body_names: Tuple[str, ...] = _static(())
    joint_names: Tuple[str, ...] = _static(())
    # contact pair table: ((geom_idx, world_geom_idx), ...) robot-vs-world
    world_pairs: Tuple[Tuple[int, int], ...] = _static(())
    # robot-vs-robot (self collision) pairs
    self_pairs: Tuple[Tuple[int, int], ...] = _static(())
    dt: float = _static(0.002)                 # physics timestep (skel <physics>)
    name: str = _static("skel")
    solver: SolverConfig = _static(SolverConfig())
    # multi-skeleton worlds (model/compose.py): per source skeleton
    # (name, body_start, nb, dof_start, n); () = single skeleton
    skel_ranges: Tuple = _static(())

    # ---- joint frames: pose of joint frame J in parent body frame (T_pj)
    #      and in child body frame (T_cj); relative child pose =
    #      T_pj o JointT(q) o inv(T_cj)  (reference: Joint::mT_ParentBodyToJoint
    #      / mT_ChildBodyToJoint †) ----
    pj_rot: Any = None   # (nb, 3, 3)
    pj_pos: Any = None   # (nb, 3)
    cj_rot: Any = None   # (nb, 3, 3)
    cj_pos: Any = None   # (nb, 3)
    axes: Any = None     # (nb, 3, 3) joint axes, rows

    # ---- inertial ----
    mass: Any = None       # (nb,)
    com: Any = None        # (nb, 3) COM offset in body frame
    inertia: Any = None    # (nb, 3, 3) about COM, body frame

    # ---- per-dof ----
    damping: Any = None        # (n,)
    spring_stiff: Any = None   # (n,)
    rest_pos: Any = None       # (n,)
    dof_friction: Any = None   # (n,) Coulomb joint friction
    # (n,) servo-motor force limit per dof; > 0 adds a servo constraint row
    # driving dq toward the commanded velocity within +-flimit*dt impulse
    # (reference: dart/constraint/ServoMotorConstraint.cpp †)
    servo_flimit: Any = None
    q_lower: Any = None        # (n,)
    q_upper: Any = None        # (n,)
    limited: Any = None        # (n,) float mask {0, 1}
    q_init: Any = None         # (n,) skel-file default pose
    dq_init: Any = None        # (n,)
    # dofs affecting each body: static ancestry mask, (nb, n) in {0,1}
    ancestor_mask: Any = None

    # ---- robot collision geoms ----
    geom_body: Any = None   # (ng,) int body index
    geom_type: Any = None   # (ng,) int
    geom_size: Any = None   # (ng, 3)
    geom_rot: Any = None    # (ng, 3, 3) pose in body frame
    geom_pos: Any = None    # (ng, 3)
    geom_friction: Any = None     # (ng,)
    geom_restitution: Any = None  # (ng,)
    # mesh geoms (GEOM_MESH): per-geom mesh index (-1 = not a mesh, static)
    # and the padded vertex store.  The reference loads collision meshes
    # through assimp into FCL BVH models (`dart/dynamics/MeshShape.cpp` †,
    # SURVEY.md §2.4 "Shapes"); here a convex vertex cloud is baked into
    # the model pytree and collided analytically — static shapes, so a
    # vmapped top-k over vertices replaces the BVH traversal.
    geom_mesh: Tuple[int, ...] = _static(())
    mesh_verts: Any = None  # (n_mesh, Vmax, 3) body-frame vertices, padded
    mesh_vmask: Any = None  # (n_mesh, Vmax) {0,1} valid-vertex mask

    # ---- static world geoms: halfspaces (ground) ----
    wg_normal: Any = None   # (nw, 3) outward (up) normal
    wg_offset: Any = None   # (nw,) plane: n.x = offset
    wg_friction: Any = None     # (nw,)
    wg_restitution: Any = None  # (nw,)

    # ---- world ----
    gravity: Any = None     # (3,)

    @property
    def ng(self) -> int:
        return 0 if self.geom_body is None else int(self.geom_body.shape[-1])

    def dof_body_index(self) -> Tuple[int, ...]:
        """Static map dof -> owning body."""
        out = []
        for b in range(self.nb):
            out += [b] * self.ndof[b]
        return tuple(out)

    def replace(self, **kw) -> "SkelModel":
        return dataclasses.replace(self, **kw)


def ancestor_mask_np(parent: Tuple[int, ...], q_start: Tuple[int, ...],
                     ndof: Tuple[int, ...], n: int) -> np.ndarray:
    """(nb, n) mask: mask[i, d] = 1 iff dof d's joint is on the path
    root..body i (inclusive)."""
    nb = len(parent)
    mask = np.zeros((nb, n), dtype=np.float64)
    for i in range(nb):
        j = i
        while j >= 0:
            mask[i, q_start[j]:q_start[j] + ndof[j]] = 1.0
            j = parent[j]
    return mask
