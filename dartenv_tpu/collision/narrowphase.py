"""Analytic primitive collision (fixed contact slots, masked).

JAX replacement of the reference collision stack
(`dart/collision/**` †: FCL/dart-native narrowphase + manifold generation —
SURVEY.md §2.4 "collision").  The five tasks only need primitive-vs-halfspace
(and optionally primitive-vs-primitive self pairs), so instead of a general
GJK engine we use closed-form pair tests with a *static* contact-slot layout:
every (geom, world-geom) pair contributes a fixed number of slots
(sphere: 1, capsule: 2, box: 4), each slot permanently tied to one body.
Inactive slots are masked — shapes never change under jit.

Determinism: slot order is the static pair order; within a pair, capsule
endpoints are ordered (end0, end1) and box corners are ranked by depth with
`top_k` (stable) — contact ordering feeds the LCP row order and therefore
matters for reproducibility (SURVEY.md §7 hard parts).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.collision.primitives import (
    box_box, capsule_box, cylinder_halfspace, ellipsoid_halfspace,
    sphere_box,
)
from dartenv_tpu.model.skel_model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_ELLIPSOID, GEOM_MESH,
    GEOM_SPHERE, SkelModel,
)

# contact slots a geom contributes against a halfspace
_WORLD_SLOTS = {GEOM_SPHERE: 1, GEOM_CAPSULE: 2, GEOM_BOX: 4,
                GEOM_CYLINDER: 4, GEOM_ELLIPSOID: 1, GEOM_MESH: 4}


def _self_pair_slots(ta: int, tb: int) -> int:
    """Contact slots for a robot-robot pair, by (unordered) type pair."""
    key = frozenset((ta, tb))
    if key <= {GEOM_SPHERE, GEOM_CAPSULE}:
        return 1                       # sphere/capsule closest-point pair
    if key == {GEOM_BOX}:
        return 4                       # SAT face manifold
    if key == {GEOM_CAPSULE, GEOM_BOX}:
        return 3                       # 2 endpoint spheres + interior
    if key == {GEOM_SPHERE, GEOM_BOX}:
        return 1
    # every remaining convex combination (mesh-vs-anything, cylinder /
    # ellipsoid pairs) goes through the swept-cloud SAT path — the
    # batched analogue of the reference's FCL GJK general-pair engine
    # (`dart/collision/**` †; collision/support.py)
    from dartenv_tpu.collision.support import SLOTS

    return SLOTS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Contacts:
    """Fixed-capacity contact set for one env.  Slot body indices are static
    (`slot_body` lives on the layout, not here)."""

    pos: Any        # (nc, 3) world contact position
    normal: Any     # (nc, 3) world normal, pointing toward the robot body
    depth: Any      # (nc,)  penetration depth (>=0 when active)
    active: Any     # (nc,)  {0., 1.}
    friction: Any   # (nc,)
    restitution: Any  # (nc,)
    # () active slots beyond SolverConfig.contact_cap this substep (0 when
    # the cap is off or fits).  Nonzero means the LCP silently dropped
    # contacts — surfaced via step info["contact_overflow"] and the
    # checkify debug mode (VERDICT.md r1 weak #3).
    overflow: Any = 0.0


def slot_layout(
    model: SkelModel,
) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """Static slot metadata: (slot_body_a, slot_body_b, slot_geom) per
    contact slot.  body_b == -1 for world (halfspace) slots; self pairs
    (robot-geom vs robot-geom) carry both body indices so the constraint
    layer builds relative-velocity Jacobian rows (J_a - J_b)."""
    geom_body = np.asarray(model.geom_body)
    geom_type = np.asarray(model.geom_type)
    bodies_a: List[int] = []
    bodies_b: List[int] = []
    geoms: List[int] = []
    for gi, _ in model.world_pairs:
        npts = _WORLD_SLOTS[int(geom_type[gi])]
        bodies_a += [int(geom_body[gi])] * npts
        bodies_b += [-1] * npts
        geoms += [int(gi)] * npts
    for ga, gb in model.self_pairs:
        npts = _self_pair_slots(int(geom_type[ga]), int(geom_type[gb]))
        bodies_a += [int(geom_body[ga])] * npts
        bodies_b += [int(geom_body[gb])] * npts
        geoms += [int(ga)] * npts
    return tuple(bodies_a), tuple(bodies_b), tuple(geoms)


def num_slots(model: SkelModel) -> int:
    return len(slot_layout(model)[0])


def _closest_on_segment(p, a, hl, u):
    """Closest point to p on segment {a + t*u, |t| <= hl} (u unit)."""
    t = jnp.clip(jnp.dot(p - a, u), -hl, hl)
    return a + t * u


def _segment_segment(pa, ua, ha, pb, ub, hb):
    """Closest points between two segments (centers p, unit dirs u,
    half-lengths h).  Standard clamped-parameter solve (Ericson RTCD 5.1.9
    structure), branch-free for jit."""
    r = pa - pb
    a = 1.0
    e = 1.0
    b = jnp.dot(ua, ub)
    c = jnp.dot(ua, r)
    f = jnp.dot(ub, r)
    denom = a * e - b * b      # = 1 - b^2 >= 0
    # non-parallel closest params on the infinite lines, clamped
    s = jnp.where(denom > 1e-9, (b * f - c * e) / jnp.maximum(denom, 1e-9),
                  0.0)
    s = jnp.clip(s, -ha, ha)
    t = jnp.clip(b * s + f, -hb, hb)
    s = jnp.clip(b * t - c, -ha, ha)
    return pa + s * ua, pb + t * ub


def _pair_points(model, gi, R, p):
    """(center, radius, axis, half_len) of a sphere/capsule geom in world."""
    gt = int(np.asarray(model.geom_type)[gi])
    r = model.geom_size[gi, 0]
    if gt == GEOM_SPHERE:
        return p, r, None, None
    assert gt == GEOM_CAPSULE
    return p, r, R[:, 2], model.geom_size[gi, 1]


def _round_pair(model, ga, gb, Ra, pa, Rb, pb):
    """One contact for a sphere/capsule self pair.  Normal points from geom
    b toward geom a (matching the world-pair convention: toward body_a)."""
    ca, ra, ua, ha = _pair_points(model, ga, Ra, pa)
    cb, rb, ub, hb = _pair_points(model, gb, Rb, pb)
    if ua is None and ub is None:
        qa, qb = ca, cb
    elif ua is None:
        qb = _closest_on_segment(ca, cb, hb, ub)
        qa = ca
    elif ub is None:
        qa = _closest_on_segment(cb, ca, ha, ua)
        qb = cb
    else:
        qa, qb = _segment_segment(ca, ua, ha, cb, ub, hb)
    d = qa - qb
    dist = jnp.linalg.norm(d)
    # jit-safe normal for the coincident case (masked out by depth anyway)
    n = d / jnp.maximum(dist, 1e-9)
    depth = (ra + rb) - dist
    # contact point: midpoint of the two surface points
    pos = 0.5 * ((qa - n * ra) + (qb + n * rb))
    return pos[None], n[None], depth[None]


def collide_self_pair(model: SkelModel, ga: int, gb: int, Ra, pa, Rb, pb):
    """Robot-robot pair dispatch: returns (pos (k,3), normal (k,3),
    depth (k,)) with the static slot count of `_self_pair_slots`.  Normals
    point from geom b toward geom a."""
    geom_type = np.asarray(model.geom_type)
    ta, tb = int(geom_type[ga]), int(geom_type[gb])

    if {ta, tb} <= {GEOM_SPHERE, GEOM_CAPSULE}:
        return _round_pair(model, ga, gb, Ra, pa, Rb, pb)

    if ta == GEOM_BOX and tb == GEOM_BOX:
        return box_box(Ra, pa, model.geom_size[ga],
                       Rb, pb, model.geom_size[gb])

    # mixed round-vs-box: primitives take (round, box) and return normals
    # box->round; flip when the BOX is geom a so normals stay b->a
    if GEOM_BOX in (ta, tb) and {ta, tb} <= {GEOM_BOX, GEOM_SPHERE,
                                             GEOM_CAPSULE}:
        flip = ta == GEOM_BOX
        g_r, R_r, p_r = (gb, Rb, pb) if flip else (ga, Ra, pa)
        g_b, R_b, p_b = (ga, Ra, pa) if flip else (gb, Rb, pb)
        t_r = int(geom_type[g_r])
        hb = model.geom_size[g_b]
        if t_r == GEOM_SPHERE:
            pos, n, dep = sphere_box(p_r, model.geom_size[g_r, 0],
                                     R_b, p_b, hb)
            pos, n, dep = pos[None], n[None], dep[None]
        else:
            assert t_r == GEOM_CAPSULE
            pos, n, dep = capsule_box(
                p_r, R_r[:, 2], model.geom_size[g_r, 1],
                model.geom_size[g_r, 0], R_b, p_b, hb)
        if flip:
            n = -n
        return pos, n, dep

    # general convex pair: swept-cloud direction-set SAT
    from dartenv_tpu.collision.support import collide_support_pair

    return collide_support_pair(model, ga, gb, Ra, pa, Rb, pb)


def _halfspace_point(p, r, normal, offset):
    """Sphere of radius r centered at p vs halfspace {x: n.x >= offset}."""
    dist = jnp.dot(normal, p) - offset
    depth = r - dist
    pos = p - normal * dist
    return pos, depth


def collide(model: SkelModel, R_w, p_w) -> Contacts:
    """All world pairs, single env.  R_w: (nb,3,3), p_w: (nb,3)."""
    geom_type = np.asarray(model.geom_type)
    pos_l, nrm_l, dep_l, fr_l, re_l = [], [], [], [], []
    for gi, wi in model.world_pairs:
        gt = int(geom_type[gi])
        b = None  # resolved below via model arrays (static index ok)
        bidx = int(np.asarray(model.geom_body)[gi])
        Rg = R_w[bidx] @ model.geom_rot[gi]
        pg = p_w[bidx] + R_w[bidx] @ model.geom_pos[gi]
        n = model.wg_normal[wi]
        off = model.wg_offset[wi]
        fric = jnp.minimum(model.geom_friction[gi], model.wg_friction[wi])
        rest = jnp.maximum(model.geom_restitution[gi],
                           model.wg_restitution[wi])
        if gt == GEOM_SPHERE:
            r = model.geom_size[gi, 0]
            cpos, cdep = _halfspace_point(pg, r, n, off)
            pos_l.append(cpos[None])
            nrm_l.append(n[None])
            dep_l.append(cdep[None])
            fr_l.append(fric[None])
            re_l.append(rest[None])
        elif gt == GEOM_CAPSULE:
            r, hl = model.geom_size[gi, 0], model.geom_size[gi, 1]
            axis = Rg[:, 2]
            ends = jnp.stack([pg + axis * hl, pg - axis * hl])
            cpos, cdep = jax.vmap(
                lambda e: _halfspace_point(e, r, n, off)
            )(ends)
            pos_l.append(cpos)
            nrm_l.append(jnp.broadcast_to(n, (2, 3)))
            dep_l.append(cdep)
            fr_l.append(jnp.broadcast_to(fric, (2,)))
            re_l.append(jnp.broadcast_to(rest, (2,)))
        elif gt == GEOM_BOX:
            h = model.geom_size[gi]
            corners = jnp.asarray(
                np.array([[sx, sy, sz] for sx in (-1.0, 1.0)
                          for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]),
                dtype=p_w.dtype,
            ) * h
            cw = pg + corners @ Rg.T
            dist = cw @ n - off
            depth = -dist
            top_d, top_i = jax.lax.top_k(depth, 4)
            cpos = cw[top_i] - jnp.outer(dist[top_i], n)
            pos_l.append(cpos)
            nrm_l.append(jnp.broadcast_to(n, (4, 3)))
            dep_l.append(top_d)
            fr_l.append(jnp.broadcast_to(fric, (4,)))
            re_l.append(jnp.broadcast_to(rest, (4,)))
        elif gt == GEOM_CYLINDER:
            r, hh = model.geom_size[gi, 0], model.geom_size[gi, 1]
            cpos8, cdep8 = cylinder_halfspace(pg, Rg, r, hh, n, off)
            top_d, top_i = jax.lax.top_k(cdep8, 4)
            pos_l.append(cpos8[top_i])
            nrm_l.append(jnp.broadcast_to(n, (4, 3)))
            dep_l.append(top_d)
            fr_l.append(jnp.broadcast_to(fric, (4,)))
            re_l.append(jnp.broadcast_to(rest, (4,)))
        elif gt == GEOM_ELLIPSOID:
            cpos, cdep = ellipsoid_halfspace(pg, Rg, model.geom_size[gi],
                                             n, off)
            pos_l.append(cpos[None])
            nrm_l.append(n[None])
            dep_l.append(cdep[None])
            fr_l.append(fric[None])
            re_l.append(rest[None])
        elif gt == GEOM_MESH:
            # convex vertex cloud vs halfspace: 4-point manifold from the
            # deepest vertices (same rule as the box corner manifold —
            # GEOM_BOX is the 8-vertex special case).  Padded vertices are
            # masked to -inf depth so top_k never selects them.
            mi = model.geom_mesh[gi]
            verts = model.mesh_verts[mi]          # (V, 3) body frame
            vmask = model.mesh_vmask[mi]          # (V,)
            vw = pg + verts @ Rg.T                # world vertices
            dist = vw @ n - off
            # finite sentinel (not -inf): padded slots must stay inert in
            # downstream arithmetic (active = depth > 0), not produce NaNs
            depth = jnp.where(vmask > 0.5, -dist, -1e9)
            top_d, top_i = jax.lax.top_k(depth, 4)
            cpos = vw[top_i] - jnp.outer(dist[top_i], n)
            pos_l.append(cpos)
            nrm_l.append(jnp.broadcast_to(n, (4, 3)))
            dep_l.append(top_d)
            fr_l.append(jnp.broadcast_to(fric, (4,)))
            re_l.append(jnp.broadcast_to(rest, (4,)))
        else:
            raise NotImplementedError(f"geom type {gt} vs halfspace")
    for ga, gb in model.self_pairs:
        ba = int(np.asarray(model.geom_body)[ga])
        bb = int(np.asarray(model.geom_body)[gb])
        Ra = R_w[ba] @ model.geom_rot[ga]
        pa = p_w[ba] + R_w[ba] @ model.geom_pos[ga]
        Rb = R_w[bb] @ model.geom_rot[gb]
        pb = p_w[bb] + R_w[bb] @ model.geom_pos[gb]
        cpos, n, cdep = collide_self_pair(model, ga, gb, Ra, pa, Rb, pb)
        k = cpos.shape[0]
        fric = jnp.minimum(model.geom_friction[ga], model.geom_friction[gb])
        rest = jnp.maximum(model.geom_restitution[ga],
                           model.geom_restitution[gb])
        pos_l.append(cpos)
        nrm_l.append(n)
        dep_l.append(cdep)
        fr_l.append(jnp.broadcast_to(fric, (k,)))
        re_l.append(jnp.broadcast_to(rest, (k,)))
    if not pos_l:
        z3 = jnp.zeros((0, 3), dtype=p_w.dtype)
        z = jnp.zeros((0,), dtype=p_w.dtype)
        return Contacts(pos=z3, normal=z3, depth=z, active=z,
                        friction=z, restitution=z,
                        overflow=jnp.zeros((), dtype=p_w.dtype))
    depth = jnp.concatenate(dep_l)
    eps = model.solver.contact_eps
    active = (depth > eps).astype(p_w.dtype)
    cap = int(model.solver.contact_cap)
    n_active = jnp.sum(active)
    if cap and cap < active.shape[0]:
        overflow = jnp.maximum(n_active - cap, 0.0)
    else:
        overflow = jnp.zeros((), dtype=p_w.dtype)
    return Contacts(
        pos=jnp.concatenate(pos_l),
        normal=jnp.concatenate(nrm_l),
        depth=depth,
        active=active,
        friction=jnp.concatenate(fr_l),
        restitution=jnp.concatenate(re_l),
        overflow=overflow,
    )
