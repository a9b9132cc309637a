"""Closed-form primitive pair tests (branch-free, jit/vmap-safe).

JAX counterparts of the reference's narrowphase
(`dart/collision/dart/DARTCollide.cpp` † — ODE-derived box-box SAT with
face clipping — and FCL's convex pairs; SURVEY.md §2.4 "collision").
Everything here is fixed-shape: each function returns a static number of
candidate contact slots with depths; callers mask by depth sign.

Conventions (matching collision/narrowphase.py):
* normals point FROM the second object TOWARD the first ("toward body_a");
* depth > 0 means penetration; inactive slots just carry depth <= 0;
* determinism: candidate order is a static function of the pair, never of
  runtime values (contact order feeds LCP row order — SURVEY.md §7).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _safe_unit(v, fallback):
    n = jnp.linalg.norm(v)
    return jnp.where(n > 1e-9, v / jnp.maximum(n, 1e-9), fallback)


# ---------------------------------------------------------------------------
# vs-halfspace (plane {x : n.x >= offset}, n the outward/up unit normal)
# ---------------------------------------------------------------------------

def cylinder_halfspace(p, R, radius, half_h, n, offset):
    """Cylinder (axis local z) vs halfspace: 8 rim candidates (4 per cap).

    Resting on the side -> the two deepest are one per cap along the
    steepest-descent rim direction (a line contact); resting on an end cap
    -> that cap's 4 candidates span the disc (stable manifold).  Callers
    typically keep the top-4 by depth (DART/ODE emit <=3-4 points for a
    cylinder-plane pair †).
    """
    az = R[:, 2]
    # in-plane steepest descent direction on the rim; degenerate when the
    # axis is parallel to n (then any rim direction works: use local x)
    u = _safe_unit(n - jnp.dot(n, az) * az, R[:, 0])
    w = jnp.cross(az, u)
    caps = jnp.stack([p + half_h * az, p - half_h * az])       # (2, 3)
    dirs = jnp.stack([-u, u, w, -w]) * radius                  # (4, 3)
    pts = (caps[:, None, :] + dirs[None, :, :]).reshape(8, 3)
    dist = pts @ n - offset
    return pts - jnp.outer(dist, n), -dist                     # (8,3),(8,)


def ellipsoid_halfspace(p, R, radii, n, offset):
    """Ellipsoid (semi-axes `radii` along local axes) vs halfspace: the
    support point in -n, closed form."""
    nl = R.T @ n                        # normal in local frame
    er = radii * nl
    r_eff = jnp.linalg.norm(er)
    r_eff = jnp.maximum(r_eff, 1e-12)
    pt = p - R @ (radii * er) / r_eff   # support point in world
    dist = jnp.dot(pt, n) - offset
    return pt - dist * n, -dist         # (3,), ()


# ---------------------------------------------------------------------------
# sphere / capsule vs box
# ---------------------------------------------------------------------------

def _closest_on_box(c_local, h):
    """Closest point on an origin-centered AABB (half extents h) to c,
    plus penetration normal/depth handling for the interior case.

    Returns (point_local, normal_local, depth) where depth > 0 iff c is
    inside the box; for exterior points depth is the negative gap and the
    normal points from the box surface toward c.
    """
    clamped = jnp.clip(c_local, -h, h)
    delta = c_local - clamped
    gap = jnp.linalg.norm(delta)
    inside = gap < 1e-12
    # interior: push out through the nearest face
    face_d = h - jnp.abs(c_local)           # distance to each face pair
    k = jnp.argmin(face_d)
    sgn = jnp.where(c_local[k] >= 0.0, 1.0, -1.0)
    n_in = jnp.zeros(3, dtype=c_local.dtype).at[k].set(sgn)
    p_in = c_local.at[k].set(sgn * h[k])
    n_out = _safe_unit(delta, n_in)
    point = jnp.where(inside, p_in, clamped)
    normal = jnp.where(inside, n_in, n_out)
    depth = jnp.where(inside, face_d[k], -gap)
    return point, normal, depth


def sphere_box(c, r, Rb, pb, hb):
    """Sphere (center c, radius r) vs OBB: 1 candidate.
    Normal points from the box toward the sphere."""
    cl = Rb.T @ (c - pb)
    pt_l, n_l, depth_c = _closest_on_box(cl, hb)
    pos = Rb @ pt_l + pb
    normal = Rb @ n_l
    depth = depth_c + r           # center-inside adds r; outside: r - gap
    return pos, normal, depth


def capsule_box(pc, uc, hc, r, Rb, pb, hb, iters: int = 32):
    """Capsule (center pc, unit axis uc, half length hc, radius r) vs OBB:
    3 candidates — both endpoint spheres + the interior closest point
    (found by fixed-trip-count ternary search on the convex distance
    t -> dist(segment(t), box); branch-free).  The interior candidate is
    masked (depth -inf) when it coincides with an endpoint so flat resting
    yields exactly the two endpoint contacts.
    """
    def box_dist2(t):
        cl = Rb.T @ ((pc + t * uc) - pb)
        d = cl - jnp.clip(cl, -hb, hb)
        return jnp.dot(d, d)

    # ternary search over t in [-hc, hc]
    def body(_, ab):
        a, b_ = ab
        m1 = a + (b_ - a) / 3.0
        m2 = b_ - (b_ - a) / 3.0
        go_right = box_dist2(m1) > box_dist2(m2)
        return (jnp.where(go_right, m1, a), jnp.where(go_right, b_, m2))

    a0 = jnp.asarray(-hc, dtype=pc.dtype)
    b0 = jnp.asarray(hc, dtype=pc.dtype)
    a_f, b_f = jax.lax.fori_loop(0, iters, body, (a0, b0))
    t_star = 0.5 * (a_f + b_f)

    ends = jnp.stack([pc + hc * uc, pc - hc * uc, pc + t_star * uc])
    pos, normal, depth = jax.vmap(
        lambda c: sphere_box(c, r, Rb, pb, hb)
    )(ends)
    # degenerate interior point == an endpoint: drop it (mask via depth)
    near_end = jnp.minimum(jnp.abs(t_star - hc), jnp.abs(t_star + hc)) \
        < 1e-4 * jnp.maximum(hc, 1e-9)
    depth = depth.at[2].set(jnp.where(near_end, -1e9, depth[2]))
    return pos, normal, depth     # (3,3),(3,3),(3,)


# ---------------------------------------------------------------------------
# box vs box: SAT + reference-face clipping (ODE dBoxBox structure †,
# re-derived; deterministic 4-point manifold)
# ---------------------------------------------------------------------------

_EDGE_PAIRS = np.array([(i, j) for i in range(3) for j in range(3)])


def _face_clip(ref_R, ref_p, ref_h, ref_axis_k, ref_sign,
               inc_R, inc_p, inc_h, dtype):
    """Clip the incident box face against the reference face's 4 side
    planes (Sutherland-Hodgman on fixed-size vertex rings).

    Returns (points (8, 3) world, depth (8,), valid (8,)) measured along
    the reference face normal.
    """
    # reference face frame: normal = ref_sign * ref_R[:, k], tangent axes
    n_ref = ref_sign * ref_R[:, ref_axis_k]
    i1 = (ref_axis_k + 1) % 3
    i2 = (ref_axis_k + 2) % 3
    t1, t2 = ref_R[:, i1], ref_R[:, i2]
    face_c = ref_p + n_ref * ref_h[ref_axis_k]

    # incident face on the other box: the face whose outward normal is most
    # anti-parallel to n_ref
    dots = n_ref @ inc_R                  # (3,) per local axis
    k_inc = jnp.argmax(jnp.abs(dots))
    s_inc = -jnp.sign(dots[k_inc] + 1e-30)   # outward normal ~ -n_ref
    n_inc_l = jnp.zeros(3, dtype=dtype).at[k_inc].set(1.0)
    # the 4 verts of the incident face, local: x[k_inc] = s_inc*h, others +-h
    j1 = (k_inc + 1) % 3
    j2 = (k_inc + 2) % 3
    e1 = jnp.zeros(3, dtype=dtype).at[j1].set(1.0)
    e2 = jnp.zeros(3, dtype=dtype).at[j2].set(1.0)
    h1 = inc_h @ e1
    h2 = inc_h @ e2
    base = n_inc_l * (s_inc * (inc_h @ n_inc_l))
    quad_l = jnp.stack([
        base + h1 * e1 + h2 * e2,
        base - h1 * e1 + h2 * e2,
        base - h1 * e1 - h2 * e2,
        base + h1 * e1 - h2 * e2,
    ])
    verts = quad_l @ inc_R.T + inc_p      # (4, 3) world

    # ring of 8 with validity mask; valid vertices are always COMPACTED to
    # the front, in polygon (ring) order.  Clip against the 4 side planes
    # of the reference face: |(x - face_c). t| <= h_t
    pts = jnp.concatenate([verts, jnp.zeros((4, 3), dtype=dtype)])
    valid = jnp.concatenate([jnp.ones(4, bool), jnp.zeros(4, bool)])

    def clip(pts_valid, plane):
        pts, valid = pts_valid
        t_axis, h_t, sgn = plane          # clip to sgn*(x-face_c).t <= h_t
        d = sgn * ((pts - face_c) @ t_axis) - h_t   # >0 = outside
        nv = pts.shape[0]
        k_valid = jnp.sum(valid)          # valid entries are 0..k_valid-1
        ar = jnp.arange(nv)
        # ring successor: wrap the LAST valid vertex back to slot 0 (the
        # compacted layout guarantees contiguity)
        nxt = jnp.where(ar == k_valid - 1, 0, ar + 1)
        valid_next = valid[nxt]
        p_next = pts[nxt]
        d_next = d[nxt]
        inside = d <= 0.0
        inside_next = d_next <= 0.0
        # each (current, next) edge contributes: current point if inside,
        # plus an intersection point if the edge crosses the plane
        denom = d - d_next
        tpar = d / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
        cross_pt = pts + (p_next - pts) * tpar[:, None]
        crossing = valid & valid_next & (inside != inside_next)
        keep = valid & inside
        # interleave kept verts and crossings (preserves ring order), then
        # compact valid-first with a stable sort
        out_pts = jnp.zeros((2 * nv, 3), dtype=dtype)
        out_valid = jnp.zeros(2 * nv, bool)
        out_pts = out_pts.at[0::2].set(pts)
        out_valid = out_valid.at[0::2].set(keep)
        out_pts = out_pts.at[1::2].set(cross_pt)
        out_valid = out_valid.at[1::2].set(crossing)
        order = jnp.argsort(jnp.where(out_valid, 0, 1), stable=True)
        out_pts = out_pts[order][:nv]     # a quad clipped by <=4 planes
        out_valid = out_valid[order][:nv]  # has <=8 verts: 8 slots suffice
        return (out_pts, out_valid), None

    planes = [
        (t1, ref_h[i1], jnp.asarray(1.0, dtype)),
        (t1, ref_h[i1], jnp.asarray(-1.0, dtype)),
        (t2, ref_h[i2], jnp.asarray(1.0, dtype)),
        (t2, ref_h[i2], jnp.asarray(-1.0, dtype)),
    ]
    state = (pts, valid)
    for pl in planes:
        state, _ = clip(state, pl)
    pts, valid = state

    # depth of each kept point below the reference face plane
    depth = -((pts - face_c) @ n_ref)
    depth = jnp.where(valid, depth, -jnp.inf)
    # project points onto the reference face (ODE reports points on the
    # penetrating surface; DART midpoints — we use the incident points,
    # consistent with the halfspace pairs reporting the deep point)
    return pts, depth


def box_box(Ra, pa, ha, Rb, pb, hb):
    """OBB vs OBB: SAT over 15 axes + face clipping.  4 candidates.

    Normal points from box b toward box a.  Face contacts produce up to 4
    clipped points; edge-edge contacts produce 1 (the other slots carry
    depth = -inf).  Axis choice uses ODE's fudge (edge axes need 5% more
    penetration to win) for manifold stability †.
    """
    dtype = pa.dtype
    R = Ra.T @ Rb                         # b's axes in a's frame
    t = Ra.T @ (pb - pa)
    absR = jnp.abs(R) + 1e-9

    # 6 face axes
    dep_a = (ha + absR @ hb) - jnp.abs(t)             # (3,) a's axes
    dep_b = (hb + absR.T @ ha) - jnp.abs(t @ R)       # (3,) b's axes

    # 9 edge-edge axes: l = a_i x b_j (in a's frame)
    ei = _EDGE_PAIRS[:, 0]
    ej = _EDGE_PAIRS[:, 1]
    eye = jnp.eye(3, dtype=dtype)
    axes_e = jnp.cross(eye[ei], R.T[ej])              # (9, 3) a-frame
    norm_e = jnp.linalg.norm(axes_e, axis=1)
    unit_e = axes_e / jnp.maximum(norm_e, 1e-9)[:, None]
    ra_e = jnp.abs(unit_e) @ ha
    rb_e = jnp.abs(unit_e @ R) @ hb
    dep_e = (ra_e + rb_e) - jnp.abs(unit_e @ t)
    # degenerate (parallel edges) axes are skipped
    dep_e = jnp.where(norm_e > 1e-6, dep_e, jnp.inf)

    deps = jnp.concatenate([dep_a, dep_b, dep_e * 1.05 + 1e-9])
    separated = jnp.min(deps) < 0.0
    code = jnp.argmin(deps)               # 0-2 faceA, 3-5 faceB, 6-14 edge

    # ---- face-face manifolds (computed for both orientations, selected) --
    def face_manifold(use_a):
        k = jnp.where(use_a, code, code - 3)
        onehot = (jnp.arange(3) == k).astype(dtype)
        refR = jnp.where(use_a, Ra, Rb)
        incR = jnp.where(use_a, Rb, Ra)
        refp = jnp.where(use_a, pa, pb)
        incp = jnp.where(use_a, pb, pa)
        refh = jnp.where(use_a, ha, hb)
        inch = jnp.where(use_a, hb, ha)
        # world axis k of the reference box
        axis_w = refR @ onehot
        to_other = incp - refp
        sgn = jnp.sign(jnp.dot(axis_w, to_other) + 1e-30)
        # clip needs a static axis index: compute for all three and select
        outs = []
        for kk in range(3):
            pts_k, dep_k = _face_clip(refR, refp, refh, kk, sgn,
                                      incR, incp, inch, dtype)
            outs.append((pts_k, dep_k))
        pts = jnp.stack([o[0] for o in outs])   # (3, 8, 3)
        dep = jnp.stack([o[1] for o in outs])   # (3, 8)
        sel = onehot > 0.5
        # NB: dep rows hold -inf on invalid slots, so select with a masked
        # max (0 * -inf in an einsum would poison the result with NaN)
        pts = jnp.where(sel[:, None, None], pts, 0.0).sum(0)
        dep = jnp.where(sel[:, None], dep, -jnp.inf).max(0)
        n_world = sgn * axis_w                  # ref -> incident direction
        return pts, dep, n_world

    pts_fa, dep_fa, n_fa = face_manifold(jnp.asarray(True))
    pts_fb, dep_fb, n_fb = face_manifold(jnp.asarray(False))

    # ---- edge-edge single contact ----------------------------------------
    ecode = jnp.clip(code - 6, 0, 8)
    onehot_e = (jnp.arange(9) == ecode).astype(dtype)
    ui_l = eye[ei]                       # (9,3) a-frame unit of a's edge
    uj_l = R.T[ej]                       # b's edge dir in a-frame? rows
    l_a = onehot_e @ unit_e              # chosen axis, a-frame
    sgn_e = jnp.sign(jnp.dot(l_a, t) + 1e-30)
    n_edge_a = -sgn_e * l_a              # from b toward a, a-frame
    # supporting edge on a: corner maximizing x . (sgn_e*l) among +-h
    ca = jnp.sign(l_a * sgn_e) * ha
    ua = onehot_e @ ui_l
    ca = ca - ca * jnp.abs(ua)           # zero the component along the edge
    # supporting edge on b (work in a-frame): center t, axes columns of R
    l_b = (onehot_e @ unit_e) @ R        # axis in b's local coords? (l in a-frame) dot columns
    ub_l = jnp.zeros(3, dtype=dtype).at[0].set(0.0)
    ub_onehot = (jnp.arange(3)[None, :] == ej[:, None]).astype(dtype)
    ub_sel = onehot_e @ ub_onehot        # one-hot of b's edge axis index
    cb_l = -jnp.sign(l_b * sgn_e) * hb
    cb_l = cb_l - cb_l * ub_sel
    cb = t + R @ cb_l                    # b-edge center, a-frame
    ub = R @ ub_sel
    # closest points of the two edge lines
    r_ab = ca - cb
    d1 = jnp.dot(ua, ub)
    denom = jnp.maximum(1.0 - d1 * d1, 1e-9)
    s_par = (d1 * jnp.dot(ub, r_ab) - jnp.dot(ua, r_ab)) / denom
    t_par = (jnp.dot(ub, r_ab) - d1 * jnp.dot(ua, r_ab)) / denom
    p_edge_a = ca + s_par * ua
    p_edge_b = cb + t_par * ub
    pt_edge = Ra @ (0.5 * (p_edge_a + p_edge_b)) + pa
    # masked select (dep_e holds +inf on degenerate axes; see above)
    dep_edge = jnp.where(jnp.arange(9) == ecode, dep_e, -jnp.inf).max()
    n_edge = Ra @ n_edge_a

    # ---- select ----------------------------------------------------------
    is_fa = code < 3
    is_fb = (code >= 3) & (code < 6)
    neg_inf = jnp.full((8,), -jnp.inf, dtype=dtype)
    pts_edge8 = jnp.zeros((8, 3), dtype=dtype).at[0].set(pt_edge)
    dep_edge8 = neg_inf.at[0].set(dep_edge)

    pts = jnp.where(is_fa, pts_fa, jnp.where(is_fb, pts_fb, pts_edge8))
    dep = jnp.where(is_fa, dep_fa, jnp.where(is_fb, dep_fb, dep_edge8))
    # normal: for faceA the reference normal points a->b, so the contact
    # normal (b toward a) is its negation; for faceB it already points
    # b->a; edge normal computed directly
    normal = jnp.where(is_fa, -n_fa, jnp.where(is_fb, n_fb, n_edge))

    top_d, top_i = jax.lax.top_k(dep, 4)
    top_d = jnp.where(separated, -jnp.inf, top_d)
    top_d = jnp.where(jnp.isfinite(top_d), top_d, -1.0)
    return pts[top_i], jnp.broadcast_to(normal, (4, 3)), top_d
