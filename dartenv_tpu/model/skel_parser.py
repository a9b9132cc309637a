"""`.skel` world parser -> SkelModel(s).

JAX counterpart of `dart/utils/SkelParser.cpp:~1-3000` †
(SURVEY.md §2.4 "utils: parsers"): offline Python (stdlib xml.etree) that
turns the same `<world><physics>...<skeleton>...` XML into pure array data.
Honors the same defaults: dt from `<time_step>`, gravity from `<gravity>`
(y-up worlds, -9.81 y ‡), body `<transformation>` = zero-configuration world
pose, joint `<transformation>` = joint frame in the CHILD body frame, from
which the parent-side anchor is derived as
    T_pj = inv(T_world_parent) @ T_world_child @ T_cj.

Static (`<mobile>false</mobile>`) skeletons become world geometry: their
axis-aligned ground boxes convert to halfspaces at the top face (the five
tasks only ever use flat grounds ‡).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from dartenv_tpu.model import skel_model as sm
from dartenv_tpu.model.builder import (
    ModelBuilder, box_inertia, capsule_inertia, cylinder_inertia,
    ellipsoid_inertia,
    sphere_inertia,
)

_JOINT_TYPES = {
    "weld": sm.WELD,
    "revolute": sm.REVOLUTE,
    "prismatic": sm.PRISMATIC,
    "universal": sm.UNIVERSAL,
    "euler": sm.EULER,
    "ball": sm.BALL,
    "translational": sm.TRANSLATIONAL,
    "planar": sm.PLANAR,
    "free": sm.FREE,
    "screw": sm.SCREW,
}

_PLANES = {
    # translation axis 1, translation axis 2, rotation axis
    "xy": ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    "yz": ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
    "zx": ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
}


def _floats(text) -> np.ndarray:
    return np.asarray([float(x) for x in text.split()])


def euler_xyz_to_mat(r, p, y):
    """DART's eulerXYZToMatrix: R = Rx(r) @ Ry(p) @ Rz(y) †."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp_ = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp_], [0, 1, 0], [-sp_, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def euler_zyx_to_mat(r, p, y):
    """Fixed-axis roll-pitch-yaw: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
    (SDF <pose> convention; the reference SdfParser composes ZYX †)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp_ = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp_], [0, 1, 0], [-sp_, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _transform(elem) -> tuple:
    """<transformation>x y z r p y</transformation> -> (R, p)."""
    if elem is None:
        return np.eye(3), np.zeros(3)
    v = _floats(elem.text)
    return euler_xyz_to_mat(v[3], v[4], v[5]), v[:3]


def _t_mul(Ta, Tb):
    Ra, pa = Ta
    Rb, pb = Tb
    return Ra @ Rb, pa + Ra @ pb


def _t_inv(T):
    R, p = T
    return R.T, -R.T @ p


class ParsedShape:
    def __init__(self, gtype, size, T, inertia_fn, verts=None):
        self.gtype = gtype
        self.size = size
        self.T = T
        self.inertia_fn = inertia_fn
        self.verts = verts  # (V, 3) for GEOM_MESH


def _parse_shape(shape_elem, base_dir=None):
    """<collision_shape>/<visualization_shape> -> ParsedShape or None."""
    T = _transform(shape_elem.find("transformation"))
    geom = shape_elem.find("geometry")
    if geom is None:
        return None
    box = geom.find("box")
    if box is not None:
        full = _floats(box.find("size").text)
        half = full / 2.0
        return ParsedShape(sm.GEOM_BOX, half, T,
                           lambda m, h=half: box_inertia(m, h))
    sph = geom.find("sphere")
    if sph is not None:
        r = float(sph.find("radius").text)
        return ParsedShape(sm.GEOM_SPHERE, np.array([r, 0, 0]), T,
                           lambda m, r=r: sphere_inertia(m, r))
    cap = geom.find("capsule")
    if cap is not None:
        r = float(cap.find("radius").text)
        h = float(cap.find("height").text)
        return ParsedShape(sm.GEOM_CAPSULE, np.array([r, h / 2.0, 0]), T,
                           lambda m, r=r, h=h: capsule_inertia(m, r, h / 2.0))
    cyl = geom.find("cylinder")
    if cyl is not None:
        r = float(cyl.find("radius").text)
        h = float(cyl.find("height").text)
        return ParsedShape(sm.GEOM_CYLINDER, np.array([r, h / 2.0, 0]), T,
                           lambda m, r=r, h=h: cylinder_inertia(m, r, h))
    mesh = geom.find("mesh")
    if mesh is not None:
        from dartenv_tpu.model.builder import mesh_inertia
        from dartenv_tpu.model.mesh_loader import load_mesh

        fn_el = mesh.find("file_name")
        if fn_el is None or not fn_el.text:
            return None
        fn = fn_el.text.strip()
        sc_el = mesh.find("scale")
        scale = _floats(sc_el.text) if sc_el is not None else np.ones(3)
        path = fn
        if base_dir is not None and not os.path.isabs(fn):
            path = os.path.join(base_dir, fn)
        verts = load_mesh(path, scale=scale)
        return ParsedShape(sm.GEOM_MESH, np.zeros(3), T,
                           lambda m, v=verts: mesh_inertia(m, v),
                           verts=verts)
    ell = geom.find("ellipsoid")
    if ell is not None:
        full = _floats(ell.find("size").text)   # DART <size> = diameters ‡
        radii = full / 2.0
        return ParsedShape(sm.GEOM_ELLIPSOID, radii, T,
                           lambda m, rr=radii: ellipsoid_inertia(m, rr))
    return None


class ParsedWorld:
    """Physics config + per-skeleton models (last mobile skeleton = robot,
    matching `robot_skeleton = world.skeletons[-1]` †)."""

    def __init__(self, dt, gravity, skeletons, solver=None):
        self.dt = dt
        self.gravity = gravity
        self.skeletons = skeletons  # list of SkelModel (mobile only)

    @property
    def robot(self) -> sm.SkelModel:
        return self.skeletons[-1]

    @property
    def combined(self) -> sm.SkelModel:
        """ALL mobile skeletons composed into one block-diagonal model
        (reference: World::step iterates every skeleton †); equals `robot`
        for single-skeleton worlds.  See model/compose.py."""
        from dartenv_tpu.model.compose import compose_models

        return compose_models(self.skeletons)


def parse_skel(path: str, dtype=jnp.float32,
               solver: Optional[sm.SolverConfig] = None) -> ParsedWorld:
    tree = ET.parse(path)
    root = tree.getroot()
    world = root.find("world") if root.tag != "world" else root

    phys = world.find("physics")
    dt = 0.002
    gravity = np.array([0.0, -9.81, 0.0])
    if phys is not None:
        ts = phys.find("time_step")
        if ts is not None:
            dt = float(ts.text)
        gr = phys.find("gravity")
        if gr is not None:
            gravity = _floats(gr.text)

    # pass 1: collect static world geometry (halfspaces from ground boxes)
    halfspaces = []
    mobile_skels = []
    up = -gravity / max(np.linalg.norm(gravity), 1e-9)
    for skel in world.findall("skeleton"):
        mob = skel.find("mobile")
        is_static = mob is not None and mob.text.strip().lower() == "false"
        if is_static:
            T_skel = _transform(skel.find("transformation"))
            for body in skel.findall("body"):
                T_b = _t_mul(T_skel, _transform(body.find("transformation")))
                for cs in body.findall("collision_shape"):
                    shape = _parse_shape(cs)
                    if shape is None:
                        continue
                    Rg, pg = _t_mul(T_b, shape.T)
                    if shape.gtype == sm.GEOM_BOX:
                        # top-face halfspace: plane height = projection of
                        # the box center on `up` + half extents projected
                        h = float(up @ pg) + float(
                            np.abs(up @ Rg) @ shape.size
                        )
                        halfspaces.append((up.copy(), h))
                    else:
                        # non-box static shapes unused by the tasks ‡
                        pass
        else:
            mobile_skels.append(skel)

    models: List[sm.SkelModel] = []
    for skel in mobile_skels:
        models.append(
            _build_skeleton(skel, dt, gravity, halfspaces, dtype, solver,
                            base_dir=os.path.dirname(os.path.abspath(path)))
        )
    return ParsedWorld(dt, gravity, models)


def _axis_dynamics(joint, axis_names=("axis", "axis2", "axis3")):
    """Per-axis xyz/limits/damping/stiffness/friction."""
    axes, lowers, uppers, dampings, stiffs, frictions, limited = (
        [], [], [], [], [], [], []
    )
    for nm in axis_names:
        ax = joint.find(nm)
        if ax is None:
            continue
        xyz = ax.find("xyz")
        axes.append(_floats(xyz.text) if xyz is not None
                    else np.array([0.0, 0.0, 1.0]))
        lim = ax.find("limit")
        lo, hi, has_lim = -1e16, 1e16, 0.0
        if lim is not None:
            l_el, u_el = lim.find("lower"), lim.find("upper")
            if l_el is not None:
                lo = float(l_el.text)
                has_lim = 1.0
            if u_el is not None:
                hi = float(u_el.text)
                has_lim = 1.0
        lowers.append(lo)
        uppers.append(hi)
        limited.append(has_lim)
        dyn = ax.find("dynamics")
        damp, stiff, fric = 0.0, 0.0, 0.0
        if dyn is not None:
            d_el = dyn.find("damping")
            if d_el is not None:
                damp = float(d_el.text)
            s_el = dyn.find("spring_stiffness")
            if s_el is not None:
                stiff = float(s_el.text)
            f_el = dyn.find("friction")
            if f_el is not None:
                fric = float(f_el.text)
        dampings.append(damp)
        stiffs.append(stiff)
        frictions.append(fric)
    return axes, lowers, uppers, dampings, stiffs, frictions, limited


def _build_skeleton(skel, dt, gravity, halfspaces, dtype, solver,
                    base_dir=None):
    name = skel.get("name", "skeleton")
    T_skel = _transform(skel.find("transformation"))

    bodies = {}
    body_order = []
    for body in skel.findall("body"):
        bname = body.get("name")
        bodies[bname] = body
        body_order.append(bname)

    joints = {}
    child_to_joint = {}
    for joint in skel.findall("joint"):
        jname = joint.get("name", "joint")
        child = joint.find("child").text.strip()
        joints[jname] = joint
        child_to_joint[child] = joint

    # world poses at q=0
    T_world = {}
    for bname in body_order:
        T_world[bname] = _t_mul(
            T_skel, _transform(bodies[bname].find("transformation"))
        )

    # topological order: parents before children
    parent_of = {}
    for bname in body_order:
        joint = child_to_joint.get(bname)
        if joint is None:
            raise ValueError(f"body {bname} has no joint")
        p = joint.find("parent").text.strip()
        parent_of[bname] = None if p == "world" else p
    ordered = []
    remaining = list(body_order)
    while remaining:
        progressed = False
        for bname in list(remaining):
            p = parent_of[bname]
            if p is None or p in ordered:
                ordered.append(bname)
                remaining.remove(bname)
                progressed = True
        if not progressed:
            raise ValueError(f"cycle in skeleton {name}")

    b = ModelBuilder(dt=dt, gravity=gravity, name=name, solver=solver)
    q_init_all = []
    for bname in ordered:
        joint = child_to_joint[bname]
        jtype = _JOINT_TYPES[joint.get("type")]
        T_cj = _transform(joint.find("transformation"))
        pname = parent_of[bname]
        if pname is None:
            T_pj = _t_mul(T_world[bname], T_cj)
        else:
            T_pj = _t_mul(_t_mul(_t_inv(T_world[pname]), T_world[bname]),
                          T_cj)

        (axes, lowers, uppers, dampings, stiffs, frictions,
         limited) = _axis_dynamics(joint)
        if jtype == sm.PLANAR:
            plane = joint.find("plane")
            ptype = plane.get("type", "xy") if plane is not None else "xy"
            axes = [np.asarray(a, dtype=np.float64)
                    for a in _PLANES[ptype]]

        nd = sm.JOINT_NDOF[jtype]

        def _fit(vals, fill):
            vals = list(vals)
            while len(vals) < nd:
                vals.append(fill)
            return vals[:nd]

        has_any_limit = any(x > 0.5 for x in _fit(limited, 0.0))
        init_pos = joint.find("init_pos")
        q0 = (_floats(init_pos.text) if init_pos is not None
              else np.zeros(nd))
        q0 = list(np.atleast_1d(q0))
        while len(q0) < nd:
            q0.append(0.0)

        body = bodies[bname]
        inertia_el = body.find("inertia")
        mass = 1.0
        com = np.zeros(3)
        moi = None
        if inertia_el is not None:
            m_el = inertia_el.find("mass")
            if m_el is not None:
                mass = float(m_el.text)
            off = inertia_el.find("offset")
            if off is not None:
                com = _floats(off.text)
            moi_el = inertia_el.find("moment_of_inertia")
            if moi_el is not None:
                g = lambda t: float(moi_el.find(t).text) \
                    if moi_el.find(t) is not None else 0.0
                moi = np.array([
                    [g("ixx"), g("ixy"), g("ixz")],
                    [g("ixy"), g("iyy"), g("iyz")],
                    [g("ixz"), g("iyz"), g("izz")],
                ])

        shapes = []
        for cs in body.findall("collision_shape"):
            s = _parse_shape(cs, base_dir=base_dir)
            if s is not None:
                shapes.append((s, True))
        if not shapes:
            for vs in body.findall("visualization_shape"):
                s = _parse_shape(vs, base_dir=base_dir)
                if s is not None:
                    shapes.append((s, False))
        if moi is None:
            if shapes:
                # reference behavior: inertia from shape geometry
                # (rotated into the body frame)
                s0 = shapes[0][0]
                I_local = s0.inertia_fn(mass)
                Rs = s0.T[0]
                moi = Rs @ I_local @ Rs.T
            else:
                moi = np.eye(3) * 1e-8

        if len(axes) < 3:
            axes = axes + [(0.0, 0.0, 1.0)] * (3 - len(axes))

        b.add_body(
            bname, pname, jtype,
            axes=np.asarray(axes[:3], dtype=np.float64),
            pj_rot=T_pj[0], pj_pos=T_pj[1],
            cj_rot=T_cj[0], cj_pos=T_cj[1],
            mass=mass, com=com, inertia=moi,
            damping=_fit(dampings, 0.0),
            spring=_fit(stiffs, 0.0),
            dof_friction=_fit(frictions, 0.0),
            q_lower=_fit(lowers, -1e16) if has_any_limit else None,
            q_upper=_fit(uppers, 1e16) if has_any_limit else None,
            q_init=q0,
            joint_name=joint.get("name", bname + "_joint"),
            pitch=(float(joint.find("thread_pitch").text)
                   if joint.find("thread_pitch") is not None else 0.0),
        )
        for s, _col in shapes:
            if _col:
                if s.gtype == sm.GEOM_MESH:
                    b.add_mesh_geom(bname, s.verts, pos=s.T[1], rot=s.T[0],
                                    friction=1.0)
                else:
                    b.add_geom(bname, s.gtype, s.size, pos=s.T[1],
                               rot=s.T[0], friction=1.0)

    for n_up, off in halfspaces:
        b.add_ground(normal=n_up, offset=off, friction=1.0)
    return b.finalize(dtype=dtype)


def asset_path(fname: str) -> str:
    return os.path.join(os.path.dirname(__file__), "assets", fname)
