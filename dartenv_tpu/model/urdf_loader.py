"""URDF robot parser -> SkelModel.

JAX counterpart of the reference's URDF path
(`dart/utils/urdf/DartLoader.cpp` † on urdfdom — SURVEY.md §2.4 "utils:
parsers"): offline Python (stdlib xml.etree) producing the same pure-array
`SkelModel` the .skel parser emits, so URDF robots drop into the identical
jittable engine.

URDF conventions honored:
* `<joint><origin>` is the joint (== child link) frame in the PARENT link
  frame -> T_pj = origin, T_cj = identity;
* `<inertial><origin>` gives the COM offset and inertia frame in the link
  frame (inertia rotated into the link frame);
* joint types: fixed -> WELD, revolute/continuous -> REVOLUTE (continuous
  unlimited), prismatic -> PRISMATIC, floating -> FREE, planar -> PLANAR;
* `<limit lower upper>` / `<dynamics damping friction>` map to per-dof
  arrays (effort/velocity limits are recorded but unenforced, as in DART ‡);
* geometry: sphere and box map exactly; cylinder maps to a capsule of equal
  radius and cylinder half-length (DART renders true cylinders but the
  tasks' collision set here is primitive-vs-halfspace/primitive — the
  capsule approximation is conservative at the caps); mesh geometry is
  rejected with a clear error (out of scope, SURVEY.md §2.4 L0 row).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from dartenv_tpu.model import skel_model as sm
from dartenv_tpu.model.builder import (
    ModelBuilder, box_inertia, capsule_inertia, cylinder_inertia,
    sphere_inertia, rpy_to_mat,
)

_JOINT_TYPES = {
    "fixed": sm.WELD,
    "revolute": sm.REVOLUTE,
    "continuous": sm.REVOLUTE,
    "prismatic": sm.PRISMATIC,
    "floating": sm.FREE,
    "planar": sm.PLANAR,
}


def _floats(text, default=None):
    if text is None:
        return default
    return np.asarray([float(x) for x in text.split()], dtype=np.float64)


def _origin(elem):
    """(R, p) of an <origin xyz rpy> child (identity if absent)."""
    if elem is None:
        return np.eye(3), np.zeros(3)
    o = elem.find("origin")
    if o is None:
        return np.eye(3), np.zeros(3)
    xyz = _floats(o.get("xyz"), np.zeros(3))
    rpy = _floats(o.get("rpy"), np.zeros(3))
    return rpy_to_mat(*rpy), xyz


def _geometry(geom_elem, base_dir=None):
    """-> (gtype, size(3,), inertia_fn) or raises on meshes."""
    box = geom_elem.find("box")
    if box is not None:
        half = _floats(box.get("size")) / 2.0
        return sm.GEOM_BOX, half, lambda m: box_inertia(m, half)
    sph = geom_elem.find("sphere")
    if sph is not None:
        r = float(sph.get("radius"))
        return (sm.GEOM_SPHERE, np.array([r, 0.0, 0.0]),
                lambda m: sphere_inertia(m, r))
    cyl = geom_elem.find("cylinder")
    if cyl is not None:
        r = float(cyl.get("radius"))
        ln = float(cyl.get("length"))
        return (sm.GEOM_CAPSULE, np.array([r, ln / 2.0, 0.0]),
                lambda m: cylinder_inertia(m, r, ln))
    mesh = geom_elem.find("mesh")
    if mesh is not None:
        from dartenv_tpu.model.builder import mesh_inertia
        from dartenv_tpu.model.mesh_loader import load_mesh

        fn = mesh.get("filename")
        if fn is None:
            raise ValueError("URDF <mesh> without filename")
        # strip the ROS package:// prefix the reference's DartLoader
        # resolves through its resource retriever †; relative (and
        # package://-stripped) paths resolve against the URDF file's own
        # directory, matching skel_parser (ADVICE.md round 2)
        if fn.startswith("package://"):
            fn = fn[len("package://"):]
        if base_dir is not None and not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        scale = _floats(mesh.get("scale"), np.ones(3))
        verts = load_mesh(fn, scale=scale)
        return ("mesh", verts, lambda m: mesh_inertia(m, verts))
    raise ValueError("URDF geometry element with no known shape")


def parse_urdf(path_or_string: str, dtype=jnp.float32,
               root_joint: Optional[int] = None,
               solver: Optional[sm.SolverConfig] = None,
               dt: float = 0.002,
               gravity=(0.0, -9.81, 0.0),
               ground: bool = False) -> sm.SkelModel:
    """Parse a URDF file (or XML string) into a SkelModel.

    root_joint: joint type for the root link when the URDF gives none
    (DART's DartLoader default is a FreeJoint †); pass sm.WELD to pin.
    ground: add a y=0 halfspace so collision geoms collide with a floor.
    """
    if os.path.exists(path_or_string):
        tree = ET.parse(path_or_string)
        robot = tree.getroot()
        base_dir = os.path.dirname(os.path.abspath(path_or_string))
    else:
        robot = ET.fromstring(path_or_string)
        base_dir = None
    if robot.tag != "robot":
        raise ValueError(f"expected <robot>, got <{robot.tag}>")
    name = robot.get("name", "urdf_robot")

    links: Dict[str, ET.Element] = {}
    link_order: List[str] = []
    for link in robot.findall("link"):
        links[link.get("name")] = link
        link_order.append(link.get("name"))

    # child link -> joint
    child_joint: Dict[str, ET.Element] = {}
    has_parent = set()
    for joint in robot.findall("joint"):
        child = joint.find("child").get("link")
        child_joint[child] = joint
        has_parent.add(child)

    roots = [ln for ln in link_order if ln not in has_parent]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")

    # topological order
    ordered: List[str] = []
    remaining = [ln for ln in link_order]
    while remaining:
        progressed = False
        for ln in list(remaining):
            j = child_joint.get(ln)
            p = None if j is None else j.find("parent").get("link")
            if p is None or p in ordered:
                ordered.append(ln)
                remaining.remove(ln)
                progressed = True
        if not progressed:
            raise ValueError("cycle in URDF kinematic tree")

    b = ModelBuilder(dt=dt, gravity=gravity, name=name, solver=solver)
    rj = sm.FREE if root_joint is None else root_joint
    for ln in ordered:
        link = links[ln]
        joint = child_joint.get(ln)
        if joint is None:
            jtype, axes, pitch = rj, ((1, 0, 0), (0, 1, 0), (0, 0, 1)), 0.0
            R_pj, p_pj = np.eye(3), np.zeros(3)
            lo = hi = None
            damping = friction = 0.0
            jname = ln + "_root"
            parent = None
        else:
            jt = joint.get("type")
            if jt not in _JOINT_TYPES:
                raise NotImplementedError(f"URDF joint type {jt}")
            jtype = _JOINT_TYPES[jt]
            R_pj, p_pj = _origin(joint)
            ax_el = joint.find("axis")
            axis = (_floats(ax_el.get("xyz")) if ax_el is not None
                    else np.array([1.0, 0.0, 0.0]))
            nrm = np.linalg.norm(axis)
            axis = axis / nrm if nrm > 0 else np.array([1.0, 0.0, 0.0])
            if jtype == sm.PLANAR:
                # URDF planar: motion in the plane normal to axis; build an
                # orthonormal (e1, e2, axis) triad
                ref = (np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9
                       else np.array([0.0, 0, 1.0]))
                e1 = np.cross(axis, ref)
                e1 /= np.linalg.norm(e1)
                e2 = np.cross(axis, e1)
                axes = (e1, e2, axis)
            else:
                axes = (axis, (0, 1, 0), (0, 0, 1))
            lim = joint.find("limit")
            lo = hi = None
            if lim is not None and jt not in ("continuous", "fixed"):
                if lim.get("lower") is not None:
                    lo = float(lim.get("lower"))
                if lim.get("upper") is not None:
                    hi = float(lim.get("upper"))
            dyn = joint.find("dynamics")
            damping = float(dyn.get("damping", 0.0)) if dyn is not None \
                else 0.0
            friction = float(dyn.get("friction", 0.0)) if dyn is not None \
                else 0.0
            jname = joint.get("name", ln + "_joint")
            parent = joint.find("parent").get("link")
            pitch = 0.0

        # inertial
        inertial = link.find("inertial")
        mass = 1e-6
        com = np.zeros(3)
        moi = np.eye(3) * 1e-9
        if inertial is not None:
            m_el = inertial.find("mass")
            if m_el is not None:
                mass = float(m_el.get("value"))
            R_i, p_i = _origin(inertial)
            com = p_i
            i_el = inertial.find("inertia")
            if i_el is not None:
                g = lambda k: float(i_el.get(k, 0.0))
                I_local = np.array([
                    [g("ixx"), g("ixy"), g("ixz")],
                    [g("ixy"), g("iyy"), g("iyz")],
                    [g("ixz"), g("iyz"), g("izz")],
                ])
                moi = R_i @ I_local @ R_i.T

        nd = sm.JOINT_NDOF[jtype]
        b.add_body(
            ln, parent, jtype, axes=np.asarray(axes, dtype=np.float64),
            pj_rot=R_pj, pj_pos=p_pj,
            mass=mass, com=com, inertia=moi,
            damping=damping, dof_friction=friction,
            q_lower=None if lo is None else [lo] * nd,
            q_upper=None if hi is None else [hi] * nd,
            joint_name=jname, pitch=pitch,
        )
        for col in link.findall("collision"):
            geom_el = col.find("geometry")
            if geom_el is None:
                continue
            gtype, size, _fn = _geometry(geom_el, base_dir=base_dir)
            R_g, p_g = _origin(col)
            if gtype == "mesh":
                b.add_mesh_geom(ln, size, pos=p_g, rot=R_g)
            else:
                b.add_geom(ln, gtype, size, pos=p_g, rot=R_g)

    if ground:
        b.add_ground(normal=(0, 1, 0), offset=0.0)
    return b.finalize(dtype=dtype)
