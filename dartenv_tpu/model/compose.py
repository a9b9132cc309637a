"""Multi-skeleton worlds: block-diagonal composition into one SkelModel
(VERDICT.md round 2 order #5).

The reference steps EVERY skeleton in `world.skeletons` each substep
(`dart/simulation/World::step` iterates all skeletons †, SURVEY.md §3.2);
pydart2 exposes them as `world.skeletons[i]`.  The batched equivalent
is not N engine instances but ONE composed model: skeleton forests are
already first-class (SkelModel roots have parent = -1 and every kinematic
scan gathers per-body parents), so composition is pure concatenation —
bodies/dofs/geoms of each skeleton appended with offset indices, the
ancestor mask recomputed for the forest, and cross-skeleton contact pairs
added to `self_pairs` (the constraint assembler's signed slot masks
already handle arbitrary body pairs).  One `sim_step`, one LCP, full
robot-object coupling — exactly how the reference's single ConstrainedGroup
treats skeletons linked by contacts.

`SkelModel.skel_ranges` records each source skeleton's (body, dof) spans
so the facade (`envs/facade.py`) can expose per-skeleton q/dq views
matching pydart2's `world.skeletons` surface.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from dartenv_tpu.model.skel_model import SkelModel, ancestor_mask_np


def _cat(vals, axis=0):
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return jnp.concatenate(vals, axis=axis)


def _cat_or_zeros(models, field, n_of):
    """Concatenate per-dof/body field, substituting zeros for Nones."""
    out = []
    any_set = False
    for m in models:
        v = getattr(m, field)
        if v is None:
            v = jnp.zeros((n_of(m),), dtype=m.q_init.dtype)
        else:
            any_set = True
        out.append(v)
    if not any_set:
        return None
    return jnp.concatenate(out)


def compose_models(models: Sequence[SkelModel],
                   cross_collide: bool = True,
                   name: Optional[str] = None) -> SkelModel:
    """Compose mobile skeletons into one block-diagonal SkelModel.

    cross_collide: add a contact pair for every (collidable geom of skel
    i) x (collidable geom of skel j), i < j — the reference's collision
    world tests all skeleton pairs by default †.  Collidable = appears in
    the model's world_pairs when the world has geometry, else every geom.
    All convex type combinations are supported (collision/support.py).
    """
    models = list(models)
    if len(models) == 1:
        return models[0]
    assert models, "compose_models needs at least one skeleton"
    m0 = models[0]
    for m in models[1:]:
        assert m.dt == m0.dt, "skeletons must share the world timestep"

    body_off, dof_off, geom_off, mesh_off = [], [], [], []
    b = d = g = me = 0
    for m in models:
        body_off.append(b)
        dof_off.append(d)
        geom_off.append(g)
        mesh_off.append(me)
        b += m.nb
        d += m.n
        g += m.ng
        me += 0 if m.mesh_verts is None else int(m.mesh_verts.shape[0])
    nb, n = b, d

    parent = tuple(
        p + (body_off[i] if p >= 0 else 0)
        for i, m in enumerate(models) for p in m.parent
    )
    q_start = tuple(
        qs + dof_off[i] for i, m in enumerate(models) for qs in m.q_start
    )
    ndof = tuple(nd for m in models for nd in m.ndof)
    joint_type = tuple(t for m in models for t in m.joint_type)

    # world geometry: identical tables collapse to the first; otherwise
    # concatenate and offset each model's world-pair indices
    def _wg_same(a, b_):
        if a.shape != b_.shape:
            return False
        return bool(np.allclose(np.asarray(a), np.asarray(b_)))

    same_world = all(
        _wg_same(m.wg_normal, m0.wg_normal)
        and _wg_same(m.wg_offset, m0.wg_offset) for m in models[1:]
    )
    if same_world:
        wg_normal, wg_offset = m0.wg_normal, m0.wg_offset
        wg_friction, wg_rest = m0.wg_friction, m0.wg_restitution
        w_off = [0] * len(models)
    else:
        wg_normal = _cat([m.wg_normal for m in models])
        wg_offset = _cat([m.wg_offset for m in models])
        wg_friction = _cat([m.wg_friction for m in models])
        wg_rest = _cat([m.wg_restitution for m in models])
        w_off, w = [], 0
        for m in models:
            w_off.append(w)
            w += int(m.wg_offset.shape[0])

    world_pairs = tuple(
        (gi + geom_off[i], wi + w_off[i])
        for i, m in enumerate(models) for gi, wi in m.world_pairs
    )
    self_pairs = [
        (ga + geom_off[i], gb + geom_off[i])
        for i, m in enumerate(models) for ga, gb in m.self_pairs
    ]
    if cross_collide:
        collidable = []
        for i, m in enumerate(models):
            if m.world_pairs:
                gs = sorted({gi for gi, _ in m.world_pairs})
            else:
                gs = list(range(m.ng))
            collidable.append([gi + geom_off[i] for gi in gs])
        for i in range(len(models)):
            for j in range(i + 1, len(models)):
                for ga in collidable[i]:
                    for gb in collidable[j]:
                        self_pairs.append((ga, gb))

    # mesh store: re-pad to the common Vmax
    meshes = []
    for m in models:
        if m.mesh_verts is not None:
            for k in range(int(m.mesh_verts.shape[0])):
                meshes.append((m.mesh_verts[k], m.mesh_vmask[k]))
    if meshes:
        vmax = max(int(v.shape[0]) for v, _ in meshes)
        mv, mk = [], []
        for v, k in meshes:
            pad = vmax - int(v.shape[0])
            mv.append(jnp.concatenate(
                [v, jnp.broadcast_to(v[:1], (pad, 3))]) if pad else v)
            mk.append(jnp.concatenate(
                [k, jnp.zeros((pad,), dtype=k.dtype)]) if pad else k)
        mesh_verts = jnp.stack(mv)
        mesh_vmask = jnp.stack(mk)
    else:
        mesh_verts = mesh_vmask = None
    geom_mesh = tuple(
        (gm + mesh_off[i] if gm >= 0 else -1)
        for i, m in enumerate(models) for gm in m.geom_mesh
    )

    geom_body = _cat([
        (jnp.asarray(m.geom_body) + body_off[i]) if m.ng else
        jnp.zeros((0,), jnp.int32)
        for i, m in enumerate(models)
    ])

    return SkelModel(
        nb=nb, n=n, parent=parent, joint_type=joint_type,
        q_start=q_start, ndof=ndof,
        body_names=tuple(nm for m in models for nm in m.body_names),
        joint_names=tuple(nm for m in models for nm in m.joint_names),
        world_pairs=world_pairs, self_pairs=tuple(self_pairs),
        dt=m0.dt,
        name=name or "+".join(m.name for m in models),
        solver=m0.solver,
        skel_ranges=tuple(
            (m.name, body_off[i], m.nb, dof_off[i], m.n)
            for i, m in enumerate(models)
        ),
        pj_rot=_cat([m.pj_rot for m in models]),
        pj_pos=_cat([m.pj_pos for m in models]),
        cj_rot=_cat([m.cj_rot for m in models]),
        cj_pos=_cat([m.cj_pos for m in models]),
        axes=_cat([m.axes for m in models]),
        mass=_cat([m.mass for m in models]),
        com=_cat([m.com for m in models]),
        inertia=_cat([m.inertia for m in models]),
        # every optional per-dof field zero-fills models that leave it None
        # (the SkelModel default): a plain _cat would silently drop those
        # segments and misassign dofs across skeletons (ADVICE.md r3)
        damping=_cat_or_zeros(models, "damping", lambda m: m.n),
        spring_stiff=_cat_or_zeros(models, "spring_stiff", lambda m: m.n),
        rest_pos=_cat_or_zeros(models, "rest_pos", lambda m: m.n),
        dof_friction=_cat_or_zeros(models, "dof_friction", lambda m: m.n),
        servo_flimit=_cat_or_zeros(models, "servo_flimit", lambda m: m.n),
        q_lower=_cat([m.q_lower for m in models]),
        q_upper=_cat([m.q_upper for m in models]),
        limited=_cat([m.limited for m in models]),
        q_init=_cat([m.q_init for m in models]),
        dq_init=_cat([m.dq_init for m in models]),
        ancestor_mask=jnp.asarray(
            ancestor_mask_np(parent, q_start, ndof, n),
            dtype=m0.q_init.dtype),
        geom_body=geom_body,
        geom_type=_cat([jnp.asarray(m.geom_type) for m in models]),
        geom_size=_cat([m.geom_size for m in models]),
        geom_rot=_cat([m.geom_rot for m in models]),
        geom_pos=_cat([m.geom_pos for m in models]),
        geom_friction=_cat([m.geom_friction for m in models]),
        geom_restitution=_cat([m.geom_restitution for m in models]),
        geom_mesh=geom_mesh,
        mesh_verts=mesh_verts, mesh_vmask=mesh_vmask,
        wg_normal=wg_normal, wg_offset=wg_offset,
        wg_friction=wg_friction, wg_restitution=wg_rest,
        gravity=m0.gravity,
    )
