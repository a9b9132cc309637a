"""Domain randomization: batched SkelModel leaves with a leading env axis.

SURVEY.md §2.5 "Batched model params": the reference's analogue was one
`World` object per env (users mutated masses/frictions per instance); here
the model is a pytree, so per-env physics is just `jax.vmap` over the
model argument with a leading env axis on the randomized leaves — the
whole randomized batch stays one XLA program (no per-env recompilation,
unlike the reference where each World re-parses the asset).

Randomizable leaves are the purely NUMERIC ones (mass, inertia, com,
damping, spring_stiff, gravity, geom_size, geom_friction,
geom_restitution, wg_friction, q_init, ...).  Leaves that define the
STATIC constraint/contact layout (limited, dof_friction, servo_flimit,
geom_body, geom_type, ancestor_mask) must stay shared — they are read at
trace time to build the row layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import jax
import jax.numpy as jnp

from dartenv_tpu.engine.world import make_sim_step
from dartenv_tpu.model.skel_model import SkelModel

# leaves whose values feed the static layout — never batch these
LAYOUT_LEAVES = frozenset({
    "limited", "dof_friction", "servo_flimit", "geom_body", "geom_type",
    "ancestor_mask",
})


def _data_fields(model: SkelModel):
    return [f.name for f in dataclasses.fields(model)
            if not f.metadata.get("static", False)]


def model_in_axes(model: SkelModel, batched_fields: Sequence[str]
                  ) -> SkelModel:
    """An `in_axes` pytree for vmapping over a partially-batched model:
    0 on the randomized fields, None (unbatched) elsewhere."""
    bad = set(batched_fields) & LAYOUT_LEAVES
    if bad:
        raise ValueError(
            f"cannot batch layout-defining leaves {sorted(bad)}; they are "
            "read at trace time to build the static constraint layout")
    kw = {f: (0 if f in batched_fields else None)
          for f in _data_fields(model)}
    return model.replace(**kw)


def randomize_model(model: SkelModel, key, spec: Dict[str, float],
                    num_envs: int) -> SkelModel:
    """Batched copy of `model`: each field in `spec` gets a leading env
    axis with values scaled by uniform(1-s, 1+s) per env (s = spec[field]).

    Returns a SkelModel whose randomized leaves are (num_envs, ...) —
    pair with `model_in_axes(model, spec.keys())` under `jax.vmap`.
    """
    kw = {}
    for f, s in spec.items():
        if f in LAYOUT_LEAVES:
            raise ValueError(f"cannot randomize layout leaf {f!r}")
        leaf = getattr(model, f)
        key, k = jax.random.split(key)
        scale = jax.random.uniform(
            k, (num_envs,) + (1,) * leaf.ndim,
            minval=1.0 - s, maxval=1.0 + s, dtype=leaf.dtype)
        kw[f] = leaf[None] * scale
    return model.replace(**kw)


def make_randomized_sim_step(model: SkelModel,
                             batched_fields: Sequence[str]) -> Callable:
    """Batched substep over (batched_model, batched_state, batched_tau):
    one vmapped XLA program stepping N envs with PER-ENV physics params.

    The model leaves are traced, so the dynamics kernel (which bakes
    model values into its code) does not serve this path; the batched
    PGS solve still takes the kernel on the GPU."""
    axes = model_in_axes(model, batched_fields)   # also validates fields

    # the phase-wise path with a traced model.
    # layout-defining leaves must be CONCRETE at trace time (build_layout
    # reads them with numpy); under jit every argument is a tracer, so
    # rebind them from the closed-over base model
    concrete = {f: getattr(model, f) for f in LAYOUT_LEAVES
                if getattr(model, f) is not None}

    def step_with_model(m, state, tau):
        m = m.replace(**concrete)
        return make_sim_step(m)(state, tau)

    return jax.vmap(step_with_model, in_axes=(axes, 0, 0))
