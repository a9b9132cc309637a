"""DartWalker2d: planar biped with multi-contact ground interaction.

Reference: `gym/envs/dart/walker2d.py:~1-100` † (SURVEY.md §2.2):
6 actuated dofs (tau[3:] = a*100 ‡), frame_skip 4; obs (17,) =
[q[1:], clip(dq, +-10)] ‡; reward = dx/dt + 1.0 - 1e-3*||a||^2 ‡;
done unless 0.8 < height < 2.0 and |pitch| < 1.0 ‡.

This is the north-star benchmark config (BASELINE.md config 4).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dartenv_tpu.dynamics.algorithms import fk_positions
from dartenv_tpu.envs.base import DartEnv, Task, with_solver
from dartenv_tpu.model.skel_parser import asset_path, parse_skel
from dartenv_tpu.utils.ezpickle import EzPickle


class Walker2dTask(Task):
    name = "DartWalker2d"
    frame_skip = 4
    obs_size = 17
    control_bounds = np.array([[1.0] * 6, [-1.0] * 6])
    action_scale = 100.0
    reset_noise = 0.005
    torso_body = 0

    def action_to_tau(self, a, aux):
        tau = jnp.zeros(self.model.n, dtype=a.dtype)
        return tau.at[3:].set(a * self.action_scale)

    def obs(self, sim, aux):
        return jnp.concatenate([
            sim.q[1:], jnp.clip(sim.dq, -10.0, 10.0)
        ])

    def height_pitch(self, sim):
        R_w, p_w = fk_positions(self.model, sim.q)
        com_t = p_w[self.torso_body] + R_w[self.torso_body] @ \
            self.model.com[self.torso_body]
        return com_t[1], sim.q[2]

    def reward(self, sim_prev, sim, a, contacts, aux):
        dtype = sim.q.dtype
        vel = (sim.q[0] - sim_prev.q[0]) / self.dt
        alive_bonus = jnp.asarray(1.0, dtype=dtype)
        return vel + alive_bonus - 1e-3 * jnp.sum(a * a)

    def done(self, sim, aux):
        s = jnp.concatenate([sim.q, sim.dq])
        height, pitch = self.height_pitch(sim)
        ok = (
            jnp.all(jnp.isfinite(s))
            & jnp.all(jnp.abs(s[2:]) < 100.0)
            & (height > 0.8)
            & (height < 2.0)
            & (jnp.abs(pitch) < 1.0)
        )
        return ~ok


def make_walker2d_task(dtype=jnp.float32, lcp_solver=None,
                       **solver_kw) -> Walker2dTask:
    world = parse_skel(asset_path("walker2d.skel"), dtype=dtype)
    # LCP active-set cap (see SolverConfig.contact_cap): at most
    # 6 simultaneously active contact slots for this morphology
    # pgs_iters/escalate: warm-started PGS with exact-solver escalation of
    # the worst 1/32 of envs per substep (docs/SOLVERS.md residual study)
    # escalation budget: 4 damped + 2 refine pivots — the re-solve is a
    # serial pivot chain, and the CPU study shows this budget keeps the
    # envelope (max 2.9e-5 vs 8.9e-6 at the legacy 8+6; bound 1e-4)
    kw = dict(contact_cap=6, pgs_iters=8, escalate_frac=1.0 / 32,
              escalate_tol=1e-5, escalate_iters=4, escalate_refine=2)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return Walker2dTask(with_solver(world.robot, lcp_solver, **kw))


class DartWalker2dEnv(DartEnv, EzPickle):
    def __init__(self):
        EzPickle.__init__(self)
        super().__init__(make_walker2d_task())
