"""DartHumanWalker: full 3D humanoid walking (= "DartHumanoid" in
BASELINE.json, config 5).

Reference: `gym/envs/dart/humanwalker.py:~1-250` † (SURVEY.md §2.2):
kima humanoid, 29 dofs (free root + 23 actuated), per-joint action scale
array (~60-160 N.m ‡), frame_skip 15 with dt 0.002 ‡;
reward = velocity tracking toward a target speed + alive bonus - energy
penalty ‡; done on trunk-height / orientation bounds ‡.
Obs (57,) = [q without the forward translation (28), clip(dq, +-10) (29)].
All constants are reconstructions pending reference mount (SURVEY.md
provenance warning).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dartenv_tpu.envs.base import DartEnv, Task, with_solver
from dartenv_tpu.model.skel_parser import asset_path, parse_skel
from dartenv_tpu.utils.ezpickle import EzPickle

# actuated dofs 6..29: spine(3), hipR(3), kneeR, ankleR(2),
# hipL(3), kneeL, ankleL(2), shoulderR(3), elbowR, shoulderL(3), elbowL
ACTION_SCALE = np.array(
    [150.0, 100.0, 150.0,
     120.0, 60.0, 160.0, 120.0, 90.0, 40.0,
     120.0, 60.0, 160.0, 120.0, 90.0, 40.0,
     50.0, 30.0, 50.0, 40.0,
     50.0, 30.0, 50.0, 40.0]
)

_TARGET_VEL = 1.0
_ALIVE_BONUS = 4.5


class HumanWalkerTask(Task):
    name = "DartHumanWalker"
    frame_skip = 15
    obs_size = 57
    control_bounds = np.array([[1.0] * 23, [-1.0] * 23])
    reset_noise = 0.005

    def __init__(self, model):
        super().__init__(model)
        self._scale = jnp.asarray(ACTION_SCALE, dtype=model.q_init.dtype)

    def action_to_tau(self, a, aux):
        tau = jnp.zeros(self.model.n, dtype=a.dtype)
        return tau.at[6:].set(a * self._scale)

    def obs(self, sim, aux):
        # drop the forward (x) root translation, q[3]
        q_obs = jnp.concatenate([sim.q[:3], sim.q[4:]])
        return jnp.concatenate([q_obs, jnp.clip(sim.dq, -10.0, 10.0)])

    def reward(self, sim_prev, sim, a, contacts, aux):
        dtype = sim.q.dtype
        vel = (sim.q[3] - sim_prev.q[3]) / self.dt
        vel_rew = -jnp.abs(vel - _TARGET_VEL)
        energy = 1e-3 * jnp.sum(a * a)
        return jnp.asarray(_ALIVE_BONUS, dtype=dtype) + vel_rew - energy

    def done(self, sim, aux):
        s = jnp.concatenate([sim.q, sim.dq])
        height = sim.q[4]  # pelvis world height (root translation y)
        rot = sim.q[:3]
        ok = (
            jnp.all(jnp.isfinite(s))
            & (height > -0.35) & (height < 0.35)   # offsets from 1.0 m
            & (jnp.abs(rot[0]) < 0.8)              # roll-ish
            & (jnp.abs(rot[2]) < 0.8)              # pitch-ish
        )
        return ~ok


def make_humanwalker_task(dtype=jnp.float32, lcp_solver=None,
                          **solver_kw) -> HumanWalkerTask:
    world = parse_skel(asset_path("kima_humanwalker.skel"), dtype=dtype)
    # m = 47 LCP rows x 15 substeps makes the PGS sweep the humanoid's
    # serial bottleneck: cap the 8 foot-capsule slots at 6, halve the
    # sweep budget under warm-starting, and let hybrid escalation hold
    # the worst-case residual (docs/SOLVERS.md)
    # escalation (r5, VERDICT r4 order #3): a warm 16-pivot tier-1 for
    # the worst 1/32 plus TWO compensated double-float refinement passes
    # (lcp/dantzig.refine_compensated).  The r4 two-tier cold re-solve
    # (escalate_iters2=24, a SERIAL 24-pivot BPP chain) is retired: the
    # CPU sweep (docs/SOLVERS.md round 5) shows warm-16 + refinement
    # STRICTLY BEATS it on the pinned single-env envelope (p95 2.2e-5 ->
    # 1.2e-5, max 1.9e-3 -> 1.5e-3; warm-8 + refinement alone leaves p95
    # at 3.9e-3 — the cold tier's real job was fixing wrong PGS
    # partitions, which a deeper warm pivot budget also does), and the
    # refinement reaches past the f32 ceiling the cold solve plateaued
    # at (captured offenders 6e-4 -> 6e-7).  escalate_frac=1/8 gives
    # K = 128 at B=1024; its cost on the GPU is measured in PERF.md and
    # the fraction is not yet re-derived from it.
    kw = dict(contact_cap=6, pgs_iters=15, escalate_frac=1.0 / 8,
              escalate_tol=1e-5, escalate_iters=16, escalate_ref=2)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return HumanWalkerTask(with_solver(world.robot, lcp_solver, **kw))


class DartHumanWalkerEnv(DartEnv, EzPickle):
    def __init__(self):
        EzPickle.__init__(self)
        super().__init__(make_humanwalker_task())
