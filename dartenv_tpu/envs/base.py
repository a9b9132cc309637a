"""DartEnv base layer: functional task core + gym-style OO shim.

Reference: `gym/envs/dart/dart_env.py:~1-260` † (SURVEY.md §2.2) — asset
loading, action/observation spaces, `set_state`/`state_vector`,
`do_simulation(tau, n_frames)`, seeding, `dt = world.dt * frame_skip`.

Architecture (SURVEY.md §7 "functional core, OO shim"):

* `Task` — a per-environment bundle of pure functions
  (action->tau, obs, reward, done, reset) closed over a `SkelModel`.
  `make_env_step(task)` fuses clamp -> scale -> frame_skip substeps ->
  obs/reward/done into ONE jittable function with zero host crossings
  (the reference pays ~2 Python->C++ crossings per substep, §3.2).
* `DartEnv(Task)` — the single-env, numpy-in/numpy-out gym 0.9.x class.
  Reset noise uses `gym.utils.seeding`-compatible NumPy streams for
  seed-for-seed parity with the reference (§3.3); the batched path uses
  `jax.random` (see dartenv_tpu.parallel.vec_env).

Behavioral invariants replicated (SURVEY.md §2.2): action clamped to
control_bounds BEFORE scaling; tau applied to the full dof vector with root
dofs zeroed; same tau for every frame_skip substep; reward dt =
sim_dt * frame_skip; termination on post-step state; reset perturbs the
skel-file default pose.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.api import core, error, seeding, spaces
from dartenv_tpu.engine.world import (
    SimState, init_state, make_do_simulation,
)
from dartenv_tpu.model.skel_model import SkelModel


def with_solver(model: SkelModel, lcp_solver: Optional[str] = None,
                **overrides) -> SkelModel:
    """Override SolverConfig fields on a model (task-factory plumbing).

    `lcp_solver` picks the contact solver: "pgs" (iterative, the
    throughput default) or "dantzig" (block principal pivoting — the
    exact Dantzig-class path matching the reference's ODE dSolveLCP †
    default; see docs/SOLVERS.md for the recorded per-task decision).
    Extra kwargs override any SolverConfig field (pgs_iters, erp, ...).
    """
    if lcp_solver is not None:
        overrides["solver"] = lcp_solver
    if not overrides:
        return model
    return model.replace(
        solver=dataclasses.replace(model.solver, **overrides)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnvState:
    """Complete per-env state for the functional path."""

    sim: SimState
    aux: Any         # task-specific pytree (e.g. reacher target)
    key: Any         # jax PRNG key (functional resets)
    steps: Any       # int32 episode step counter


class Task:
    """Pure-function bundle for one environment family.

    Subclasses set the class attributes and override the hooks.  All hooks
    must be jit-safe (no data-dependent Python control flow).
    """

    name: str = "task"
    frame_skip: int = 1
    obs_size: int = 0
    # (2, m): row 0 = upper, row 1 = lower (reference control_bounds layout ‡)
    control_bounds: np.ndarray = np.zeros((2, 0))
    # reset noise: uniform(-s, s) added to q_init/dq_init
    reset_noise: float = 0.01
    # random external perturbation (reference DartEnv.add_perturbation /
    # perturbation_parameters = [prob, magnitude, body_id, duration] ‡)
    add_perturbation: bool = False
    perturbation_parameters = (0.05, 30.0, 0, 40)
    # carry LCP impulses across substeps to warm-start the solver (free
    # double-digit % throughput on contact tasks; see SimState.lam).  The
    # validation tracer keeps cold starts (validation/trace.py builds its
    # own SimState without lam), so reference-parity traces are unaffected.
    warm_start: bool = True

    def __init__(self, model: SkelModel):
        self.model = model
        self._lcp_rows = None  # lazily computed layout.m

    def lam_init(self, dtype):
        """Zero LCP-impulse carry enabling warm starts (or None when
        disabled / the model has no constraint rows)."""
        if not self.warm_start:
            return None
        if self._lcp_rows is None:
            from dartenv_tpu.engine.constraints import build_layout
            self._lcp_rows = build_layout(self.model).m
        if self._lcp_rows == 0:
            return None
        return jnp.zeros((self._lcp_rows,), dtype=dtype)

    # -- control ---------------------------------------------------------
    def action_to_tau(self, a, aux):
        """Map clamped action -> full-dof generalized force."""
        raise NotImplementedError

    # -- observation -----------------------------------------------------
    def obs(self, sim: SimState, aux):
        raise NotImplementedError

    # -- reward / termination -------------------------------------------
    def reward(self, sim_prev: SimState, sim: SimState, a, contacts, aux):
        raise NotImplementedError

    def done(self, sim: SimState, aux):
        raise NotImplementedError

    # -- reset -----------------------------------------------------------
    def aux_init(self):
        """Static initial aux pytree (must match aux_reset's structure)."""
        if self.add_perturbation:
            dtype = self.model.q_init.dtype
            return {
                "perturb_force": jnp.zeros(3, dtype=dtype),
                "perturb_ttl": jnp.zeros((), dtype=jnp.int32),
            }
        return ()

    def aux_reset(self, key, aux):
        """Resample task-specific state on reset (jax path)."""
        return self.aux_init()

    def reset_sim(self, key) -> SimState:
        """Default reference semantics: q,dq = defaults + U(-s, s) ‡."""
        model = self.model
        s = self.reset_noise
        kq, kdq = jax.random.split(key)
        q = model.q_init + jax.random.uniform(
            kq, (model.n,), minval=-s, maxval=s, dtype=model.q_init.dtype
        )
        dq = model.dq_init + jax.random.uniform(
            kdq, (model.n,), minval=-s, maxval=s, dtype=model.q_init.dtype
        )
        return SimState(q=q, dq=dq,
                        time=jnp.zeros((), dtype=model.q_init.dtype),
                        lam=self.lam_init(model.q_init.dtype))

    def np_reset_sim(self, np_random) -> Tuple[np.ndarray, np.ndarray]:
        """NumPy reset path for seed parity (same call order as the
        reference's reset_model †): uniform on q then dq."""
        model = self.model
        s = self.reset_noise
        q = np.asarray(model.q_init) + np_random.uniform(
            low=-s, high=s, size=model.n
        )
        dq = np.asarray(model.dq_init) + np_random.uniform(
            low=-s, high=s, size=model.n
        )
        return q, dq

    def np_reset_aux(self, np_random, aux):
        return self.aux_init()

    @property
    def dt(self) -> float:
        """Control dt — the reference's `self.dt = world.dt * frame_skip` †"""
        return self.model.dt * self.frame_skip

    @property
    def action_size(self) -> int:
        return self.control_bounds.shape[1]


def make_env_step(task: Task):
    """Fused env step: (EnvState, action) -> (EnvState, obs, reward, done).

    One jittable function per control step (frame_skip substeps inside).
    """
    model = task.model
    do_sim = make_do_simulation(model, task.frame_skip)
    hi = jnp.asarray(task.control_bounds[0], dtype=model.q_init.dtype)
    lo = jnp.asarray(task.control_bounds[1], dtype=model.q_init.dtype)

    def env_step(state: EnvState, action):
        # HIGHEST matmul precision over the whole env step: the physics
        # substep sets this itself (engine/world.make_sim_step), but the
        # obs/reward/done path also runs FK contractions whose default-
        # precision TF32 passes would perturb termination thresholds
        with jax.default_matmul_precision("highest"):
            return _env_step(state, action)

    def _env_step(state: EnvState, action):
        a = jnp.clip(action, lo, hi)
        tau = task.action_to_tau(a, state.aux)
        aux, key = state.aux, state.key
        if task.add_perturbation:
            # reference DartEnv.do_simulation perturbation logic ‡, at the
            # reference's granularity: the dice roll happens INSIDE the
            # substep loop (once per world.step, not once per control
            # step — VERDICT.md r1 weak #6)
            prob, mag, body_id, duration = task.perturbation_parameters
            sub_step = make_do_simulation(model, 1)

            def body(carry, k):
                sim, force, ttl = carry
                k1, k2, k3 = jax.random.split(k, 3)
                start = (ttl <= 0) & (jax.random.uniform(k1, ()) < prob)
                axis = jax.random.randint(k2, (), 0, 2)
                sign = (jax.random.randint(k3, (), 0, 2) * 2 - 1).astype(
                    force.dtype)
                fresh = jnp.zeros_like(force).at[axis].set(sign * mag)
                live = ttl > 0
                force = jnp.where(
                    start, fresh,
                    jnp.where(live, force, jnp.zeros_like(force)))
                ttl = jnp.where(start, jnp.asarray(duration, jnp.int32),
                                jnp.maximum(ttl - 1, 0))
                f_ext = jnp.zeros((model.nb, 6), dtype=force.dtype)
                f_ext = f_ext.at[body_id, 3:].set(force)
                sim2, contacts = sub_step(sim, tau, f_ext)
                return (sim2, force, ttl), contacts

            key, ksub = jax.random.split(key)
            keys = jax.random.split(ksub, task.frame_skip)
            (sim_new, force, ttl), cs = jax.lax.scan(
                body, (state.sim, aux["perturb_force"],
                       aux["perturb_ttl"]), keys)
            contacts = jax.tree_util.tree_map(lambda x: x[-1], cs)
            contacts = dataclasses.replace(
                contacts, overflow=jnp.max(cs.overflow, axis=0))
            aux = dict(aux, perturb_force=force, perturb_ttl=ttl)
        else:
            sim_new, contacts = do_sim(state.sim, tau, None)
        obs = task.obs(sim_new, aux)
        reward = task.reward(state.sim, sim_new, a, contacts, aux)
        done = task.done(sim_new, aux)
        new_state = EnvState(
            sim=sim_new, aux=aux, key=key,
            steps=state.steps + 1,
        )
        # per-step diagnostics (jit-safe scalars); contact_overflow > 0
        # means the active-set cap dropped contacts this step (VERDICT.md
        # r1 weak #3 — the reference's dynamic row assembly can't overflow)
        step_info = {"contact_overflow": contacts.overflow}
        return new_state, obs, reward, done, step_info

    return env_step


def make_env_reset(task: Task):
    """Functional reset: key -> (EnvState, obs)."""
    def env_reset(key):
        key, k_sim, k_aux = jax.random.split(key, 3)
        aux = task.aux_reset(k_aux, task.aux_init())
        sim = task.reset_sim(k_sim)
        state = EnvState(
            sim=sim, aux=aux, key=key,
            steps=jnp.zeros((), dtype=jnp.int32),
        )
        return state, task.obs(sim, aux)

    return env_reset


class _CustomTask(Task):
    """Task shell for reference-style custom env subclasses (which override
    `_step`/`reset_model`/`_get_obs` on the env and drive the sim through
    `do_simulation` + `robot_skeleton`, so the jit-path hooks here are
    never exercised unless the subclass provides them)."""

    def __init__(self, model: SkelModel, frame_skip: int, obs_size: int,
                 control_bounds):
        super().__init__(model)
        self.frame_skip = int(frame_skip)
        self.obs_size = int(obs_size)
        self.control_bounds = np.asarray(control_bounds, dtype=np.float64)

    def action_to_tau(self, a, aux):  # pragma: no cover - subclass owns step
        return jnp.zeros(self.model.n, dtype=a.dtype)

    def obs(self, sim, aux):
        return sim.state_vector()[: self.obs_size]

    def reward(self, sim_prev, sim, a, contacts, aux):
        return jnp.asarray(0.0, dtype=sim.q.dtype)

    def done(self, sim, aux):
        return jnp.asarray(False)


# Sentinel cached in `_viewer` once opening a window failed (headless host)
# or the user closed it — keeps `render('human')` a cheap no-op afterwards
# instead of retrying Tk on every frame.
_HEADLESS = object()


class DartEnv(core.Env):
    """Single-env gym 0.9.x-compatible shim over a Task.

    Two construction modes:
      * `DartEnv(task)` — the batched JAX path (built-in env families).
      * `DartEnv(model_paths, frame_skip, observation_size, action_bounds,
        dt=0.002, obs_type='parameter', ...)` — the REFERENCE signature
        (`gym/envs/dart/dart_env.py:~30` †, SURVEY.md §2.2) for users
        porting custom env subclasses: the subclass overrides `_step`
        (calling `self.do_simulation`), `reset_model`, `_get_obs` and codes
        against `self.robot_skeleton` exactly as with pydart2.
    """

    metadata = {"render.modes": ["human", "rgb_array"]}

    def __init__(self, task, frame_skip=None, observation_size=None,
                 action_bounds=None, dt=0.002, obs_type="parameter",
                 action_type="continuous", visualize=False,
                 disableViewer=True, screen_width=80, screen_height=45):
        if not isinstance(task, Task):
            task = self._task_from_model_paths(
                task, frame_skip, observation_size, action_bounds, dt
            )
        self.obs_type = obs_type
        self.visualize = visualize and not disableViewer
        self.screen_width = screen_width
        self.screen_height = screen_height
        self.task = task
        self.model = task.model
        self.frame_skip = task.frame_skip
        self._env_step = jax.jit(make_env_step(task))
        self._do_sim = jax.jit(make_do_simulation(
            task.model, task.frame_skip, return_impulses=True))

        m = task.action_size
        self.action_space = spaces.Box(
            np.asarray(task.control_bounds[1], dtype=np.float64),
            np.asarray(task.control_bounds[0], dtype=np.float64),
            dtype=np.float64,
        )
        self.observation_space = spaces.Box(
            -np.inf * np.ones(task.obs_size),
            np.inf * np.ones(task.obs_size),
            dtype=np.float64,
        )
        self.metadata = {
            "render.modes": ["human", "rgb_array"],
            "video.frames_per_second": int(round(1.0 / self.dt)),
        }
        self._viewer = None
        self._seed()
        self._state = None
        # pydart2-parity surfaces (envs/facade.py): staged forces and the
        # last substep's manifold + impulses back collision_result †
        self._staged_tau = None
        self._staged_servo = None
        self._pending_fext = None
        self._last_contacts = None
        self._last_lam = None
        self._robot_skeleton = None
        self._world_facade = None

    @staticmethod
    def _task_from_model_paths(model_paths, frame_skip, observation_size,
                               action_bounds, dt):
        """Reference-signature construction: parse the asset(s) and keep
        EVERY mobile skeleton — the reference's World::step iterates all
        skeletons †, and `robot_skeleton = world.skeletons[-1]` † (the last
        skeleton of the last file).  Multiple skeletons compose into one
        block-diagonal model (model/compose.py) with cross-skeleton
        contact pairs, so a ported env that loads
        `['ground.urdf', 'obstacle.skel', 'robot.skel']` steps the
        obstacle too (VERDICT.md r3 missing #2)."""
        import os as _os

        from dartenv_tpu.model.compose import compose_models
        from dartenv_tpu.model.skel_parser import asset_path, parse_skel
        from dartenv_tpu.model.urdf_loader import parse_urdf

        if frame_skip is None or observation_size is None \
                or action_bounds is None:
            raise error.Error(
                "DartEnv(model_paths, ...) requires frame_skip, "
                "observation_size and action_bounds (reference signature †)"
            )
        paths = [model_paths] if isinstance(model_paths, str) else \
            list(model_paths)
        models = []
        for p in paths:
            full = p if _os.path.exists(p) else asset_path(p)
            if full.endswith(".urdf"):
                models.append(parse_urdf(full))
            elif full.endswith(".sdf"):
                from dartenv_tpu.model.sdf_loader import parse_sdf

                models.extend(parse_sdf(full).skeletons)
            else:
                models.extend(parse_skel(full).skeletons)
        # ctor dt overrides the files' <physics> dt (reference
        # `pydart.World(dt, path)` †); applied per model so composition's
        # shared-timestep invariant holds
        models = [m.replace(dt=float(dt)) if float(m.dt) != float(dt)
                  else m for m in models]
        model = compose_models(models) if len(models) > 1 else models[0]
        return _CustomTask(model, frame_skip, observation_size,
                           action_bounds)

    # -- pydart2-style facade (reference: pydart2 World/Skeleton †) -------
    @property
    def robot_skeleton(self):
        if self._robot_skeleton is None:
            # composed multi-skeleton world: the robot is the LAST
            # skeleton (reference: `world.skeletons[-1]` †)
            self._robot_skeleton = self.world.skeletons[-1]
        return self._robot_skeleton

    @property
    def world(self):
        if self._world_facade is None:
            from dartenv_tpu.envs.facade import WorldFacade
            self._world_facade = WorldFacade(self)
        return self._world_facade

    def _add_ext_force(self, body_id, force, offset=(0.0, 0.0, 0.0)):
        """Stage a world-frame force at a body-frame offset for the next
        do_simulation (reference: BodyNode.add_ext_force †).  Torque about
        the body origin = (R offset) x F."""
        import numpy as _np
        from dartenv_tpu.dynamics.algorithms import fk_positions

        if self._pending_fext is None:
            self._pending_fext = _np.zeros((self.model.nb, 6))
        R_w, _ = fk_positions(self.model, self._state.sim.q)
        arm = _np.asarray(R_w[body_id]) @ _np.asarray(offset, dtype=_np.float64)
        f = _np.asarray(force, dtype=_np.float64)
        self._pending_fext[body_id, :3] += _np.cross(arm, f)
        self._pending_fext[body_id, 3:] += f

    def _collision_result(self):
        from dartenv_tpu.envs.facade import CollisionResult, Contact

        contacts = self._last_contacts
        if contacts is None:
            # no step yet: collide at the current configuration
            from dartenv_tpu.collision.narrowphase import collide
            from dartenv_tpu.dynamics.algorithms import fk_positions
            R_w, p_w = fk_positions(self.model, self._state.sim.q)
            contacts = collide(self.model, R_w, p_w)
        import numpy as _np
        from dartenv_tpu.engine.constraints import build_layout
        layout = build_layout(self.model)
        active = _np.asarray(contacts.active) > 0.5
        pos = _np.asarray(contacts.pos)
        normal = _np.asarray(contacts.normal)
        depth = _np.asarray(contacts.depth)
        nc = active.shape[0]
        lam = (_np.asarray(self._last_lam)
               if self._last_lam is not None else _np.zeros(layout.m))
        out = []
        dt = float(self.model.dt)
        # full 3-vector force: normal row + both friction-pyramid tangent
        # rows, reconstructed with the same deterministic tangent basis the
        # LCP assembly used (pydart2 contact.force is the full vector †)
        from dartenv_tpu.engine.constraints import tangent_basis
        t1, t2 = tangent_basis(jnp.asarray(normal))
        t1, t2 = _np.asarray(t1), _np.asarray(t2)
        for k in range(nc):
            if not active[k]:
                continue
            f = (normal[k] * lam[3 * k]
                 + t1[k] * lam[3 * k + 1]
                 + t2[k] * lam[3 * k + 2]) / dt
            out.append(Contact(pos[k], normal[k], f, float(depth[k]),
                               layout.slot_body[k]))
        return CollisionResult(out)

    # -- gym plumbing ----------------------------------------------------
    @property
    def dt(self):
        return self.task.dt

    def _seed(self, seed=None):
        self.np_random, seed = seeding.np_random(seed)
        return [seed]

    # -- state access (reference: set_state / state_vector †) ------------
    def set_state(self, qpos, qvel):
        assert qpos.shape == (self.model.n,) and qvel.shape == (self.model.n,)
        dtype = self.model.q_init.dtype
        sim = SimState(
            q=jnp.asarray(qpos, dtype=dtype),
            dq=jnp.asarray(qvel, dtype=dtype),
            time=self._state.sim.time if self._state is not None
            else jnp.zeros((), dtype=dtype),
            # set_state is a teleport: stale impulses don't correspond to
            # the new configuration, so the warm-start carry restarts at 0
            lam=self.task.lam_init(dtype),
        )
        self._state = dataclasses.replace(self._state, sim=sim)

    def set_state_vector(self, s):
        n = self.model.n
        self.set_state(np.asarray(s[:n]), np.asarray(s[n:]))

    def state_vector(self):
        return np.concatenate([
            np.asarray(self._state.sim.q), np.asarray(self._state.sim.dq)
        ])

    # -- stepping --------------------------------------------------------
    def do_simulation(self, tau, n_frames):
        """Low-level parity hook: apply raw generalized forces."""
        from dartenv_tpu.engine.world import make_do_simulation as _mk

        if n_frames == self.frame_skip:
            do = self._do_sim
        else:
            # cache per n_frames: rebuilding the jit each call would
            # recompile every substep (validation tracers step 1 frame
            # at a time)
            if not hasattr(self, "_do_sim_cache"):
                self._do_sim_cache = {}
            do = self._do_sim_cache.get(n_frames)
            if do is None:
                do = jax.jit(_mk(self.model, n_frames,
                                 return_impulses=True))
                self._do_sim_cache[n_frames] = do
        dtype = self.model.q_init.dtype
        tau = np.asarray(tau)
        if tau.shape[0] != self.model.n and self.model.skel_ranges:
            # composed multi-skeleton world, robot-sized tau (reference:
            # `robot_skeleton.set_forces(tau)` drives only the robot †):
            # scatter into the robot's dof span, zeros elsewhere
            _, _, _, d0, nd = self.model.skel_ranges[-1]
            if tau.shape[0] != nd:
                raise error.Error(
                    f"tau has {tau.shape[0]} dofs; expected the full "
                    f"world ({self.model.n}) or the robot skeleton ({nd})"
                )
            full_tau = np.zeros(self.model.n, dtype=tau.dtype)
            full_tau[d0:d0 + nd] = tau
            tau = full_tau
        fext = None
        if self._pending_fext is not None:
            fext = jnp.asarray(self._pending_fext, dtype=dtype)
            self._pending_fext = None  # cleared each step, pydart2-style †
        servo = None
        if self._staged_servo is not None:
            servo = jnp.asarray(self._staged_servo, dtype=dtype)
        sim, (contacts, lam) = do(
            self._state.sim, jnp.asarray(tau, dtype=dtype), fext, servo
        )
        self._state = dataclasses.replace(self._state, sim=sim)
        self._last_contacts = contacts
        self._last_lam = lam
        return contacts

    def _step(self, action):
        a = jnp.asarray(action, dtype=self.model.q_init.dtype)
        self._state, obs, reward, done, step_info = \
            self._env_step(self._state, a)
        info = {k: float(v) for k, v in step_info.items()}
        if self.obs_type == "image":
            # reference: image observations come from the offscreen viewer
            # at the ctor's screen size (`dart_env.py` obs_type='image',
            # screen_width/height †)
            obs = self._render(mode="rgb_array", width=self.screen_width,
                               height=self.screen_height)
            return obs, float(reward), bool(done), info
        return (
            np.asarray(obs, dtype=np.float64),
            float(reward),
            bool(done),
            info,
        )

    def _reset(self):
        if hasattr(self, "reset_model"):
            # reference custom-env workflow †: world.reset() then the
            # subclass's reset_model() perturbs/sets state and returns obs
            dtype = self.model.q_init.dtype
            sim = SimState(
                q=self.model.q_init, dq=self.model.dq_init,
                time=jnp.zeros((), dtype=dtype),
                lam=self.task.lam_init(dtype),
            )
            self._state = EnvState(
                sim=sim, aux=self.task.aux_init(),
                key=jax.random.PRNGKey(0),
                steps=jnp.zeros((), dtype=jnp.int32),
            )
            self._staged_tau = None
            self._pending_fext = None
            return self.reset_model()
        q, dq = self.task.np_reset_sim(self.np_random)
        aux = self.task.np_reset_aux(self.np_random, self.task.aux_init())
        dtype = self.model.q_init.dtype
        sim = SimState(
            q=jnp.asarray(q, dtype=dtype),
            dq=jnp.asarray(dq, dtype=dtype),
            time=jnp.zeros((), dtype=dtype),
            lam=self.task.lam_init(dtype),
        )
        self._state = EnvState(
            sim=sim, aux=aux,
            key=jax.random.PRNGKey(0),
            steps=jnp.zeros((), dtype=jnp.int32),
        )
        if self.obs_type == "image":
            return self._render(mode="rgb_array", width=self.screen_width,
                                height=self.screen_height)
        return np.asarray(
            self.task.obs(sim, aux), dtype=np.float64
        )

    def _render(self, mode="human", close=False, width=None, height=None):
        if close:
            if self._viewer is not None:
                if self._viewer is not _HEADLESS:
                    self._viewer.close()
                self._viewer = None
            return
        from dartenv_tpu.envs.render import render_frame

        # COM-tracked perspective camera (reference: StaticGLUTWindow
        # trackball following track_skeleton_id †); envs may override the
        # view by setting `self.camera = render.Camera(...)` — the
        # viewer_setup() analogue.  width/height default to the renderer's
        # video resolution; the image-observation path passes the ctor's
        # screen size instead (reference obs_type='image' †).
        size = {}
        if width is not None:
            size["width"] = width
            # width alone: keep the renderer's 4:3 default aspect rather
            # than forwarding height=None into np.empty
            size["height"] = (height if height is not None
                              else max(1, round(width * 3 / 4)))
        elif height is not None:
            size["height"] = height
        if mode == "human":
            # reference human mode: a trackball GLUT window stepped once
            # per frame (`StaticGLUTWindow.runSingleStep()` †).  Here: a
            # stdlib-Tk window over the same rasterizer (envs/viewer.py);
            # on a headless host it degrades to a recorded no-op, matching
            # `disableViewer=True` semantics.
            viewer = self._get_viewer()
            if viewer is None:
                return None
            frame = render_frame(
                self.model, self._state.sim, camera=viewer.camera,
                track_body=getattr(self.task, "torso_body", None),
                **size,
            )
            viewer.imshow(frame)
            if not viewer.is_open:
                self._viewer = _HEADLESS
            return None
        frame = render_frame(
            self.model, self._state.sim,
            camera=getattr(self, "camera", None),
            track_body=getattr(self.task, "torso_body", None),
            **size,
        )
        return frame

    def _get_viewer(self):
        """Lazily open the interactive window (None while headless/closed).

        Reference: `DartEnv._get_viewer()` caching a `StaticGLUTWindow` †.
        `render(close=True)` resets the cache so a new window can open.
        """
        if self._viewer is _HEADLESS:
            return None
        if self._viewer is None:
            from dartenv_tpu.envs import viewer as _viewer_mod

            v = _viewer_mod.create_viewer(
                640, 480,
                camera=getattr(self, "camera", None),
                title=type(self).__name__,
            )
            self._viewer = v if v is not None else _HEADLESS
            if v is None:
                return None
        return self._viewer
