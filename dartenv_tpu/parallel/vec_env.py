"""Batched vector env: vmap over the env axis with on-device auto-reset.

This is the rebuild's replacement for what reference users hand-rolled with
env pools (SURVEY.md §2.5 — the reference has NO parallelism; batching is
new and first-class here).  One program steps B envs in lockstep:

* `vmap(env_step)` turns every per-env op into a (B,)-wide elementwise op;
* auto-reset runs the reset branch unconditionally and `select`s per env on
  done — no host sync, no data-dependent control flow (SURVEY.md §7 hard
  parts "auto-reset under vmap");
* episode-step TimeLimit runs on-device (the OO TimeLimit wrapper is the
  host-side equivalent).

The terminal observation of a finished episode is returned in
`info["terminal_obs"]` (the post-reset obs is what flows to the policy).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from dartenv_tpu.envs.base import (
    EnvState, Task, make_env_reset, make_env_step,
)


class VecEnv:
    """Functional batched env.  All methods are pure and jit-safe; state is
    carried by the caller (a batched EnvState pytree)."""

    def __init__(self, task: Task, num_envs: int,
                 max_episode_steps: Optional[int] = None,
                 auto_reset: bool = True):
        self.task = task
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.auto_reset = auto_reset
        self._step1 = make_env_step(task)
        self._reset1 = make_env_reset(task)
        self._vstep = jax.vmap(self._step1)
        self._vreset = jax.vmap(self._reset1)

    # -- pure API --------------------------------------------------------
    def reset(self, key):
        keys = jax.random.split(key, self.num_envs)
        return self._vreset(keys)

    def step(self, state: EnvState, actions):
        new_state, obs, reward, done, step_info = self._vstep(state,
                                                               actions)
        if self.max_episode_steps is not None:
            done = done | (new_state.steps >= self.max_episode_steps)
        info = {"terminal_obs": obs, "steps": new_state.steps, **step_info}
        if self.auto_reset:
            reset_keys = jax.vmap(
                lambda k: jax.random.split(k)[1]
            )(new_state.key)
            reset_state, reset_obs = self._vreset(reset_keys)

            def sel(a, b):
                d = done.reshape(done.shape + (1,) * (a.ndim - done.ndim))
                return jnp.where(d, a, b)

            new_state = jax.tree_util.tree_map(sel, reset_state, new_state)
            obs = sel(reset_obs, obs)
        return new_state, obs, reward, done, info
