"""Device-mesh sharding of env batches (SURVEY.md §2.5/§2.6).

The reference has no distributed layer; this module is the data-parallel
design: a 1-D `Mesh(('env',))` over all cards, env batches sharded along
it with `shard_map`, per-device stepping with ZERO cross-card
communication inside `sim_step` (envs are independent), and XLA
collectives (`all_gather` / `psum`, NCCL on GPUs) only at the learner
boundary.  Multi-host entry is standard JAX SPMD:
`jax.distributed.initialize()` then the same code (one process per host,
each host owns its addressable shard).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from dartenv_tpu.parallel.rollout import EpisodeStats, make_rollout
from dartenv_tpu.parallel.vec_env import VecEnv


def env_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices with a single 'env' axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("env",))


def distributed_init(**kwargs):
    """Multi-host entry point: `jax.distributed.initialize` (SURVEY.md
    §2.5 "Distributed runtime").  No-op when already initialized or
    single-process."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass


def replicate_model(tree, mesh: Mesh):
    """Model/params are identical on every device (the env axis shards
    only the state/obs batch)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_env_batch(tree, mesh: Mesh):
    """Place a batched pytree with leading env axis onto the mesh."""
    sharding = NamedSharding(mesh, P("env"))
    return jax.device_put(tree, sharding)


def make_sharded_rollout(vec_env: VecEnv, policy_fn: Callable,
                         horizon: int, mesh: Mesh,
                         gather_stats: bool = True,
                         collect: bool = False):
    """shard_map-wrapped rollout: each device steps its env shard; episode
    stats are reduced over the mesh with `psum` (the only collective on the
    rollout path — learner-side gathers live in the train step).

    With collect=True also returns the (T, B, ...) trajectory stack,
    sharded along the env (batch) axis.
    """
    n_dev = mesh.shape["env"]
    assert vec_env.num_envs % n_dev == 0, (
        f"num_envs={vec_env.num_envs} must divide over {n_dev} devices"
    )
    per_dev = vec_env.num_envs // n_dev
    local_env = VecEnv(
        vec_env.task, per_dev,
        max_episode_steps=vec_env.max_episode_steps,
        auto_reset=vec_env.auto_reset,
    )
    local_rollout = make_rollout(local_env, policy_fn, horizon,
                                 collect=collect)

    state_spec = P("env")
    stats_spec = EpisodeStats(
        returns_sum=P(), lengths_sum=P(), episodes=P(),
        running_return=P("env"), running_length=P("env"),
    )

    def _body(params, state, keys):
        out = local_rollout(params, state, keys[0])
        state, stats = out[0], out[1]
        if gather_stats:
            stats = EpisodeStats(
                returns_sum=jax.lax.psum(stats.returns_sum, "env"),
                lengths_sum=jax.lax.psum(stats.lengths_sum, "env"),
                episodes=jax.lax.psum(stats.episodes, "env"),
                running_return=stats.running_return,
                running_length=stats.running_length,
            )
        if collect:
            return state, stats, out[2]
        return state, stats

    out_specs = (state_spec, stats_spec)
    if collect:
        traj_spec = (P(None, "env"), P(None, "env"), P(None, "env"),
                     P(None, "env"))
        out_specs = (state_spec, stats_spec, traj_spec)

    sharded = shard_map(
        _body, mesh=mesh,
        in_specs=(P(), state_spec, P("env")),
        out_specs=out_specs,
        check_vma=False,
    )

    def rollout(params, state, key):
        keys = jax.random.split(key, n_dev)
        return sharded(params, state, keys)

    return rollout


def sharded_reset(vec_env: VecEnv, mesh: Mesh, key):
    """Reset all envs with state sharded over the mesh."""
    state, obs = vec_env.reset(key)
    return (
        shard_env_batch(state, mesh),
        shard_env_batch(obs, mesh),
    )
