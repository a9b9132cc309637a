"""Multi-process distributed path.

The reference has no distributed layer (SURVEY.md §2.5); the rebuild's
multi-host story is standard JAX SPMD: `jax.distributed.initialize()` then
the same shard_map code, collectives riding the runtime transport (NCCL
on GPUs; Gloo here on CPU).  This test ACTUALLY runs it: two OS processes with
2 virtual CPU devices each form one 4-device global mesh, run the sharded
deterministic-policy rollout on DartCartPole, and both processes' psum'd
episode stats must equal a single-process unsharded rollout of the same
initial states.
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

_CHILD = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="localhost:" + port,
                           num_processes=2, process_id=pid)
import jax.numpy as jnp
import jax.experimental.multihost_utils as mhu
from jax.sharding import PartitionSpec as P
from dartenv_tpu.envs.cart_pole import make_cartpole_task
from dartenv_tpu.parallel.sharding import env_mesh, make_sharded_rollout
from dartenv_tpu.parallel.train import init_policy, policy_mean
from dartenv_tpu.parallel.vec_env import VecEnv

task = make_cartpole_task(dtype=jnp.float32)
mesh = env_mesh()                       # 4 global devices, 2 per process
vec = VecEnv(task, num_envs=8, max_episode_steps=5)
params = init_policy(jax.random.PRNGKey(3), task.obs_size,
                     task.action_size, dtype=jnp.float32)
det = lambda p, obs, key: policy_mean(p, obs)
rollout = jax.jit(make_sharded_rollout(vec, det, 12, mesh))

# every process computes the same full reset (same key), then keeps its
# addressable shard — standard JAX SPMD data distribution
state0, _ = vec.reset(jax.random.PRNGKey(4))
# host_local_array_to_global_array concatenates per-process locals, so
# feed each process its OWN half to reconstruct the full batch
half = jax.tree_util.tree_map(lambda x: x[pid * 4:(pid + 1) * 4], state0)
gstate = jax.tree_util.tree_map(
    lambda x: mhu.host_local_array_to_global_array(x, mesh, P("env")),
    half)
_, stats = rollout(params, gstate, jax.random.PRNGKey(5))
print("RESULT", pid, float(stats.episodes), float(stats.returns_sum),
      flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_rollout(tmp_path):
    port = str(_free_port())
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), port],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    results = {}
    for out in outs:
        m = re.search(r"RESULT (\d) ([-\d.e+]+) ([-\d.e+]+)", out)
        assert m, out[-2000:]
        results[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    # both processes see identical psum'd global stats
    assert results[0] == results[1], results

    # single-process ground truth of the same rollout
    import jax
    import jax.numpy as jnp
    from dartenv_tpu.envs.cart_pole import make_cartpole_task
    from dartenv_tpu.parallel.rollout import make_rollout
    from dartenv_tpu.parallel.train import init_policy, policy_mean
    from dartenv_tpu.parallel.vec_env import VecEnv

    task = make_cartpole_task(dtype=jnp.float32)
    vec = VecEnv(task, num_envs=8, max_episode_steps=5)
    params = init_policy(jax.random.PRNGKey(3), task.obs_size,
                         task.action_size, dtype=jnp.float32)
    det = lambda p, obs, key: policy_mean(p, obs)
    state0, _ = vec.reset(jax.random.PRNGKey(4))
    _, stats = jax.jit(make_rollout(vec, det, 12))(
        params, state0, jax.random.PRNGKey(5))
    eps, rets = results[0]
    assert eps > 0
    assert eps == float(stats.episodes)
    np.testing.assert_allclose(rets, float(stats.returns_sum), rtol=1e-5)
