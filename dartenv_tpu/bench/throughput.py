"""Throughput benchmark: batched env-steps/s (SURVEY.md §6).

Primary tracked metric (BASELINE.json): env-steps/s/chip on batched
DartWalker2d.  One env-step = one control step (frame_skip physics substeps
inside).  The whole rollout (policy + B envs x T steps) is a single jitted
XLA program; timing excludes compilation.

Baseline note: the reference publishes NO numbers (BASELINE.md).  The
`vs_baseline` ratio is computed against the survey's anecdotal single-core
CPU estimate for the reference stack (~5,000 env-steps/s/core, SURVEY.md §6
"anecdotal reference speed", explicitly an estimate) until the reference
can be measured.
"""
from __future__ import annotations

import json
import time
from typing import Optional

import jax
import jax.numpy as jnp

from dartenv_tpu.backend import enable_compile_cache

REFERENCE_CPU_STEPS_PER_S = 5000.0  # anecdotal estimate, see module docstring

_TASKS = {
    "cartpole": ("dartenv_tpu.envs.cart_pole", "make_cartpole_task"),
    "reacher": ("dartenv_tpu.envs.reacher", "make_reacher_task"),
    "hopper": ("dartenv_tpu.envs.hopper", "make_hopper_task"),
    "walker2d": ("dartenv_tpu.envs.walker2d", "make_walker2d_task"),
    "humanwalker": ("dartenv_tpu.envs.human_walker",
                    "make_humanwalker_task"),
    "reacher2d": ("dartenv_tpu.envs.reacher2d", "make_reacher2d_task"),
    "doublependulum": ("dartenv_tpu.envs.double_pendulum",
                       "make_double_pendulum_task"),
    "snake7link": ("dartenv_tpu.envs.snake_7link", "make_snake7link_task"),
    "walker3d": ("dartenv_tpu.envs.walker3d", "make_walker3d_task"),
    "dog": ("dartenv_tpu.envs.dog", "make_dog_task"),
}


def device_info():
    """The device as JAX reports it: every result names where it ran."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def lowered_kernels(lowered):
    """Names of the Pallas kernels (Triton custom calls) in a lowered
    program: what proves a run took the kernel path and not XLA."""
    import re

    return sorted(set(re.findall(r'name = "(dartenv_\w+)"',
                                 lowered.as_text())))


def tree_finite(tree) -> bool:
    """Every floating leaf of a pytree is finite."""
    return all(bool(jnp.all(jnp.isfinite(x)))
               for x in jax.tree_util.tree_leaves(tree)
               if jnp.issubdtype(x.dtype, jnp.floating))


def make_task(name: str, dtype=jnp.float32, lcp_solver=None):
    import importlib

    mod, fn = _TASKS[name]
    kw = {} if lcp_solver is None else dict(lcp_solver=lcp_solver)
    return getattr(importlib.import_module(mod), fn)(dtype=dtype, **kw)


def random_policy(task):
    hi = jnp.asarray(task.control_bounds[0], dtype=jnp.float32)
    lo = jnp.asarray(task.control_bounds[1], dtype=jnp.float32)

    def policy(params, obs, key):
        del params
        shape = obs.shape[:-1] + (task.action_size,)
        return jax.random.uniform(key, shape, obs.dtype, 0.0, 1.0) * (
            hi - lo
        ) + lo

    return policy


def lower_env(name: str = "walker2d", batch: int = 4096,
              horizon: int = 100, max_episode_steps: int = 1000,
              devices=None, lcp_solver=None, warm_start: bool = True,
              solver_overrides=None) -> dict:
    """Build and lower one rollout cell (random policy, B envs x horizon
    control steps, one jitted program).  Returns the cell: its lowered
    program plus what `run_env` needs.  Lowering reads the kernel
    switches (DARTENV_NO_*_KERNEL); compiling may then happen anywhere,
    e.g. several cells concurrently in threads."""
    from dartenv_tpu.parallel.rollout import make_rollout
    from dartenv_tpu.parallel.sharding import (
        env_mesh, make_sharded_rollout, shard_env_batch,
    )
    from dartenv_tpu.parallel.vec_env import VecEnv

    task = make_task(name, lcp_solver=lcp_solver)
    if not warm_start:
        # cold-start LCP every substep (reference semantics) — drops the
        # lam carry entirely
        task.warm_start = False
    if solver_overrides:
        from dartenv_tpu.envs.base import with_solver
        task.model = with_solver(task.model, **solver_overrides)
    vec = VecEnv(task, num_envs=batch, max_episode_steps=max_episode_steps)
    policy = random_policy(task)

    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_dev > 1:
        mesh = env_mesh(devices)
        rollout = jax.jit(
            make_sharded_rollout(vec, policy, horizon, mesh)
        )
        state, _ = vec.reset(jax.random.PRNGKey(0))
        state = shard_env_batch(state, mesh)
    else:
        rollout = jax.jit(make_rollout(vec, policy, horizon))
        state, _ = vec.reset(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    return dict(name=name, batch=batch, horizon=horizon, n_dev=n_dev,
                frame_skip=task.frame_skip, state=state, key=key,
                lowered=rollout.lower(None, state, key))


def timed_compile(lowered):
    """(executable, seconds) — XLA compile, Triton kernels included."""
    t0 = time.perf_counter()
    exe = lowered.compile()
    return exe, time.perf_counter() - t0


def run_env(cell: dict, rollout, compile_s: float, iters: int = 5,
            profile_dir: Optional[str] = None) -> dict:
    """Warm up and time a compiled cell; returns env-steps/s and detail."""
    state, key = cell["state"], cell["key"]
    state, stats = rollout(None, state, key)
    jax.block_until_ready(stats.returns_sum)

    if profile_dir:
        # one profiled iteration; the engine's named scopes (dynamics /
        # collision / constraints / integrate) show up per-phase in
        # TensorBoard/XProf (SURVEY.md §5.1)
        with jax.profiler.trace(profile_dir):
            state, stats = rollout(None, state, key)
            jax.block_until_ready(stats.returns_sum)

    times = []
    for i in range(iters):
        key = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        state, stats = rollout(None, state, key)
        jax.block_until_ready(stats.returns_sum)
        times.append(time.perf_counter() - t0)

    best = min(times)
    steps = cell["batch"] * cell["horizon"]
    n_dev = cell["n_dev"]
    return {
        "env": cell["name"],
        "device": device_info(),
        "batch": cell["batch"],
        "horizon": cell["horizon"],
        "devices": n_dev,
        "env_steps_per_s": steps / best,
        "env_steps_per_s_per_chip": steps / best / n_dev,
        "substeps_per_s": steps * cell["frame_skip"] / best,
        "compile_s": compile_s,
        "kernels": lowered_kernels(cell["lowered"]),
        "iter_times_s": times,
        "episodes_seen": float(stats.episodes),
        "mean_return": float(stats.mean_return()),
        "state_finite": tree_finite(state),
    }


def bench_env(name: str = "walker2d", batch: int = 4096,
              horizon: int = 100, iters: int = 5,
              max_episode_steps: int = 1000, devices=None,
              profile_dir: Optional[str] = None, lcp_solver=None,
              warm_start: bool = True, solver_overrides=None):
    """Returns dict with env-steps/s and timing detail."""
    t0 = time.perf_counter()
    cell = lower_env(name, batch, horizon, max_episode_steps, devices,
                     lcp_solver, warm_start, solver_overrides)
    rollout, _ = timed_compile(cell["lowered"])
    # compile_s: trace + lower + XLA compile, kernels included
    return run_env(cell, rollout, time.perf_counter() - t0, iters,
                   profile_dir)


def lower_dr(name: str = "walker2d", batch: int = 4096,
             substeps: int = 400) -> dict:
    """Build and lower a DOMAIN-RANDOMIZED cell: per-env
    mass/friction/damping leaves, stepped as one jitted lax.scan over
    `substeps` physics substeps."""
    import numpy as np

    from dartenv_tpu.engine.world import init_state
    from dartenv_tpu.parallel.domain_rand import (
        make_randomized_sim_step, randomize_model,
    )

    task = make_task(name)
    model = task.model
    spec = {"mass": 0.3, "geom_friction": 0.3, "damping": 0.3}
    bmodel = randomize_model(model, jax.random.PRNGKey(0), spec, batch)
    vstep = make_randomized_sim_step(model, list(spec))

    state0 = init_state(model, warm_start=task.warm_start)
    stateB = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), state0)
    rng = np.random.default_rng(0)
    tauB = jnp.asarray(rng.uniform(-1.0, 1.0, (batch, model.n)),
                       jnp.float32) * 50.0

    def roll(state):
        def body(s, _):
            s2, _ = vstep(bmodel, s, tauB)
            return s2, ()

        out, _ = jax.lax.scan(body, state, None, length=substeps)
        return out

    return dict(name=name, batch=batch, substeps=substeps,
                frame_skip=task.frame_skip, dr_fields=sorted(spec),
                state=stateB, lowered=jax.jit(roll).lower(stateB))


def run_dr(cell: dict, roll, compile_s: float, iters: int = 5) -> dict:
    """Time a compiled DR cell.  Reported env-steps/s divides substeps
    by frame_skip so numbers are comparable to bench_env's control-step
    metric."""
    out = roll(cell["state"])
    jax.block_until_ready(out.q)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = roll(cell["state"])
        jax.block_until_ready(out.q)
        times.append(time.perf_counter() - t0)
    env_steps = cell["batch"] * cell["substeps"] / cell["frame_skip"]
    return {
        "env": cell["name"], "device": device_info(),
        "batch": cell["batch"], "substeps": cell["substeps"],
        "dr_fields": cell["dr_fields"],
        "env_steps_per_s_per_chip": env_steps / min(times),
        "compile_s": compile_s,
        "kernels": lowered_kernels(cell["lowered"]),
        "iter_times_s": times, "state_finite": tree_finite(out),
    }


def bench_dr(name: str = "walker2d", batch: int = 4096,
             substeps: int = 400, iters: int = 5):
    """Throughput of a domain-randomized batch (lower_dr + run_dr)."""
    t0 = time.perf_counter()
    cell = lower_dr(name, batch, substeps)
    roll, _ = timed_compile(cell["lowered"])
    return run_dr(cell, roll, time.perf_counter() - t0, iters)


# the five BASELINE.md benchmark configs (env, batch); humanwalker's batch
# is smaller because 29 dofs x frame_skip 15 is ~10x the per-env work
# (env, batch, horizon): cartpole runs a 1000-step horizon — its per-step
# work is so small that a 100-step rollout is dominated by per-call
# dispatch latency
BASELINE_CONFIGS = (("cartpole", 8192, 1000), ("reacher", 4096, 100),
                    ("hopper", 4096, 100), ("walker2d", 4096, 100),
                    ("humanwalker", 1024, 100))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--env", default="walker2d", choices=sorted(_TASKS))
    p.add_argument("--all", action="store_true",
                   help="run all five BASELINE.md configs sequentially and "
                        "print one JSON line each (docs/BENCH.md table)")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=None,
                   help="rollout length per timed call (default: 1000 "
                        "for cartpole, 100 otherwise)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--profile_dir", default=None,
                   help="write a jax.profiler trace of one iteration here")
    p.add_argument("--solver", default=None, choices=["pgs", "dantzig"],
                   help="override the task's LCP solver")
    p.add_argument("--cold", action="store_true",
                   help="disable LCP warm-starting (cold start every "
                        "substep; bisect/validation mode)")
    p.add_argument("--pgs_iters", type=int, default=None,
                   help="override the task's PGS iteration budget")
    p.add_argument("--escalate_frac", type=float, default=None,
                   help="override the task's exact-solver escalation "
                        "fraction (0 disables)")
    p.add_argument("--escalate_iters", type=int, default=None,
                   help="override the tier-1 escalation pivot budget")
    p.add_argument("--escalate_iters2", type=int, default=None,
                   help="tier-2 cold re-solve pivot budget (0 disables)")
    p.add_argument("--escalate_refine", type=int, default=None,
                   help="tier-1 refinement pivots (-1 = legacy formula)")
    p.add_argument("--escalate_kmax", type=int, default=None,
                   help="cap on the escalation batch K")
    p.add_argument("--escalate_ref64", type=int, default=None,
                   help="mixed-precision f64-residual refinement passes "
                        "for the escalated K batch (enables x64)")
    p.add_argument("--escalate_ref", type=int, default=None,
                   help="compensated double-float refinement passes "
                        "(production tier; no x64 needed)")
    p.add_argument("--dr", action="store_true",
                   help="bench a domain-randomized batch (per-env "
                        "mass/friction/damping) at the substep level")
    args = p.parse_args(argv)

    if args.escalate_ref64 is not None:
        # f64 arrays must exist for lcp/dantzig.refine_mixed; the kernels
        # stay f32 (pallas_dynamics._x64_safe_kernel)
        jax.config.update("jax_enable_x64", True)

    enable_compile_cache()
    overrides = {}
    if args.pgs_iters is not None:
        overrides["pgs_iters"] = args.pgs_iters
    if args.escalate_frac is not None:
        overrides["escalate_frac"] = args.escalate_frac
    if args.escalate_iters is not None:
        overrides["escalate_iters"] = args.escalate_iters
    if args.escalate_iters2 is not None:
        overrides["escalate_iters2"] = args.escalate_iters2
    if args.escalate_refine is not None:
        overrides["escalate_refine"] = args.escalate_refine
    if args.escalate_kmax is not None:
        overrides["escalate_kmax"] = args.escalate_kmax
    if args.escalate_ref64 is not None:
        overrides["escalate_ref64"] = args.escalate_ref64
    if args.escalate_ref is not None:
        overrides["escalate_ref"] = args.escalate_ref
    overrides = overrides or None

    if args.dr:
        r = bench_dr(args.env, args.batch, iters=args.iters)
        per_chip = r["env_steps_per_s_per_chip"]
        line = {
            "metric": f"env-steps/s/chip (DR Dart"
                      f"{args.env.capitalize()}, B={args.batch})",
            "value": round(per_chip, 1),
            "unit": "env-steps/s/chip",
            "vs_baseline": round(per_chip / REFERENCE_CPU_STEPS_PER_S, 2),
        }
        if args.verbose:
            print(json.dumps(r, indent=2))
        print(json.dumps(line))
        return line

    if args.all:
        lines = []
        for env, batch, horizon in BASELINE_CONFIGS:
            r = bench_env(env, batch, args.horizon or horizon, args.iters,
                          lcp_solver=args.solver,
                          warm_start=not args.cold,
                          solver_overrides=overrides)
            per_chip = r["env_steps_per_s_per_chip"]
            line = {
                "metric": f"env-steps/s/chip (batched Dart"
                          f"{env.capitalize()}, B={batch})",
                "value": round(per_chip, 1),
                "unit": "env-steps/s/chip",
                "vs_baseline": round(per_chip / REFERENCE_CPU_STEPS_PER_S,
                                     2),
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
        return lines

    horizon = args.horizon or (1000 if args.env == "cartpole" else 100)
    r = bench_env(args.env, args.batch, horizon, args.iters,
                  profile_dir=args.profile_dir, lcp_solver=args.solver,
                  warm_start=not args.cold, solver_overrides=overrides)
    per_chip = r["env_steps_per_s_per_chip"]
    line = {
        "metric": f"env-steps/s/chip (batched Dart{args.env.capitalize()},"
                  f" B={args.batch})",
        "value": round(per_chip, 1),
        "unit": "env-steps/s/chip",
        "vs_baseline": round(per_chip / REFERENCE_CPU_STEPS_PER_S, 2),
    }
    if args.verbose:
        print(json.dumps(r, indent=2))
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
