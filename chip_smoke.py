#!/usr/bin/env python3
"""Smoke test of the main path on NVIDIA GPUs.

    python3 chip_smoke.py               # one card: every phase below
    python3 chip_smoke.py --four-cards  # the sharded path on 4 cards only

Phases on one card, each printing its numbers before the last line:

  preflight  JAX's platform must be 'gpu'; prints the device kind and the
             card's `nvidia-smi` name and power limit.
  parity     each Pallas kernel, compiled for the card, against the plain
             XLA path on one substep from a warm state at real widths
             (walker2d B=4096, humanwalker B=1024, cartpole B=8192), and
             the kernel path against CPU float64 on a 64-env slice.
  main path  gym.make("DartWalker2d-v1") reset + 10 steps; the batched
             rollouts of bench.py (walker2d B=4096, humanwalker B=1024,
             cartpole B=8192 x 1000 steps, DR walker2d B=4096): finite
             states, completed episodes, and the Triton custom call of
             each kernel in the lowered program.

All programs are lowered first and compiled concurrently in threads.

With --four-cards: the walker2d `make_sharded_rollout` over four cards
against the one-card rollout of the same states, and one
`make_train_step` whose psum runs over NCCL.  (The humanwalker sharded
rollout runs on the 8-device CPU mesh in the test suite; on the cards
its two programs would add about 200 s of compilation.)

Any failure raises: nothing is caught.  The last line of standard output
is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The kernels each path must run (the Triton custom-call names).
DYNAMICS, PGS = "dartenv_dynamics", "dartenv_pgs"
KERNELS = {
    "walker2d": [DYNAMICS, PGS],
    "humanwalker": [PGS],       # n=29: dynamics over KERNEL_MAX_DOFS
    "cartpole": [DYNAMICS],     # no constraint rows
    "walker2d_dr": [PGS],       # traced model leaves: XLA dynamics
}
SIZES = {"walker2d": 4096, "humanwalker": 1024, "cartpole": 8192}

# One substep from the same warm f32 state: |kernel - XLA| over
# max(1, |XLA|_inf), per field.  The two sides run the same algebra in
# another association order (the kernels are unrolled per env, XLA
# contracts (B, n, n)/(B, m, m) arrays, with FMA contraction on both),
# so they differ by f32 rounding amplified by the conditioning of the
# n x n mass-matrix solve and of the m-row PGS: walker2d (n=9, m_c=24)
# stays near 1e-5, humanwalker (n=29, m_c=41) near 1e-3; on the CPU the
# suite holds the kernel traces to 2e-4 (dq_star) and 5e-6 (kinematics)
# in tests/test_pallas_dynamics.py.  Contact and limit activity is a
# discrete test on a depth; an env whose active set flips at the
# threshold is counted and excluded from the field check.
TOL_XLA = {"walker2d": 1e-3, "humanwalker": 2e-2, "cartpole": 1e-4}
# Against CPU float64 on 64 envs: f32 rounding of the whole substep
# (measured on the CPU at 6e-6 for walker2d and 1.1e-4 for humanwalker).
TOL_F64 = {"walker2d": 1e-3, "humanwalker": 5e-2, "cartpole": 1e-4}
MAX_FLIP_FRAC = 0.01
WARM_SUBSTEPS = 50
F64_ENVS = 64
SWITCHES = ("DARTENV_NO_DYN_KERNEL", "DARTENV_NO_PGS_KERNEL")


def preflight(n_cards: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform "
                 f"{devices[0].platform!r}); this script runs on the card")
    if len(devices) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs, JAX found "
                 f"{len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"preflight: platform=gpu kind={devices[0].device_kind} "
          f"count={len(devices)}")
    print(f"card: {card}")
    return devices


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _lower_step(model, state, tau, xla_only: bool):
    """Lower one batched substep returning (state', contacts.active);
    xla_only lowers it with every kernel switched off (the switches are
    read while the step is built and traced)."""
    import jax

    from dartenv_tpu.engine.world import make_sim_step

    if xla_only:
        for f in SWITCHES:
            os.environ[f] = "1"
    try:
        step1 = make_sim_step(model)

        def fn(s, t):
            s2, c = jax.vmap(step1)(s, t)
            return s2, c.active

        return jax.jit(fn).lower(state, tau)
    finally:
        for f in SWITCHES:
            os.environ.pop(f, None)


def lower_parity(env: str, B: int) -> dict:
    """The kernel-path and XLA-path substeps of `env` at batch B (f32,
    on the card), and the CPU float64 substep on F64_ENVS envs."""
    import jax
    import jax.numpy as jnp

    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.engine.world import init_state
    from dartenv_tpu.envs.base import with_solver

    # escalation off: its worst-K choice is a cross-env ranking, so two
    # paths whose residuals differ in the last bits can escalate other
    # envs; the kernels themselves are what is compared here
    task = make_task(env)
    model = with_solver(task.model, None, escalate_frac=0.0)
    rng = np.random.default_rng(1)
    n, root = model.n, int(model.ndof[0])
    s0 = init_state(model, warm_start=task.warm_start)
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), s0)
    q = np.asarray(model.q_init)[None] + rng.uniform(-0.05, 0.05, (B, n))
    state = state.__class__(
        q=jnp.asarray(q, jnp.float32),
        dq=jnp.asarray(rng.uniform(-0.5, 0.5, (B, n)), jnp.float32),
        time=state.time, lam=state.lam)
    tau = np.zeros((B, n), np.float32)
    tau[:, root:] = rng.uniform(-1.0, 1.0, (B, n - root)) * 50.0
    tau = jnp.asarray(tau)
    out = dict(env=env, B=B, state=state, tau=tau,
               kernel=_lower_step(model, state, tau, False),
               xla=_lower_step(model, state, tau, True))
    k = min(F64_ENVS, B)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        model64 = with_solver(make_task(env, dtype=jnp.float64).model,
                              None, escalate_frac=0.0)
        s64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x)[:k], jnp.float64), state)
        out["f64"] = _lower_step(model64, s64,
                                 jnp.asarray(np.asarray(tau)[:k],
                                             jnp.float64), False)
    return out


def check_parity(p: dict, exe: dict):
    """Warm the batch with WARM_SUBSTEPS XLA substeps (contacts active),
    then compare one substep: kernel vs XLA on the card, kernel vs CPU
    float64 on the first F64_ENVS envs."""
    import jax
    import jax.numpy as jnp

    env, B, tau = p["env"], p["B"], p["tau"]
    state = p["state"]
    for _ in range(WARM_SUBSTEPS):
        state = exe["xla"](state, tau)[0]
    (sk, ak), (sx, ax) = exe["kernel"](state, tau), exe["xla"](state, tau)
    kern = [p["kernel_names"], p["xla_names"]]
    assert kern == [KERNELS[env], []], (env, kern)
    assert all(np.isfinite(np.asarray(v)).all() for v in (sk.q, sk.dq))
    ak, ax = np.asarray(ak), np.asarray(ax)
    same = (ak == ax).all(axis=1)
    flips = int(B - same.sum())
    active = float(ak.sum()) / B
    fields = lambda s: (("q", s.q), ("dq", s.dq), ("lam", s.lam))
    errs = {f: _rel(np.asarray(a)[same], np.asarray(b)[same])
            for (f, a), (_, b) in zip(fields(sk), fields(sx))}
    print(f"parity {env} B={B}: kernels={kern[0]} contacts/env="
          f"{active:.2f} active-set flips={flips} rel err vs XLA "
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (tol {TOL_XLA[env]:.0e})", flush=True)
    assert flips <= MAX_FLIP_FRAC * B, (env, flips)
    assert max(errs.values()) <= TOL_XLA[env], (env, errs)
    assert active > 0 or env == "cartpole", (env, "no contacts")

    k = min(F64_ENVS, B)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        s64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x)[:k], jnp.float64), state)
        t64 = jnp.asarray(np.asarray(tau)[:k], jnp.float64)
        s6, a6 = exe["f64"](s64, t64)
    a6 = np.asarray(a6)
    same6 = (ak[:k] == a6).all(axis=1)
    errs6 = {f: _rel(np.asarray(a)[:k][same6], np.asarray(b)[same6])
             for (f, a), (_, b) in zip(fields(sk), fields(s6))}
    print(f"parity {env} vs CPU f64 ({k} envs, flips="
          f"{int(k - same6.sum())}): rel err "
          + " ".join(f"{k_}={v:.2e}" for k_, v in errs6.items())
          + f" (tol {TOL_F64[env]:.0e})", flush=True)
    assert p["f64_names"] == [] and max(errs6.values()) <= TOL_F64[env], \
        (env, errs6)


def gym_check():
    import dartenv_tpu as gym

    env = gym.make("DartWalker2d-v1")
    env.seed(0)
    obs = env.reset()
    for _ in range(10):
        obs, r, done, _info = env.step(env.action_space.sample())
        assert np.isfinite(np.asarray(obs)).all() and np.isfinite(r)
        if done:
            obs = env.reset()
    print(f"gym DartWalker2d-v1: reset + 10 steps ok, obs "
          f"{np.asarray(obs).shape}", flush=True)


def one_card():
    """Lower every program, compile them concurrently in threads (XLA
    releases the GIL while it compiles), run the gym check meanwhile,
    then check parity and run the bench cells."""
    from dartenv_tpu.bench.throughput import (
        lower_dr, lower_env, lowered_kernels, run_dr, run_env,
        timed_compile,
    )

    t0 = time.perf_counter()
    parity = {env: lower_parity(env, B) for env, B in SIZES.items()}
    cells = {env: lower_env(env, B, 1000 if env == "cartpole" else 100)
             for env, B in SIZES.items()}
    dr = lower_dr("walker2d", SIZES["walker2d"])
    jobs = {(env, side): p[side] for env, p in parity.items()
            for side in ("kernel", "xla", "f64")}
    jobs.update({("bench", env): c["lowered"] for env, c in cells.items()})
    jobs[("bench", "dr")] = dr["lowered"]
    print(f"lowered {len(jobs)} programs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for env, p in parity.items():
        for side in ("kernel", "xla", "f64"):
            p[side + "_names"] = lowered_kernels(p[side])

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {k: pool.submit(timed_compile, low)
                   for k, low in jobs.items()}
        gym_check()
        done = {k: f.result() for k, f in futures.items()}
    print("compile s (concurrent): " + " ".join(
        f"{a}/{b}={done[(a, b)][1]:.1f}" for a, b in jobs), flush=True)

    for env, p in parity.items():
        check_parity(p, {side: done[(env, side)][0]
                         for side in ("kernel", "xla", "f64")})
    for env, cell in cells.items():
        exe, secs = done[("bench", env)]
        r = run_env(cell, exe, secs, iters=3)
        print(f"bench {env} B={r['batch']} T={r['horizon']}: "
              f"{r['env_steps_per_s_per_chip']:.1f} env-steps/s "
              f"compile_s={secs:.1f} kernels={r['kernels']} "
              f"episodes={r['episodes_seen']:.0f}", flush=True)
        assert r["kernels"] == KERNELS[env], (env, r["kernels"])
        assert r["state_finite"], env
        assert r["episodes_seen"] > 0, env
    exe, secs = done[("bench", "dr")]
    r = run_dr(dr, exe, secs, iters=3)
    print(f"bench DR walker2d B={r['batch']}: "
          f"{r['env_steps_per_s_per_chip']:.1f} env-steps/s "
          f"compile_s={secs:.1f} kernels={r['kernels']}", flush=True)
    assert r["kernels"] == KERNELS["walker2d_dr"], r["kernels"]
    assert r["state_finite"]


def four_cards(devices):
    """The sharded rollout over 4 cards == the one-card rollout of the
    same states, and one data-parallel train step (psum over NCCL).  All
    programs are lowered first and compiled concurrently."""
    import jax
    import jax.numpy as jnp

    from dartenv_tpu.bench.throughput import timed_compile
    from dartenv_tpu.envs.walker2d import make_walker2d_task
    from dartenv_tpu.parallel.rollout import make_rollout
    from dartenv_tpu.parallel.sharding import (
        env_mesh, make_sharded_rollout, shard_env_batch,
    )
    from dartenv_tpu.parallel.train import (
        init_policy, make_train_step, policy_mean,
    )
    from dartenv_tpu.parallel.vec_env import VecEnv

    t0 = time.perf_counter()
    mesh = env_mesh(devices[:4])
    det = lambda params, obs, key: policy_mean(params, obs)
    key = jax.random.PRNGKey(5)
    runs, jobs = {}, {}
    # escalate_frac=0: escalation ranks its worst K per device under
    # shard_map, so an escalating sharded run may escalate other envs
    # than the one-card run; the shard plumbing is what is compared
    for name, make, B, T in (("walker2d", make_walker2d_task, 4096, 40),):
        task = make(dtype=jnp.float32, escalate_frac=0.0)
        # a time limit inside the horizon: every env completes episodes
        vec = VecEnv(task, B, max_episode_steps=T // 2)
        params = init_policy(jax.random.PRNGKey(3), task.obs_size,
                             task.action_size, dtype=jnp.float32)
        state0, _ = vec.reset(jax.random.PRNGKey(4))
        sh_state = shard_env_batch(state0, mesh)
        one_state = jax.device_put(state0, devices[0])
        jobs[(name, "sharded")] = jax.jit(
            make_sharded_rollout(vec, det, T, mesh)).lower(
                params, sh_state, key)
        jobs[(name, "one-card")] = jax.jit(
            make_rollout(vec, det, T)).lower(params, one_state, key)
        runs[name] = (B, T, params, sh_state, one_state)
    init_fn, train_step = make_train_step(
        make_walker2d_task(dtype=jnp.float32), num_envs=4096, horizon=16,
        mesh=mesh, max_episode_steps=1000)
    tparams, tstate = init_fn(jax.random.PRNGKey(0))
    tkey = jax.random.PRNGKey(1)
    jobs[("train", "step")] = jax.jit(train_step).lower(tparams, tstate,
                                                        tkey)
    print(f"four-cards: lowered {len(jobs)} programs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {k: pool.submit(timed_compile, low)
                   for k, low in jobs.items()}
        done = {k: f.result() for k, f in futures.items()}
    print("four-cards compile s (concurrent): " + " ".join(
        f"{a}/{b}={done[(a, b)][1]:.1f}" for a, b in jobs), flush=True)

    for name, (B, T, params, sh_state, one_state) in runs.items():
        _, st_sh = done[(name, "sharded")][0](params, sh_state, key)
        _, st_un = done[(name, "one-card")][0](params, one_state, key)
        eps_sh, eps_un = float(st_sh.episodes), float(st_un.episodes)
        rr_sh = np.sort(np.asarray(st_sh.running_return))
        rr_un = np.sort(np.asarray(st_un.running_return))
        err = float(np.abs(rr_sh - rr_un).max()
                    / max(1.0, np.abs(rr_un).max()))
        print(f"four-cards {name} B={B} T={T}: episodes sharded="
              f"{eps_sh:.0f} one-card={eps_un:.0f} running-return rel "
              f"err={err:.2e}", flush=True)
        assert eps_sh == eps_un and eps_sh > 0, (name, eps_sh, eps_un)
        # per-env returns accumulate T*frame_skip chaotic f32 contact
        # substeps whose batch shapes differ between (B/4,) shards and
        # the (B,) batch, so per-env returns drift by f32 rounding
        assert err <= 1e-3, (name, err)
    exe = done[("train", "step")][0]
    tparams, tstate, tstats = exe(tparams, tstate, tkey)
    jax.block_until_ready(tparams)
    assert all(bool(jnp.all(jnp.isfinite(v)))
               for v in jax.tree_util.tree_leaves(tparams))
    n_ar = exe.as_text().count("all-reduce")
    print(f"four-cards train step: ok, episodes={float(tstats.episodes):.0f}"
          f", all-reduce ops in the compiled program={n_ar}", flush=True)
    assert n_ar > 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on 4 GPUs")
    args = p.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    devices = preflight(n_cards)

    from dartenv_tpu.backend import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(devices)
    else:
        one_card()
    print(f"total seconds: {time.perf_counter() - t0:.1f}")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
