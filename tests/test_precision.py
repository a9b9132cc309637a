"""Matmul-precision gate for the XLA physics path.

Default-precision dot_generals may run in a reduced-precision matrix
unit (TF32 on the GPU), which costs 1e-2-class per-substep error vs
CPU-f64 on this path.  The fix is trace-time (`jax.default_matmul_precision('highest')` around
the step trace in engine/world.py and envs/base.py), so it can be gated
WITHOUT a GPU: walk the traced jaxpr and require every dot_general —
including those inside scan/cond/pjit subjaxprs — to carry HIGHEST
precision.  A new default-precision einsum/`@` on the hot path fails
here instead of as silent physics drift on the GPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dartenv_tpu.engine.world import init_state, make_sim_step


def _iter_eqns(jaxpr):
    """All equations in a jaxpr, recursing into sub-jaxprs in params."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                yield from _iter_eqns(sub)


def _subjaxprs(v):
    core = jax.extend.core if hasattr(jax, "extend") else jax.core
    Jaxpr = getattr(core, "Jaxpr", None)
    ClosedJaxpr = getattr(core, "ClosedJaxpr", None)
    if ClosedJaxpr is not None and isinstance(v, ClosedJaxpr):
        yield v.jaxpr
    elif Jaxpr is not None and isinstance(v, Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _subjaxprs(x)


def _assert_all_highest(jaxpr, what):
    n_dots = 0
    for eqn in _iter_eqns(jaxpr):
        if eqn.primitive.name != "dot_general":
            continue
        n_dots += 1
        prec = eqn.params.get("precision")
        assert prec is not None, f"{what}: default-precision dot_general"
        if isinstance(prec, tuple):
            assert all(p == jax.lax.Precision.HIGHEST for p in prec), \
                f"{what}: dot_general precision {prec}"
        else:
            assert prec == jax.lax.Precision.HIGHEST, \
                f"{what}: dot_general precision {prec}"
    assert n_dots > 0, f"{what}: no dot_generals traced (vacuous gate)"


def _xla_only(monkeypatch):
    # force the phase-wise XLA path — the exact path under test (the
    # kernels are elementwise mul/add and carry no dot_generals)
    monkeypatch.setenv("DARTENV_NO_DYN_KERNEL", "1")
    monkeypatch.setenv("DARTENV_NO_PGS_KERNEL", "1")


@pytest.mark.parametrize("env", ["walker2d", "humanwalker"])
def test_sim_step_xla_path_all_dots_highest(monkeypatch, env):
    from dartenv_tpu.bench.throughput import make_task

    _xla_only(monkeypatch)
    task = make_task(env, dtype=jnp.float32)
    model = task.model
    step = make_sim_step(model)
    state = init_state(model, warm_start=True)
    tau = jnp.zeros((model.n,), jnp.float32)
    jaxpr = jax.make_jaxpr(step)(state, tau)
    _assert_all_highest(jaxpr.jaxpr, f"make_sim_step[{env}]")
    # the batched (vmapped) trace is what production runs
    B = 4
    statB = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), state)
    tauB = jnp.zeros((B, model.n), jnp.float32)
    jaxpr_b = jax.make_jaxpr(jax.vmap(step))(statB, tauB)
    _assert_all_highest(jaxpr_b.jaxpr, f"vmap(make_sim_step)[{env}]")


def test_sim_step_perturbation_and_servo_paths_highest(monkeypatch):
    """f_ext / servo_target take the branch the fused kernels never
    serve."""
    from dartenv_tpu.bench.throughput import make_task

    _xla_only(monkeypatch)
    model = make_task("hopper", dtype=jnp.float32).model
    step = make_sim_step(model)
    state = init_state(model, warm_start=True)
    tau = jnp.zeros((model.n,), jnp.float32)
    f_ext = jnp.zeros((model.nb, 6), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda s, t, f: step(s, t, f_ext_world=f))(state, tau, f_ext)
    _assert_all_highest(jaxpr.jaxpr, "make_sim_step[f_ext]")


def test_env_step_obs_reward_dots_highest(monkeypatch):
    """The full env step (obs/reward/done FK included)."""
    from dartenv_tpu.envs.base import make_env_reset, make_env_step
    from dartenv_tpu.bench.throughput import make_task

    _xla_only(monkeypatch)
    task = make_task("walker2d", dtype=jnp.float32)
    env_step = make_env_step(task)
    state, _ = make_env_reset(task)(jax.random.PRNGKey(0))
    a = jnp.zeros((task.action_size,), jnp.float32)
    jaxpr = jax.make_jaxpr(env_step)(state, a)
    _assert_all_highest(jaxpr.jaxpr, "make_env_step[walker2d]")


def test_lcp_capture_dots_highest(monkeypatch):
    from dartenv_tpu.engine.world import make_lcp_capture
    from dartenv_tpu.bench.throughput import make_task

    _xla_only(monkeypatch)
    model = make_task("hopper", dtype=jnp.float32).model
    cap = make_lcp_capture(model)
    state = init_state(model, warm_start=True)
    tau = jnp.zeros((model.n,), jnp.float32)
    jaxpr = jax.make_jaxpr(cap)(state, tau)
    _assert_all_highest(jaxpr.jaxpr, "make_lcp_capture")


def test_pallas_kernels_x64_clean():
    """Under jax_enable_x64 (the mixed-precision escalation tier's mode)
    the Pallas kernel bodies must stay f64-free: weak-f64 Python literals
    (`jnp.where(c, -1.0, 1.0)`) inside a kernel would promote its f32
    arithmetic and stores to f64.  Gate on the traced jaxpr so the leak
    fails on CPU, not mid-bench."""
    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.dynamics.pallas_dynamics import (
        _Static, dynamics_pallas)

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        task = make_task("walker2d", dtype=jnp.float32)
        model = task.model
        B = 8
        z = jnp.zeros((B, model.n), jnp.float32)
        dst = _Static(model)
        jaxpr = jax.make_jaxpr(
            lambda *a: dynamics_pallas(model, *a, st=dst, interpret=True)
        )(z, z, z)
        assert "f64" not in str(jaxpr), "f64 leaked into dynamics kernel"

        from dartenv_tpu.lcp.pallas_pgs import pgs_solve_pallas

        m = 6
        fi = np.full(m, -1, np.int32)
        Ab = jnp.eye(m, dtype=jnp.float32)[None].repeat(4, 0) * 2.0
        vb = jnp.zeros((4, m), jnp.float32)
        jaxpr = jax.make_jaxpr(
            lambda A, b: pgs_solve_pallas(A, b, b, b + 1.0, fi, b,
                                          b + 1.0, interpret=True)
        )(Ab, vb)
        assert "f64" not in str(jaxpr), "f64 leaked into PGS kernel"
    finally:
        jax.config.update("jax_enable_x64", prev)
