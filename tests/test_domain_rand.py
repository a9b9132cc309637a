"""Batched model params / domain randomization (SURVEY.md §2.5 "Batched
model params", VERDICT.md r1 missing #7): per-env physics parameters with
a leading env axis, one vmapped XLA program — correctness proven against
per-env unbatched runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.engine.world import init_state, make_sim_step
from dartenv_tpu.parallel.domain_rand import (
    LAYOUT_LEAVES, make_randomized_sim_step, model_in_axes, randomize_model,
)

from test_dynamics import double_pendulum_model


def test_randomized_batch_matches_per_env_runs():
    """vmapped batched-model stepping == stepping each env's model
    individually (bitwise in f64 up to vmap reassociation tolerance)."""
    base = double_pendulum_model(dtype=jnp.float64)
    base = dataclasses.replace(base, damping=jnp.asarray([0.3, 0.8]))
    num_envs = 5
    spec = {"mass": 0.4, "damping": 0.5}
    bmodel = randomize_model(base, jax.random.PRNGKey(0), spec, num_envs)
    assert bmodel.mass.shape == (num_envs, base.nb)
    assert bmodel.damping.shape == (num_envs, base.n)

    vstep = jax.jit(make_randomized_sim_step(base, list(spec)))
    state0 = init_state(base)
    bstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (num_envs,) + x.shape), state0)
    btau = jnp.broadcast_to(jnp.asarray([0.5, -0.2]), (num_envs, 2))

    bs = bstate
    for _ in range(25):
        bs, _ = vstep(bmodel, bs, btau)

    # per-env ground truth with plain (unbatched) models
    for i in range(num_envs):
        mi = base.replace(mass=bmodel.mass[i], damping=bmodel.damping[i])
        step_i = jax.jit(make_sim_step(mi))
        si = state0
        for _ in range(25):
            si, _ = step_i(si, jnp.asarray([0.5, -0.2]))
        np.testing.assert_allclose(
            np.asarray(bs.q[i]), np.asarray(si.q), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(bs.dq[i]), np.asarray(si.dq), rtol=1e-12, atol=1e-12)

    # randomization actually changes the physics across envs
    assert float(jnp.std(bs.q[:, 0])) > 1e-5


def test_randomized_contact_params():
    """geom_friction randomization through the full contact pipeline:
    higher friction decelerates a sliding box faster."""
    from dartenv_tpu.model import skel_model as sm
    from dartenv_tpu.model.builder import ModelBuilder, box_inertia

    b = ModelBuilder(dt=0.002)
    b.add_body("b", None, sm.TRANSLATIONAL, mass=1.0,
               inertia=box_inertia(1.0, (0.1, 0.1, 0.1)),
               q_init=[0.0, 0.1, 0.0])
    b.add_geom("b", sm.GEOM_BOX, (0.1, 0.1, 0.1), friction=0.5)
    b.add_ground(friction=10.0)          # pair friction = min -> geom's
    base = b.finalize(dtype=jnp.float64)

    num_envs = 4
    fr = jnp.asarray([0.05, 0.2, 0.5, 1.0])[:, None]
    bmodel = base.replace(
        geom_friction=jnp.broadcast_to(fr, (num_envs, 1)))
    vstep = jax.jit(make_randomized_sim_step(base, ["geom_friction"]))
    state0 = init_state(base)
    bstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (num_envs,) + x.shape), state0)
    # slide at 2 m/s in x
    bstate = dataclasses.replace(
        bstate, dq=jnp.broadcast_to(jnp.asarray([2.0, 0.0, 0.0]),
                                    (num_envs, 3)))
    btau = jnp.zeros((num_envs, 3), dtype=jnp.float64)
    for _ in range(100):
        bstate, _ = vstep(bmodel, bstate, btau)
    vx = np.asarray(bstate.dq[:, 0])
    # strictly more friction -> strictly less remaining velocity
    assert np.all(np.diff(vx) < 0), vx
    assert vx[-1] < 0.4 < vx[0]


def test_layout_leaves_rejected():
    base = double_pendulum_model(dtype=jnp.float64)
    for leaf in sorted(LAYOUT_LEAVES)[:2]:
        try:
            model_in_axes(base, [leaf])
            assert False, f"{leaf} should be rejected"
        except ValueError:
            pass


def test_bench_dr_smoke():
    """bench.py --dr's harness runs on CPU: finite per-env randomized
    physics and a positive rate, naming the device it ran on."""
    from dartenv_tpu.bench.throughput import bench_dr

    r = bench_dr("hopper", batch=8, substeps=4, iters=1)
    assert r["env_steps_per_s_per_chip"] > 0
    assert r["state_finite"]
    assert r["device"]["platform"] == "cpu"
    assert r["kernels"] == []
