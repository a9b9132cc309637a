"""Multi-skeleton worlds (VERDICT.md round 2 order #5).

The reference steps every skeleton in `world.skeletons`
(`dart/simulation/World::step` iterates all skeletons †); pydart2 exposes
them individually.  Here, all mobile skeletons compose into ONE
block-diagonal SkelModel (model/compose.py) — forest topology, cross-
skeleton contact pairs — and the facade exposes per-skeleton views.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dartenv_tpu.engine.world import init_state, make_sim_step
from dartenv_tpu.model import skel_model as sm
from dartenv_tpu.model.builder import ModelBuilder, box_inertia, \
    capsule_inertia
from dartenv_tpu.model.compose import compose_models
from dartenv_tpu.model.skel_parser import parse_skel


def _pendulum_model():
    """Driven prismatic ram: a capsule at box height sliding along +x
    (the "robot" that shoves the free object)."""
    b = ModelBuilder(dt=0.002)
    b.add_body(
        "ram", None, sm.PRISMATIC, mass=2.0,
        inertia=capsule_inertia(2.0, 0.05, 0.3),
        pj_pos=(0.0, 0.1, 0.0),           # slide axis at box mid-height
        axes=[(1.0, 0.0, 0.0)],           # translate along world x
        q_init=[0.0],
    )
    # capsule along local z = world z, so its SIDE faces the box along x
    b.add_geom("ram", sm.GEOM_CAPSULE, (0.05, 0.15), friction=0.3)
    b.add_ground()
    return b.finalize(dtype=jnp.float64)


def _box_model():
    b = ModelBuilder(dt=0.002)
    half = (0.1, 0.1, 0.1)
    b.add_body("boxbody", None, sm.FREE, mass=0.3,
               inertia=box_inertia(0.3, half),
               q_init=[0.0, 0.0, 0.0, 0.35, 0.101, 0.0])
    b.add_geom("boxbody", sm.GEOM_BOX, half, friction=0.4)
    b.add_ground()
    return b.finalize(dtype=jnp.float64)


def test_compose_two_skeletons_robot_knocks_box():
    """A driven ram shoves a free box resting on the ground: full
    cross-skeleton contact coupling (normal + friction) in one jitted
    step — the reference scenario where World::step advances every
    skeleton and the contact group links them +."""
    arm = _pendulum_model()
    box = _box_model()
    model = compose_models([arm, box])
    assert model.nb == 2 and model.n == 1 + 6
    assert len(model.skel_ranges) == 2
    # cross pair ram-capsule vs box exists
    assert (0, 1) in model.self_pairs

    step = jax.jit(make_sim_step(model))
    state = init_state(model)
    # push the ram toward the box (prismatic dof 0, +x)
    tau = jnp.zeros(model.n, dtype=jnp.float64).at[0].set(8.0)
    box_x0 = float(state.q[4])  # free-joint x translation
    hit = False
    for _ in range(700):
        state, contacts = step(state, tau)
        if float(jnp.sum(contacts.active)) > 0:
            hit = True
    assert hit, "pendulum never touched the box"
    assert bool(jnp.all(jnp.isfinite(state.q)))
    box_x = float(state.q[4])
    assert box_x - box_x0 > 0.05, (
        f"box did not move: x {box_x0} -> {box_x}")


_TWO_SKEL_XML = """<?xml version="1.0" ?>
<skel version="1.0">
  <world name="world 1">
    <physics>
      <time_step>0.002</time_step>
      <gravity>0 -9.81 0</gravity>
    </physics>
    <skeleton name="ground skeleton">
      <mobile>false</mobile>
      <body name="ground">
        <transformation>0 -0.05 0 0 0 0</transformation>
        <collision_shape>
          <geometry><box><size>4.0 0.1 4.0</size></box></geometry>
        </collision_shape>
      </body>
    </skeleton>
    <skeleton name="object skeleton">
      <body name="obj">
        <transformation>0.3 0.1 0 0 0 0</transformation>
        <inertia><mass>0.5</mass></inertia>
        <collision_shape>
          <geometry><box><size>0.2 0.2 0.2</size></box></geometry>
        </collision_shape>
      </body>
      <joint type="free" name="obj_joint">
        <parent>world</parent>
        <child>obj</child>
      </joint>
    </skeleton>
    <skeleton name="robot skeleton">
      <body name="link1">
        <transformation>0 0.5 0 0 0 0</transformation>
        <inertia><mass>1.0</mass></inertia>
        <collision_shape>
          <geometry><capsule><height>0.4</height><radius>0.05</radius>
          </capsule></geometry>
        </collision_shape>
      </body>
      <joint type="revolute" name="j1">
        <parent>world</parent>
        <child>link1</child>
        <axis><xyz>0 0 1</xyz></axis>
      </joint>
    </skeleton>
  </world>
</skel>
"""


def test_parse_skel_multi_skeleton(tmp_path):
    """A .skel with two mobile skeletons loses NEITHER (r2 missing #5:
    skel_parser kept only skeletons[-1])."""
    p = tmp_path / "two.skel"
    p.write_text(_TWO_SKEL_XML)
    world = parse_skel(str(p), dtype=jnp.float64)
    assert len(world.skeletons) == 2
    # reference surface: robot stays skeletons[-1]
    assert world.robot is world.skeletons[-1]
    combined = world.combined
    assert combined.nb == 2
    assert combined.n == world.skeletons[0].n + world.skeletons[1].n
    assert len(combined.skel_ranges) == 2
    # the composed world steps under jit and stays finite
    step = jax.jit(make_sim_step(combined))
    state = init_state(combined)
    tau = jnp.zeros(combined.n, dtype=jnp.float64)
    for _ in range(50):
        state, _ = step(state, tau)
    assert bool(jnp.all(jnp.isfinite(state.q)))


_RAM_BOX_XML = """<?xml version="1.0" ?>
<skel version="1.0">
  <world name="world 1">
    <physics>
      <time_step>0.002</time_step>
      <gravity>0 -9.81 0</gravity>
    </physics>
    <skeleton name="ground skeleton">
      <mobile>false</mobile>
      <body name="ground">
        <transformation>0 -0.05 0 0 0 0</transformation>
        <collision_shape>
          <geometry><box><size>4.0 0.1 4.0</size></box></geometry>
        </collision_shape>
      </body>
    </skeleton>
    <skeleton name="object skeleton">
      <body name="obj">
        <transformation>0.35 0.101 0 0 0 0</transformation>
        <inertia><mass>0.3</mass></inertia>
        <collision_shape>
          <geometry><box><size>0.2 0.2 0.2</size></box></geometry>
        </collision_shape>
      </body>
      <joint type="free" name="obj_joint">
        <parent>world</parent>
        <child>obj</child>
      </joint>
    </skeleton>
    <skeleton name="robot skeleton">
      <body name="ram">
        <transformation>0 0.1 0 0 0 0</transformation>
        <inertia><mass>2.0</mass></inertia>
        <collision_shape>
          <geometry><capsule><height>0.3</height><radius>0.05</radius>
          </capsule></geometry>
        </collision_shape>
      </body>
      <joint type="prismatic" name="slide">
        <parent>world</parent>
        <child>ram</child>
        <axis><xyz>1 0 0</xyz></axis>
      </joint>
    </skeleton>
  </world>
</skel>
"""


def test_reference_ctor_composes_all_skeletons(tmp_path):
    """The reference-signature constructor `DartEnv(model_paths, ...)`
    keeps EVERY mobile skeleton (VERDICT.md r3 missing #2: it used to
    silently drop all but the last file's robot): the non-robot object
    skeleton demonstrably moves under contact with the driven robot, and
    `env.world.skeletons` matches the file."""
    from dartenv_tpu.envs.base import DartEnv

    p = tmp_path / "ram_box.skel"
    p.write_text(_RAM_BOX_XML)
    env = DartEnv([str(p)], frame_skip=5, observation_size=14,
                  action_bounds=np.array([[1.0], [-1.0]]))
    env.reset()
    # both mobile skeletons survive the ctor; robot is the LAST one
    assert len(env.world.skeletons) == 2
    obj, ram = env.world.skeletons
    assert env.robot_skeleton is ram
    assert obj.ndofs == 6 and ram.ndofs == 1
    box_x0 = float(obj.q[3])
    # drive the ram with a ROBOT-sized tau (reference:
    # robot_skeleton.set_forces(tau) drives only the robot's dofs †)
    hit = False
    for _ in range(140):
        contacts = env.do_simulation(np.array([8.0]), 5)
        if float(jnp.sum(contacts.active)) > 0:
            hit = True
    assert hit, "ram never touched the object skeleton"
    box_x = float(obj.q[3])
    assert box_x - box_x0 > 0.05, (
        f"object skeleton did not move under contact: "
        f"x {box_x0} -> {box_x}")
    assert np.isfinite(env.state_vector()).all()


def test_facade_exposes_all_skeletons():
    """pydart2 surface: world.skeletons lists every skeleton with
    consistent per-skeleton q/dq views writing into the shared state."""
    from dartenv_tpu.envs.base import DartEnv, _CustomTask

    arm = _pendulum_model()
    box = _box_model()
    model = compose_models([arm, box])
    bounds = np.array([[1.0], [-1.0]])
    task = _CustomTask(model, 1, model.n * 2, bounds)
    env = DartEnv(task, disableViewer=True)
    env.reset()
    world = env.world
    assert len(world.skeletons) == 2
    s_arm, s_box = world.skeletons
    assert s_arm.ndofs == 1 and s_box.ndofs == 6
    # robot_skeleton is the LAST skeleton (reference: skeletons[-1])
    assert env.robot_skeleton is s_box
    # per-skeleton setters write into the shared composed state
    s_arm.set_positions(np.array([0.7]))  # ram slide position
    assert abs(float(s_arm.q[0]) - 0.7) < 1e-12
    np.testing.assert_allclose(env.state_vector()[0], 0.7)
    q_box = s_box.q
    s_box.set_positions(q_box + 0.01)
    np.testing.assert_allclose(s_box.q, q_box + 0.01, atol=1e-12)
    # arm slice untouched by box writes
    assert abs(float(s_arm.q[0]) - 0.7) < 1e-12
    # per-skeleton M blocks are the composed blocks (block-diagonal)
    assert s_arm.M.shape == (1, 1) and s_box.M.shape == (6, 6)


def test_composed_model_vmapped_batch():
    """The composed multi-skeleton model steps under vmap like any other
    SkelModel (the batching path is skeleton-count agnostic)."""
    model = compose_models([_pendulum_model(), _box_model()])
    step = make_sim_step(model)
    B = 16
    state = init_state(model)
    bstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), state)
    # per-env ram force: half push, half idle
    taus = jnp.zeros((B, model.n)).at[: B // 2, 0].set(8.0)
    vstep = jax.jit(jax.vmap(step))
    for _ in range(400):
        bstate, contacts = vstep(bstate, taus)
    box_x = np.asarray(bstate.q[:, 4])
    assert (box_x[: B // 2] > 0.45).all(), box_x  # pushed boxes moved
    assert (np.abs(box_x[B // 2:] - 0.35) < 0.05).all(), box_x  # idle stay
    assert bool(jnp.all(jnp.isfinite(bstate.q)))


def test_compose_three_skeletons():
    """Composition scales past two: ram + TWO stacked free boxes, all
    coupled through cross-skeleton pairs, stepping finite under jit."""
    def small_box(x, y, name):
        b = ModelBuilder(dt=0.002)
        half = (0.08, 0.08, 0.08)
        b.add_body(name, None, sm.FREE, mass=0.2,
                   inertia=box_inertia(0.2, half),
                   q_init=[0.0, 0.0, 0.0, x, y, 0.0])
        b.add_geom(name, sm.GEOM_BOX, half, friction=0.4)
        b.add_ground()
        return b.finalize(dtype=jnp.float64)

    ram = _pendulum_model()
    box1 = small_box(0.35, 0.081, "b1")
    box2 = small_box(0.35, 0.243, "b2")      # stacked on box1
    model = compose_models([ram, box1, box2])
    assert model.nb == 3 and model.n == 13
    assert len(model.skel_ranges) == 3
    # all three cross pairs exist: ram-b1, ram-b2, b1-b2
    assert {(0, 1), (0, 2), (1, 2)} <= set(model.self_pairs)

    step = jax.jit(make_sim_step(model))
    state = init_state(model)
    tau = jnp.zeros(model.n, dtype=jnp.float64).at[0].set(8.0)
    for _ in range(500):
        state, contacts = step(state, tau)
    assert bool(jnp.all(jnp.isfinite(state.q)))
    # the ram drove through: bottom box displaced
    assert float(state.q[4]) > 0.40
