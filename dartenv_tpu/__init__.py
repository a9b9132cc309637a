"""dartenv_tpu: a JAX rigid-body physics engine + RL env suite.

Brand-new JAX implementation with the capabilities of the reference stack
(dart-env on pydart2 on DART — see SURVEY.md): Featherstone articulated
dynamics, velocity-level boxed-LCP contact/friction, joint limits, and the
gym-0.9.x-style env API, all as pure jittable functions vmapped over
thousands of envs and sharded over device meshes.

Top-level API mirrors the reference's `gym` surface:
    import dartenv_tpu as gym
    env = gym.make('DartCartPole-v1')
    obs = env.reset(); obs, r, done, info = env.step(env.action_space.sample())
"""
from dartenv_tpu.api import error, spaces  # noqa: F401
from dartenv_tpu.api.core import (  # noqa: F401
    ActionWrapper, Env, ObservationWrapper, RewardWrapper, Wrapper,
)
from dartenv_tpu.api.registration import (  # noqa: F401
    make, register, registry, spec,
)
from dartenv_tpu.api import seeding  # noqa: F401
from dartenv_tpu.api.benchmarks import (  # noqa: F401
    benchmark_spec, register_benchmark,
)
from dartenv_tpu.api.wrappers import Monitor, TimeLimit  # noqa: F401
from dartenv_tpu.api.configuration import (  # noqa: F401
    logger_setup, undo_logger_setup,
)
from dartenv_tpu.api import scoreboard  # noqa: F401

__version__ = "0.1.0"


# ---------------------------------------------------------------------------
# Env registrations (reference: the dart block of `gym/envs/__init__.py` † —
# SURVEY.md §2.1 "Env registrations"; max_episode_steps/reward_threshold
# values marked ‡ pending reference verification)
# ---------------------------------------------------------------------------

register(
    id="DartCartPole-v1",
    entry_point="dartenv_tpu.envs.cart_pole:DartCartPoleEnv",
    max_episode_steps=1000,
    reward_threshold=950.0,
)

register(
    id="DartCartPoleSwingUp-v1",
    entry_point="dartenv_tpu.envs.cart_pole:DartCartPoleSwingUpEnv",
    max_episode_steps=500,
)

register(
    id="DartReacher-v1",
    entry_point="dartenv_tpu.envs.reacher:DartReacherEnv",
    max_episode_steps=500,
    reward_threshold=-3.75,
)

register(
    id="DartHopper-v1",
    entry_point="dartenv_tpu.envs.hopper:DartHopperEnv",
    max_episode_steps=1000,
    reward_threshold=3800.0,
)

register(
    id="DartWalker2d-v1",
    entry_point="dartenv_tpu.envs.walker2d:DartWalker2dEnv",
    max_episode_steps=1000,
    reward_threshold=None,
)

register(
    id="DartHumanWalker-v1",
    entry_point="dartenv_tpu.envs.human_walker:DartHumanWalkerEnv",
    max_episode_steps=300,
)

register(
    id="DartDoubleInvertedPendulum-v1",
    entry_point="dartenv_tpu.envs.double_pendulum:"
                "DartDoubleInvertedPendulumEnv",
    max_episode_steps=1000,
    reward_threshold=9100.0,
)

register(
    id="DartReacher2d-v1",
    entry_point="dartenv_tpu.envs.reacher2d:DartReacher2dEnv",
    max_episode_steps=500,
)

register(
    id="DartSnake7Link-v1",
    entry_point="dartenv_tpu.envs.snake_7link:DartSnake7LinkEnv",
    max_episode_steps=1000,
)

register(
    id="DartWalker3d-v1",
    entry_point="dartenv_tpu.envs.walker3d:DartWalker3dEnv",
    max_episode_steps=1000,
)

register(
    id="DartDog-v1",
    entry_point="dartenv_tpu.envs.dog:DartDogEnv",
    max_episode_steps=1000,
)
