"""The backend -> implementation choice, the compile-cache rule, the
Triton lowering of every kept kernel, and chip_smoke.py's refusal to run
without a GPU.

The lowering tests cross-lower for CUDA on the CPU: that runs the
Pallas Triton lowering (power-of-two loads, supported primitives, block
specs) of the very kernels the GPU compiles, without a card.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from dartenv_tpu import backend
from dartenv_tpu.backend import KERNEL, XLA, implementation

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,dtype,batched,expected", [
    ("gpu", jnp.float32, True, KERNEL),
    ("gpu", jnp.float32, False, XLA),
    ("gpu", jnp.float64, True, XLA),
    ("gpu", jnp.float64, False, XLA),
    ("cpu", jnp.float32, True, XLA),
    ("cpu", jnp.float32, False, XLA),
    ("cpu", jnp.float64, True, XLA),
    ("neuron", jnp.float32, True, ValueError),
    ("rocm", jnp.float32, True, ValueError),
    ("METAL", jnp.float64, False, ValueError),
])
def test_backend_choice(platform, dtype, batched, expected):
    if expected is ValueError:
        with pytest.raises(ValueError, match=platform):
            implementation(platform, dtype, batched)
    else:
        assert implementation(platform, dtype, batched) == expected


def test_use_kernel_reads_default_backend(monkeypatch):
    assert not backend.use_kernel(jnp.float32)          # the CPU suite
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.use_kernel(jnp.float32)
    assert not backend.use_kernel(jnp.float64)
    monkeypatch.setattr(jax, "default_backend", lambda: "neuron")
    with pytest.raises(ValueError):
        backend.use_kernel(jnp.float32)


@pytest.mark.parametrize("env_dir", [None, "named"])
def test_compile_cache_rule(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set over it;
    otherwise the cache is <repo>/.jax_cache, a path that does not move
    with the host or the process."""
    prev = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "untouched")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = str(REPO / ".jax_cache")
            assert backend.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            assert backend.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == sentinel
        assert backend.compile_cache_dir() == want
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_dir_is_ignored_by_git():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def _lowered_triton_kernels(fn, *args):
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    return sorted(set(re.findall(r'name = "(dartenv_\w+)"', text)))


def _batch(tree, B):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), tree)


@pytest.mark.parametrize("env,f_ext,expected", [
    ("walker2d", False, ["dartenv_dynamics", "dartenv_pgs"]),
    ("hopper", False, ["dartenv_dynamics", "dartenv_pgs"]),
    ("cartpole", False, ["dartenv_dynamics"]),
    ("walker2d", True, ["dartenv_pgs"]),
    ("humanwalker", False, ["dartenv_pgs"]),
])
def test_gpu_lowering_has_triton_kernels(monkeypatch, env, f_ext, expected):
    """With the platform reported as 'gpu', a batched f32 sim step lowers
    for CUDA with the Triton custom call of each kernel its path keeps:
    the dynamics kernel for models up to KERNEL_MAX_DOFS dofs (not under
    an external push, which the XLA dynamics takes), the PGS kernel for
    every model with constraint rows."""
    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.engine.world import init_state, make_sim_step

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.enable_x64(False):
        model = make_task(env).model
        step = make_sim_step(model)
        B = 40                      # > one TB=32 tile: padding lowers too
        state = _batch(init_state(model), B)
        tau = jnp.zeros((B, model.n), jnp.float32)
        if f_ext:
            push = jnp.zeros((model.nb, 6), jnp.float32)
            fn = jax.vmap(lambda s, t: step(s, t, f_ext_world=push)[0])
        else:
            fn = jax.vmap(lambda s, t: step(s, t)[0])
        assert _lowered_triton_kernels(fn, state, tau) == expected


@pytest.mark.parametrize("env,served", [
    ("cartpole", True), ("hopper", True), ("walker2d", True),
    ("walker3d", False), ("dog", False), ("humanwalker", False),
])
def test_dynamics_kernel_model_gate(env, served):
    """The dynamics kernel serves models up to KERNEL_MAX_DOFS dofs; the
    larger ones keep the XLA phase (their straight-line kernels are too
    large to compile in reasonable time)."""
    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.dynamics.pallas_dynamics import (
        KERNEL_MAX_DOFS, make_dynamics_phase)

    model = make_task(env).model
    assert (model.n <= KERNEL_MAX_DOFS) == served
    phase = make_dynamics_phase(model, float(model.dt))
    assert (phase is not None) == served


def test_cpu_lowering_has_no_kernels():
    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.engine.world import init_state, make_sim_step

    with jax.enable_x64(False):
        model = make_task("walker2d").model
        step = make_sim_step(model)
        state = _batch(init_state(model), 4)
        tau = jnp.zeros((4, model.n), jnp.float32)
        text = jax.jit(jax.vmap(lambda s, t: step(s, t)[0])).trace(
            state, tau).lower().as_text()
    assert "triton" not in text


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """Under JAX_PLATFORMS=cpu, and in a directory holding chip_smoke.py
    and nothing else of the repo, the script exits non-zero and prints
    no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd, env_path = tmp_path, ""
    else:
        cwd, env_path = REPO, str(REPO)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=env_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
