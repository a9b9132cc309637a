"""The one backend -> implementation choice for batched physics calls.

Every `custom_vmap` batch rule of the engine (the fused substep and
dynamics kernels, the PGS solver) asks `use_kernel` whether its vmapped
batch runs the Pallas kernel or the vmapped XLA formulation:

  * a float32 batch on a GPU runs the kernel (Pallas through Triton);
  * on the CPU, for float64 and for an unbatched call, the XLA path runs;
  * any other platform is an error, not a silent fallback.

The platform is `jax.default_backend()`: a process that found GPUs
computes on them, and tests run with `JAX_PLATFORMS=cpu`.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

KERNEL = "kernel"
XLA = "xla"


def implementation(platform: str, dtype, batched: bool) -> str:
    """KERNEL or XLA for a call on `platform` with `dtype` operands."""
    if platform == "gpu":
        if batched and jnp.dtype(dtype) == jnp.float32:
            return KERNEL
        return XLA
    if platform == "cpu":
        return XLA
    raise ValueError(
        f"no implementation choice for platform {platform!r}: the engine "
        f"runs on 'gpu' (Pallas kernels) or 'cpu' (XLA reference path)")


def use_kernel(dtype) -> bool:
    """Does a vmapped batch with `dtype` operands take the kernel here?"""
    return implementation(jax.default_backend(), dtype, True) == KERNEL


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: the directory
    `JAX_COMPILATION_CACHE_DIR` names when it is set (JAX then reads it
    itself), else `.jax_cache/` at the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(Path(__file__).resolve().parent.parent / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on for this process.

    Called by the benchmark and the measurement scripts, never at import
    time.  When the environment names a directory, JAX already uses it
    and nothing is set here.  Returns the directory in use."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
