"""Test harness config: run on a virtual 8-device CPU mesh.

The suite runs on the CPU; sharding logic is exercised on a virtual CPU
mesh (xla_force_host_platform_device_count), the Pallas kernels run in
interpret mode, and their Triton lowering is checked by cross-lowering
for CUDA (tests/test_backend.py).  `python3 chip_smoke.py` runs the
compiled kernels on a GPU.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# float64 validation mode (SURVEY.md §7 float policy): tests validate the
# physics in f64; the f32 production mode has its own tolerance tests.
jax.config.update("jax_enable_x64", True)

# No persistent compilation cache for the suite: one pytest process
# reuses its in-memory compilations, and the benchmark and scripts keep
# theirs (dartenv_tpu.backend.enable_compile_cache).


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Make a missing native tier LOUD (VERDICT.md r2 weak #6): the
    strongest correctness evidence in the repo (tests/test_exact_solver.py,
    tests/test_native.py — JAX vs C++ golden cross-checks) silently skips
    without g++.  Set DARTENV_REQUIRE_NATIVE=1 to turn the skip into a
    hard failure (CI should)."""
    from dartenv_tpu import native

    if not native.available():
        msg = ("NATIVE TIER UNAVAILABLE: g++ golden cross-checks "
               "(test_native.py, test_exact_solver.py) were SKIPPED — "
               "the solver-equivalence evidence did not run.")
        if os.environ.get("DARTENV_REQUIRE_NATIVE"):
            terminalreporter.write_line(msg, red=True, bold=True)
            raise RuntimeError(msg)
        terminalreporter.write_line("WARNING: " + msg, yellow=True,
                                    bold=True)
