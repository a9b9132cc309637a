"""Validation harness: trace capture + state-by-state comparison.

SURVEY.md §7 phase 8: the north-star demands seeded rollouts matched
state-by-state against the reference engine.  While `/root/reference` is
unmounted (see SURVEY.md provenance warning) the harness runs in
*self-consistency* modes:

  * f32 (production dtype) vs f64 (validation dtype)
  * JAX engine vs the native C++ golden tier (smooth dynamics)

The `Trace` schema is engine-agnostic so a pydart2-backed capture can be
plugged in unchanged once the reference is available (the adapter boundary
is `capture_trace`'s (q, dq, lam) per-substep record).
"""
from dartenv_tpu.validation.trace import (  # noqa: F401
    Trace, capture_trace, compare_traces, self_consistency_report,
)
