"""Validation harness tests (SURVEY.md §7 phase 8, §4 golden strategy)."""
import numpy as np
import jax.numpy as jnp

from dartenv_tpu.validation import (
    capture_trace, compare_traces, self_consistency_report,
)


def test_trace_determinism():
    """Two same-input captures are bit-identical (the reference's
    test_determinism analogue †)."""
    from dartenv_tpu.model.skel_parser import asset_path, parse_skel

    world = parse_skel(asset_path("hopper_capsule.skel"), dtype=jnp.float64)
    model = world.robot
    tau = np.random.default_rng(0).uniform(-1, 1, (50, model.n))
    q0 = np.asarray(model.q_init)
    t1 = capture_trace(model, q0, np.zeros(model.n), tau)
    t2 = capture_trace(model, q0, np.zeros(model.n), tau)
    assert (t1.q == t2.q).all() and (t1.dq == t2.dq).all()
    assert (t1.lam == t2.lam).all()
    rep = compare_traces(t1, t2, atol=0.0, rtol=0.0)
    assert rep["first_divergence"] == -1
    assert rep["contact_events_match"]


def test_trace_catches_divergence():
    from dartenv_tpu.model.skel_parser import asset_path, parse_skel

    world = parse_skel(asset_path("walker2d.skel"), dtype=jnp.float64)
    model = world.robot
    tau_a = np.random.default_rng(1).uniform(-1, 1, (30, model.n))
    tau_b = tau_a.copy()
    tau_b[10] += 0.5  # diverge at substep 10
    q0 = np.asarray(model.q_init)
    ta = capture_trace(model, q0, np.zeros(model.n), tau_a)
    tb = capture_trace(model, q0, np.zeros(model.n), tau_b)
    rep = compare_traces(ta, tb)
    assert rep["first_divergence"] == 10


def test_f32_self_consistency_hopper():
    """The f32 production dtype tracks the f64 build: tolerance comparison +
    identical discrete contact on/off events over a short horizon
    (SURVEY.md §7 'Bit-matching' strategy)."""
    rep = self_consistency_report("hopper_capsule.skel", T=60, seed=0,
                                  tau_scale=0.5)["f32_vs_f64"]
    assert rep["max_q_err"] < 5e-2
    # discrete events are allowed to differ only in the chaotic tail;
    # require agreement (they are computed over the full horizon here,
    # so keep the horizon short)
    assert rep["first_divergence"] != 0  # never diverges at step 0
