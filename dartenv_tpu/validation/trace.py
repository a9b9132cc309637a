"""Trace capture and comparison (reference parity harness).

Reference analogue: none — the reference records trajectories only via
`simulation::Recording` † / Monitor stats; this harness is the rebuild's
bit-match tooling (SURVEY.md §7 phase 8, §4 "golden tests").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Trace:
    """Per-substep record of a driven rollout (host numpy, f64)."""

    q: np.ndarray        # (T, n) post-substep positions
    dq: np.ndarray       # (T, n) post-substep velocities
    lam: np.ndarray      # (T, m) constraint impulses (0 when no solver rows)
    dtype: str = "float64"
    meta: Optional[Dict[str, Any]] = None


def capture_trace(model, q0, dq0, tau_seq) -> Trace:
    """Drive the engine with a (T, n) tau sequence (one tau per SUBSTEP),
    recording post-substep (q, dq, lam).  Runs jitted; results on host."""
    from dartenv_tpu.engine.constraints import build_layout
    from dartenv_tpu.engine.world import SimState, make_sim_step

    raw_step = make_sim_step(model, return_impulses=True)
    layout = build_layout(model)

    def step(state, tau):
        st2, (_contacts, lam) = raw_step(state, tau)
        return st2, lam
    dtype = jnp.asarray(model.mass).dtype
    state = SimState(
        q=jnp.asarray(q0, dtype=dtype),
        dq=jnp.asarray(dq0, dtype=dtype),
        time=jnp.zeros((), dtype=dtype),
    )
    tau_seq = jnp.asarray(tau_seq, dtype=dtype)

    def body(st, tau):
        st2, lam = step(st, tau)
        return st2, (st2.q, st2.dq, lam)

    _, (qs, dqs, lams) = jax.jit(
        lambda s, t: jax.lax.scan(body, s, t)
    )(state, tau_seq)
    return Trace(
        q=np.asarray(qs, dtype=np.float64),
        dq=np.asarray(dqs, dtype=np.float64),
        lam=np.asarray(lams, dtype=np.float64),
        dtype=str(dtype),
        meta={"n_rows": int(layout.m)},
    )


def compare_traces(a: Trace, b: Trace, atol: float = 1e-9,
                   rtol: float = 1e-7) -> Dict[str, Any]:
    """State-by-state diff.  Returns per-field max abs error, the first
    substep where tolerance is exceeded (-1 = never), and whether discrete
    contact events (lam > 0 pattern) agree."""
    report: Dict[str, Any] = {}
    T = min(a.q.shape[0], b.q.shape[0])
    diverged = -1
    for t in range(T):
        ok = np.allclose(a.q[t], b.q[t], atol=atol, rtol=rtol) and \
            np.allclose(a.dq[t], b.dq[t], atol=atol, rtol=rtol)
        if not ok:
            diverged = t
            break
    report["first_divergence"] = diverged
    report["max_q_err"] = float(np.abs(a.q[:T] - b.q[:T]).max())
    report["max_dq_err"] = float(np.abs(a.dq[:T] - b.dq[:T]).max())
    if a.lam.size and b.lam.size and a.lam.shape == b.lam.shape:
        ev_a = a.lam[:T] > 1e-9
        ev_b = b.lam[:T] > 1e-9
        report["contact_events_match"] = bool((ev_a == ev_b).all())
        report["max_lam_err"] = float(np.abs(a.lam[:T] - b.lam[:T]).max())
    return report


def self_consistency_report(asset: str, T: int = 200, seed: int = 0,
                            tau_scale: float = 1.0) -> Dict[str, Any]:
    """f32-vs-f64 self-consistency for one task asset: same seeded tau
    sequence through both builds; f32 (production mode) is held to
    per-step tolerance + identical discrete contact events rather than
    bitwise equality (SURVEY.md §7 "Bit-matching")."""
    from dartenv_tpu.model.skel_parser import asset_path, parse_skel

    reports = {}
    traces = {}
    for dtype in (jnp.float64, jnp.float32):
        world = parse_skel(asset_path(asset), dtype=dtype)
        model = world.robot
        n = model.n
        q0 = np.asarray(model.q_init, dtype=np.float64)
        # identical seeded tau sequence through both dtype builds
        tau = np.random.default_rng(seed).uniform(
            -tau_scale, tau_scale, (T, n)
        )
        traces[dtype] = capture_trace(model, q0, np.zeros(n), tau)
    # f32 tolerance: per-step drift is chaotic; compare with loose rtol and
    # check event agreement over a short horizon
    rep = compare_traces(
        traces[jnp.float64], traces[jnp.float32], atol=1e-3, rtol=1e-2
    )
    reports["f32_vs_f64"] = rep
    return reports
