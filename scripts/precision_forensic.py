#!/usr/bin/env python
"""Per-substep precision forensics vs CPU-f64 ground truth.

Default-precision contractions may run in a reduced-precision matrix
unit (TF32 on the GPU), so the whole physics trace runs under
jax.default_matmul_precision('highest') (engine/world.py) — this script
measures what the production paths deliver:

  1. roll a contact-rich walker2d trajectory on CPU in f64 and record
     every substep's (state, tau) plus the f64 next-state ground truth;
  2. on the target device (run WITHOUT --cpu on the GPU) evaluate the
     SAME substeps as one vmapped f32 batch through
       (a) the XLA fallback path (kernels disabled — the path domain
           randomization/perturbation/servo/dantzig take), and
       (b) the kernel path (Triton dynamics + PGS kernels);
  3. report max/median relative error of dq_plus and q_new vs f64.

Done = (a) sits at 1e-5-class f32 roundoff like (b), not the
1e-2-class of a reduced-precision matrix unit.

Usage:  python scripts/precision_forensic.py            # on the GPU
        python scripts/precision_forensic.py --cpu      # CPU sanity
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

_parser = argparse.ArgumentParser()
_parser.add_argument("--cpu", action="store_true")
_parser.add_argument("--env", default="walker2d")
_parser.add_argument("--substeps", type=int, default=200)
_parser.add_argument("--seed", type=int, default=0)
_ARGS = _parser.parse_args()

if _ARGS.cpu:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from dartenv_tpu.backend import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp  # noqa: E402


def main():
    from dartenv_tpu.bench.throughput import make_task
    from dartenv_tpu.engine.world import SimState, init_state, make_sim_step

    env, T, seed = _ARGS.env, _ARGS.substeps, _ARGS.seed
    cpu = jax.devices("cpu")[0]

    # ---- phase 1: f64 ground-truth rollout on CPU ----------------------
    task64 = make_task(env, dtype=jnp.float64)
    model64 = task64.model
    with jax.default_device(cpu):
        step64 = jax.jit(make_sim_step(model64))
        state = init_state(model64, warm_start=True)
        rng = np.random.default_rng(seed)
        tau = jnp.zeros(model64.n, jnp.float64)
        recs = []
        for k in range(T):
            if k % task64.frame_skip == 0:
                a = rng.uniform(-1.0, 1.0, model64.n - 3)
                tau = jnp.zeros(model64.n, jnp.float64).at[3:].set(
                    jnp.asarray(a) * 100.0)
            nxt, _ = step64(state, tau)
            recs.append((np.asarray(state.q), np.asarray(state.dq),
                         np.asarray(state.lam), np.asarray(tau),
                         np.asarray(nxt.q), np.asarray(nxt.dq)))
            state = nxt
    qs, dqs, lams, taus, q_ref, dq_ref = (np.stack([r[i] for r in recs])
                                          for i in range(6))

    # ---- phase 2: f32 batch through both device paths ------------------
    task32 = make_task(env, dtype=jnp.float32)
    model32 = task32.model

    switches = ("DARTENV_NO_DYN_KERNEL", "DARTENV_NO_PGS_KERNEL")

    f32 = jnp.float32
    batch = SimState(q=jnp.asarray(qs, f32), dq=jnp.asarray(dqs, f32),
                     time=jnp.zeros((T,), f32),
                     lam=jnp.asarray(lams, f32))
    tau_b = jnp.asarray(taus, f32)

    def run(xla_only):
        # the kernel switches are read while the step is built and traced
        for f in switches if xla_only else ():
            os.environ[f] = "1"
        try:
            step = make_sim_step(model32)
            st, _ = jax.jit(jax.vmap(step))(batch, tau_b)
        finally:
            for f in switches:
                os.environ.pop(f, None)
        return np.asarray(st.q, np.float64), np.asarray(st.dq, np.float64)

    out = {"env": env, "substeps": T,
           "backend": jax.default_backend()}
    dq_scale = np.maximum(1.0, np.abs(dq_ref).max(axis=1, keepdims=True))
    q_scale = np.maximum(1.0, np.abs(q_ref).max(axis=1, keepdims=True))
    for name, xla_only in (("xla_fallback", True), ("kernels", False)):
        q_got, dq_got = run(xla_only)
        e_dq = np.abs(dq_got - dq_ref) / dq_scale
        e_q = np.abs(q_got - q_ref) / q_scale
        out[name] = dict(
            dq_plus_rel_max=float(e_dq.max()),
            dq_plus_rel_med=float(np.median(e_dq.max(axis=1))),
            q_new_rel_max=float(e_q.max()),
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
