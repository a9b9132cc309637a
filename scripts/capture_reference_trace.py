#!/usr/bin/env python
"""Reference trace-capture adapter (SURVEY.md §7 phase 8, VERDICT.md r1
missing #3).

Given a runnable REFERENCE install (DartEnv/dart-env gym fork + pydart2 +
DART — e.g. once /root/reference is mounted and installed), this records
seeded per-substep (q, dq, contacts) traces in the `validation.Trace`
schema that `dartenv_tpu.validation.compare_traces` consumes unchanged.
Until the reference is available, `--backend self` drives dartenv_tpu's
own gym surface through the IDENTICAL code path as a stand-in, so the
adapter is exercised end-to-end today (the dry-run mode the VERDICT asks
for).

Usage:
  python scripts/capture_reference_trace.py --env DartWalker2d-v1 \
      --seed 0 --steps 200 --out /tmp/ref_walker2d.npz [--backend auto]

  # later, compare a dartenv_tpu trace against it:
  python scripts/capture_reference_trace.py --env DartWalker2d-v1 \
      --seed 0 --steps 200 --out /tmp/jax_walker2d.npz --backend self
  python - <<'PY'
  import numpy as np
  from dartenv_tpu.validation.trace import Trace, compare_traces
  a, b = (np.load(p, allow_pickle=True)
          for p in ("/tmp/ref_walker2d.npz", "/tmp/jax_walker2d.npz"))
  ta = Trace(q=a["q"], dq=a["dq"], lam=a["lam"])
  tb = Trace(q=b["q"], dq=b["dq"], lam=b["lam"])
  print(compare_traces(ta, tb))
  PY

Action sequence: deterministic from --seed via np.random.RandomState
(uniform over the env's action space), so reference and rebuild replay the
SAME controls; reset noise parity additionally requires both stacks'
seeding (gym.utils.seeding SHA-512 — replicated in dartenv_tpu.api.seeding,
algorithm-exact).

What is recorded per SUBSTEP (frame_skip substeps per control step):
  q (T, n), dq (T, n)   — post-substep generalized state
  lam (T, m)            — contact impulses; for the reference backend the
                          row layout differs, so lam holds zeros and the
                          contact records go to `contacts` instead
  contacts (T, C, 10)   — [pos(3) normal(3) force(3) active(1)] per slot
  meta                  — env id, seed, dt, frame_skip, backend
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# runnable as `python scripts/capture_reference_trace.py` from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# backend adapters
# ---------------------------------------------------------------------------

class SelfAdapter:
    """Drives dartenv_tpu's own DartEnv, one physics substep at a time
    (the stand-in backend; same recording schema as the reference one)."""

    def __init__(self, env_id: str, seed: int):
        import dartenv_tpu as gym

        self.env = gym.make(env_id).unwrapped
        self.env._seed(seed)
        task = self.env.task
        self.frame_skip = task.frame_skip
        self.n = task.model.n
        self.dt = float(task.model.dt)
        from dartenv_tpu.engine.constraints import build_layout
        self.m = build_layout(task.model).m
        self.max_c = len(build_layout(task.model).slot_body)

    def reset(self):
        self.env.reset()

    def action_spec(self):
        a = self.env.action_space
        return np.asarray(a.low), np.asarray(a.high)

    def control_to_tau(self, action):
        task = self.env.task
        import jax.numpy as jnp
        a = np.clip(action, task.control_bounds[1], task.control_bounds[0])
        aux = self.env._state.aux
        return np.asarray(task.action_to_tau(jnp.asarray(a), aux))

    def substep(self, tau):
        """One world substep; returns (q, dq, lam, contact_records)."""
        self.env.do_simulation(tau, 1)
        q = np.asarray(self.env._state.sim.q, dtype=np.float64)
        dq = np.asarray(self.env._state.sim.dq, dtype=np.float64)
        lam = np.asarray(self.env._last_lam, dtype=np.float64)
        rec = np.zeros((self.max_c, 10))
        cr = self.env._collision_result()
        for i, c in enumerate(cr.contacts[: self.max_c]):
            rec[i, 0:3] = np.asarray(c.point)
            rec[i, 3:6] = np.asarray(c.normal)
            rec[i, 6:9] = np.asarray(c.force)
            rec[i, 9] = 1.0
        return q, dq, lam, rec


class ReferenceAdapter:
    """Drives the mounted reference (gym fork + pydart2), recording after
    every `world.step()` by instrumenting the world object.

    Requires `import gym` + `import pydart2` to succeed (i.e. a working
    reference install).  q/dq come from `robot_skeleton`; contact records
    from `world.collision_result.contacts` (pos/normal/force — pydart2
    contact.py †).
    """

    MAX_CONTACTS = 32

    def __init__(self, env_id: str, seed: int):
        import gym  # the reference fork, NOT dartenv_tpu

        self.env = gym.make(env_id).unwrapped
        # reference API vintage: seed via _seed/seed
        if hasattr(self.env, "seed"):
            self.env.seed(seed)
        else:                              # pragma: no cover
            self.env._seed(seed)
        self.world = getattr(self.env, "dart_world", None)
        if self.world is None:             # pragma: no cover
            self.world = self.env.robot_skeleton.world
        self.skel = self.env.robot_skeleton
        self.frame_skip = int(self.env.frame_skip)
        self.n = int(self.skel.ndofs)
        self.dt = float(self.world.dt)
        self.m = 0                          # reference rows not exposed
        self.max_c = self.MAX_CONTACTS

    def reset(self):
        self.env.reset()

    def action_spec(self):
        a = self.env.action_space
        return np.asarray(a.low), np.asarray(a.high)

    def control_to_tau(self, action):
        """The reference computes tau inside `_step`; per SURVEY §2.2 the
        universal pattern is clamp -> scale -> zero root dofs.  We instead
        capture tau EXACTLY by letting the env stage it: run the env's own
        action->tau code by calling `_step` with world.step disabled, then
        read `skel.forces()`. (Monkeypatch valid across dart-env's envs,
        which all call do_simulation(tau, frame_skip).)"""
        captured = {}
        orig_do = self.env.do_simulation

        def spy_do(tau, n_frames):
            captured["tau"] = np.array(tau, dtype=np.float64)
            # do NOT step: state must be unchanged; _step's kinematic reads
            # (posbefore etc.) happened before do_simulation
            return None

        self.env.do_simulation = spy_do
        try:
            self.env.step(action)
        except Exception:
            # some envs read contacts after do_simulation; ignore — we only
            # need the staged tau
            pass
        finally:
            self.env.do_simulation = orig_do
        return captured["tau"]

    def substep(self, tau):
        self.skel.set_forces(tau)
        self.world.step()
        q = np.asarray(self.skel.q, dtype=np.float64)
        dq = np.asarray(self.skel.dq, dtype=np.float64)
        rec = np.zeros((self.max_c, 10))
        contacts = self.world.collision_result.contacts
        for i, c in enumerate(contacts[: self.max_c]):
            rec[i, 0:3] = np.asarray(c.point)
            rec[i, 3:6] = np.asarray(c.normal)
            rec[i, 6:9] = np.asarray(c.force)
            rec[i, 9] = 1.0
        return q, dq, np.zeros(0), rec


# ---------------------------------------------------------------------------
# capture loop (backend-independent)
# ---------------------------------------------------------------------------

def capture(adapter, n_control_steps: int, seed: int):
    adapter.reset()
    low, high = adapter.action_spec()
    rng = np.random.RandomState(seed + 1000)   # action stream
    qs, dqs, lams, recs, taus = [], [], [], [], []
    for _ in range(n_control_steps):
        action = rng.uniform(low, high)
        tau = adapter.control_to_tau(action)
        for _ in range(adapter.frame_skip):
            q, dq, lam, rec = adapter.substep(tau)
            qs.append(q)
            dqs.append(dq)
            lams.append(lam if lam.size else np.zeros(1))
            recs.append(rec)
            taus.append(tau)
    return dict(
        q=np.stack(qs), dq=np.stack(dqs), lam=np.stack(lams),
        contacts=np.stack(recs), tau=np.stack(taus),
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=100,
                   help="control steps (substeps = steps * frame_skip)")
    p.add_argument("--out", required=True)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "reference", "self"])
    args = p.parse_args(argv)

    backend = args.backend
    if backend == "auto":
        try:
            import pydart2  # noqa: F401 — only the reference install has it
            backend = "reference"
        except ImportError:
            backend = "self"
            print("pydart2 not importable -> using the dartenv_tpu "
                  "stand-in backend", file=sys.stderr)

    adapter = (ReferenceAdapter if backend == "reference"
               else SelfAdapter)(args.env, args.seed)
    data = capture(adapter, args.steps, args.seed)
    data["meta"] = np.array(
        [args.env, str(args.seed), str(adapter.dt),
         str(adapter.frame_skip), backend])
    np.savez_compressed(args.out, **data)
    print(f"wrote {args.out}: {data['q'].shape[0]} substeps of "
          f"{args.env} ({backend} backend), n={data['q'].shape[1]}")


if __name__ == "__main__":
    main()
