#!/usr/bin/env python
"""Kernel-vs-XLA A/B of the bench cells, end to end, on one GPU.

For each cell (walker2d B=4096 T=100, humanwalker B=1024 T=20, cartpole
B=8192 T=1000) it lowers the rollout once per variant:

  kernels   the default routing (dartenv_tpu.backend.use_kernel)
  xla       every Pallas kernel switched off (DARTENV_NO_*_KERNEL)
  no_dyn    the dynamics kernel off        (walker2d only)
  no_pgs    the PGS kernel off             (walker2d only)
  kernels_esc0  the default routing with escalate_frac=0: the
            escalation's share of the step

compiles every program concurrently in threads, then times them in
interleaved rounds (one call of each variant per round), so drift on
the card hits every variant alike.  Prints one JSON line per variant
with the device, the median and all call times, env-steps/s at the
median, the compile seconds (concurrent, so an upper bound) and the
kernels in the lowered program.

    python scripts/kernel_ab.py [--rounds 5] [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

SWITCHES = {"dyn": "DARTENV_NO_DYN_KERNEL", "pgs": "DARTENV_NO_PGS_KERNEL"}
# humanwalker runs 20 control steps per call, not bench.py's 100: its
# XLA-path calls take seconds each, and env-steps/s does not depend on
# the horizon once compiled
CELLS = (("walker2d", 4096, 100), ("humanwalker", 1024, 20),
         ("cartpole", 8192, 1000))


def variants(env):
    off_all = tuple(SWITCHES.values())
    out = [("kernels", (), None), ("xla", off_all, None)]
    if env == "walker2d":
        out += [("no_dyn", (SWITCHES["dyn"],), None),
                ("no_pgs", (SWITCHES["pgs"],), None)]
    if env != "cartpole":
        out += [("kernels_esc0", (), {"escalate_frac": 0.0})]
    return out


def main(argv=None):
    from dartenv_tpu.backend import enable_compile_cache
    from dartenv_tpu.bench.throughput import (
        device_info, lower_env, lowered_kernels, timed_compile,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_ab: needs a GPU")
    enable_compile_cache()

    cells = {}
    t0 = time.perf_counter()
    for env, B, T in CELLS:
        for name, off, overrides in variants(env):
            for f in off:
                os.environ[f] = "1"
            try:
                cells[(env, name)] = lower_env(env, B, T,
                                               solver_overrides=overrides)
            finally:
                for f in off:
                    os.environ.pop(f, None)
    print(f"lowered {len(cells)} programs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with ThreadPoolExecutor(max_workers=len(cells)) as pool:
        futures = {k: pool.submit(timed_compile, c["lowered"])
                   for k, c in cells.items()}
        compiled = {k: f.result() for k, f in futures.items()}

    state = {k: c["state"] for k, c in cells.items()}
    times = {k: [] for k in cells}

    def call(k, i):
        c = cells[k]
        key = jax.random.fold_in(c["key"], i)
        t = time.perf_counter()
        state[k], stats = compiled[k][0](None, state[k], key)
        jax.block_until_ready(stats.returns_sum)
        return time.perf_counter() - t

    print("compile s (concurrent): " + " ".join(
        f"{e}/{v}={compiled[(e, v)][1]:.1f}" for e, v in cells), flush=True)
    for k in cells:                         # warm-up call, not timed
        call(k, 0)
    for r in range(args.rounds):
        for k in cells:
            times[k].append(call(k, r + 1))
        print(f"round {r}: " + " ".join(
            f"{e}/{v}={times[(e, v)][-1]:.4f}s" for e, v in cells),
            flush=True)

    lines = []
    for (env, name), c in cells.items():
        med = statistics.median(times[(env, name)])
        line = dict(
            env=env, variant=name, device=device_info(),
            batch=c["batch"], horizon=c["horizon"],
            env_steps_per_s_median=c["batch"] * c["horizon"] / med,
            call_s_median=med, call_s=times[(env, name)],
            compile_s_concurrent=compiled[(env, name)][1],
            kernels=lowered_kernels(c["lowered"]))
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
