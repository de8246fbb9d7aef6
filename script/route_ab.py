"""A/B of the tiled layout's routes on the bench deck, on one GPU.

    python script/route_ab.py [--steps N] [--rounds R]

Builds input/bench_maxwellian.ini once per variant (tiles:* overrides),
compiles one scan window of N steps for each, then runs the windows in
turns (A B C .. C B A, R rounds) and prints the best ms/step of each:

* kernel        — Triton particle kernel, exchange re-bucket (default)
* xla           — XLA contraction route (dense-contraction gather)
* xla_direct    — XLA route with the per-corner gather

It also times the field work of one step on its own (fold -> FFT solve ->
-gradient -> tile padding) and reports the flat layout's compiled peak
bytes per particle slot (memory_analysis of one flat step).  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VARIANTS = {
    "kernel": [],
    "xla": ["tiles:backend=xla"],
    "xla_direct": ["tiles:backend=xla", "tiles:gather=direct"],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", action="append", default=None,
                    choices=sorted(VARIANTS))
    ap.add_argument("--set", action="append", default=[],
                    help="extra deck override for every variant")
    args = ap.parse_args()

    from pinc_tpu.utils.jaxconfig import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from pinc_tpu.config import PincConfig
    from pinc_tpu.grid import gradient
    from pinc_tpu.ops import tiled as tl
    from pinc_tpu.parallel.pic import make_simulation
    from pinc_tpu.simulation import Simulation

    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        sys.exit(f"needs a GPU, JAX sees {dev.platform!r} (JAX_PLATFORMS=cpu "
                 f"for a CPU rehearsal)")
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
           if dev.platform == "gpu" else "cpu rehearsal")
    print(f"device {dev.device_kind}; nvidia-smi: {smi}", flush=True)
    deck = str(REPO / "input/bench_maxwellian.ini")

    runs, carries, n_part = {}, {}, {}
    for name in args.variant or VARIANTS:
        t0 = time.monotonic()
        sim = make_simulation(PincConfig.from_file(
            deck, VARIANTS[name] + args.set))
        st = sim.state
        sim.state = None
        n_part[name] = int(jnp.sum(st.alive > 0.5))
        run_n = sim.make_scan_steps(args.steps, donate=True)
        t1 = time.monotonic()
        runs[name] = run_n.lower(st).compile()
        print(f"{name}: setup {t1 - t0:.1f} s, compile "
              f"{time.monotonic() - t1:.1f} s, route {sim._backend}, "
              f"cadences "
              f"{sim.rebucket_every_s}, face cap {sim._exchange_cap}",
              flush=True)
        carries[name] = st
        if name == "kernel":
            ref_sim = sim
    best = {k: float("inf") for k in runs}
    order = list(runs)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.monotonic()
            st, (ke, pe, dropped) = runs[name](carries[name])
            jax.block_until_ready(st.lpos)
            dt = time.monotonic() - t0
            carries[name] = st
            best[name] = min(best[name], dt)
            print(f"  round {r} {name}: {dt / args.steps * 1e3:.3f} ms/step "
                  f"(dropped {int(dropped)})", flush=True)
    for name in order:
        ms = best[name] / args.steps * 1e3
        print(f"{name}: best {ms:.3f} ms/step, "
              f"{n_part[name] * args.steps / best[name]:.4e} "
              f"particle-steps/s", flush=True)

    if "kernel" in runs:
        sim, ts = ref_sim, ref_sim.ts
        tiles = jnp.ones((ts.NT,) + (ts.P,) * 3, jnp.float32)

        @jax.jit
        def field_work(tiles):
            rho = tl.fold_to_global(tiles, ts)
            return tl.pad_tiles(-gradient(sim.solver(rho)), ts)

        field_work(tiles).block_until_ready()
        t0 = time.monotonic()
        for _ in range(10):
            out = field_work(tiles)
        out.block_until_ready()
        ms = (time.monotonic() - t0) / 10 * 1e3
        print(f"field work (fold, FFT solve, -gradient, pad) {ms:.3f} ms "
              f"per step ({ms / (best['kernel'] / args.steps * 1e3):.1%} "
              f"of the kernel route's step)", flush=True)
    del runs, carries

    cfg = PincConfig.from_file(deck, ["methods:layout=flat",
                                      "grid:trueSize=64,64,64"] + args.set)
    flat = Simulation(cfg, seed=1)
    slots = flat.particles.capacity * flat.particles.n_species
    mem = jax.jit(flat._step).lower(flat.particles).compile() \
        .memory_analysis()
    total = (mem.argument_size_in_bytes + mem.output_size_in_bytes
             + mem.temp_size_in_bytes)
    print(f"flat step at 64^3 x 2 x 32 per cell: {slots} slots, compiled "
          f"bytes (args+out+temp) {total} = {total / slots:.1f} per slot",
          flush=True)


if __name__ == "__main__":
    main()
