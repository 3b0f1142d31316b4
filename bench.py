"""Headline benchmark: steps/sec of the full stable-fluids step on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N, ...}

Flagship config (BASELINE.md north star): 2048² grid, gpu-parity pipeline
(20 diffusion iters on velocity+dye, 40 pressure iters), driven impulse, full
jit lax.scan.  vs_baseline compares cell-update throughput against the
reference GPU's 960x540 @ 108 FPS on an RTX 3090 (= 0.056 Gcell/s,
BASELINE.md derivation).  The line also carries the quiet (no impulse) rate
on the same compiled program, the quality preset's rate, and the realized
backtrace displacement of the driven rollout.

Exits non-zero without a GPU: a CPU rate is not a measurement of this
program.
"""

import json
import subprocess
import sys

import jax


def main():
    from cudafluidsimulation_tpu import FluidConfig, Simulation
    from cudafluidsimulation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from cudafluidsimulation_tpu.utils.impulse import no_impulse, orbit_impulse
    from cudafluidsimulation_tpu.utils.timing import time_fn

    def rate(sim, state, imp):
        """Median steps/s of the jitted rollout after a warm-up run."""
        return steps / time_fn(sim.run, state, imp, iters=5, warmup=1)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    n, steps = 2048, 200
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=40,
                                    max_displacement=31)
    sim = Simulation(cfg)
    state = sim.init()
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8,
                        omega=3.0)
    driven = rate(sim, state, imp)
    quiet = rate(sim, state, no_impulse(steps, cfg.dt))
    _, (disp_x, disp_y) = sim.run_displacement(state, imp)

    qsim = Simulation(FluidConfig.quality(nx=n, ny=n))
    quality = rate(qsim, qsim.init(), imp)

    gcell = driven * n * n / 1e9
    baseline_gcell = 0.056  # reference RTX 3090: 960*540*108 (BASELINE.md)
    print(json.dumps({
        "metric": f"sim steps/sec at {n}^2 (40 Jacobi pressure iters, 20 "
        f"diffusion, gpu-parity pipeline, backend={cfg.resolve_backend()})",
        "value": driven,
        "unit": "steps/s",
        "vs_baseline": gcell / baseline_gcell,
        "quiet_steps_per_sec": quiet,
        "quality_steps_per_sec": quality,
        "realized_max_displacement": max(disp_x, disp_y),
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
