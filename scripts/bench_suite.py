"""Full benchmark suite over the BASELINE.json configs, on the GPU.

Prints one JSON line per config (bench.py remains the single headline
metric).  Exits non-zero without a GPU.

  1. 256² cpu-parity headless, 100 steps, scripted center splat
  1b. the reference's own 960x540 workload, 20/30 iters, driven
  2. 1024², 40 Jacobi iters, 1000-step jit scan
  3. 2048² with on-device RGBA render each step
  4. vmapped ensemble: 64 x 512² viscosity sweep
  4b. 8192² and 16384² on one device; 4c. solver frontier (Jacobi-40 vs
      multigrid, residual + throughput)
  5. 8192² sharded over the visible GPUs: rows mesh and 2-D mesh (needs 4)
"""

import functools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def emit(name, steps, sec, cells, extra=None):
    rec = {
        "config": name,
        "steps_per_sec": steps / sec,
        "gcell_per_sec": steps / sec * cells / 1e9,
        "vs_ref_gpu_gcell": (steps / sec * cells / 1e9) / 0.056,
    }
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def main():
    from cudafluidsimulation_tpu import FluidConfig, Simulation, init_state
    from cudafluidsimulation_tpu.models.ensemble import (
        batched_impulse,
        batched_state,
        make_diffusion_sweep_run,
    )
    from cudafluidsimulation_tpu.models.simulation import run_scan_render
    from cudafluidsimulation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from cudafluidsimulation_tpu.utils.impulse import constant_impulse, orbit_impulse
    from cudafluidsimulation_tpu.utils.timing import time_fn

    def timed(fn, *args, reps=3):
        """Median wall seconds of ``fn(*args)`` after one warm-up call."""
        return time_fn(fn, *args, iters=reps, warmup=1)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_suite.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    print(json.dumps({
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)

    # 1. cpu-parity 256², 100 steps, center splat
    n = 256
    cfg = FluidConfig.cpu_reference(nx=n, ny=n)
    sim = Simulation(cfg)
    imp = constant_impulse(100, cfg.dt, pos=(n / 2, n / 2), last_pos=(n / 2 - 3, n / 2 - 2))
    sec = timed(sim.run, sim.init(), imp)
    emit("cpu-parity 256^2 x100 center-splat", 100, sec, n * n)

    # 1b. the reference's OWN workload: 960x540, 20/30 iters, driven —
    # frame-for-frame vs the RTX 3090's 8.99 ms/frame (108 FPS)
    nx, ny = 960, 540
    steps = 200
    cfg = FluidConfig.gpu_reference(nx=nx, ny=ny)
    sim = Simulation(cfg)
    imp = orbit_impulse(steps, cfg.dt, center=(nx / 2, ny / 2),
                        radius=ny / 8)
    sec = timed(sim.run, sim.init(), imp)
    emit(f"reference-workload {nx}x{ny} x{steps} (20/30 iters)", steps,
         sec, nx * ny, {"vs_ref_gpu_fps": (steps / sec) / 108.0})

    # 2. 1024², 40 iters, 1000 steps
    n = 1024
    steps = 1000
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=40)
    sim = Simulation(cfg)
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8)
    sec = timed(sim.run, sim.init(), imp, reps=1)
    emit(f"single-device {n}^2 x{steps} (40 pressure iters)", steps, sec,
         n * n)

    # 3. 2048² with per-step device-side render
    n = 2048
    steps = 100
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=40)
    sim = Simulation(cfg)
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8)
    fn = jax.jit(functools.partial(
        run_scan_render, sim.step_fn, sim.render_fn))
    sec = timed(lambda s, i: fn(s, i)[0], sim.init(), imp, reps=1)
    emit(f"render-pipeline {n}^2 x{steps} (RGBA every step)", steps, sec, n * n)

    # 4. ensemble: 64 x 512² viscosity sweep
    b = 64
    n = 512
    steps = 100
    cfg = FluidConfig.gpu_reference(nx=n, ny=n)
    run = make_diffusion_sweep_run(cfg)
    states = batched_state(cfg, b)
    imp = batched_impulse(
        orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8), b,
        jitter_pos=np.random.default_rng(0).uniform(-8, 8, (b, 2)),
    )
    diffs = jnp.linspace(0.2, 1.5, b)
    sec = timed(run, diffs, states, imp, reps=1)
    emit(f"ensemble {b} x {n}^2 x{steps} viscosity sweep", steps, sec,
         b * n * n)

    # 4b. 8192² (1.9 GB of fields) and 16384² (7.0 GB) on ONE device — the
    # sharded config's single-device anchor and the capacity point
    for n, steps in ((8192, 24), (16384, 8)):
        cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=100)
        sim = Simulation(cfg)
        imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8)
        sec = timed(sim.run, sim.init(), imp, reps=2)
        emit(f"single-device {n}^2 x{steps} (100 pressure iters)", steps,
             sec, n * n)

    # 4c. solver quality/time frontier: the parity Jacobi-40 barely dents
    # the pressure residual at 2048² (it stalls on low-frequency error),
    # while multigrid actually SOLVES the Poisson problem
    from cudafluidsimulation_tpu.ops.multigrid import (
        pressure_solve_mg, residual_norm,
    )

    n = 2048
    steps = 100
    cfg_j = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=40)
    sim_j = Simulation(cfg_j)
    imp = orbit_impulse(steps, cfg_j.dt, center=(n / 2, n / 2), radius=n / 8)
    st = sim_j.run(sim_j.init(), imp)
    sec_j = timed(sim_j.run, sim_j.init(), imp, reps=1)
    ops_j = sim_j.ops
    div = jax.jit(lambda s: ops_j.divergence(s.u, s.v,
                                             cfg_j.half_divergence))(st)
    r_zero = float(residual_norm(jnp.zeros_like(div), div))
    r_j = float(residual_norm(
        jax.jit(lambda d: ops_j.pressure_solve(d, 40))(div), div))
    emit(f"solver-frontier {n}^2 jacobi-40 (parity)", steps, sec_j, n * n,
         {"pressure_residual_rms": r_j, "zero_guess_residual_rms": r_zero})

    cycles = 2
    cfg_m = FluidConfig.gpu_reference(nx=n, ny=n,
                                      pressure_solver="multigrid",
                                      mg_cycles=cycles)
    sim_m = Simulation(cfg_m)
    r_m = float(residual_norm(
        jax.jit(lambda d: pressure_solve_mg(d, cycles))(div), div))
    sec_m = timed(sim_m.run, sim_m.init(), imp, reps=1)
    emit(f"solver-frontier {n}^2 multigrid-{cycles}", steps, sec_m, n * n,
         {"pressure_residual_rms": r_m,
          "residual_vs_jacobi40": r_j / max(r_m, 1e-30)})

    # the --preset quality config: residual-targeted multigrid (rms < 0.05)
    cfg_q = FluidConfig.quality(nx=n, ny=n)
    sim_q = Simulation(cfg_q)
    r_q = float(residual_norm(
        jax.jit(lambda d: pressure_solve_mg(
            d, cfg_q.mg_cycles, tol=cfg_q.mg_tol,
            max_cycles=cfg_q.mg_max_cycles))(div), div))
    sec_q = timed(sim_q.run, sim_q.init(), imp, reps=1)
    emit(f"solver-frontier {n}^2 quality-preset (mg tol={cfg_q.mg_tol})",
         steps, sec_q, n * n,
         {"pressure_residual_rms": r_q,
          "residual_vs_jacobi40": r_j / max(r_q, 1e-30)})

    # 5. sharded 8192² over 4 GPUs: rows mesh and 2x2 mesh, with the halo
    # traffic each schedule moves (counted from the traced jaxpr)
    ndev = len(jax.devices())
    if ndev < 4:
        print(json.dumps({"config": "sharded 8192^2",
                          "skipped": f"needs 4 devices, have {ndev}"}),
              flush=True)
        return 0
    from cudafluidsimulation_tpu.parallel.halo import measure_halo_traffic
    from cudafluidsimulation_tpu.parallel.sharded import make_mesh, shard_state
    from cudafluidsimulation_tpu.parallel.shardmap2d import (
        make_mesh2d, make_shardmap2d_rollout, make_shardmap2d_step,
        shard_state_2d,
    )
    from cudafluidsimulation_tpu.parallel.shardmap_step import (
        make_shardmap_rollout,
    )

    n = 8192
    steps = 20
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=100)
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8)
    mesh = make_mesh(4, ens=1)
    sec = timed(make_shardmap_rollout(cfg, mesh),
                shard_state(init_state(cfg), mesh), imp, reps=1)
    emit(f"sharded {n}^2 x{steps} rows mesh 4x1 (100 pressure iters)",
         steps, sec, n * n, measure_halo_traffic(cfg, mesh))
    mesh2 = make_mesh2d(2, 2)
    sec = timed(make_shardmap2d_rollout(cfg, mesh2),
                shard_state_2d(init_state(cfg), mesh2), imp, reps=1)
    emit(f"sharded {n}^2 x{steps} 2-D mesh 2x2 (100 pressure iters)",
         steps, sec, n * n,
         measure_halo_traffic(cfg, mesh2, step_builder=make_shardmap2d_step))
    return 0


if __name__ == "__main__":
    sys.exit(main())
