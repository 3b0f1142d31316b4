"""Run-accumulated per-stage timing — the reference's in-run timers.

The reference accumulates running averages around every stage of the ACTUAL
run (cpuFluidSim.cpp:329-385, GPUFluidSim.cu:609-712) and prints them at
exit.  The production path must not sync per stage (it would drain the
device's queue), so `Simulation.stage_timings` samples stages out-of-band instead.
This module provides the DECOMPOSED in-run variant for diagnostics (CLI
``--report-mode decomposed``): it wraps the op namespace so every op call
blocks and bills its wall time to the reference's stage buckets, and splits
the fused production ops (pressure_project, diffuse_multi_splat,
advect_both) back into their unfused sub-ops so the reference's per-stage
buckets (GPUFluidSim.cu:609-712) stay meaningful.  That decomposition is the
point AND the caveat: the timed kernels pay per-stage HBM round trips the
fused production step does not, so totals here exceed the production step
time — use ``Simulation.stage_timings`` (CLI ``--report-mode sampled``) for
timings of the ops the pipeline actually runs.  Slow by design (un-jitted,
per-op blocking) — use for stage attribution, not production.
"""

from __future__ import annotations

import time
import types
from typing import Dict, Tuple

import jax

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.models.pipelines import make_step
from cudafluidsimulation_tpu.ops.backend import get_ops
from cudafluidsimulation_tpu.state import FluidState
from cudafluidsimulation_tpu.utils.impulse import Impulse, num_steps, slice_step
from cudafluidsimulation_tpu.utils.timing import StageReport

# op name -> reference stage bucket (Main.cpp:183 stage names)
_STAGE_OF = {
    "advect_velocity": "Advect",
    "advect_dye": "Advect",
    "curl": "Vorticity",
    "vorticity_confinement_cpu": "Vorticity",
    "vorticity_confinement_gpu": "Vorticity",
    "diffuse": "Diffuse",
    "diffuse_multi": "Diffuse",
    "splat_cpu": "Force",
    "splat_gpu": "Force",
    "cycle_color": "Force",
    "divergence": "Pressure",
    "pressure_solve": "Pressure",
    "pressure_solve_mg": "Pressure",
    "project": "Project",
    "boundary_strip": "Project",
    "pack_rgba": "Paint",
    "apply_bloom": "Bloom",
}


def timed_ops(base, totals: Dict[str, float]) -> types.SimpleNamespace:
    ns = types.SimpleNamespace()
    for name in vars(base):
        fn = getattr(base, name)
        stage = _STAGE_OF.get(name)
        if stage is None:
            setattr(ns, name, fn)
            continue

        def wrapped(*args, _fn=fn, _stage=stage, **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            jax.block_until_ready(out)
            totals[_stage] = totals.get(_stage, 0.0) + time.perf_counter() - t0
            return out

        setattr(ns, name, wrapped)

    # The production pipeline runs fused ops; for stage ATTRIBUTION
    # decompose them through the wrapped sub-ops so the reference's stage
    # buckets (GPUFluidSim.cu:609-712) stay meaningful.
    def pressure_project(u, v, iters, half, return_stats=False):
        d = ns.divergence(u, v, half)
        p = ns.pressure_solve(d, iters)
        if return_stats:
            u2, v2, st = ns.project(u, v, p, return_stats=True)
            return u2, v2, p, st
        u2, v2 = ns.project(u, v, p)
        return u2, v2, p

    def diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, radius):
        from cudafluidsimulation_tpu.ops import ref as _ref

        f = ns.diffuse_multi(fields, dt, coeffs, iters)  # bills Diffuse
        t0 = time.perf_counter()
        xs, ys = _ref.coord_grids(fields.shape[-2], fields.shape[-1])
        out = _ref.splat_tail(f, amps, last, radius, xs, ys)
        jax.block_until_ready(out)
        totals["Force"] = totals.get("Force", 0.0) + time.perf_counter() - t0
        return out

    def advect_both(u, v, dye, dt, decay_rate):
        # decompose the (optional, sharded-namespace) fused advection through
        # the wrapped sub-ops so Advect billing survives namespace patching —
        # same rule as the pressure_project/diffuse_multi_splat decompositions
        u2, v2 = ns.advect_velocity(u, v, dt, decay_rate)
        return u2, v2, ns.advect_dye(dye, u2, v2, dt, decay_rate)

    def render_frame(dye, pos, intense, radius, active):
        import jax.numpy as jnp

        rgba = ns.pack_rgba(dye)  # bills Paint
        bloomed = ns.apply_bloom(rgba, pos, intense, radius)  # bills Bloom
        return jnp.where(jnp.asarray(active), bloomed, rgba)

    ns.pressure_project = pressure_project
    ns.diffuse_multi_splat = diffuse_multi_splat
    ns.render_frame = render_frame
    if hasattr(base, "advect_both"):
        ns.advect_both = advect_both
    return ns


def run_instrumented(
    config: FluidConfig, state: FluidState, impulses: Impulse
) -> Tuple[FluidState, StageReport]:
    """Run the rollout un-jitted with per-op blocking timers; returns the
    final state and a reference-style per-stage report of the actual run."""
    totals: Dict[str, float] = {}
    ops = timed_ops(get_ops(config), totals)
    step = make_step(config, ops)

    n = num_steps(impulses)
    t0 = time.perf_counter()
    for i in range(n):
        state = step(state, slice_step(impulses, i))
    jax.block_until_ready(state)
    total = time.perf_counter() - t0

    report = StageReport(
        grid=f"{config.nx}x{config.ny}", steps=n, total_s=total
    )
    order = ["Advect", "Vorticity", "Diffuse", "Force", "Pressure", "Project",
             "Paint", "Bloom"]
    for stage in order:
        if stage in totals:
            report.stage_ms[stage] = 1000.0 * totals[stage] / max(1, n)
    return state, report
