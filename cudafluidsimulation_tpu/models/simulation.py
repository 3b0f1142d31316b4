"""The simulation harness: jitted scan loop, frame collection, timing.

This is the replacement for the reference's app shell + frame loop
(Main.cpp:61-210): instead of a host-driven while-loop launching kernels every
frame, the whole multi-step rollout is one compiled ``lax.scan``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.models.pipelines import make_render, make_step
from cudafluidsimulation_tpu.ops.backend import get_ops
from cudafluidsimulation_tpu.state import FluidState, init_state
from cudafluidsimulation_tpu.utils.impulse import Impulse, no_impulse
from cudafluidsimulation_tpu.utils.timing import StageReport, time_fn, time_scanned


def run_scan(step_fn, state: FluidState, impulses: Impulse) -> FluidState:
    """Run ``step_fn`` over a batched impulse stream under one scan."""
    final, _ = jax.lax.scan(lambda s, imp: (step_fn(s, imp), None), state, impulses)
    return final


def run_scan_render(
    step_fn, render_fn, state: FluidState, impulses: Impulse
) -> Tuple[FluidState, jnp.ndarray]:
    """Scan that emits a rendered RGBA frame EVERY step (the interactive-
    equivalent pipeline; frames buffer is T*H*W*4 bytes — for subsampled
    collection use Simulation.collect_frames, which renders per segment)."""

    def body(s, imp):
        s2 = step_fn(s, imp)
        return s2, render_fn(s2)

    return jax.lax.scan(body, state, impulses)


class Simulation:
    """Convenience wrapper: config -> jitted step/run/render + reporting.

    Equivalent surface to the reference's 4-function backend APIs
    (init/step/free/getAverageTimes, cpuFluidSim.h:8-11) plus everything the
    reference lacks: headless rollouts, frame dumps, checkpoints, timing.
    """

    def __init__(self, config: FluidConfig):
        self.config = config
        self.ops = get_ops(config)
        self.step_fn = make_step(config, self.ops)
        self.render_fn = make_render(config, self.ops)
        self._jit_step = jax.jit(self.step_fn)
        self._jit_run = jax.jit(functools.partial(run_scan, self.step_fn))
        self._jit_render = jax.jit(self.render_fn)

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> FluidState:
        return init_state(self.config)

    def step(self, state: FluidState, imp: Impulse) -> FluidState:
        return self._jit_step(state, imp)

    def run(self, state: FluidState, impulses: Impulse) -> FluidState:
        return self._jit_run(state, impulses)

    @property
    def jit_run(self):
        """The jitted rollout itself (exposes ``.lower`` for AOT compiles —
        the CLI precompiles segment shapes without executing them)."""
        return self._jit_run

    def run_steps(self, state: FluidState, steps: int) -> FluidState:
        return self.run(state, no_impulse(steps, self.config.dt))

    def run_displacement(self, state: FluidState, impulses: Impulse):
        """Rollout + realized advection displacement: returns
        ``(final_state, (max|u|*dt, max|v|*dt))`` where the maxima run over
        EVERY step of the scan (not just the final state) — the quantity the
        sharded advection bound ``max_displacement`` clamps, measured
        on the velocity each backtrace actually sampled (pre-advection).

        Tracking is free: each step's ``state.vel_stats`` is the
        projection-emitted bound of exactly that pre-advection velocity
        (see state.FluidState), so the scan adds two scalar max ops per
        step, no field reductions."""

        @functools.partial(jax.jit)
        def run(state, impulses):
            def body(carry, imp):
                s, mu, mv = carry
                mu = jnp.maximum(mu, s.vel_stats[0] * imp.dt)
                mv = jnp.maximum(mv, s.vel_stats[1] * imp.dt)
                return (self.step_fn(s, imp), mu, mv), None

            (final, mu, mv), _ = jax.lax.scan(
                body, (state, jnp.float32(0.0), jnp.float32(0.0)), impulses)
            return final, mu, mv

        final, mu, mv = run(state, impulses)
        return final, (float(mu), float(mv))

    # -- rendering ----------------------------------------------------------

    @staticmethod
    def frame_image(device_frame, flip: bool = True) -> np.ndarray:
        """(4, H, W) device frame -> uint8 (H, W, 4) host image (y-up at the
        top when ``flip``) — the ONE place the layout/flip convention lives."""
        img = np.moveaxis(np.asarray(device_frame), 0, -1)
        return img[::-1] if flip else img

    def render(self, state: FluidState, flip: bool = True) -> np.ndarray:
        """uint8 (H, W, 4) frame; ``flip`` puts y-up at image top for viewing."""
        return self.frame_image(self._jit_render(state), flip)

    def collect_frames(
        self, state: FluidState, impulses: Impulse, every: int = 1
    ):
        """Roll out and return one frame per ``every`` steps.

        Runs in ``every``-step compiled segments and renders once per
        segment, so device memory holds a single frame at a time (a
        one-frame-per-step scan output would be T*H*W*4 bytes).
        """
        n = int(impulses.pressed.shape[0])
        frames = []
        start = 0
        while start < n:
            end = min(start + every, n)
            part = Impulse(*(f[start:end] for f in impulses))
            state = self._jit_run(state, part)
            frames.append(self.frame_image(self._jit_render(state)))
            start = end
        return state, np.stack(frames)  # (N, H, W, 4), y-up

    # -- ensembles ----------------------------------------------------------

    def vmapped_run(self):
        """vmap of the rollout over a leading batch axis of (state, impulses) —
        independent sims batched on one chip (parameter sweeps)."""
        return jax.jit(jax.vmap(functools.partial(run_scan, self.step_fn)))

    # -- timing / report ----------------------------------------------------

    def benchmark(self, steps: int = 100, impulses: Optional[Impulse] = None,
                  iters: int = 5) -> StageReport:
        state = self.init()
        if impulses is None:
            impulses = no_impulse(steps, self.config.dt)
        else:
            steps = int(impulses.pressed.shape[0])  # report what actually ran
        sec = time_fn(self._jit_run, state, impulses, iters=iters)
        report = StageReport(
            grid=f"{self.config.nx}x{self.config.ny}", steps=steps, total_s=sec
        )
        return report

    def stage_timings(self, iters: int = 24,
                      state: Optional[FluidState] = None) -> StageReport:
        """Out-of-band per-stage breakdown, the analogue of the reference's
        per-stage averages (Main.cpp:195-206).  Each sampled stage matches
        what the configured pipeline actually runs — including its FUSIONS:
        when the pipeline executes the fused divergence->Jacobi->project op
        the report shows one "Pressure+Project" bucket (not the unfused
        passes, whose separate HBM round trips the pipeline no longer pays),
        and when the splat rides the final diffusion burst the bucket is
        "Diffuse+Force".  Use ``--report-mode instrumented`` for the
        decomposed reference-style buckets.

        Each stage is timed as ONE jitted ``lax.scan`` of ``iters``
        applications with the stage output threaded back into its input
        (utils.timing.time_scanned), so per-call dispatch is amortized.
        Caveat: a scanned stage that injects energy self-amplifies (e.g.
        confinement scanned alone grows |v| every iteration), so
        flow-dependent stage rows can read off their in-step cost; the step
        total is the ground truth.
        Stages whose carry does not naturally close over their output mix it
        in with ``x + eps * y`` where eps is a traced runtime-0.0 scalar, so
        the measured numerics are unchanged but XLA cannot hoist the loop
        body."""
        cfg = self.config
        ops = self.ops
        if state is None:
            state = self.init()
        dt = jnp.float32(cfg.dt)
        u, v, dye, p = state.u, state.v, state.dye, state.pressure
        palette = jnp.asarray(cfg.palette_array())
        color = palette[0]
        pos = jnp.asarray([cfg.nx / 2.0, cfg.ny / 2.0], jnp.float32)

        fused_splat = cfg.color_diffusion_enabled and cfg.variant == "gpu"
        if cfg.color_diffusion_enabled:
            coeffs = jnp.asarray(
                [cfg.velocity_diffusion] * 2 + [cfg.color_diffusion] * 3,
                jnp.float32,
            )

        if fused_splat:
            # the pipeline's actual op: splat folded into the last diffusion
            # burst (pipelines.py diffuse_multi_splat path)
            amps = jnp.concatenate([jnp.ones((2,), jnp.float32), color])

            def diffuse_body(c, eps):
                u, v, dye = c
                all5 = ops.diffuse_multi_splat(
                    jnp.concatenate([jnp.stack([u, v]), dye]), dt, coeffs,
                    cfg.diffusion_iters, amps, pos, cfg.splat_radius,
                )
                return all5[0], all5[1], all5[2:]
        elif cfg.color_diffusion_enabled:
            def diffuse_body(c, eps):
                u, v, dye = c
                all5 = ops.diffuse_multi(
                    jnp.concatenate([jnp.stack([u, v]), dye]), dt, coeffs,
                    cfg.diffusion_iters,
                )
                return all5[0], all5[1], all5[2:]
        else:
            def diffuse_body(c, eps):
                u, v, dye = c
                uv = ops.diffuse(
                    jnp.stack([u, v]), dt, cfg.velocity_diffusion,
                    cfg.diffusion_iters,
                )
                return uv[0], uv[1], dye + eps

        splat = ops.splat_cpu if cfg.variant == "cpu" else ops.splat_gpu

        if cfg.pressure_solver == "multigrid":
            def solve(div):
                return ops.pressure_solve_mg(div, cfg.mg_cycles,
                                             tol=cfg.mg_tol,
                                             max_cycles=cfg.mg_max_cycles)
        else:
            def solve(div):
                return ops.pressure_solve(div, cfg.pressure_iters)

        vort = (ops.vorticity_confinement_cpu if cfg.variant == "cpu"
                else ops.vorticity_confinement_gpu)

        def advect_body(c, eps):
            u, v, dye = c
            u2, v2 = ops.advect_velocity(u, v, dt, cfg.decay_rate)
            return u2, v2, ops.advect_dye(dye, u2, v2, dt, cfg.decay_rate)

        def vorticity_body(c, eps):
            return vort(c[0], c[1], dt, cfg.vorticity)

        def force_body(c, eps):
            return splat(*c, pos, pos, dt, cfg.force_scale, cfg.splat_radius,
                         color)

        def pressure_body(c, eps):
            u, v, p = c
            # eps*p makes the (otherwise loop-invariant) divergence input
            # depend on the previous iterate's output
            p2 = solve(ops.divergence(u + eps * p, v, cfg.half_divergence))
            return u, v, p2

        def pressure_project_body(c, eps):
            # the pipeline's actual op on the Jacobi path: fused
            # divergence -> burst solve -> gradient subtraction
            u, v, p = c
            return ops.pressure_project(u + eps * p, v, cfg.pressure_iters,
                                        cfg.half_divergence)

        def project_body(c, eps):
            u, v, p = c
            u2, v2 = ops.project(u, v, p)
            return u2, v2, p + eps

        def paint_body(c, eps):
            dye, s = c
            rgba = ops.pack_rgba(dye + eps * s)
            return dye, rgba[0, :1, :1].astype(jnp.float32)

        stages = {
            "Advect": (advect_body, (u, v, dye)),
            "Vorticity": (vorticity_body, (u, v)),
        }
        if fused_splat:
            stages["Diffuse+Force"] = (diffuse_body, (u, v, dye))
        else:
            stages["Diffuse"] = (diffuse_body, (u, v, dye))
            stages["Force"] = (force_body, (u, v, dye))
        if cfg.pressure_solver == "multigrid":
            stages["Pressure"] = (pressure_body, (u, v, p))
            stages["Project"] = (project_body, (u, v, p))
        else:
            stages["Pressure+Project"] = (pressure_project_body, (u, v, p))
        if cfg.bloom_enabled:
            # the pipeline's actual render op: pack + gated bloom in one
            # fused pass (ops.render_frame); timed with the bloom ACTIVE —
            # the driven/interactive worst case
            def render_body(c, eps):
                dye, s = c
                rgba = ops.render_frame(dye + eps * s, pos,
                                        cfg.bloom_intense, cfg.splat_radius,
                                        jnp.float32(1.0))
                return dye, rgba[0, :1, :1].astype(jnp.float32)

            stages["Paint+Bloom"] = (render_body,
                                     (dye, jnp.zeros((1, 1), jnp.float32)))
        else:
            stages["Paint"] = (paint_body,
                               (dye, jnp.zeros((1, 1), jnp.float32)))

        report = StageReport(grid=f"{cfg.nx}x{cfg.ny}", steps=iters, total_s=0.0)
        for name, (body, carry) in stages.items():
            sec = time_scanned(body, carry, n=iters)
            report.stage_ms[name] = sec * 1000.0
            report.total_s += sec
        report.steps = 1
        return report
