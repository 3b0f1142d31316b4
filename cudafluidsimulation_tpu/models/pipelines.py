"""The per-step physics pipeline as a pure function.

Both reference backends run the same stage order each frame
(cpuFluidSim.cpp:327-410 and GPUFluidSim.cu:604-715):

    advect velocity -> advect dye -> vorticity confinement -> diffuse
    -> [splat if pressed] -> divergence -> Jacobi pressure -> project
    -> [cpu only: boundary strip] -> render (pack [+ gpu bloom])

``make_step`` builds ``step(state, impulse) -> state`` with the variant
switches (vorticity formula/sign, splat geometry, color-diffusion no-op,
divergence scaling, boundary strip) chosen by the config.  The step is pure
and jit/scan/vmap/shard_map-friendly; "if pressed" is a masked ``jnp.where``
blend, not control flow.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.ops.backend import get_ops
from cudafluidsimulation_tpu.state import FluidState
from cudafluidsimulation_tpu.utils.impulse import Impulse

StepFn = Callable[[FluidState, Impulse], FluidState]


def make_step(config: FluidConfig, ops=None) -> StepFn:
    if ops is None:
        ops = get_ops(config)
    palette = jnp.asarray(config.palette_array())
    cpu_variant = config.variant == "cpu"

    def step(state: FluidState, imp: Impulse) -> FluidState:
        dt = imp.dt
        u, v, dye = state.u, state.v, state.dye

        # -- advection (velocity first; dye uses post-advection velocity,
        #    cpuFluidSim.cpp:340-341 / GPUFluidSim.cu:620-622).  A namespace
        #    may provide the optional fused ``advect_both`` (the sharded
        #    paths do: one halo exchange carries velocity AND dye, since
        #    both advections tap pre-advection data).
        advect_both = getattr(ops, "advect_both", None)
        if advect_both is not None:
            u, v, dye = advect_both(u, v, dye, dt, config.decay_rate)
        else:
            u, v = ops.advect_velocity(u, v, dt, config.decay_rate)
            dye = ops.advect_dye(dye, u, v, dt, config.decay_rate)

        # -- vorticity confinement
        if cpu_variant:
            u, v = ops.vorticity_confinement_cpu(u, v, dt, config.vorticity)
        else:
            u, v = ops.vorticity_confinement_gpu(u, v, dt, config.vorticity)

        # -- impulse parameters ("if pressed" as data, not control flow: the
        #    force scale and dye color are zeroed when unpressed, which
        #    makes the splat exactly the identity — u + 0*e == u — without
        #    the five full-field where-blends a masked output needs)
        pressed = imp.pressed
        pressed_f = pressed.astype(jnp.float32)
        press_time = state.press_time + dt * pressed_f
        color = ops.cycle_color(palette, press_time)
        cur = imp.pos
        # cpu-parity remembers its own previous position (the mousePos/
        # lastMousePos globals, cpuFluidSim.cpp:31-32,409); gpu-parity gets
        # both positions from the caller (Main.cpp:155).
        last = state.mouse if cpu_variant else imp.last_pos
        force_eff = config.force_scale * pressed_f
        color_eff = color * pressed_f

        # -- diffusion (velocity always; dye only where the reference's is
        #    observable — the CPU path's is a buffered-out no-op) + splat.
        #    When both diffuse, they share one 5-channel pass with
        #    per-channel coefficients (the reference used 2 CUDA streams for
        #    the same concurrency, GPUFluidSim.cu:636-639), and the splat
        #    that follows (GPUFluidSim.cu:663) is one op with it (same math,
        #    same order — amps carry splat_gpu's exact scalar association).
        if config.color_diffusion_enabled and not cpu_variant:
            coeffs = jnp.asarray(
                [config.velocity_diffusion] * 2 + [config.color_diffusion] * 3,
                jnp.float32,
            )
            amps = jnp.concatenate([
                jnp.stack([(last[0] - cur[0]) * force_eff * dt,
                           (last[1] - cur[1]) * force_eff * dt]),
                color_eff,
            ])
            all5 = ops.diffuse_multi_splat(
                jnp.concatenate([jnp.stack([u, v]), dye]), dt, coeffs,
                config.diffusion_iters, amps, last, config.splat_radius,
            )
            u, v, dye = all5[0], all5[1], all5[2:]
        else:
            if config.diffusion_iters > 0:
                if config.color_diffusion_enabled:
                    # cpu variant with dye diffusion explicitly enabled:
                    # dye still diffuses (splat_cpu's two-Gaussian geometry
                    # just cannot fuse into the burst)
                    coeffs = jnp.asarray(
                        [config.velocity_diffusion] * 2
                        + [config.color_diffusion] * 3,
                        jnp.float32,
                    )
                    all5 = ops.diffuse_multi(
                        jnp.concatenate([jnp.stack([u, v]), dye]), dt,
                        coeffs, config.diffusion_iters,
                    )
                    u, v, dye = all5[0], all5[1], all5[2:]
                else:
                    uv = ops.diffuse(
                        jnp.stack([u, v]), dt, config.velocity_diffusion,
                        config.diffusion_iters,
                    )
                    u, v = uv[0], uv[1]
            splat = ops.splat_cpu if cpu_variant else ops.splat_gpu
            u, v, dye = splat(
                u, v, dye, cur, last, dt, force_eff,
                config.splat_radius, color_eff
            )

        # -- pressure projection (the step's final velocity producer; it
        #    also returns next step's vel_stats bound)
        if config.pressure_solver == "multigrid":
            div = ops.divergence(u, v, config.half_divergence)
            p = ops.pressure_solve_mg(div, config.mg_cycles,
                                      tol=config.mg_tol,
                                      max_cycles=config.mg_max_cycles)
            u, v, vel_stats = ops.project(u, v, p, return_stats=True)
        else:
            # one op for divergence -> Jacobi -> projection, so the sharded
            # namespaces can fold the three stages' halo exchanges together
            u, v, p, vel_stats = ops.pressure_project(
                u, v, config.pressure_iters, config.half_divergence,
                return_stats=True,
            )

        # -- boundary strip (cpu path only; zeroing rows can only shrink
        #    the max, so vel_stats stays a valid upper bound)
        if config.boundary_rows > 0:
            u, v, dye = ops.boundary_strip(u, v, dye, config.boundary_rows)

        return FluidState(
            u=u,
            v=v,
            dye=dye,
            pressure=p,
            t=state.t + dt,
            press_time=press_time,
            time_since_press=jnp.where(pressed, 0.0, state.time_since_press + dt),
            mouse=jnp.where(pressed, cur, state.mouse),
            step=state.step + 1,
            vel_stats=vel_stats,
        )

    return step


def make_render(config: FluidConfig, ops=None) -> Callable[[FluidState], jnp.ndarray]:
    """Device-side frame render: dye -> uint8 RGBA (+ optional bloom).

    Replaces the reference's convertToOpenGLInput/applyBloom/writeToTexture
    chain (GPUFluidSim.cu:432-442, 576-601) — no OpenGL; the frame is a plain
    (4, H, W) uint8 array ready for host streaming.

    Bloom centers on ``state.mouse`` (the most recent pressed position); the
    reference centers on x2pos = the PREVIOUS frame's cursor
    (GPUFluidSim.cu:701, Main.cpp:155), i.e. one frame behind ours — a
    sub-cell visual difference.
    """
    if ops is None:
        ops = get_ops(config)

    def render(state: FluidState) -> jnp.ndarray:
        if config.bloom_enabled:
            # one fused pass (pack + gated bloom); bit-exact to
            # where(active, apply_bloom(pack_rgba(dye)), pack_rgba(dye)) but
            # without the two extra RGBA round trips (ops.ref.render_frame)
            active = state.time_since_press < config.bloom_duration
            return ops.render_frame(
                state.dye, state.mouse, config.bloom_intense,
                config.splat_radius, active
            )
        return ops.pack_rgba(state.dye)

    return render
