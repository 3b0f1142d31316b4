"""Simulation state pytree.

The reference keeps its state in 6-9 mutable flat device/heap arrays
(cpuFluidSim.cpp:34-46, GPUFluidSim.cu:84-91) plus a handful of host globals
(elapsed press time, last mouse position, time since press —
cpuFluidSim.cpp:31-32,56 / GPUFluidSim.cu:79-81).  Here all of it is one
immutable pytree, which gives functional double-buffering, checkpointing,
vmap-able ensembles, and shard-able fields for free.

Layout is planar-channel (separate (H, W) arrays / a leading channel axis)
rather than the reference's interleaved float2/float3: neighbouring threads
then read neighbouring cells of one channel, so stencil loads coalesce.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from cudafluidsimulation_tpu.config import FluidConfig


class FluidState(NamedTuple):
    """All evolving simulation state. Fields are float32 (H, W) planes."""

    u: jnp.ndarray  # x-velocity, (H, W)
    v: jnp.ndarray  # y-velocity, (H, W)
    dye: jnp.ndarray  # RGB dye, (3, H, W)
    pressure: jnp.ndarray  # last pressure solve result, (H, W)
    t: jnp.ndarray  # total sim time, f32 scalar
    press_time: jnp.ndarray  # accumulated pressed time, drives the dye color
    #   cycle (cpuFluidSim.cpp:305 _timePassed / GPUFluidSim.cu:649 elapsedTime)
    time_since_press: jnp.ndarray  # gates the bloom effect (GPUFluidSim.cu:668,699)
    mouse: jnp.ndarray  # last impulse grid position (2,), the cpu-parity
    #   splat's force center memory (cpuFluidSim.cpp:31-32,317,409)
    step: jnp.ndarray  # i32 step counter
    vel_stats: jnp.ndarray  # (2,) [max|u|, max|v|] UPPER BOUND of (u, v),
    #   returned by the pressure projection that produced them
    #   (ops.ref.vel_max), so always-on clamp observability (realized
    #   backtrace displacement = vel_stats * dt) costs no extra pass.  The
    #   cpu-variant boundary strip only zeroes rows, so the bound stays valid
    #   after it.  No reference counterpart (the reference has no runtime
    #   stats).


def init_state(config: FluidConfig) -> FluidState:
    """Zero fields, like the reference's init (cpuFluidSim.cpp:103-106;
    cudaMalloc'd fields are driven from zero dynamics on the GPU path)."""
    h, w = config.shape
    f32 = jnp.float32
    return FluidState(
        u=jnp.zeros((h, w), f32),
        v=jnp.zeros((h, w), f32),
        dye=jnp.zeros((3, h, w), f32),
        pressure=jnp.zeros((h, w), f32),
        t=jnp.zeros((), f32),
        press_time=jnp.zeros((), f32),
        time_since_press=jnp.full((), 1e9, f32),  # "never pressed yet"
        mouse=jnp.zeros((2,), f32),
        step=jnp.zeros((), jnp.int32),
        vel_stats=jnp.zeros((2,), f32),  # exact: initial velocity is zero
    )
