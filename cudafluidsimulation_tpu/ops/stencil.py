"""Clamped-edge shift helpers shared by both backends.

Every neighbor access in the reference clamps indices to the domain
(the CLAMP macro, cpuFluidSim.cpp:8 / GPUFluidSim.cu:13), i.e. edge values
replicate outward.  "Value at (y+dy, x+dx), clamped" is a static slice +
edge-replication concat, which XLA fuses into the surrounding elementwise
work — no gather needed for the fixed-offset stencils.
"""

from __future__ import annotations

import jax.numpy as jnp


def shift_x(a: jnp.ndarray, d: int) -> jnp.ndarray:
    """Element (..., y, x) of the result is a[..., y, clamp(x+d)]."""
    if d == 0:
        return a
    if d > 0:
        edge = a[..., -1:]
        body = a[..., d:]
        reps = [edge] * d
        return jnp.concatenate([body] + reps, axis=-1)
    d = -d
    edge = a[..., :1]
    body = a[..., :-d]
    reps = [edge] * d
    return jnp.concatenate(reps + [body], axis=-1)


def shift_y(a: jnp.ndarray, d: int) -> jnp.ndarray:
    """Element (..., y, x) of the result is a[..., clamp(y+d), x]."""
    if d == 0:
        return a
    if d > 0:
        edge = a[..., -1:, :]
        body = a[..., d:, :]
        reps = [edge] * d
        return jnp.concatenate([body] + reps, axis=-2)
    d = -d
    edge = a[..., :1, :]
    body = a[..., :-d, :]
    reps = [edge] * d
    return jnp.concatenate(reps + [body], axis=-2)


def neighbors(a: jnp.ndarray):
    """(left, right, bottom, top) clamped 4-neighborhood.

    "bottom" is y-1 and "top" is y+1, matching the reference's flipped-y
    convention (larger y = up; see the B/T naming in GPUFluidSim.cu:302-307).
    """
    return shift_x(a, -1), shift_x(a, 1), shift_y(a, -1), shift_y(a, 1)
