"""Simulation health checks — the failure-detection layer the reference
lacks entirely (SURVEY.md §5: only a CUDA abort macro).

Numerical blow-up in a stable-fluids step shows up as NaN/Inf fields or
runaway velocity magnitudes.  These helpers make that observable at the
harness level without touching the hot loop: run segments, check between
segments, and report the segment where health was lost.

Health also surfaces the REALIZED advection displacement (max |u|*dt,
max |v|*dt): the sharded meshes bound backtrace taps at
``config.max_displacement`` cells (vertical on the rows mesh, both axes on
the 2-D mesh), so a flow whose realized displacement exceeds the
bound silently diverges from the reference's unbounded backtrace
(GPUFluidSim.cu:267).  :func:`displacement_check` turns that into a warning
instead of silent clamping.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from cudafluidsimulation_tpu.state import FluidState


class Health(NamedTuple):
    finite: bool
    max_speed: float
    max_dye: float
    max_abs_u: float = 0.0
    max_abs_v: float = 0.0

    @property
    def ok(self) -> bool:
        return self.finite

    def realized_displacement(self, dt: float) -> Tuple[float, float]:
        """(max |u|*dt, max |v|*dt): the realized backtrace displacement in
        cells, the quantity the advection bound ``max_displacement`` clamps."""
        return self.max_abs_u * dt, self.max_abs_v * dt


class HealthError(RuntimeError):
    pass


@jax.jit
def _health_stats(state: FluidState):
    finite = (
        jnp.isfinite(state.u).all()
        & jnp.isfinite(state.v).all()
        & jnp.isfinite(state.dye).all()
        & jnp.isfinite(state.pressure).all()
    )
    au = jnp.max(jnp.abs(state.u))
    av = jnp.max(jnp.abs(state.v))
    speed = jnp.sqrt(jnp.max(state.u * state.u + state.v * state.v))
    return finite, speed, jnp.max(state.dye), au, av


def check_health(state: FluidState, max_speed: Optional[float] = None) -> Health:
    finite, speed, dye, au, av = _health_stats(state)
    h = Health(bool(finite), float(speed), float(dye), float(au), float(av))
    if not h.finite:
        raise HealthError(
            f"non-finite fields at step {int(state.step)} "
            f"(t={float(state.t):.4f})"
        )
    if max_speed is not None and h.max_speed > max_speed:
        raise HealthError(
            f"velocity blow-up at step {int(state.step)}: "
            f"max speed {h.max_speed:.1f} > limit {max_speed:.1f}"
        )
    return h


def displacement_check(health: Health, dt: float, bound: int,
                       axes: str = "y") -> Optional[str]:
    """Warning string when the realized backtrace displacement exceeds the
    advection bound on the clamped axes ('y' for the rows mesh — x taps
    there are exact; 'xy' for the 2-D mesh), else None."""
    dx, dy = health.realized_displacement(dt)
    clamped = []
    if dy > bound:
        clamped.append(f"|v|*dt = {dy:.1f}")
    if "x" in axes and dx > bound:
        clamped.append(f"|u|*dt = {dx:.1f}")
    if not clamped:
        return None
    return (
        f"advection clamp: realized displacement {' and '.join(clamped)} "
        f"cells exceeds max_displacement={bound}; backtraces are clamped "
        f"where the flow is fast (physics diverges from the reference's "
        f"unbounded backtrace) — raise --max-displacement to "
        f"{int(max(dx if 'x' in axes else 0.0, dy)) + 1} or more for "
        f"exactness"
    )


def clamp_axes(mesh: str = "none") -> str:
    """Which advection axes the active execution path clamps at
    ``max_displacement``: '' = none (exact unbounded backtrace),
    'y' = vertical only, 'xy' = both.

    The single-device step is exact; both sharded meshes bound vertical
    taps (halo depth) and the 2-D mesh additionally bounds horizontal taps
    (parallel/shardmap2d.py)."""
    return {"2d": "xy", "rows": "y"}.get(mesh, "")


def run_checked(sim, state: FluidState, impulses, segment: int = 100,
                max_speed: Optional[float] = None) -> FluidState:
    """Run a rollout in ``segment``-step slices with a health check between
    slices; raises HealthError naming the failing segment."""
    from cudafluidsimulation_tpu.utils.impulse import Impulse

    total = int(impulses.pressed.shape[0])
    start = 0
    while start < total:
        end = min(start + segment, total)
        part = Impulse(*(f[start:end] for f in impulses))
        state = sim.run(state, part)
        check_health(state, max_speed=max_speed)
        start = end
    return state
