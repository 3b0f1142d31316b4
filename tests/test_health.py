"""Health checks: blow-up detection between rollout segments."""

import numpy as np
import jax.numpy as jnp
import pytest

from cudafluidsimulation_tpu import FluidConfig, Simulation
from cudafluidsimulation_tpu.utils.health import (
    Health,
    HealthError,
    check_health,
    clamp_axes,
    displacement_check,
    run_checked,
)
from cudafluidsimulation_tpu.utils.impulse import constant_impulse


def test_healthy_run_passes():
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref",
                                    diffusion_iters=2, pressure_iters=2)
    sim = Simulation(cfg)
    imp = constant_impulse(25, cfg.dt, pos=(32.0, 32.0), last_pos=(30.0, 31.0))
    state = run_checked(sim, sim.init(), imp, segment=10)
    assert int(state.step) == 25
    h = check_health(state)
    assert h.ok and h.max_speed > 0


def test_nan_detected():
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref")
    sim = Simulation(cfg)
    bad = sim.init()._replace(u=jnp.full((64, 64), jnp.nan))
    with pytest.raises(HealthError, match="non-finite"):
        check_health(bad)


def test_speed_limit_detected():
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref",
                                    diffusion_iters=2, pressure_iters=2)
    sim = Simulation(cfg)
    imp = constant_impulse(30, cfg.dt, pos=(32.0, 32.0), last_pos=(20.0, 28.0))
    with pytest.raises(HealthError, match="blow-up"):
        run_checked(sim, sim.init(), imp, segment=10, max_speed=1.0)


# -- realized-displacement (advection clamp) observability --------------------


def test_health_reports_realized_displacement():
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref",
                                    diffusion_iters=2, pressure_iters=2)
    sim = Simulation(cfg)
    imp = constant_impulse(20, cfg.dt, pos=(32.0, 32.0), last_pos=(28.0, 30.0))
    state = sim.run(sim.init(), imp)
    h = check_health(state)
    dx, dy = h.realized_displacement(cfg.dt)
    assert dx > 0 and dy > 0
    assert dx == pytest.approx(h.max_abs_u * cfg.dt)
    assert np.isclose(h.max_abs_u, float(jnp.max(jnp.abs(state.u))))


def test_displacement_check_warns_only_on_clamped_axes():
    h = Health(True, 10.0, 1.0, max_abs_u=1200.0, max_abs_v=60.0)
    dt = 1.0 / 60.0  # dx = 20 cells, dy = 1 cell
    assert displacement_check(h, dt, bound=15, axes="y") is None
    warn = displacement_check(h, dt, bound=15, axes="xy")
    assert warn is not None and "|u|*dt" in warn and "max_displacement=15" in warn
    # suggests a sufficient bound
    assert "21" in warn


def test_displacement_check_vertical():
    h = Health(True, 10.0, 1.0, max_abs_u=0.0, max_abs_v=1320.0)  # dy = 22
    warn = displacement_check(h, 1.0 / 60.0, bound=15, axes="y")
    assert warn is not None and "|v|*dt" in warn
    assert displacement_check(h, 1.0 / 60.0, bound=31, axes="y") is None


def test_clamp_axes_matrix():
    """The single-device step is exact on either backend; only the sharded
    meshes bound backtraces (by their halo depth)."""
    assert clamp_axes() == ""
    assert clamp_axes("none") == ""
    assert clamp_axes(mesh="rows") == "y"
    assert clamp_axes(mesh="2d") == "xy"


def test_run_displacement_scans_per_step_maxima():
    """run_displacement tracks the rollout MAX (pre-advection velocity each
    step), not just the final state."""
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref",
                                    diffusion_iters=2, pressure_iters=2)
    sim = Simulation(cfg)
    # press hard for 10 steps then release for 30: the flow decays, so the
    # final state is slower than the peak
    import jax.numpy as jnp
    from cudafluidsimulation_tpu.utils.impulse import Impulse, no_impulse

    hot = constant_impulse(10, cfg.dt, pos=(32.0, 32.0), last_pos=(24.0, 28.0))
    cold = no_impulse(30, cfg.dt)
    imp = Impulse(*(jnp.concatenate([a, b]) for a, b in zip(hot, cold)))
    final, (dx, dy) = sim.run_displacement(sim.init(), imp)
    h_final = check_health(final)
    fx, fy = h_final.realized_displacement(cfg.dt)
    assert dx >= fx and dy >= fy
    assert dx > 0
