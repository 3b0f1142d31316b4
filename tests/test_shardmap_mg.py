"""Sharded multigrid: the shard_map step with pressure_solver='multigrid'
must match the single-device multigrid step."""

import numpy as np
import jax
import pytest

from cudafluidsimulation_tpu import FluidConfig, Simulation, init_state
from cudafluidsimulation_tpu.parallel.sharded import make_mesh, shard_state
from cudafluidsimulation_tpu.parallel.shardmap_step import make_shardmap_step
from cudafluidsimulation_tpu.utils.impulse import orbit_impulse, slice_step

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@requires_multidevice
def test_shardmap_multigrid_matches_single_device():
    cfg = FluidConfig.gpu_reference(
        nx=128, ny=128, backend="ref", diffusion_iters=5,
        pressure_solver="multigrid", mg_cycles=2,
        vorticity=0.5, force_scale=500.0,
    )
    mesh = make_mesh(8, ens=1)
    sim = Simulation(cfg)
    imp = orbit_impulse(4, cfg.dt, center=(64.0, 64.0), radius=16.0)

    st_single = sim.init()
    st_shard = shard_state(init_state(cfg), mesh)
    sstep = make_shardmap_step(cfg, mesh)
    for i in range(4):
        one = slice_step(imp, i)
        st_single = sim.step(st_single, one)
        st_shard = sstep(st_shard, one)

    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_shard, name)),
            np.asarray(getattr(st_single, name)),
            atol=5e-5, rtol=1e-4, err_msg=name,
        )


@requires_multidevice
def test_shardmap_multigrid_below_shard_cap():
    """Geometry where the GLOBAL level count exceeds what a shard's rows can
    coarsen (ny=320 / 8 shards -> 40 local rows -> local cap 4 < global
    level 5): the sub-cap levels must be all-gathered and continued, making
    the sharded hierarchy level-equivalent to the single-chip solver (the
    round-1 version silently ran a shallower — different — solver here)."""
    from cudafluidsimulation_tpu.ops.multigrid import _levels

    ny, nx, n = 320, 512, 8
    hl = ny // n
    cap = 1
    hh = hl
    while hh % 2 == 0 and hh >= 2:
        hh //= 2
        cap += 1
    assert cap < _levels(ny, nx), "fixture must exercise the gathered bottom"

    cfg = FluidConfig.gpu_reference(
        nx=nx, ny=ny, backend="ref", diffusion_iters=3,
        pressure_solver="multigrid", mg_cycles=2,
        vorticity=0.5, force_scale=500.0,
    )
    mesh = make_mesh(n, ens=1)
    sim = Simulation(cfg)
    imp = orbit_impulse(3, cfg.dt, center=(nx / 2.0, ny / 2.0), radius=30.0)

    st_single = sim.init()
    st_shard = shard_state(init_state(cfg), mesh)
    sstep = make_shardmap_step(cfg, mesh)
    for i in range(3):
        one = slice_step(imp, i)
        st_single = sim.step(st_single, one)
        st_shard = sstep(st_shard, one)

    # solver-level agreement is ~4e-5 (pure fp reassociation); three pipeline
    # steps amplify that slightly
    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_shard, name)),
            np.asarray(getattr(st_single, name)),
            atol=3e-4, rtol=1e-4, err_msg=name,
        )


@requires_multidevice
def test_shardmap_multigrid_tol_matches_single_device():
    """Residual-targeted stopping on the rows mesh: the psum'd global
    residual must make every shard stop at the same cycle count the
    single-chip solver picks, so the results agree."""
    cfg = FluidConfig.gpu_reference(
        nx=128, ny=128, backend="ref", diffusion_iters=3,
        pressure_solver="multigrid", mg_tol=0.02, mg_max_cycles=6,
        vorticity=0.5, force_scale=500.0,
    )
    mesh = make_mesh(8, ens=1)
    sim = Simulation(cfg)
    imp = orbit_impulse(3, cfg.dt, center=(64.0, 64.0), radius=16.0)

    st_single = sim.init()
    st_shard = shard_state(init_state(cfg), mesh)
    sstep = make_shardmap_step(cfg, mesh)
    for i in range(3):
        one = slice_step(imp, i)
        st_single = sim.step(st_single, one)
        st_shard = sstep(st_shard, one)

    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_shard, name)),
            np.asarray(getattr(st_single, name)),
            atol=3e-4, rtol=1e-3, err_msg=name,
        )


@requires_multidevice
def test_shardmap2d_multigrid_tol_matches_single_device():
    """Same check on the 2-D (rows x cols) mesh (psum over both axes)."""
    from cudafluidsimulation_tpu.parallel.shardmap2d import (
        make_mesh2d, make_shardmap2d_step, shard_state_2d,
    )

    cfg = FluidConfig.gpu_reference(
        nx=128, ny=128, backend="ref", diffusion_iters=3,
        pressure_solver="multigrid", mg_tol=0.02, mg_max_cycles=6,
        vorticity=0.5, force_scale=500.0, max_displacement=15,
    )
    mesh = make_mesh2d(2, 4)
    sim = Simulation(cfg)
    imp = orbit_impulse(3, cfg.dt, center=(64.0, 64.0), radius=16.0)

    st_single = sim.init()
    st_shard = shard_state_2d(init_state(cfg), mesh)
    sstep = make_shardmap2d_step(cfg, mesh)
    for i in range(3):
        one = slice_step(imp, i)
        st_single = sim.step(st_single, one)
        st_shard = sstep(st_shard, one)

    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_shard, name)),
            np.asarray(getattr(st_single, name)),
            atol=3e-4, rtol=1e-3, err_msg=name,
        )


@requires_multidevice
def test_sharded_mg_exchange_schedule_pinned():
    """The sharded multigrid exchange schedule: stacked (p, rhs) smoothing
    exchanges and residuals riding the pre-smooth's k+1-deep exchange
    (r4).  Regressing to separate/per-op exchanges would raise the count —
    pin it (trace is shape-only, so the 8192² config is cheap)."""
    from cudafluidsimulation_tpu.parallel.halo import measure_halo_traffic

    mesh = make_mesh(8, ens=1)
    cfg = FluidConfig.gpu_reference(nx=8192, ny=8192, pressure_iters=100,
                                    backend="ref",
                                    pressure_solver="multigrid", mg_cycles=2)
    t = measure_halo_traffic(cfg, mesh)
    assert t["exchange_pairs_per_step"] == 55, t
    assert t["all_gather_per_step"] == 0, t
