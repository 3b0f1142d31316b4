"""2-D (rows x cols) spatial mesh: equivalence with the single-device step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudafluidsimulation_tpu import FluidConfig, Simulation, init_state
from cudafluidsimulation_tpu.parallel.shardmap2d import (
    make_mesh2d,
    make_shardmap2d_rollout,
    make_shardmap2d_step,
    shard_state_2d,
)
from cudafluidsimulation_tpu.utils.impulse import orbit_impulse, slice_step

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

MILD = dict(vorticity=0.5, force_scale=500.0)


def _run_pair(cfg, mesh, steps=4):
    sim = Simulation(cfg)
    imp = orbit_impulse(steps, cfg.dt, center=(cfg.nx / 2.0, cfg.ny / 2.0),
                        radius=min(cfg.nx, cfg.ny) / 4.0)
    st_single = sim.init()
    st_shard = shard_state_2d(init_state(cfg), mesh)
    sstep = make_shardmap2d_step(cfg, mesh)
    for i in range(steps):
        one = slice_step(imp, i)
        st_single = sim.step(st_single, one)
        st_shard = sstep(st_shard, one)
    return st_single, st_shard


def _assert_close(a, b, atol=5e-5):
    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(b, name)), np.asarray(getattr(a, name)),
            atol=atol, rtol=1e-4, err_msg=name,
        )


@requires_multidevice
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_2d_mesh_matches_single_device(shape):
    """Orbit flow crossing both row and column seams (and their corners)."""
    cfg = FluidConfig.gpu_reference(nx=128, ny=128, backend="ref",
                                    diffusion_iters=4, **MILD)
    mesh = make_mesh2d(*shape)
    single, shard = _run_pair(cfg, mesh)
    _assert_close(single, shard)


@requires_multidevice
def test_2d_mesh_cpu_variant_boundary_strip():
    cfg = FluidConfig.cpu_reference(nx=128, ny=128, backend="ref", **MILD)
    mesh = make_mesh2d(4, 2)
    single, shard = _run_pair(cfg, mesh)
    _assert_close(single, shard)
    # the y<=10 strip must be zero on the bottom shard row only
    assert np.abs(np.asarray(shard.dye)[:, :11, :]).max() == 0


@requires_multidevice
def test_2d_rollout_matches_stepwise():
    cfg = FluidConfig.gpu_reference(nx=128, ny=64, backend="ref",
                                    diffusion_iters=3, pressure_iters=6, **MILD)
    mesh = make_mesh2d(2, 4)
    imp = orbit_impulse(5, cfg.dt, center=(64.0, 32.0), radius=16.0)
    run = make_shardmap2d_rollout(cfg, mesh)
    st = shard_state_2d(init_state(cfg), mesh)
    out = run(st, imp)

    sstep = make_shardmap2d_step(cfg, mesh)
    st2 = shard_state_2d(init_state(cfg), mesh)
    for i in range(5):
        st2 = sstep(st2, slice_step(imp, i))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(st2.u), atol=1e-6)


@requires_multidevice
def test_2d_mesh_pallas_composition():
    """The default backend's Jacobi bursts on the 2-D-halo-padded local
    views (the CUDA kernel on a GPU, jnp sweeps here) match the
    single-device step."""
    cfg = FluidConfig.gpu_reference(nx=128, ny=128, backend="auto",
                                    diffusion_iters=4, pressure_iters=6,
                                    max_displacement=7, **MILD)
    mesh = make_mesh2d(2, 2)
    single, shard = _run_pair(cfg, mesh, steps=2)
    _assert_close(single, shard, atol=2e-4)


@requires_multidevice
def test_2d_multigrid_matches_single_device():
    cfg = FluidConfig.gpu_reference(
        nx=128, ny=128, backend="ref", diffusion_iters=3,
        pressure_solver="multigrid", mg_cycles=2, **MILD)
    mesh = make_mesh2d(2, 4)
    single, shard = _run_pair(cfg, mesh, steps=3)
    _assert_close(single, shard, atol=3e-4)


@requires_multidevice
def test_2d_multigrid_below_shard_cap_solver_level():
    """Geometry where BOTH shard dims stop halving before the global level
    count: the sub-cap levels must be gathered along both mesh axes."""
    from jax.sharding import PartitionSpec as P

    from cudafluidsimulation_tpu.ops import multigrid as mg
    from cudafluidsimulation_tpu.parallel.shardmap2d import sharded_ops_2d

    ny, nx = 1088, 1088  # 2^6 * 17: v2 small relative to the level count
    mesh = make_mesh2d(4, 2)
    hl, wl = ny // 4, nx // 2
    assert min(mg.local_levels(hl), mg.local_levels(wl)) < mg._levels(ny, nx), \
        "fixture must exercise the gathered bottom"

    rng = np.random.default_rng(0)
    div = jnp.asarray(rng.standard_normal((ny, nx)).astype(np.float32))
    exp = np.asarray(mg.pressure_solve_mg(div, cycles=1))

    ops = sharded_ops_2d("rows", "cols", ny, nx, 15)
    fn = jax.jit(jax.shard_map(
        lambda dd: ops.pressure_solve_mg(dd, 1), mesh=mesh,
        in_specs=P("rows", "cols"), out_specs=P("rows", "cols")))
    got = np.asarray(fn(div))
    np.testing.assert_allclose(got, exp, atol=2e-4)


@requires_multidevice
def test_2d_mesh_validation_errors():
    mesh = make_mesh2d(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        make_shardmap2d_step(
            FluidConfig.gpu_reference(nx=130, ny=128, backend="ref"), mesh)
    with pytest.raises(ValueError, match="max_displacement"):
        make_shardmap2d_step(
            FluidConfig.gpu_reference(nx=32, ny=128, backend="ref"), mesh)
