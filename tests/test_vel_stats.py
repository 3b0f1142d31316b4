"""Producer-emitted velocity stats (ops.ref.vel_max contract).

The pressure projection returns a (2,) [max|u|, max|v|] bound about its
OUTPUT velocity; the pipeline threads it through ``state.vel_stats`` so the
clamp-observability warning and the realized-displacement report never
re-read the fields.  These tests pin: emission correctness on every
producer path and geometry, the state threading invariant (vel_stats is a
valid upper bound of the state's velocity), legacy checkpoint loading, and
the replicated stats on both sharded meshes.  No reference counterpart (the
reference has no runtime stats); the contract is this repo's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.models.pipelines import make_step
from cudafluidsimulation_tpu.ops import ref
from cudafluidsimulation_tpu.state import init_state
from cudafluidsimulation_tpu.utils.impulse import Impulse

DT = 0.25


def _true_stats(u, v):
    return np.asarray([np.max(np.abs(np.asarray(u))),
                       np.max(np.abs(np.asarray(v)))])


def _vel(rng, h, w, scale):
    u = jnp.asarray(rng.standard_normal((h, w)).astype(np.float32)) * scale
    v = jnp.asarray(rng.standard_normal((h, w)).astype(np.float32)) * scale
    return u, v


# -- emission correctness ------------------------------------------------------


@pytest.mark.parametrize("iters", [5, 30])
def test_pressure_project_stats(rng, iters):
    u, v = _vel(rng, 128, 128, 10.0)
    u2, v2, p, st = ref.pressure_project(u, v, iters, False,
                                         return_stats=True)
    np.testing.assert_allclose(np.asarray(st), _true_stats(u2, v2), atol=0)
    # the no-stats call returns the identical fields
    u2b, v2b, pb = ref.pressure_project(u, v, iters, False)
    np.testing.assert_array_equal(np.asarray(u2), np.asarray(u2b))
    np.testing.assert_array_equal(np.asarray(p), np.asarray(pb))


@pytest.mark.parametrize("scale", [0.5 / DT, 30.0])  # quiet / driven flow
def test_pressure_project_stats_at_flow_scales(rng, scale):
    u, v = _vel(rng, 64, 128, scale)
    u2, v2, _, st = ref.pressure_project(u, v, 30, True, return_stats=True)
    np.testing.assert_allclose(np.asarray(st), _true_stats(u2, v2), atol=0)


@pytest.mark.parametrize("shape", [(128, 4096), (100, 200)])
def test_pressure_project_stats_wide_and_odd_grids(rng, shape):
    u, v = _vel(rng, *shape, 10.0)
    u2, v2, _, st = ref.pressure_project(u, v, 8, False, return_stats=True)
    np.testing.assert_allclose(np.asarray(st), _true_stats(u2, v2), atol=0)


def test_project_stats(rng):
    u, v = _vel(rng, 128, 128, 1.0)
    p = jnp.asarray(rng.standard_normal((128, 128)).astype(np.float32))
    eu, ev, est = ref.project(u, v, p, return_stats=True)
    np.testing.assert_allclose(np.asarray(est), _true_stats(eu, ev), atol=0)
    np.testing.assert_allclose(np.asarray(ref.vel_max(eu, ev)),
                               _true_stats(eu, ev), atol=0)


# -- state threading -----------------------------------------------------------


def _drive(cfg, steps=5):
    step = jax.jit(make_step(cfg))
    s = init_state(cfg)
    for _ in range(steps):
        imp = Impulse(pos=jnp.asarray([70.0, 70.0]),
                      last_pos=jnp.asarray([64.0, 64.0]),
                      pressed=jnp.asarray(True), dt=jnp.asarray(cfg.dt))
        s = step(s, imp)
    return s


@pytest.mark.parametrize("make_cfg", [
    lambda: FluidConfig(nx=128, ny=128, backend="ref"),
    lambda: FluidConfig.quality(nx=128, ny=128, backend="ref"),
    lambda: FluidConfig.cpu_reference(nx=128, ny=128),
    lambda: FluidConfig(nx=128, ny=128, backend="ref",
                        pressure_solver="multigrid"),
])
def test_state_vel_stats_bounds_state_velocity(make_cfg):
    s = _drive(make_cfg())
    st = np.asarray(s.vel_stats)
    true = _true_stats(s.u, s.v)
    assert np.isfinite(st).all()
    assert (st >= true - 1e-5 * (1 + true)).all(), (st, true)
    # and reasonably tight: the bound comes from the same arrays (the cpu
    # variant's boundary strip may shrink the true max below the bound)
    if make_cfg().variant != "cpu":
        np.testing.assert_allclose(st, true, rtol=1e-5)


def test_checkpoint_roundtrip_and_legacy_load(tmp_path):
    from cudafluidsimulation_tpu.utils import checkpoint

    cfg = FluidConfig(nx=128, ny=128, backend="ref")
    s = _drive(cfg, steps=3)
    path = str(tmp_path / "c.npz")
    checkpoint.save_state(path, s)
    loaded = checkpoint.load_state(path)
    np.testing.assert_array_equal(np.asarray(loaded.vel_stats),
                                  np.asarray(s.vel_stats))

    # legacy checkpoint: strip vel_stats, loader must recompute the bound
    data = dict(np.load(path))
    del data["vel_stats"]
    legacy = str(tmp_path / "legacy.npz")
    np.savez_compressed(legacy, **data)
    loaded2 = checkpoint.load_state(legacy)
    np.testing.assert_allclose(np.asarray(loaded2.vel_stats),
                               _true_stats(s.u, s.v), rtol=1e-6)


# -- sharded meshes ------------------------------------------------------------

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@requires_multidevice
def test_rows_mesh_vel_stats_replicated_and_valid():
    from cudafluidsimulation_tpu.parallel.sharded import make_mesh, shard_state
    from cudafluidsimulation_tpu.parallel.shardmap_step import make_shardmap_step

    cfg = FluidConfig(nx=128, ny=128, backend="ref")
    mesh = make_mesh(8, ens=1)
    sstep = make_shardmap_step(cfg, mesh)
    s = shard_state(init_state(cfg), mesh)
    for _ in range(3):
        imp = Impulse(pos=jnp.asarray([70.0, 70.0]),
                      last_pos=jnp.asarray([64.0, 64.0]),
                      pressed=jnp.asarray(True), dt=jnp.asarray(cfg.dt))
        s = sstep(s, imp)
    st = np.asarray(s.vel_stats)
    true = _true_stats(s.u, s.v)
    assert (st >= true - 1e-5 * (1 + true)).all(), (st, true)
    np.testing.assert_allclose(st, true, rtol=1e-5)


@requires_multidevice
def test_2d_mesh_vel_stats_replicated_and_valid():
    from jax.sharding import Mesh
    from cudafluidsimulation_tpu.parallel.shardmap2d import (
        make_shardmap2d_step, shard_state_2d)

    cfg = FluidConfig(nx=128, ny=128, backend="ref", max_displacement=15)
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("rows", "cols"))
    sstep = make_shardmap2d_step(cfg, mesh)
    s = shard_state_2d(init_state(cfg), mesh)
    for _ in range(3):
        imp = Impulse(pos=jnp.asarray([70.0, 70.0]),
                      last_pos=jnp.asarray([64.0, 64.0]),
                      pressed=jnp.asarray(True), dt=jnp.asarray(cfg.dt))
        s = sstep(s, imp)
    st = np.asarray(s.vel_stats)
    true = _true_stats(s.u, s.v)
    assert (st >= true - 1e-5 * (1 + true)).all(), (st, true)
    np.testing.assert_allclose(st, true, rtol=1e-5)
