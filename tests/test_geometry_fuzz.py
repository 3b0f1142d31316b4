"""Geometry robustness: odd grid sizes must run finite and agree with the
NumPy oracle, and the sharded fused projection must match the single-device
composition at odd shard heights, iteration counts and burst depths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cudafluidsimulation_tpu import FluidConfig, Simulation
from cudafluidsimulation_tpu.config import PALETTE
from cudafluidsimulation_tpu.ops import ref
from cudafluidsimulation_tpu.parallel.sharded import make_mesh
from cudafluidsimulation_tpu.parallel.shardmap_step import sharded_ops
from cudafluidsimulation_tpu.utils.impulse import constant_impulse, slice_step
import oracle

SIZES = [(64, 64), (48, 128), (100, 200), (17, 64), (96, 192), (135, 240),
         (40, 72)]


@pytest.mark.parametrize("ny,nx", SIZES)
def test_odd_sizes_run_and_agree(ny, nx):
    steps = 3
    imp = constant_impulse(steps, 1 / 60, pos=(nx / 2, ny / 2),
                           last_pos=(nx / 2 - 2, ny / 2 - 1))
    cfg = FluidConfig.gpu_reference(
        nx=nx, ny=ny, backend="ref", diffusion_iters=3,
        pressure_iters=4, vorticity=0.5, force_scale=500.0,
    )
    sim = Simulation(cfg)
    st = sim.run(sim.init(), imp)
    assert np.isfinite(np.asarray(st.u)).all(), (ny, nx)
    assert np.isfinite(np.asarray(st.dye)).all(), (ny, nx)
    orc = oracle.OracleSim(cfg, PALETTE)
    for i in range(steps):
        s = slice_step(imp, i)
        orc.step(np.asarray(s.pos), np.asarray(s.last_pos), bool(s.pressed),
                 float(s.dt))
    np.testing.assert_allclose(np.asarray(st.u), orc.u, atol=5e-4,
                               err_msg=f"{ny}x{nx}")


def test_pressure_project_geometry_fuzz(rng):
    """Shard heights x iteration counts x burst depths: the sharded
    pressure_project (fused where the shard is tall enough, composed
    otherwise) must match the single-device composition — guards the
    per-burst halo-depth selection."""
    mesh = make_mesh(2, ens=1, devices=jax.devices()[:2])
    ran = 0
    for h in (24, 72, 200):
        for it, b in ((1, 8), (7, 8), (30, 8), (40, 8), (30, 20), (13, 5)):
            u = jnp.asarray(rng.standard_normal((h, 128)).astype(np.float32)
                            * 20)
            v = jnp.asarray(rng.standard_normal((h, 128)).astype(np.float32)
                            * 20)
            ns = sharded_ops("x", h, 15, burst=min(b, h // 2))
            fn = jax.jit(shard_map(
                lambda uu, vv: ns.pressure_project(uu, vv, it, True),
                mesh=mesh, in_specs=(P("x", None), P("x", None)),
                out_specs=(P("x", None),) * 3))
            gu, gv, gp = fn(u, v)
            eu, ev, ep = ref.pressure_project(u, v, it, True)
            msg = f"{h}x128 it={it} b={b}"
            np.testing.assert_allclose(np.asarray(gp), np.asarray(ep),
                                       atol=5e-5, err_msg=msg)
            np.testing.assert_allclose(np.asarray(gu), np.asarray(eu),
                                       atol=5e-5, err_msg=msg)
            ran += 1
    assert ran == 18
