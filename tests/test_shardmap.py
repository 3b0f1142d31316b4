"""Explicit shard_map + ppermute halo-exchange step vs single-device ref."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudafluidsimulation_tpu import FluidConfig, Simulation, init_state
from cudafluidsimulation_tpu.parallel.halo import exchange_rows
from cudafluidsimulation_tpu.parallel.sharded import make_mesh, shard_state
from cudafluidsimulation_tpu.parallel.shardmap_step import (
    make_shardmap_rollout,
    make_shardmap_step,
)
from cudafluidsimulation_tpu.utils.impulse import orbit_impulse, slice_step

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def mild_cfg(**kw):
    base = dict(
        nx=128, ny=128, backend="ref", diffusion_iters=5, pressure_iters=10,
        vorticity=0.5, force_scale=500.0,
    )
    base.update(kw)
    return FluidConfig.gpu_reference(**base)


@requires_multidevice
def test_exchange_rows_matches_pad():
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(8, ens=1)
    H, W = 64, 128
    a = jnp.arange(H * W, dtype=jnp.float32).reshape(H, W)

    fn = shard_map(
        lambda x: exchange_rows(x, 2, "x"),
        mesh=mesh, in_specs=P("x", None), out_specs=P("x", None),
        
    )
    out = np.asarray(fn(a)).reshape(8, 12, W)  # each shard: 8 rows + 2+2 halo
    an = np.asarray(a).reshape(8, 8, W)
    for s in range(8):
        np.testing.assert_array_equal(out[s][2:-2], an[s])
        if s > 0:
            np.testing.assert_array_equal(out[s][:2], an[s - 1][-2:])
        else:
            np.testing.assert_array_equal(out[s][:2], np.tile(an[0][:1], (2, 1)))
        if s < 7:
            np.testing.assert_array_equal(out[s][-2:], an[s + 1][:2])
        else:
            np.testing.assert_array_equal(out[s][-2:], np.tile(an[7][-1:], (2, 1)))


@requires_multidevice
@pytest.mark.parametrize("variant", ["gpu", "cpu"])
def test_shardmap_step_matches_single_device(variant):
    if variant == "cpu":
        cfg = FluidConfig.cpu_reference(nx=128, ny=128, backend="ref")
    else:
        cfg = mild_cfg()
    mesh = make_mesh(8, ens=1)
    sim = Simulation(cfg)
    imp = orbit_impulse(5, cfg.dt, center=(64.0, 64.0), radius=16.0)

    st_single = sim.init()
    st_shard = shard_state(init_state(cfg), mesh)
    sstep = make_shardmap_step(cfg, mesh)
    for i in range(5):
        one = slice_step(imp, i)
        st_single = sim.step(st_single, one)
        st_shard = sstep(st_shard, one)

    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_shard, name)),
            np.asarray(getattr(st_single, name)),
            atol=2e-5, rtol=1e-5, err_msg=f"{variant}/{name}",
        )


@requires_multidevice
def test_shardmap_rollout_matches_single_device():
    cfg = mild_cfg()
    mesh = make_mesh(8, ens=1)
    sim = Simulation(cfg)
    imp = orbit_impulse(8, cfg.dt, center=(64.0, 64.0), radius=16.0)

    run = make_shardmap_rollout(cfg, mesh)
    st = run(shard_state(init_state(cfg), mesh), imp)
    ref_final = sim.run(sim.init(), imp)
    np.testing.assert_allclose(
        np.asarray(st.u), np.asarray(ref_final.u), atol=5e-5, rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(st.dye), np.asarray(ref_final.dye), atol=5e-5, rtol=1e-4
    )


@requires_multidevice
def test_shardmap_with_pallas_bursts_matches_ref(monkeypatch):
    """The shard_map path's k-deep mirror halo bursts (k = BURST local
    sweeps per exchange) must match the sweep-by-sweep schedule (k = 1)."""
    from cudafluidsimulation_tpu.parallel import shardmap_step

    cfg_ref = cfg_pal = mild_cfg()
    mesh = make_mesh(8, ens=1)
    imp = orbit_impulse(3, cfg_ref.dt, center=(64.0, 32.0), radius=10.0)

    st_r = shard_state(init_state(cfg_ref), mesh)
    st_p = shard_state(init_state(cfg_pal), mesh)
    step_p = make_shardmap_step(cfg_pal, mesh)
    monkeypatch.setattr(shardmap_step, "BURST", 1)
    step_r = make_shardmap_step(cfg_ref, mesh)
    for i in range(3):
        one = slice_step(imp, i)
        st_r = step_r(st_r, one)
        st_p = step_p(st_p, one)

    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_p, name)), np.asarray(getattr(st_r, name)),
            atol=5e-5, rtol=1e-4, err_msg=name,
        )


@requires_multidevice
def test_halo_traffic_accounting():
    """measure_halo_traffic counts the step's real collective schedule from
    the traced jaxpr (shape-only: works at 8192^2 without allocating)."""
    from cudafluidsimulation_tpu.parallel.halo import measure_halo_traffic
    from cudafluidsimulation_tpu.parallel.sharded import make_mesh

    mesh = make_mesh(8, ens=1)
    cfg = FluidConfig.gpu_reference(nx=8192, ny=8192, pressure_iters=100,
                                    backend="ref")
    t = measure_halo_traffic(cfg, mesh)
    assert t["ppermute_per_step"] > 0
    assert t["ppermute_per_step"] % 2 == 0
    assert t["halo_bytes_per_step_per_device"] > 0
    # k sweeps per exchange, div/project folded into the pressure bursts,
    # curl into one 2-deep velocity exchange, and both advections onto one
    # 5-channel exchange: advect 1 + vorticity 1 + diffuse 3 + pressure
    # (1 + 13 - 1) = 18 pairs at burst=8
    assert t["exchange_pairs_per_step"] == 18
    assert t["sweeps_per_exchange_pair"] == round(200 / 18, 3)
