"""Multi-device sharding on the virtual 8-device CPU mesh: the sharded step
must match the single-device step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudafluidsimulation_tpu import FluidConfig, Simulation, init_state
from cudafluidsimulation_tpu.parallel.sharded import (
    make_mesh,
    make_sharded_step,
    shard_state,
    sharded_rollout,
)
from cudafluidsimulation_tpu.utils.impulse import Impulse, orbit_impulse, slice_step


requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def cfg64():
    # mild dynamics (low vorticity/force): the default gpu parameters are
    # turbulent enough that SPMD reduction-order rounding amplifies
    # chaotically within a few steps, which would test chaos, not sharding
    return FluidConfig.gpu_reference(
        nx=128, ny=64, backend="ref", diffusion_iters=5, pressure_iters=10,
        vorticity=0.5, force_scale=500.0,
    )


@requires_multidevice
def test_sharded_step_matches_single_device():
    cfg = cfg64()
    mesh = make_mesh(8, ens=1)
    sim = Simulation(cfg)
    imp = orbit_impulse(6, cfg.dt, center=(64.0, 32.0), radius=10.0)

    st_single = sim.init()
    st_shard = shard_state(init_state(cfg), mesh)
    sstep = make_sharded_step(cfg, mesh)
    for i in range(6):
        one = slice_step(imp, i)
        st_single = sim.step(st_single, one)
        st_shard = sstep(st_shard, one)

    for name in ("u", "v", "dye", "pressure"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_shard, name)),
            np.asarray(getattr(st_single, name)),
            atol=1e-5, rtol=1e-5, err_msg=name,
        )


@requires_multidevice
def test_sharded_state_is_actually_distributed():
    cfg = cfg64()
    mesh = make_mesh(8, ens=1)
    st = shard_state(init_state(cfg), mesh)
    # row-sharded over 8 devices -> each shard holds H/8 rows
    shards = st.u.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape == (64 // 8, 128)


@requires_multidevice
def test_sharded_ensemble_rollout():
    cfg = cfg64()
    mesh = make_mesh(8, ens=2)  # 2-way ensemble x 4-way spatial
    ens = 2
    base = init_state(cfg)
    state = jax.tree.map(lambda x: jnp.stack([x] * ens), base)
    state = shard_state(state, mesh, batched=True)

    T = 4
    one = orbit_impulse(T, cfg.dt, center=(64.0, 32.0), radius=10.0)
    imp = Impulse(*(jnp.stack([f] * ens) for f in one))

    run = sharded_rollout(cfg, mesh, batched=True)
    out = run(state, imp)
    jax.block_until_ready(out)
    assert out.u.shape == (ens, 64, 128)
    # both members got identical impulses -> identical results
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(out.u[1]), atol=1e-6
    )

    # cross-check member 0 against the plain single-device rollout
    sim = Simulation(cfg)
    ref_final = sim.run(sim.init(), one)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref_final.u), atol=1e-5, rtol=1e-5
    )


@requires_multidevice
def test_auto_spmd_never_traces_pallas():
    """XLA's SPMD partitioner cannot partition an opaque kernel call (the
    CUDA backend's ffi_call): on a >1-device mesh the auto-sharded builders
    take the jnp ops only and refuse a kernel backend (the explicit
    shard_map paths run the kernel per shard)."""
    from cudafluidsimulation_tpu.utils.impulse import orbit_impulse

    mesh = make_mesh(8, ens=1)
    with pytest.raises(ValueError):
        make_sharded_step(FluidConfig.gpu_reference(nx=256, ny=256,
                                                    backend="cuda"), mesh)
    cfg = FluidConfig.gpu_reference(nx=256, ny=256, backend="ref",
                                    diffusion_iters=4, pressure_iters=8)
    step = make_sharded_step(cfg, mesh)
    st = init_state(cfg)
    imp = slice_step(orbit_impulse(1, cfg.dt, center=(128.0, 128.0),
                                   radius=32.0), 0)

    def prims(jx, out):
        for eqn in jx.eqns:
            out.add(eqn.primitive.name)
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "eqns"):
                        prims(sub, out)
                    elif hasattr(sub, "jaxpr"):
                        prims(sub.jaxpr, out)
        return out

    names = prims(jax.make_jaxpr(step)(st, imp).jaxpr, set())
    assert not names & {"pallas_call", "ffi_call", "custom_call"}
