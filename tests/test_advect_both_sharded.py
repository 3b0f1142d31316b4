"""Fused 5-channel advection exchange (advect_both) vs the split ops.

Both sharded meshes advect velocity AND dye off one d-deep halo exchange of
the stacked [u, v, dye] fields (shardmap_step/shardmap2d advect_both).  The
fusion must be a pure communication optimization: bit-identical results to
the split advect_velocity -> advect_dye chain on the same namespace, at two
halo depths, including flows whose backtraces hit the displacement clamp.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cudafluidsimulation_tpu.parallel.sharded import make_mesh
from cudafluidsimulation_tpu.parallel.shardmap2d import make_mesh2d, sharded_ops_2d
from cudafluidsimulation_tpu.parallel.shardmap_step import sharded_ops

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

H = W = 128
DT = 1.0 / 60.0
DECAY = 1.2
D = 15


def _fields(speed, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    u = speed * jax.random.normal(ks[0], (H, W), jnp.float32)
    v = speed * jax.random.normal(ks[1], (H, W), jnp.float32)
    dye = jax.random.uniform(ks[2], (3, H, W), jnp.float32)
    return u, v, dye


def _pair(ns, spec, mesh):
    """(fused, split) shard_map'd advection callables over one namespace."""
    dye_spec = P(None, *spec)

    def fused(u, v, dye):
        return ns.advect_both(u, v, dye, DT, DECAY)

    def split(u, v, dye):
        u2, v2 = ns.advect_velocity(u, v, DT, DECAY)
        return u2, v2, ns.advect_dye(dye, u2, v2, DT, DECAY)

    def wrap(fn):
        return jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(P(*spec), P(*spec), dye_spec),
            out_specs=(P(*spec), P(*spec), dye_spec),
        ))

    return wrap(fused), wrap(split)


@requires_multidevice
@pytest.mark.parametrize("d", [8, D])
@pytest.mark.parametrize("speed", [40.0, 1200.0])  # ~0.7 and ~20 cells/step
def test_rows_advect_both_matches_split(d, speed):
    ns = sharded_ops("x", H, d)
    mesh = make_mesh(8, ens=1)
    fused, split = _pair(ns, ("x", None), mesh)
    u, v, dye = _fields(speed)
    for a, b in zip(fused(u, v, dye), split(u, v, dye)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@requires_multidevice
@pytest.mark.parametrize("d", [8, D])
@pytest.mark.parametrize("speed", [40.0, 1200.0])
def test_2d_advect_both_matches_split(d, speed):
    ns = sharded_ops_2d("rows", "cols", H, W, d)
    mesh = make_mesh2d(2, 4)
    fused, split = _pair(ns, ("rows", "cols"), mesh)
    u, v, dye = _fields(speed)
    for a, b in zip(fused(u, v, dye), split(u, v, dye)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
