"""The sharded k-burst Jacobi schedule vs global Jacobi, on both meshes.

Fused sharded pressure_project (divergence/project folded into the burst
halo exchanges) vs the single-device jnp oracle, on both mesh layouts, and
the plain diffusion / pressure bursts (k local sweeps per k-deep exchange)
vs the global sweeps at the same geometries.

The fused path must be numerically indistinguishable from the composed
divergence -> pressure_solve -> project chain (same sweep math, same clamped
stencils); these tests sweep iteration counts that cross every burst-schedule
branch (single partial burst, exactly one burst, burst + 1-sweep tail, exact
multiple, long tail) and both divergence scalings.  A jaxpr-level check pins
the collective schedule: the fused op must cost 1 + max(0, ceil(iters/k) - 1)
exchange pairs, not the composed 3 + ceil(iters/k).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cudafluidsimulation_tpu.ops import ref
from cudafluidsimulation_tpu.parallel.sharded import make_mesh
from cudafluidsimulation_tpu.parallel.shardmap2d import make_mesh2d, sharded_ops_2d
from cudafluidsimulation_tpu.parallel.shardmap_step import sharded_ops

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

H = W = 128
BURST = 8


def _fields(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    u = jax.random.normal(k1, (H, W), jnp.float32)
    v = jax.random.normal(k2, (H, W), jnp.float32)
    return u, v


def _rows_pp(mesh, iters, half):
    ns = sharded_ops("x", H, 15, burst=BURST)
    return shard_map(
        lambda uu, vv: ns.pressure_project(uu, vv, iters, half),
        mesh=mesh, in_specs=(P("x", None), P("x", None)),
        out_specs=(P("x", None), P("x", None), P("x", None)),
    )


def _2d_pp(mesh, iters, half):
    nr, nc = mesh.shape["rows"], mesh.shape["cols"]
    ns = sharded_ops_2d("rows", "cols", H, W, 15, burst=BURST)
    sp = P("rows", "cols")
    return shard_map(
        lambda uu, vv: ns.pressure_project(uu, vv, iters, half),
        mesh=mesh, in_specs=(sp, sp), out_specs=(sp, sp, sp),
    )


@requires_multidevice
@pytest.mark.parametrize("iters", [5, 8, 9, 16, 30])
@pytest.mark.parametrize("half", [True, False])
def test_rows_fused_matches_oracle(iters, half):
    u, v = _fields()
    mesh = make_mesh(8, ens=1)
    u2, v2, p = jax.jit(_rows_pp(mesh, iters, half))(u, v)
    ur, vr, pr = ref.pressure_project(u, v, iters, half)
    np.testing.assert_allclose(np.asarray(p), np.asarray(pr), atol=2e-6,
                               err_msg="pressure")
    np.testing.assert_allclose(np.asarray(u2), np.asarray(ur), atol=2e-6,
                               err_msg="u")
    np.testing.assert_allclose(np.asarray(v2), np.asarray(vr), atol=2e-6,
                               err_msg="v")


@requires_multidevice
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("iters", [5, 9, 30])
def test_2d_fused_matches_oracle(shape, iters):
    u, v = _fields(seed=3)
    mesh = make_mesh2d(*shape)
    u2, v2, p = jax.jit(_2d_pp(mesh, iters, True))(u, v)
    ur, vr, pr = ref.pressure_project(u, v, iters, True)
    np.testing.assert_allclose(np.asarray(p), np.asarray(pr), atol=2e-6,
                               err_msg="pressure")
    np.testing.assert_allclose(np.asarray(u2), np.asarray(ur), atol=2e-6,
                               err_msg="u")
    np.testing.assert_allclose(np.asarray(v2), np.asarray(vr), atol=2e-6,
                               err_msg="v")


@requires_multidevice
def test_rows_small_shard_falls_back():
    """Shard height below k+2 must fall back to the composed path (the
    fused op's k+2-deep exchange would read out-of-shard rows) and still
    match the oracle."""
    u, v = _fields(seed=7)
    u, v = u[:64], v[:64]
    mesh = make_mesh(8, ens=1)
    ns = sharded_ops("x", 64, 15, burst=BURST)
    fn = shard_map(
        lambda uu, vv: ns.pressure_project(uu, vv, 10, True),
        mesh=mesh, in_specs=(P("x", None), P("x", None)),
        out_specs=(P("x", None), P("x", None), P("x", None)),
    )
    u2, v2, p = jax.jit(fn)(u, v)
    ur, vr, pr = ref.pressure_project(u, v, 10, True)
    np.testing.assert_allclose(np.asarray(p), np.asarray(pr), atol=2e-6)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(ur), atol=2e-6)


@requires_multidevice
@pytest.mark.parametrize("burst,iters", [(3, 7), (3, 3), (5, 12), (5, 11),
                                         (8, 17), (6, 30)])
def test_rows_fused_geometry_fuzz(burst, iters):
    """Odd burst/iteration combinations: partial first bursts, 1-sweep
    tails (iters % burst == 1 exercises dep=2 center-slicing), bursts that
    do not divide the halo depth."""
    u, v = _fields(seed=burst * 100 + iters)
    mesh = make_mesh(8, ens=1)
    ns = sharded_ops("x", H, 15, burst=burst)
    fn = shard_map(
        lambda uu, vv: ns.pressure_project(uu, vv, iters, True),
        mesh=mesh, in_specs=(P("x", None), P("x", None)),
        out_specs=(P("x", None), P("x", None), P("x", None)),
    )
    u2, v2, p = jax.jit(fn)(u, v)
    ur, vr, pr = ref.pressure_project(u, v, iters, True)
    np.testing.assert_allclose(np.asarray(p), np.asarray(pr), atol=2e-6)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(ur), atol=2e-6)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(vr), atol=2e-6)


def _count_ppermute(jaxpr):
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "ppermute":
            n += 1
        for prm in eqn.params.values():
            for sub in (prm if isinstance(prm, (list, tuple)) else [prm]):
                if hasattr(sub, "eqns"):
                    n += _count_ppermute(sub)
                elif hasattr(sub, "jaxpr"):
                    n += _count_ppermute(sub.jaxpr)
    return n


@requires_multidevice
@pytest.mark.parametrize("iters,pairs", [(5, 1), (8, 1), (9, 2), (30, 4)])
def test_fused_exchange_schedule(iters, pairs):
    """1 velocity exchange + one pressure exchange per burst after the
    first: the whole projection collapses to 1 + (ceil(iters/k) - 1)
    exchange pairs (the composed chain costs 3 + ceil(iters/k))."""
    mesh = make_mesh(8, ens=1)
    fn = _rows_pp(mesh, iters, True)
    sds = jax.ShapeDtypeStruct((H, W), jnp.float32)
    jaxpr = jax.make_jaxpr(fn)(sds, sds)
    assert _count_ppermute(jaxpr.jaxpr) == 2 * pairs


def _bursts_fn(ns, mesh, op, iters, spec):
    if op == "diffuse":
        coeffs = jnp.asarray([0.8, 0.8, 0.5, 0.5, 0.5], jnp.float32)
        fn = lambda x: ns.diffuse_multi(x, 1.0 / 60.0, coeffs, iters)  # noqa
        specs = P(None, *spec)
    elif op == "diffuse_velocity":
        fn = lambda x: ns.diffuse(x, 1.0 / 60.0, 0.8, iters)  # noqa: E731
        specs = P(None, *spec)
    else:
        fn = lambda x: ns.pressure_solve(x, iters)  # noqa: E731
        specs = P(*spec)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=specs, out_specs=specs))


def _global(op, x, iters):
    if op == "diffuse":
        return ref.diffuse_multi(x, 1.0 / 60.0, [0.8, 0.8, 0.5, 0.5, 0.5],
                                 iters)
    if op == "diffuse_velocity":
        return ref.diffuse(x, 1.0 / 60.0, 0.8, iters)
    return ref.pressure_solve(x, iters)


_SHAPES = {"diffuse": (5, H, W), "diffuse_velocity": (2, H, W),
           "pressure": (H, W)}
_OPS = list(_SHAPES)


@requires_multidevice
@pytest.mark.parametrize("op", _OPS)
@pytest.mark.parametrize("burst,iters", [(8, 20), (8, 30), (3, 7), (5, 11),
                                         (8, 40)])
def test_rows_bursts_match_global_jacobi(op, burst, iters):
    """k sweeps per k-deep mirror exchange == iters global sweeps: the
    clamp error at each padded shard edge stays inside the k rows sliced
    off (the trapezoid), and the mirror fill is the true-edge ghost."""
    x = jax.random.normal(jax.random.PRNGKey(burst * 100 + iters),
                          _SHAPES[op])
    ns = sharded_ops("x", H, 15, burst=burst)
    got = _bursts_fn(ns, make_mesh(8, ens=1), op, iters, ("x", None))(x)
    exp = _global(op, x, iters)
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp), atol=2e-6,
                               rtol=1e-6)


@requires_multidevice
@pytest.mark.parametrize("op", _OPS)
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("burst,iters", [(8, 20), (5, 11)])
def test_2d_bursts_match_global_jacobi(op, shape, burst, iters):
    """Corner-carrying 2-D exchanges: the k-sweep dependence is the L1
    ball, so the diagonal halo blocks must arrive too."""
    x = jax.random.normal(jax.random.PRNGKey(burst * 10 + iters),
                          _SHAPES[op])
    ns = sharded_ops_2d("rows", "cols", H, W, 15, burst=burst)
    got = _bursts_fn(ns, make_mesh2d(*shape), op, iters,
                     ("rows", "cols"))(x)
    exp = _global(op, x, iters)
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp), atol=2e-6,
                               rtol=1e-6)
