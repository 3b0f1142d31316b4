"""The CUDA Jacobi backend (ops/jacobi_cuda.py, native/jacobi.cu).

On the CPU: the launch geometry, the FFI call each wrapper stages (shapes,
attributes, the vmap fold into channels), backend resolution, and a NumPy
emulation of the kernel's tiled trapezoid schedule, which must be bit-equal
to global Jacobi.  Tests marked ``gpu`` run the compiled kernel against
``ops.ref`` and skip without a GPU.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudafluidsimulation_tpu import FluidConfig, Simulation
from cudafluidsimulation_tpu.ops import jacobi_cuda as jc
from cudafluidsimulation_tpu.ops import ref
from cudafluidsimulation_tpu.ops.backend import get_ops
import oracle

DT = 1.0 / 60.0
F = np.float32
SM_COUNT = 132  # H100 SXM


@pytest.fixture
def staged(monkeypatch):
    """Trace the wrappers without the library: the FFI target is only
    looked up when XLA compiles the call, which these tests never do."""
    monkeypatch.setattr(jc, "_register", lambda: None)


def _ffi_eqns(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    return [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "ffi_call"]


# -- launch geometry ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["diffuse", "pressure"])
@pytest.mark.parametrize("h,w,iters", [(540, 960, 20), (2048, 2048, 40),
                                       (8192, 8192, 100)])
def test_tile_plan_covers_the_domain(mode, h, w, iters):
    th, tw, k = jc.TILE[mode]
    plan = jc.tile_plan(5, h, w, iters, mode)
    gx, gy, n = plan["grid"]
    assert n == 5
    assert gx * tw >= w > (gx - 1) * tw
    assert gy * th >= h > (gy - 1) * th
    assert plan["launches"] == math.ceil(iters / k)
    assert plan["smem_bytes"] <= jc.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("mode,channels", [("diffuse", 5), ("pressure", 1)])
def test_tile_plan_fills_the_card_at_the_reference_size(mode, channels):
    gx, gy, n = jc.tile_plan(channels, 540, 960, 30, mode)["grid"]
    assert gx * gy * n >= SM_COUNT


def test_table_tiles_are_compiled_into_the_library():
    assert set(jc.TILE.values()) <= set(_compiled_tiles())


# -- backend resolution ------------------------------------------------------------


def test_auto_resolves_to_ref_off_gpu():
    assert FluidConfig(backend="auto").resolve_backend() == "ref"
    assert FluidConfig(backend="ref").resolve_backend() == "ref"


@pytest.mark.parametrize("entry", [
    lambda cfg: cfg.resolve_backend(),
    get_ops,
    Simulation,
])
def test_cuda_backend_refused_off_gpu(entry):
    """No interpret mode and no silent fall-back to ref."""
    with pytest.raises(ValueError, match="needs a GPU"):
        entry(FluidConfig(nx=64, ny=64, backend="cuda"))


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        FluidConfig(backend="pallas")


def test_overrides_cover_only_the_jacobi_ops():
    assert set(jc.overrides()) == {"diffuse", "diffuse_multi",
                                   "diffuse_multi_splat", "pressure_solve",
                                   "pressure_project"}


# -- the staged FFI calls ----------------------------------------------------------


def test_diffuse_multi_stages_one_call(staged):
    x = jnp.zeros((5, 40, 70), jnp.float32)
    (eqn,) = _ffi_eqns(lambda x: jc.diffuse_multi(x, DT, [0.8] * 5, 20), x)
    assert [v.aval.shape for v in eqn.invars] == [(5, 40, 70), (5,), (5,)]
    assert [v.aval.shape for v in eqn.outvars] == [(5, 40, 70)] * 2
    th, tw, k = jc.TILE["diffuse"]
    assert eqn.params["target_name"] == "fluids_jacobi_diffuse"
    attrs = dict(eqn.params["attributes"])
    assert (attrs["iters"], attrs["th"], attrs["tw"], attrs["k"]) == (
        20, th, tw, k)


@pytest.mark.parametrize("shape", [(2, 40, 70), (40, 70)])
def test_diffuse_broadcasts_one_coefficient(staged, shape):
    x = jnp.zeros(shape, jnp.float32)
    out = jax.eval_shape(lambda x: jc.diffuse(x, DT, 0.8, 5), x)
    assert out.shape == shape
    (eqn,) = _ffi_eqns(lambda x: jc.diffuse(x, DT, 0.8, 5), x)
    c = shape[0] if len(shape) == 3 else 1
    assert [v.aval.shape for v in eqn.invars] == [(c, 40, 70), (c,), (c,)]


@pytest.mark.parametrize("with_init", [False, True])
def test_pressure_stages_zero_init(staged, with_init):
    d = jnp.zeros((40, 70), jnp.float32)
    init = jnp.ones((40, 70), jnp.float32) if with_init else None
    (eqn,) = _ffi_eqns(lambda d: jc.pressure_solve(d, 30, init=init), d)
    assert eqn.params["target_name"] == "fluids_jacobi_pressure"
    assert dict(eqn.params["attributes"])["zero_init"] == (not with_init)
    assert [v.aval.shape for v in eqn.invars] == [(40, 70)] * 2


@pytest.mark.parametrize("op", ["diffuse", "pressure"])
def test_vmap_folds_the_batch_into_channels(staged, op):
    """An ensemble vmaps the step: every operand gains the batch axis, and
    the handler treats all leading axes as channels."""
    if op == "diffuse":
        x = jnp.zeros((4, 5, 40, 70), jnp.float32)
        visc = jnp.linspace(0.2, 1.5, 4)

        def fn(x):
            return jax.vmap(lambda xi, k: jc.diffuse_multi(
                xi, DT, jnp.stack([k, k, 0.8, 0.8, 0.8]), 20))(x, visc)

        shapes = [(4, 5, 40, 70), (4, 5), (4, 5)]
    else:
        x = jnp.zeros((4, 40, 70), jnp.float32)

        def fn(x):
            return jax.vmap(lambda d: jc.pressure_solve(d, 30))(x)

        shapes = [(4, 40, 70)] * 2
    (eqn,) = _ffi_eqns(fn, x)
    assert [v.aval.shape for v in eqn.invars] == shapes
    assert jax.eval_shape(fn, x).shape == x.shape


@pytest.mark.parametrize("op", ["diffuse", "pressure"])
def test_zero_iters_stage_no_kernel(staged, op):
    x = jnp.ones((2, 40, 70), jnp.float32)
    if op == "diffuse":
        fn = lambda x: jc.diffuse_multi(x, DT, [0.8, 0.8], 0)  # noqa: E731
        expect = x
    else:
        fn = lambda x: jc.pressure_solve(x[0], 0)  # noqa: E731
        expect = jnp.zeros((40, 70), jnp.float32)
    assert not _ffi_eqns(fn, x)
    np.testing.assert_array_equal(np.asarray(fn(x)), np.asarray(expect))


def test_results_carry_the_shard_map_vma(staged):
    """Under shard_map with check_vma the call's results vary over the mesh
    axis like its operands (the sharded paths run the kernel per shard)."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("x",))
    fn = shard_map(lambda d: jc.pressure_solve(d, 8), mesh=mesh,
                   in_specs=P("x", None), out_specs=P("x", None))
    jaxpr = jax.make_jaxpr(fn)(jnp.zeros((64, 70), jnp.float32))
    (sm,) = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "shard_map"]
    inner = [e for e in sm.params["jaxpr"].eqns
             if e.primitive.name == "ffi_call"]
    assert inner and all(v.aval.vma == frozenset({"x"})
                         for v in inner[0].outvars)


# -- the tiled trapezoid schedule, emulated ------------------------------------------


def _emulate(x, iters, tile, alpha=None, inv_beta=None, rhs=None):
    """NumPy mirror of native/jacobi.cu: per launch, every (TH, TW) tile is
    loaded with a K-cell clamped halo, sweep s updates the cells at least s
    inside the tile edge with neighbours clamped at the true domain edges,
    and the core is written back."""
    th, tw, k = tile
    n, h, w = x.shape
    sh, sw = th + 2 * k, tw + 2 * k
    src = x
    for launch in range(-(-iters // k)):
        sweeps = min(k, iters - launch * k)
        dst = np.empty_like(x)
        for oy in range(-k, h - k, th):
            for ox in range(-k, w - k, tw):
                gy, gx = oy + np.arange(sh), ox + np.arange(sw)
                cy, cx = np.clip(gy, 0, h - 1), np.clip(gx, 0, w - 1)
                a = src[:, cy[:, None], cx[None, :]].copy()
                if rhs is not None:
                    r = rhs[:, cy[:, None], cx[None, :]]
                iy, ix = np.arange(sh), np.arange(sw)
                bot = np.where(gy > 0, iy - 1, iy)
                top = np.where(gy < h - 1, iy + 1, iy)
                lft = np.where(gx > 0, ix - 1, ix)
                rgt = np.where(gx < w - 1, ix + 1, ix)
                for s in range(1, sweeps + 1):
                    ys, xs = slice(s, sh - s), slice(s, sw - s)
                    l = a[:, ys][:, :, lft[xs]]
                    rr = a[:, ys][:, :, rgt[xs]]
                    b = a[:, bot[ys]][:, :, xs]
                    t = a[:, top[ys]][:, :, xs]
                    total = l + rr + b + t
                    new = a.copy()
                    if rhs is None:
                        new[:, ys, xs] = (total + a[:, ys, xs] * alpha) \
                            * inv_beta
                    else:
                        new[:, ys, xs] = (total - r[:, ys, xs]) * F(0.25)
                    a = new
                y1, x1 = min(oy + k + th, h), min(ox + k + tw, w)
                dst[:, oy + k:y1, ox + k:x1] = a[:, k:k + y1 - oy - k,
                                                 k:k + x1 - ox - k]
        src = dst
    return src


@pytest.mark.parametrize("mode,shape,iters,tile", [
    ("diffuse", (37, 53), 20, None),
    ("diffuse", (100, 200), 5, None),
    ("diffuse", (540, 960), 20, None),
    ("diffuse", (37, 53), 13, (8, 16, 4)),
    ("pressure", (37, 53), 1, None),
    ("pressure", (100, 200), 30, None),
    ("pressure", (540, 960), 30, None),
    ("pressure", (64, 128), 40, None),
    ("pressure", (37, 53), 9, (8, 16, 4)),
])
def test_tiled_trapezoid_schedule_is_global_jacobi(rng, mode, shape, iters,
                                                   tile):
    """Same arithmetic in the same order as the oracle's global sweeps, so
    the emulated schedule must agree bit for bit."""
    tile = tile or jc.TILE[mode]
    if mode == "diffuse":
        x = rng.standard_normal((2,) + shape).astype(F)
        alpha = F(0.8) * F(0.8) / F(DT)
        inv_beta = F(1) / (F(4) + alpha)
        got = _emulate(x, iters, tile, alpha=alpha, inv_beta=inv_beta)
        exp = oracle.diffuse(x, DT, 0.8, iters)
    else:
        div = rng.standard_normal((1,) + shape).astype(F)
        got = _emulate(np.zeros_like(div), iters, tile, rhs=div)[0]
        exp = oracle.pressure_solve(div[0], iters)
    np.testing.assert_array_equal(got, exp)


def _compiled_tiles():
    src = open(os.path.join(jc._NATIVE_DIR, "jacobi.cu")).read()
    block = src[src.index("#define FLUIDS_JACOBI_TILES"):]
    block = block[:block.index("\n\n")]
    return sorted({tuple(map(int, m)) for m in
                   re.findall(r"X\((\d+),\s*(\d+),\s*(\d+)\)", block)})


@pytest.mark.parametrize("mode", ["diffuse", "pressure"])
@pytest.mark.parametrize("tile", _compiled_tiles())
def test_every_compiled_tile_is_global_jacobi(rng, mode, tile):
    """Each tile the library compiles (any may be picked for TILE) keeps the
    schedule exact, including iteration counts that end in a partial
    launch."""
    shape, iters = (70, 150), 2 * tile[2] + 3
    if mode == "diffuse":
        x = rng.standard_normal((1,) + shape).astype(F)
        alpha = F(0.8) * F(0.8) / F(DT)
        got = _emulate(x, iters, tile, alpha=alpha,
                       inv_beta=F(1) / (F(4) + alpha))
        exp = oracle.diffuse(x, DT, 0.8, iters)
    else:
        div = rng.standard_normal((1,) + shape).astype(F)
        got = _emulate(np.zeros_like(div), iters, tile, rhs=div)[0]
        exp = oracle.pressure_solve(div[0], iters)
    np.testing.assert_array_equal(got, exp)


# -- on the card -------------------------------------------------------------------


def _tol(exp):
    """Max-abs tolerance: FMA contraction and XLA's own fusion order differ
    in the last bits per sweep; 1e-5 of the field's magnitude leaves room
    for 100 sweeps of that."""
    return 1e-5 * (1.0 + float(jnp.max(jnp.abs(exp))))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 53), (540, 960), (2048, 2048)])
def test_kernel_diffuse_matches_ref(rng, shape):
    x = jnp.asarray(rng.standard_normal((5,) + shape), jnp.float32)
    coeffs = [0.8, 0.8, 0.5, 0.5, 0.5]
    got = jax.jit(lambda x: jc.diffuse_multi(x, DT, coeffs, 20))(x)
    exp = jax.jit(lambda x: ref.diffuse_multi(x, DT, coeffs, 20))(x)
    assert float(jnp.max(jnp.abs(got - exp))) <= _tol(exp)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,iters", [((37, 53), 3), ((540, 960), 30),
                                         ((2048, 2048), 40)])
def test_kernel_pressure_matches_ref(rng, shape, iters):
    d = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    got = jax.jit(lambda d: jc.pressure_solve(d, iters))(d)
    exp = jax.jit(lambda d: ref.pressure_solve(d, iters))(d)
    assert float(jnp.max(jnp.abs(got - exp))) <= _tol(exp)
    p0 = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    got = jax.jit(lambda d, p: jc.pressure_solve(d, iters, init=p))(d, p0)
    exp = jax.jit(lambda d, p: ref.pressure_solve(d, iters, init=p))(d, p0)
    assert float(jnp.max(jnp.abs(got - exp))) <= _tol(exp)


@pytest.mark.gpu
def test_kernel_vmapped_ensemble_matches_ref(rng):
    x = jnp.asarray(rng.standard_normal((4, 5, 96, 160)), jnp.float32)
    visc = jnp.linspace(0.2, 1.5, 4)

    def run(op):
        return jax.jit(jax.vmap(lambda xi, k: op(
            xi, DT, jnp.stack([k, k, 0.8, 0.8, 0.8]), 20)))(x, visc)

    got, exp = run(jc.diffuse_multi), run(ref.diffuse_multi)
    assert float(jnp.max(jnp.abs(got - exp))) <= _tol(exp)


@pytest.mark.gpu
def test_cuda_step_matches_ref_step():
    """Ten driven gpu-parity steps at the reference's 960x540."""
    from cudafluidsimulation_tpu.utils.impulse import orbit_impulse

    imp = orbit_impulse(10, DT, center=(480.0, 270.0), radius=60.0)
    out = {}
    for backend in ("ref", "cuda"):
        cfg = FluidConfig.gpu_reference(backend=backend, vorticity=0.5,
                                        force_scale=500.0)
        sim = Simulation(cfg)
        out[backend] = sim.run(sim.init(), imp)
    for name in ("u", "v", "dye", "pressure"):
        exp = getattr(out["ref"], name)
        got = getattr(out["cuda"], name)
        assert float(jnp.max(jnp.abs(got - exp))) <= 10 * _tol(exp), name
