"""The jnp ops at the kernel-era shapes, iteration counts and flow scales,
against the independent NumPy oracle (tests/oracle.py).

These are the geometries the hand-written kernels were checked at: odd and
lane-misaligned grids, the reference's 960x540, deep single-launch sweep
counts, edge and beyond-bound backtraces.  ``ops.ref`` is what XLA compiles
on every device and what the CUDA Jacobi kernel is compared against on the
GPU, so it must hold there against the from-the-math oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cudafluidsimulation_tpu import FluidConfig, Simulation
from cudafluidsimulation_tpu.config import PALETTE
from cudafluidsimulation_tpu.ops import multigrid, ref
from cudafluidsimulation_tpu.utils.impulse import orbit_impulse, slice_step
import oracle

DT = 1.0 / 60.0
F = np.float32


def _field(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(F)


def _close(got, exp, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp), atol=atol,
                               rtol=rtol)


def _close_scaled(got, exp, rel=1e-5):
    """Agreement to ``rel`` of the field's magnitude: Jacobi sums grow with
    the sweep count, and f32 rounding grows with them."""
    exp = np.asarray(exp)
    _close(got, exp, atol=rel * (1.0 + float(np.max(np.abs(exp)))), rtol=0)


# -- pressure ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 128), (48, 128), (256, 256)])
@pytest.mark.parametrize("iters", [1, 5, 30, 40])
def test_pressure_matches_oracle(rng, shape, iters):
    div = _field(rng, shape)
    _close_scaled(ref.pressure_solve(jnp.asarray(div), iters),
                  oracle.pressure_solve(div, iters))


@pytest.mark.parametrize("shape", [(540, 960), (100, 200)])
def test_pressure_odd_grids(rng, shape):
    div = _field(rng, shape)
    _close_scaled(ref.pressure_solve(jnp.asarray(div), 30),
                  oracle.pressure_solve(div, 30))


@pytest.mark.parametrize("shape,iters", [((512, 512), 30), ((540, 960), 20),
                                         ((256, 256), 30)])
def test_deep_pressure_matches_oracle(rng, shape, iters):
    """Whole pressure stages at the sizes one launch used to cover."""
    u, v = _field(rng, shape, 5.0), _field(rng, shape, 5.0)
    div = oracle.divergence(u, v, True)
    _close_scaled(ref.pressure_solve(jnp.asarray(div), iters),
                  oracle.pressure_solve(div, iters))


def test_pressure_init_continues_the_solve(rng):
    """``init`` resumes a solve: 12 sweeps then 18 == 30 sweeps (the sharded
    bursts rely on it)."""
    div = jnp.asarray(_field(rng, (48, 128)))
    p = ref.pressure_solve(div, 12)
    _close(ref.pressure_solve(div, 18, init=p), ref.pressure_solve(div, 30),
           atol=0, rtol=0)


@pytest.mark.parametrize("iters", [1, 5, 8, 30, 40])
def test_pressure_project_matches_oracle(rng, iters):
    """Divergence -> Jacobi -> projection as one op == the oracle's three."""
    shape = (64, 128)
    u, v = _field(rng, shape, 5.0), _field(rng, shape, 5.0)
    gu, gv, gp = ref.pressure_project(jnp.asarray(u), jnp.asarray(v), iters,
                                      True)
    p = oracle.pressure_solve(oracle.divergence(u, v, True), iters)
    eu, ev = oracle.project(u, v, p)
    _close_scaled(gp, p)
    _close_scaled(gu, eu)
    _close_scaled(gv, ev)


def test_pressure_project_tall_grid(rng):
    """A tall grid (many former strip seams) stays exact everywhere."""
    shape = (512, 128)
    u, v = _field(rng, shape, 5.0), _field(rng, shape, 5.0)
    gu, gv, _ = ref.pressure_project(jnp.asarray(u), jnp.asarray(v), 30, True)
    p = oracle.pressure_solve(oracle.divergence(u, v, True), 30)
    eu, ev = oracle.project(u, v, p)
    _close_scaled(gu, eu)
    _close_scaled(gv, ev)


# -- diffusion -------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("iters", [5, 20])
def test_diffuse_matches_oracle(rng, channels, iters):
    x = _field(rng, (channels, 64, 128))
    _close(ref.diffuse(jnp.asarray(x), DT, 0.8, iters),
           oracle.diffuse(x, DT, 0.8, iters), atol=1e-4)


def test_diffuse_2d_input(rng):
    x = _field(rng, (64, 128))
    _close(ref.diffuse(jnp.asarray(x), DT, 0.8, 5),
           oracle.diffuse(x, DT, 0.8, 5), atol=1e-4)


def test_zero_iters_are_identity_and_zero(rng):
    x = jnp.asarray(_field(rng, (2, 64, 128)))
    _close(ref.diffuse(x, DT, 0.8, 0), x, atol=0, rtol=0)
    _close(ref.pressure_solve(x[0], 0), np.zeros((64, 128), F), atol=0,
           rtol=0)


@pytest.mark.parametrize("shape", [(192, 256), (540, 960)])
def test_diffuse_multi_matches_oracle(rng, shape):
    """Per-channel coefficients (velocity and dye differ) == the oracle's
    per-group diffusion."""
    x = _field(rng, (5,) + shape)
    coeffs = [0.8, 0.8, 0.5, 0.5, 0.5]
    got = ref.diffuse_multi(jnp.asarray(x), DT, coeffs, 20)
    _close(got[:2], oracle.diffuse(x[:2], DT, 0.8, 20), atol=1e-4)
    _close(got[2:], oracle.diffuse(x[2:], DT, 0.5, 20), atol=1e-4)


def test_diffuse_preserves_constant_field():
    x = jnp.full((5, 64, 128), 0.37, jnp.float32)
    _close(ref.diffuse_multi(x, DT, [0.8] * 5, 20), x, atol=1e-6)


@pytest.mark.parametrize("iters", [0, 5, 20])
def test_diffuse_multi_splat_matches_oracle(rng, iters):
    """Diffusion + gpu splat as one op == the oracle's diffuse then splat."""
    h, w = 64, 128
    u, v = _field(rng, (h, w)), _field(rng, (h, w))
    dye = rng.random((3, h, w), dtype=F)
    cur = np.asarray([60.0, 30.0], F)
    last = np.asarray([64.0, 33.0], F)
    color = np.asarray(PALETTE[2], F)
    amps = np.concatenate([(last - cur) * F(5000.0) * F(DT), color])
    got = ref.diffuse_multi_splat(
        jnp.asarray(np.concatenate([np.stack([u, v]), dye])), DT, [0.8] * 5,
        iters, jnp.asarray(amps), jnp.asarray(last), 400.0)
    uv = oracle.diffuse(np.stack([u, v]), DT, 0.8, iters)
    dd = oracle.diffuse(dye, DT, 0.8, iters)
    eu, ev, edye = oracle.splat_gpu(uv[0], uv[1], dd, cur, last, DT, 5000.0,
                                    400.0, color)
    _close(got[0], eu, atol=1e-4)
    _close(got[1], ev, atol=1e-4)
    _close(got[2:], edye, atol=1e-4)


# -- single-pass stencils -----------------------------------------------------------


@pytest.mark.parametrize("variant", ["gpu", "cpu"])
@pytest.mark.parametrize("shape", [(64, 128), (512, 128)])
def test_vorticity_matches_oracle(rng, variant, shape):
    u, v = _field(rng, shape, 5.0), _field(rng, shape, 5.0)
    if variant == "gpu":
        got = ref.vorticity_confinement_gpu(jnp.asarray(u), jnp.asarray(v),
                                            DT, 50.0)
        exp = oracle.vorticity_gpu(u, v, DT, 50.0)
    else:
        got = ref.vorticity_confinement_cpu(jnp.asarray(u), jnp.asarray(v),
                                            DT, 0.35)
        exp = oracle.vorticity_cpu(u, v, DT, 0.35)
    _close(got[0], exp[0], atol=1e-4)
    _close(got[1], exp[1], atol=1e-4)


@pytest.mark.parametrize("shape", [(64, 128), (512, 128), (100, 200)])
def test_divergence_project_match_oracle(rng, shape):
    u, v = _field(rng, shape, 5.0), _field(rng, shape, 5.0)
    p = _field(rng, shape)
    _close(ref.divergence(jnp.asarray(u), jnp.asarray(v), True),
           oracle.divergence(u, v, True))
    gu, gv, st = ref.project(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p),
                             return_stats=True)
    eu, ev = oracle.project(u, v, p)
    _close(gu, eu)
    _close(gv, ev)
    _close(st, [np.max(np.abs(eu)), np.max(np.abs(ev))])


# -- multigrid smoother -------------------------------------------------------------


def _damped_oracle(p, rhs, sweeps, omega=0.8):
    s = oracle.shift
    for _ in range(sweeps):
        jac = F(0.25) * (s(p, 0, -1) + s(p, 0, 1) + s(p, -1, 0) + s(p, 1, 0)
                         + rhs)
        p = p + F(omega) * (jac - p)
    return p


@pytest.mark.parametrize("shape", [(64, 128), (48, 128), (60, 200)])
@pytest.mark.parametrize("sweeps", [1, 2, 4, 10])
def test_mg_smoother_matches_oracle(rng, shape, sweeps):
    """The V-cycle's damped-Jacobi smoother (make_vcycle's default scan)
    against a NumPy damped sweep; the bottom level runs exactly it."""
    p, rhs = _field(rng, shape), _field(rng, shape)
    got = multigrid._vcycle(jnp.asarray(p), jnp.asarray(rhs), 1, 2, 2, sweeps)
    _close(got, _damped_oracle(p, rhs, sweeps, multigrid._OMEGA), atol=1e-5)


# -- advection ----------------------------------------------------------------------


H, W = 64, 128


def test_zero_velocity_identity(rng):
    z = np.zeros((H, W), F)
    dye = rng.random((3, H, W), dtype=F)
    _close(ref.advect_dye(jnp.asarray(dye), jnp.asarray(z), jnp.asarray(z),
                          DT, 1.2),
           oracle.advect_dye(dye, z, z, DT, 1.2), atol=1e-6)


@pytest.mark.parametrize("scale", [5.0, 60.0, 200.0])
def test_velocity_advection_matches_oracle(rng, scale):
    u = np.clip(_field(rng, (H, W), scale), -6.9 / DT, 6.9 / DT)
    v = np.clip(_field(rng, (H, W), scale), -6.9 / DT, 6.9 / DT)
    gu, gv = ref.advect_velocity(jnp.asarray(u), jnp.asarray(v), DT, 1.2)
    eu, ev = oracle.advect_velocity(u, v, DT, 1.2)
    atol = max(1e-5, 3e-7 * scale)
    _close(gu, eu, atol=atol)
    _close(gv, ev, atol=atol)


def test_dye_advection_with_fade(rng):
    u, v = _field(rng, (H, W), 60.0), _field(rng, (H, W), 60.0)
    dye = rng.random((3, H, W), dtype=F)
    _close(ref.advect_dye(jnp.asarray(dye), jnp.asarray(u), jnp.asarray(v),
                          DT, 1.2),
           oracle.advect_dye(dye, u, v, DT, 1.2), atol=1e-5)


@pytest.mark.parametrize("u0,v0", [(120.0, 0.0), (1200.0, 0.0),
                                   (0.0, 1200.0), (-1200.0, -1200.0)])
def test_uniform_flow_backtraces_match_oracle(rng, u0, v0):
    """Edge clamping and 20-cell backtraces in each direction: the
    single-device step never bounds a backtrace, so it matches the
    unbounded oracle exactly."""
    u = np.full((H, W), u0, F)
    v = np.full((H, W), v0, F)
    dye = rng.random((3, H, W), dtype=F)
    _close(ref.advect_dye(jnp.asarray(dye), jnp.asarray(u), jnp.asarray(v),
                          DT, 1.2),
           oracle.advect_dye(dye, u, v, DT, 1.2), atol=1e-5)


@pytest.mark.parametrize("shape", [(100, 200), (540, 512), (64, 512)])
def test_odd_and_wide_grid_advection(rng, shape):
    u = np.clip(_field(rng, shape, 150.0), -800, 800)
    v = np.clip(_field(rng, shape, 150.0), -800, 800)
    dye = rng.random((3,) + shape, dtype=F)
    _close(ref.advect_dye(jnp.asarray(dye), jnp.asarray(u), jnp.asarray(v),
                          DT, 1.2),
           oracle.advect_dye(dye, u, v, DT, 1.2), atol=2e-5)


@pytest.mark.parametrize("shape,mode", [((64, 128), "dye"),
                                        ((64, 128), "field"),
                                        ((100, 200), "dye"),
                                        ((540, 960), "field")])
def test_quiet_flow_advection_matches_oracle(rng, shape, mode):
    """Sub-cell flows (|v| dt < 1), the interactive steady state."""
    u = np.clip(_field(rng, shape, 20.0), -0.9 / DT, 0.9 / DT)
    v = np.clip(_field(rng, shape, 20.0), -0.9 / DT, 0.9 / DT)
    if mode == "dye":
        dye = rng.random((3,) + shape, dtype=F)
        _close(ref.advect_dye(jnp.asarray(dye), jnp.asarray(u),
                              jnp.asarray(v), DT, 1.2),
               oracle.advect_dye(dye, u, v, DT, 1.2), atol=1e-5)
    else:
        gu, gv = ref.advect_velocity(jnp.asarray(u), jnp.asarray(v), DT, 1.2)
        eu, ev = oracle.advect_velocity(u, v, DT, 1.2)
        _close(gu, eu, atol=1e-5)
        _close(gv, ev, atol=1e-5)


# -- whole step ---------------------------------------------------------------------


@pytest.mark.parametrize("params", [
    dict(vorticity=50.0, force_scale=5000.0),  # the reference's own
    dict(vorticity=0.5, force_scale=500.0),    # mild, non-chaotic
])
def test_gpu_step_matches_oracle(params):
    """Driven gpu-parity steps == the oracle's step pipeline."""
    cfg = FluidConfig.gpu_reference(nx=128, ny=64, backend="ref", **params)
    sim = Simulation(cfg)
    steps = 4
    imp = orbit_impulse(steps, cfg.dt, center=(64.0, 32.0), radius=12.0,
                        omega=3.0)
    imp_np = [np.asarray(f) for f in imp]
    orc = oracle.OracleSim(cfg, PALETTE)
    state = sim.init()
    for i in range(steps):
        state = sim.step(state, slice_step(imp, i))
        orc.step(imp_np[0][i], imp_np[1][i], bool(imp_np[2][i]),
                 float(imp_np[3][i]))
    for got, exp in ((state.u, orc.u), (state.v, orc.v),
                     (state.dye, orc.dye)):
        _close_scaled(got, exp, rel=1e-4)
