"""Pure-jnp reference ops — the numerics oracle.

This backend plays the role the reference's CPU module plays for its CUDA
module (the de-facto oracle, SURVEY.md §4): every op here is a direct, pure
functional statement of the math in cpuFluidSim.cpp / GPUFluidSim.cu, cited
per function.  The CUDA backend (ops/jacobi_cuda.py) is validated against
these ops, and these against the NumPy oracle in tests/oracle.py.

Conventions: fields are float32 (H, W) planes (dye is (3, H, W)); index order
is [y, x]; y increases upward (the reference flips window y before it reaches
the sim, Main.cpp:155 / cpuFluidSim.cpp:301); all out-of-domain neighbor
accesses clamp (edge replication).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from cudafluidsimulation_tpu.ops.stencil import neighbors

Array = jnp.ndarray


# ---------------------------------------------------------------------------
# Bilinear sampling + semi-Lagrangian advection
# ---------------------------------------------------------------------------


def _gather2d(field: Array, yi: Array, xi: Array) -> Array:
    """field[..., yi, xi] for integer index grids yi/xi of shape (H, W)."""
    h, w = field.shape[-2], field.shape[-1]
    flat = field.reshape(field.shape[:-2] + (h * w,))
    idx = (yi * w + xi).reshape(-1)
    out = jnp.take(flat, idx, axis=-1)
    return out.reshape(field.shape[:-2] + yi.shape)


def bilerp(field: Array, px: Array, py: Array) -> Array:
    """Clamped 4-tap bilinear sample of ``field`` at positions (px, py).

    Replicates the reference's interpolate() exactly (cpuFluidSim.cpp:110-155,
    GPUFluidSim.cu:205-255): the cell corner is ``(int)p`` — C truncation
    toward zero, NOT floor — so for negative coordinates the weights
    extrapolate (tx < 0) while the taps clamp to the edge.
    """
    h, w = field.shape[-2], field.shape[-1]
    x1 = jnp.trunc(px)
    y1 = jnp.trunc(py)
    tx = px - x1
    ty = py - y1

    xi1 = jnp.clip(x1, 0, w - 1).astype(jnp.int32)
    xi2 = jnp.clip(x1 + 1, 0, w - 1).astype(jnp.int32)
    yi1 = jnp.clip(y1, 0, h - 1).astype(jnp.int32)
    yi2 = jnp.clip(y1 + 1, 0, h - 1).astype(jnp.int32)

    p00 = _gather2d(field, yi1, xi1)
    p01 = _gather2d(field, yi1, xi2)
    p10 = _gather2d(field, yi2, xi1)
    p11 = _gather2d(field, yi2, xi2)

    top = p00 * (1.0 - tx) + p01 * tx
    bot = p10 * (1.0 - tx) + p11 * tx
    return top * (1.0 - ty) + bot * ty


def _backtrace(u: Array, v: Array, dt) -> Tuple[Array, Array]:
    """Departure points pos = (x, y) - dt * vel (cpuFluidSim.cpp:161,
    GPUFluidSim.cu:267)."""
    h, w = u.shape
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    return xs - dt * u, ys - dt * v


def vel_max(u: Array, v: Array) -> Array:
    """(2,) velocity magnitude stats [max|u|, max|v|] — the quantity the
    clamp-observability warning needs (realized backtrace displacement =
    stats * dt).  The projection returns it about its OUTPUT velocity, so
    XLA fuses the reduction into the producing elementwise pass."""
    return jnp.stack([jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v))])


def advect_velocity(u: Array, v: Array, dt, decay_rate):
    """Semi-Lagrangian self-advection with exponential decay
    1/(1 + rate*dt) (cpuFluidSim.cpp:172-179, GPUFluidSim.cu:258-272)."""
    decay = 1.0 / (1.0 + decay_rate * dt)
    px, py = _backtrace(u, v, dt)
    u2 = bilerp(u, px, py) * decay
    v2 = bilerp(v, px, py) * decay
    return u2, v2


def advect_dye(dye: Array, u: Array, v: Array, dt, decay_rate) -> Array:
    """Dye advection with the reference's gamma-ish fade:
    c = min(1, c^1.005 * decay) per channel (cpuFluidSim.cpp:158-169,
    GPUFluidSim.cu:275-294).  Both reference backends advect dye with the
    *already advected* velocity (cpuFluidSim.cpp:340-341 swap order;
    GPUFluidSim.cu:620-622), so callers pass post-advection (u, v)."""
    decay = 1.0 / (1.0 + decay_rate * dt)
    px, py = _backtrace(u, v, dt)
    c = bilerp(dye, px, py)
    # fmin, not minimum: C fminf(1.0f, x) returns 1.0 when x is NaN (edge
    # extrapolation can make c slightly negative -> pow NaN), so the reference
    # saturates those cells to 1.0 rather than propagating NaN.
    c = jnp.fmin(1.0, jnp.power(c, 1.005) * decay)
    return c


# ---------------------------------------------------------------------------
# Vorticity confinement
# ---------------------------------------------------------------------------


def curl(u: Array, v: Array) -> Array:
    """0.5 * (vR - vL - uT + uB), clamped edges (cpuFluidSim.cpp:261-268,
    GPUFluidSim.cu:544-549 — same formula)."""
    vl, vr, _, _ = neighbors(v)
    _, _, ub, ut = neighbors(u)
    return 0.5 * (vr - vl - ut + ub)


def vorticity_confinement_cpu(u, v, dt, vorticity):
    """CPU-path confinement (cpuFluidSim.cpp:271-296): gradient of |curl|,
    direction (acT - acB, acR - acL), normalized by (len+1e-4), scaled by
    curl * vorticity, then NEGATED (:290)."""
    w = curl(u, v)
    ac = jnp.abs(w)
    al, ar, ab, at = neighbors(ac)
    fx = 0.5 * (at - ab)
    fy = 0.5 * (ar - al)
    # NOTE: reference computes length of the *halved* direction then divides
    # the halved direction by (len + 1e-4) — replicate that order exactly.
    ln = jnp.sqrt(fx * fx + fy * fy) + 1e-4
    s = w * vorticity / ln
    fx = -fx * s
    fy = -fy * s
    return u + fx * dt, v + fy * dt


def vorticity_confinement_gpu(u, v, dt, vorticity):
    """GPU-path confinement (GPUFluidSim.cu:536-573): signed curl field, force
    ((|wT|-|wB|), (|wL|-|wR|)) * 0.5, normalized by (len + 1e-3), scaled by
    curl * vorticity, NOT negated.

    The CUDA kernel reads neighbor curl values through a grid-wide race
    (`__syncthreads` only syncs a block, :551); we compute the clean
    sequential semantics: full curl field first, then the confinement force.
    """
    w = curl(u, v)
    wl, wr, wb, wt = neighbors(w)
    fx = 0.5 * (jnp.abs(wt) - jnp.abs(wb))
    fy = 0.5 * (jnp.abs(wl) - jnp.abs(wr))
    ln = jnp.sqrt(fx * fx + fy * fy) + 1e-3
    s = w * vorticity / ln
    fx = fx * s
    fy = fy * s
    return u + fx * dt, v + fy * dt


# ---------------------------------------------------------------------------
# Jacobi diffusion
# ---------------------------------------------------------------------------


def diffuse(fields: Array, dt, diffusion, iters: int) -> Array:
    """``iters`` global Jacobi sweeps of (L + R + B + T + alpha*C) / beta with
    alpha = diffusion²/dt, beta = 4 + alpha (cpuFluidSim.cpp:182-233).

    ``fields`` is (..., H, W) — velocity as (2, H, W), dye as (3, H, W).
    The CUDA version iterates block-locally on stale halos
    (GPUFluidSim.cu:316-429); we implement the operator it approximates.
    """
    alpha = diffusion * diffusion / dt
    inv_beta = 1.0 / (4.0 + alpha)

    def sweep(x, _):
        l, r, b, t = neighbors(x)
        return (l + r + b + t + x * alpha) * inv_beta, None

    out, _ = jax.lax.scan(sweep, fields, None, length=iters)
    return out


def diffuse_multi(fields: Array, dt, coeffs, iters: int) -> Array:
    """Jacobi diffusion of (C, H, W) fields with a per-channel coefficient —
    lets velocity (2ch) and dye (3ch) diffuse in ONE fused pass even when
    their coefficients differ (vDiffusion vs cDiffusion, GPUFluidSim.cu:52,55).
    """
    coeffs = jnp.asarray(coeffs, jnp.float32)
    alpha = (coeffs * coeffs / dt)[:, None, None]
    inv_beta = 1.0 / (4.0 + alpha)

    def sweep(x, _):
        l, r, b, t = neighbors(x)
        return (l + r + b + t + x * alpha) * inv_beta, None

    out, _ = jax.lax.scan(sweep, fields, None, length=iters)
    return out


def splat_tail(fields: Array, amps, last, radius, xs, ys) -> Array:
    """The gpu-variant splat as a per-channel-amplitude Gaussian add over
    explicit coordinate grids: fields[c] += amps[c] * exp(-d2(last)/radius).

    Algebraically identical to splat_gpu (GPUFluidSim.cu:519-532) with
    amps = [(last-cur)*force*dt (x, y), color (r, g, b)] — the caller folds
    the scalar products in splat_gpu's exact association order."""
    d2 = (xs - last[0]) ** 2 + (ys - last[1]) ** 2
    e = jnp.exp(-d2 / radius)
    return fields + jnp.asarray(amps, jnp.float32)[:, None, None] * e[None]


def diffuse_multi_splat(fields: Array, dt, coeffs, iters: int,
                        amps, last, radius) -> Array:
    """Per-channel diffusion followed by the gpu-variant splat, as one op
    (GPUFluidSim.cu runs diffuse :636-639 then applyForce :663 as separate
    kernels; the composition here is the same math in the same order)."""
    f = diffuse_multi(fields, dt, coeffs, iters)
    xs, ys = coord_grids(fields.shape[-2], fields.shape[-1])
    return splat_tail(f, amps, last, radius, xs, ys)


# ---------------------------------------------------------------------------
# Pressure: divergence -> Jacobi solve -> gradient subtraction
# ---------------------------------------------------------------------------


def divergence(u: Array, v: Array, half: bool) -> Array:
    """Central-difference divergence, clamped edges.  The GPU path scales by
    0.5 (GPUFluidSim.cu:297-310); the CPU path does not (cpuFluidSim.cpp:240-243).
    """
    ul, ur, _, _ = neighbors(u)
    _, _, vb, vt = neighbors(v)
    d = (ur - ul) + (vt - vb)
    return 0.5 * d if half else d


def pressure_solve(div: Array, iters: int, init=None) -> Array:
    """``iters`` Jacobi sweeps of p = 0.25*(pL + pR + pB + pT - div) starting
    from p = 0 — both reference paths zero pressure every frame
    (cpuFluidSim.cpp:238-245; GPUFluidSim.cu:685 memset after project).
    ``init`` starts from another iterate (the sharded paths continue a
    solve burst by burst)."""

    def sweep(p, _):
        l, r, b, t = neighbors(p)
        return (l + r + b + t - div) * 0.25, None

    p0 = jnp.zeros_like(div) if init is None else init
    p, _ = jax.lax.scan(sweep, p0, None, length=iters)
    return p


def pressure_solve_mg(div: Array, cycles: int = 2, tol: float = 0.0,
                      max_cycles: int = 8) -> Array:
    """Multigrid pressure solve (beyond-parity fast mode; ops/multigrid.py).
    ``tol > 0`` runs cycles until rms(A p + div) < tol instead of a fixed
    count (cap ``max_cycles``)."""
    from cudafluidsimulation_tpu.ops.multigrid import pressure_solve_mg as mg

    return mg(div, cycles=cycles, tol=tol, max_cycles=max_cycles)


def project(u: Array, v: Array, p: Array, *, return_stats: bool = False):
    """u -= 0.5*(pR - pL), v -= 0.5*(pT - pB), clamped edges
    (cpuFluidSim.cpp:374-377, GPUFluidSim.cu:498-516)."""
    pl, pr, pb, pt = neighbors(p)
    u2, v2 = u - 0.5 * (pr - pl), v - 0.5 * (pt - pb)
    if return_stats:
        return u2, v2, vel_max(u2, v2)
    return u2, v2


def pressure_project(u: Array, v: Array, iters: int, half: bool, *,
                     return_stats: bool = False):
    """The whole projection step — divergence, ``iters``-sweep Jacobi from
    p=0, gradient subtraction — as one op returning (u', v', p).

    The reference launches these as three separate kernels
    (GPUFluidSim.cu:676-685); exposing them as one op lets the sharded
    paths fold the divergence and projection halo exchanges into the
    pressure bursts'.  This jnp form is the exactness oracle for that
    folding."""
    d = divergence(u, v, half)
    p = pressure_solve(d, iters)
    if return_stats:
        u2, v2, st = project(u, v, p, return_stats=True)
        return u2, v2, p, st
    u2, v2 = project(u, v, p)
    return u2, v2, p


# ---------------------------------------------------------------------------
# Impulse splat (force + dye)
# ---------------------------------------------------------------------------


def coord_grids(h, w, y0=0):
    """(xs, ys) float32 cell-coordinate grids; ``y0`` offsets rows for
    shard-local views of a row-sharded global field."""
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + y0
    return xs, ys


def splat_core(u, v, dye, cur, last, dt, force_scale, radius, color,
               xs, ys, kind: str):
    """Shared splat numerics over explicit coordinate grids (single source
    of truth for single-chip AND sharded paths).

    cpu kind (cpuFluidSim.cpp:299-324): force Gaussian centered at the
    *previous* position, dye Gaussian at the current one, force =
    (last - cur) * dt * scale.  (Yes, (last - cur): the reference pushes
    fluid *opposite* to the drag direction — replicated as-is.)

    gpu kind (GPUFluidSim.cu:519-532, host setup :656-663): one Gaussian at
    the *last* position (x2pos in the kernel call is lastXPos, Main.cpp:155),
    F = (last - cur) * force_scale, u += F*dt*e, dye += color*e.
    """
    d2u = (xs - last[0]) ** 2 + (ys - last[1]) ** 2
    eu = jnp.exp(-d2u / radius)
    if kind == "cpu":
        # preserve the reference's f32 evaluation order exactly per variant
        u2 = u + (last[0] - cur[0]) * dt * force_scale * eu
        v2 = v + (last[1] - cur[1]) * dt * force_scale * eu
        d2c = (xs - cur[0]) ** 2 + (ys - cur[1]) ** 2
        ec = jnp.exp(-d2c / radius)
    else:
        u2 = u + (last[0] - cur[0]) * force_scale * dt * eu
        v2 = v + (last[1] - cur[1]) * force_scale * dt * eu
        ec = eu
    dye2 = dye + color[:, None, None] * ec[None]
    return u2, v2, dye2


def splat_cpu(u, v, dye, cur, last, dt, force_scale, radius, color):
    xs, ys = coord_grids(*u.shape)
    return splat_core(u, v, dye, cur, last, dt, force_scale, radius, color,
                      xs, ys, "cpu")


def splat_gpu(u, v, dye, cur, last, dt, force_scale, radius, color):
    xs, ys = coord_grids(*u.shape)
    return splat_core(u, v, dye, cur, last, dt, force_scale, radius, color,
                      xs, ys, "gpu")


def cycle_color(palette: Array, press_time) -> Array:
    """Dye color cycling through the 7-entry palette by accumulated pressed
    time (cpuFluidSim.cpp:307-311, GPUFluidSim.cu:649-654): lerp between
    palette[int(t) % 7] and palette[(int(t)+1) % 7] with the fractional part."""
    n = palette.shape[0]
    it = jnp.floor(press_time)
    frac = press_time - it
    i0 = jnp.mod(it.astype(jnp.int32), n)
    i1 = jnp.mod(it.astype(jnp.int32) + 1, n)
    return palette[i0] * (1.0 - frac) + palette[i1] * frac


# ---------------------------------------------------------------------------
# Boundary + rendering
# ---------------------------------------------------------------------------


def boundary_strip_core(u, v, dye, rows: int, ys_i):
    """Zero global rows [0, rows) given int row coordinates ``ys_i``
    (shape (h, 1) locally or (hl, w) for a row-sharded view)."""
    mask = (ys_i >= rows).astype(u.dtype)
    return u * mask, v * mask, dye * mask[None]


def boundary_strip(u, v, dye, rows: int):
    """Zero the bottom ``rows`` rows of velocity and dye — the CPU path's
    y = 0..10 strip (cpuFluidSim.cpp:387-394)."""
    if rows <= 0:
        return u, v, dye
    h = u.shape[0]
    ys_i = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)
    return boundary_strip_core(u, v, dye, rows, ys_i)


def pack_rgba(dye: Array) -> Array:
    """float RGB dye -> uint8 RGBA, min(255, 255*c), alpha 255
    (cpuFluidSim.cpp:396-402, GPUFluidSim.cu:432-442).  Negative dye is
    clamped to 0 here (the reference's unsigned-char cast of a negative float
    is UB); dye is non-negative in practice."""
    c = jnp.clip(255.0 * dye, 0.0, 255.0).astype(jnp.uint8)
    h, w = dye.shape[-2], dye.shape[-1]
    alpha = jnp.full((1, h, w), 255, jnp.uint8)
    return jnp.concatenate([c, alpha], axis=0)


def bloom_core(rgba: Array, pos, intense, radius, xs, ys) -> Array:
    """Bloom numerics over explicit coordinate grids (shared by single-chip
    and sharded paths): adds max(R,G,B) * intense * exp(-(r² + 1)/radius²)
    near ``pos``, clamped to 255 (GPUFluidSim.cu:576-591)."""
    d2 = (xs - pos[0]) ** 2 + (ys - pos[1]) ** 2
    e = intense * jnp.exp(-(d2 + 1.0) / (radius * radius))
    rgb = rgba[:3].astype(jnp.float32)
    mx = jnp.max(rgb, axis=0)
    rgb = jnp.minimum(255.0, rgb + mx[None] * e[None])
    return jnp.concatenate([rgb.astype(jnp.uint8), rgba[3:]], axis=0)

def apply_bloom(rgba: Array, pos, intense, radius) -> Array:
    """Single-chip bloom (see bloom_core)."""
    h, w = rgba.shape[-2], rgba.shape[-1]
    xs, ys = coord_grids(h, w)
    return bloom_core(rgba, pos, intense, radius, xs, ys)


def render_frame_core(dye: Array, pos, intense, radius, active,
                      xs, ys) -> Array:
    """pack_rgba + conditional bloom in ONE fused elementwise pass, bit-exact
    to ``where(active, apply_bloom(pack_rgba(dye), ...), pack_rgba(dye))``.

    The composed form makes three device-memory round trips over the RGBA
    frame (pack write, bloom read+write, select read+read+write).  Here the
    uint8
    quantization is emulated in f32 (``floor`` of the clipped value — the
    uint8 cast truncates, and every value in [0, 255] is exact in f32), so
    the bloom reads the same quantized values the reference's uchar4 kernel
    reads (GPUFluidSim.cu:432-442, 576-591) while the whole render stays one
    XLA fusion: read dye, write frame.  ``active`` (bool/0-1 scalar) gates
    the bloom term multiplicatively: e == 0 reproduces pack_rgba exactly.
    """
    cq = jnp.floor(jnp.clip(255.0 * dye, 0.0, 255.0))  # u8 values, in f32
    d2 = (xs - pos[0]) ** 2 + (ys - pos[1]) ** 2
    act = jnp.asarray(active).astype(jnp.float32)
    e = act * intense * jnp.exp(-(d2 + 1.0) / (radius * radius))
    mx = jnp.max(cq, axis=0)
    rgb = jnp.minimum(255.0, cq + mx[None] * e[None]).astype(jnp.uint8)
    h, w = dye.shape[-2], dye.shape[-1]
    alpha = jnp.full((1, h, w), 255, jnp.uint8)
    return jnp.concatenate([rgb, alpha], axis=0)


def render_frame(dye: Array, pos, intense, radius, active) -> Array:
    """Single-chip fused render (see render_frame_core)."""
    h, w = dye.shape[-2], dye.shape[-1]
    xs, ys = coord_grids(h, w)
    return render_frame_core(dye, pos, intense, radius, active, xs, ys)
