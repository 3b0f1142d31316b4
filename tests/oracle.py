"""Independent NumPy oracle for the reference numerics.

A second, from-the-math implementation (float32 numpy) of every stage in
cpuFluidSim.cpp / GPUFluidSim.cu, used to golden-test the jnp/CUDA
backends.  Deliberately written with numpy fancy indexing rather than the
package's shift/concat style so the two implementations share no code.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def _clampi(i, n):
    return np.clip(i, 0, n - 1)


def shift(a, dy, dx):
    """a[clamp(y+dy), clamp(x+dx)] via index arrays."""
    h, w = a.shape[-2:]
    ys = _clampi(np.arange(h) + dy, h)
    xs = _clampi(np.arange(w) + dx, w)
    return a[..., ys[:, None], xs[None, :]]


def bilerp(field, px, py):
    h, w = field.shape[-2:]
    x1 = np.trunc(px).astype(F)
    y1 = np.trunc(py).astype(F)
    tx = (px - x1).astype(F)
    ty = (py - y1).astype(F)
    xi1 = _clampi(x1.astype(np.int64), w)
    xi2 = _clampi(x1.astype(np.int64) + 1, w)
    yi1 = _clampi(y1.astype(np.int64), h)
    yi2 = _clampi(y1.astype(np.int64) + 1, h)
    p00 = field[..., yi1, xi1]
    p01 = field[..., yi1, xi2]
    p10 = field[..., yi2, xi1]
    p11 = field[..., yi2, xi2]
    top = p00 * (F(1) - tx) + p01 * tx
    bot = p10 * (F(1) - tx) + p11 * tx
    return top * (F(1) - ty) + bot * ty


def _mesh(h, w):
    ys, xs = np.meshgrid(np.arange(h, dtype=F), np.arange(w, dtype=F), indexing="ij")
    return xs, ys


def advect_velocity(u, v, dt, decay_rate):
    decay = F(1) / (F(1) + F(decay_rate) * F(dt))
    xs, ys = _mesh(*u.shape)
    px = xs - F(dt) * u
    py = ys - F(dt) * v
    return bilerp(u, px, py) * decay, bilerp(v, px, py) * decay


def advect_dye(dye, u, v, dt, decay_rate):
    decay = F(1) / (F(1) + F(decay_rate) * F(dt))
    xs, ys = _mesh(*u.shape)
    px = xs - F(dt) * u
    py = ys - F(dt) * v
    c = bilerp(dye, px, py)
    with np.errstate(invalid="ignore"):
        # np.fmin mirrors C fminf: NaN (from pow of a negative extrapolated
        # sample) saturates to 1.0 instead of propagating.
        return np.fmin(F(1), np.power(c, F(1.005)) * decay)


def curl(u, v):
    return F(0.5) * (shift(v, 0, 1) - shift(v, 0, -1) - shift(u, 1, 0) + shift(u, -1, 0))


def vorticity_cpu(u, v, dt, vorticity):
    w = curl(u, v)
    ac = np.abs(w)
    fx = F(0.5) * (shift(ac, 1, 0) - shift(ac, -1, 0))
    fy = F(0.5) * (shift(ac, 0, 1) - shift(ac, 0, -1))
    ln = np.sqrt(fx * fx + fy * fy).astype(F) + F(1e-4)
    s = w * F(vorticity) / ln
    return u - fx * s * F(dt), v - fy * s * F(dt)


def vorticity_gpu(u, v, dt, vorticity):
    w = curl(u, v)
    fx = F(0.5) * (np.abs(shift(w, 1, 0)) - np.abs(shift(w, -1, 0)))
    fy = F(0.5) * (np.abs(shift(w, 0, -1)) - np.abs(shift(w, 0, 1)))
    ln = np.sqrt(fx * fx + fy * fy).astype(F) + F(1e-3)
    s = w * F(vorticity) / ln
    return u + fx * s * F(dt), v + fy * s * F(dt)


def diffuse(fields, dt, k, iters):
    alpha = F(k) * F(k) / F(dt)
    inv_beta = F(1) / (F(4) + alpha)
    x = fields
    for _ in range(iters):
        x = (
            shift(x, 0, -1) + shift(x, 0, 1) + shift(x, -1, 0) + shift(x, 1, 0)
            + x * alpha
        ) * inv_beta
    return x


def divergence(u, v, half):
    d = (shift(u, 0, 1) - shift(u, 0, -1)) + (shift(v, 1, 0) - shift(v, -1, 0))
    return F(0.5) * d if half else d


def pressure_solve(div, iters):
    p = np.zeros_like(div)
    for _ in range(iters):
        p = (
            shift(p, 0, -1) + shift(p, 0, 1) + shift(p, -1, 0) + shift(p, 1, 0) - div
        ) * F(0.25)
    return p


def project(u, v, p):
    u2 = u - F(0.5) * (shift(p, 0, 1) - shift(p, 0, -1))
    v2 = v - F(0.5) * (shift(p, 1, 0) - shift(p, -1, 0))
    return u2, v2


def splat_cpu(u, v, dye, cur, last, dt, force_scale, radius, color):
    xs, ys = _mesh(*u.shape)
    eu = np.exp(-((xs - F(last[0])) ** 2 + (ys - F(last[1])) ** 2) / F(radius))
    u2 = u + (F(last[0]) - F(cur[0])) * F(dt) * F(force_scale) * eu
    v2 = v + (F(last[1]) - F(cur[1])) * F(dt) * F(force_scale) * eu
    ec = np.exp(-((xs - F(cur[0])) ** 2 + (ys - F(cur[1])) ** 2) / F(radius))
    dye2 = dye + np.asarray(color, F)[:, None, None] * ec[None]
    return u2.astype(F), v2.astype(F), dye2.astype(F)


def splat_gpu(u, v, dye, cur, last, dt, force_scale, radius, color):
    xs, ys = _mesh(*u.shape)
    e = np.exp(-((xs - F(last[0])) ** 2 + (ys - F(last[1])) ** 2) / F(radius))
    u2 = u + (F(last[0]) - F(cur[0])) * F(force_scale) * F(dt) * e
    v2 = v + (F(last[1]) - F(cur[1])) * F(force_scale) * F(dt) * e
    dye2 = dye + np.asarray(color, F)[:, None, None] * e[None]
    return u2.astype(F), v2.astype(F), dye2.astype(F)


def cycle_color(palette, press_time):
    n = len(palette)
    it = int(np.floor(press_time))
    frac = F(press_time) - F(it)
    c0 = np.asarray(palette[it % n], F)
    c1 = np.asarray(palette[(it + 1) % n], F)
    return c0 * (F(1) - frac) + c1 * frac


def boundary_strip(u, v, dye, rows):
    u = u.copy()
    v = v.copy()
    dye = dye.copy()
    u[:rows] = 0
    v[:rows] = 0
    dye[:, :rows] = 0
    return u, v, dye


def pack_rgba(dye):
    c = np.clip(F(255) * dye, 0, 255).astype(np.uint8)
    a = np.full((1,) + dye.shape[1:], 255, np.uint8)
    return np.concatenate([c, a], axis=0)


def apply_bloom(rgba, pos, intense, radius):
    xs, ys = _mesh(*rgba.shape[-2:])
    d2 = (xs - F(pos[0])) ** 2 + (ys - F(pos[1])) ** 2
    e = F(intense) * np.exp(-(d2 + F(1)) / (F(radius) * F(radius)))
    rgb = rgba[:3].astype(F)
    mx = rgb.max(axis=0)
    rgb = np.minimum(F(255), rgb + mx[None] * e[None])
    return np.concatenate([rgb.astype(np.uint8), rgba[3:]], axis=0)


# ---------------------------------------------------------------------------
# Full step oracle
# ---------------------------------------------------------------------------


class OracleSim:
    """Stateful numpy mirror of the full step pipeline for a FluidConfig."""

    def __init__(self, config, palette):
        self.cfg = config
        self.palette = np.asarray(palette, F)
        h, w = config.shape
        self.u = np.zeros((h, w), F)
        self.v = np.zeros((h, w), F)
        self.dye = np.zeros((3, h, w), F)
        self.pressure = np.zeros((h, w), F)
        self.press_time = F(0)
        self.mouse = np.zeros(2, F)

    def step(self, pos, last_pos, pressed, dt):
        cfg = self.cfg
        cpu = cfg.variant == "cpu"
        u, v, dye = self.u, self.v, self.dye
        u, v = advect_velocity(u, v, dt, cfg.decay_rate)
        dye = advect_dye(dye, u, v, dt, cfg.decay_rate)
        if cpu:
            u, v = vorticity_cpu(u, v, dt, cfg.vorticity)
        else:
            u, v = vorticity_gpu(u, v, dt, cfg.vorticity)
        uv = diffuse(np.stack([u, v]), dt, cfg.velocity_diffusion, cfg.diffusion_iters)
        u, v = uv[0], uv[1]
        if cfg.color_diffusion_enabled:
            dye = diffuse(dye, dt, cfg.color_diffusion, cfg.diffusion_iters)
        if pressed:
            self.press_time = F(self.press_time + F(dt))
            color = cycle_color(self.palette, self.press_time)
            last = self.mouse if cpu else np.asarray(last_pos, F)
            splat = splat_cpu if cpu else splat_gpu
            u, v, dye = splat(
                u, v, dye, np.asarray(pos, F), last, dt, cfg.force_scale,
                cfg.splat_radius, color,
            )
            self.mouse = np.asarray(pos, F)
        div = divergence(u, v, cfg.half_divergence)
        p = pressure_solve(div, cfg.pressure_iters)
        u, v = project(u, v, p)
        if cfg.boundary_rows > 0:
            u, v, dye = boundary_strip(u, v, dye, cfg.boundary_rows)
        self.u, self.v, self.dye, self.pressure = u, v, dye, p
