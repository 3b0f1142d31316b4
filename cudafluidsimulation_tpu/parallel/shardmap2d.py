"""2-D spatial mesh: the grid sharded over (rows x cols).

The rows-only path (parallel.shardmap_step) stops scaling when a grid runs
out of rows to split; this module shards BOTH axes over a ("rows", "cols")
``jax.sharding.Mesh`` (SURVEY.md §5's "2D jax.sharding.Mesh over the
grid").  The mesh shape follows the algorithm alone: a 2x2 mesh halves each
shard's halo perimeter against 4x1 rows, and every device reaches every
other at the same rate (four GPUs joined all to all by NVLink).  Every
neighbor access is an explicit :func:`~.halo.exchange_2d` (rows, then
columns of the row-padded array, so corners ride along — a k-sweep 5-point
stencil's dependence is the L1 ball), boundary conditions apply only on true
domain edges, and the Jacobi bursts run on the halo-padded local views
through the single-device op namespace (the CUDA kernel on a GPU).

Reference anchor: the reference is single-GPU (SURVEY.md §2, no NCCL/MPI);
this is a beyond-parity subsystem.  Advection taps clamp to the exchanged
halo in BOTH axes here (``max_displacement`` cells), unlike the rows-only
path where x stays unbounded.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.ops import ref
from cudafluidsimulation_tpu.ops.backend import get_ops
from cudafluidsimulation_tpu.parallel.halo import exchange_2d
from cudafluidsimulation_tpu.parallel.shardmap_step import BURST
from cudafluidsimulation_tpu.state import FluidState
from cudafluidsimulation_tpu.utils.impulse import Impulse


def make_mesh2d(rows: int, cols: int, devices=None) -> Mesh:
    """A (rows, cols) spatial device mesh."""
    import numpy as np

    devs = devices if devices is not None else jax.devices()
    n = rows * cols
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]).reshape(rows, cols), ("rows", "cols"))


def _neighbors_2d(ap):
    """(left, right, below, above) for the core of a 1-deep exchange_2d
    padded array (both stencil arms come from the halo)."""
    left = ap[..., 1:-1, :-2]
    right = ap[..., 1:-1, 2:]
    below = ap[..., :-2, 1:-1]
    above = ap[..., 2:, 1:-1]
    return left, right, below, above


def sharded_ops_2d(row_axis: str, col_axis: str, h_global: int, w_global: int,
                   d: int, local=ref,
                   burst: int = BURST) -> types.SimpleNamespace:
    """Shard-local op API for a (rows x cols) spatial mesh (consumed by
    models.pipelines.make_step, like parallel.shardmap_step.sharded_ops,
    whose ``local``/``burst`` it shares)."""
    ns = types.SimpleNamespace()

    def _bases(shape):
        hl, wl = shape[-2], shape[-1]
        return lax.axis_index(row_axis) * hl, lax.axis_index(col_axis) * wl

    def _global_grids(shape):
        hl, wl = shape[-2], shape[-1]
        r0, c0 = _bases(shape)
        ys_i = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 0) + r0
        xs_i = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 1) + c0
        return ys_i.astype(jnp.float32), ys_i, xs_i.astype(jnp.float32), xs_i

    def _x2d(a, width, edge="clamp"):
        return exchange_2d(a, width, row_axis, col_axis, edge)

    # -- advection ------------------------------------------------------------

    def _bilerp_2d(field, u, v, dt):
        """Backtrace + bilerp with taps clamped to the d-deep 2-D halo."""
        return _bilerp_2d_padded(_x2d(field, d), u, v, dt)

    def _bilerp_2d_padded(fp, u, v, dt):
        """_bilerp_2d on an ALREADY d-deep-exchanged field (lets one
        exchange serve several advections)."""
        hl, wl = u.shape
        ys_f, ys_i, xs_f, xs_i = _global_grids((hl, wl))
        px = xs_f - dt * u
        py = ys_f - dt * v
        x1 = jnp.trunc(px)
        y1 = jnp.trunc(py)
        tx = px - x1
        ty = py - y1
        cx1 = jnp.clip(x1, 0, w_global - 1).astype(jnp.int32)
        cx2 = jnp.clip(x1 + 1.0, 0, w_global - 1).astype(jnp.int32)
        cy1 = jnp.clip(y1, 0, h_global - 1).astype(jnp.int32)
        cy2 = jnp.clip(y1 + 1.0, 0, h_global - 1).astype(jnp.int32)
        ly = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 0)
        lx = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 1)
        ry1 = jnp.clip(cy1 - ys_i, -d, d) + ly + d
        ry2 = jnp.clip(cy2 - ys_i, -d, d) + ly + d
        rx1 = jnp.clip(cx1 - xs_i, -d, d) + lx + d
        rx2 = jnp.clip(cx2 - xs_i, -d, d) + lx + d
        p00 = ref._gather2d(fp, ry1, rx1)
        p01 = ref._gather2d(fp, ry1, rx2)
        p10 = ref._gather2d(fp, ry2, rx1)
        p11 = ref._gather2d(fp, ry2, rx2)
        top = p00 * (1.0 - tx) + p01 * tx
        bot = p10 * (1.0 - tx) + p11 * tx
        return top * (1.0 - ty) + bot * ty

    def _vmax_repl(u2, v2):
        """Replicated ops.ref.vel_max over BOTH mesh axes (see
        shardmap_step._vmax_repl)."""
        st = jnp.stack([jnp.max(jnp.abs(u2)), jnp.max(jnp.abs(v2))])
        return lax.pmax(lax.pmax(st, row_axis), col_axis)

    def advect_velocity(u, v, dt, decay_rate):
        decay = 1.0 / (1.0 + decay_rate * dt)
        uv = _bilerp_2d(jnp.stack([u, v]), u, v, dt) * decay
        return uv[0], uv[1]

    def advect_dye(dye, u, v, dt, decay_rate):
        decay = 1.0 / (1.0 + decay_rate * dt)
        c = _bilerp_2d(dye, u, v, dt)
        return jnp.fmin(1.0, jnp.power(c, 1.005) * decay)

    def advect_both(u, v, dye, dt, decay_rate):
        """Velocity + dye advection off ONE d-deep exchange_2d of the
        stacked 5-channel halo (see shardmap_step.advect_both: both
        advections tap PRE-advection data, and the dye backtrace's NEW
        velocity taps stay inside the same halo)."""
        allp = _x2d(jnp.concatenate([jnp.stack([u, v]), dye]), d)
        decay = 1.0 / (1.0 + decay_rate * dt)
        uv = _bilerp_2d_padded(allp[:2], u, v, dt) * decay
        u2, v2 = uv[0], uv[1]
        c = _bilerp_2d_padded(allp[2:], u2, v2, dt)
        dye2 = jnp.fmin(1.0, jnp.power(c, 1.005) * decay)
        return u2, v2, dye2

    # -- stencil stages ---------------------------------------------------------

    def curl(u, v):
        uvp = _x2d(jnp.stack([u, v]), 1)
        l, r, b, t = _neighbors_2d(uvp)
        return 0.5 * (r[1] - l[1] - t[0] + b[0])

    def _curl_padded(u, v):
        """Curl with a 1-deep valid halo (both axes, corners included) from
        ONE 2-deep exchange_2d of the velocity stack — halves the vorticity
        stage's exchange pairs (see shardmap_step._curl_padded).  Physical
        edges replicate the edge curl row/column, rows first then columns of
        the row-fixed array, exactly matching exchange_2d(curl, 1, clamp)."""
        uvp = _x2d(jnp.stack([u, v]), 2)
        we = 0.5 * (uvp[1][1:-1, 2:] - uvp[1][1:-1, :-2]
                    - uvp[0][2:, 1:-1] + uvp[0][:-2, 1:-1])
        nr, nc = lax.axis_size(row_axis), lax.axis_size(col_axis)
        ri, ci = lax.axis_index(row_axis), lax.axis_index(col_axis)
        low = jnp.where(ri == 0, we[1:2], we[:1])
        high = jnp.where(ri == nr - 1, we[-2:-1], we[-1:])
        w2 = jnp.concatenate([low, we[1:-1], high], axis=0)
        lft = jnp.where(ci == 0, w2[:, 1:2], w2[:, :1])
        rgt = jnp.where(ci == nc - 1, w2[:, -2:-1], w2[:, -1:])
        return jnp.concatenate([lft, w2[:, 1:-1], rgt], axis=1)

    def vorticity_confinement_cpu(u, v, dt, vorticity):
        wp = _curl_padded(u, v)
        w = wp[1:-1, 1:-1]
        al, ar, ab, at = _neighbors_2d(jnp.abs(wp))
        fx = 0.5 * (at - ab)
        fy = 0.5 * (ar - al)
        ln = jnp.sqrt(fx * fx + fy * fy) + 1e-4
        s = w * vorticity / ln
        return u - fx * s * dt, v - fy * s * dt

    def vorticity_confinement_gpu(u, v, dt, vorticity):
        wp = _curl_padded(u, v)
        w = wp[1:-1, 1:-1]
        wl, wr, wb, wt = _neighbors_2d(wp)
        fx = 0.5 * (jnp.abs(wt) - jnp.abs(wb))
        fy = 0.5 * (jnp.abs(wl) - jnp.abs(wr))
        ln = jnp.sqrt(fx * fx + fy * fy) + 1e-3
        s = w * vorticity / ln
        return u + fx * s * dt, v + fy * s * dt

    def _bursts(fields, run_burst, iters, rhs=None):
        """k local sweeps per 2-D (corner-carrying) halo exchange; the local
        sweeps clamp at the padded array's edges, which is wrong at interior
        shard seams by at most one row/col per sweep (trapezoid), i.e.
        exactly the kk-deep margin sliced off; at true domain edges the
        mirror fill IS the Neumann condition (see
        shardmap_step.sharded_ops._bursts)."""
        k = min(burst, iters)
        rp = None
        if rhs is not None:
            rp = _x2d(rhs, k, edge="mirror")
        x = fields
        left = iters
        while left > 0:
            kk = min(k, left)
            xp = _x2d(x, kk, edge="mirror")
            if rhs is None:
                xp = run_burst(xp, kk)
            else:
                rr = rp if kk == k else rp[..., k - kk: kk - k, k - kk: kk - k]
                xp = run_burst(xp, rr, kk)
            x = xp[..., kk:-kk, kk:-kk]
            left -= kk
        return x

    def diffuse(fields, dt, diffusion, iters):
        return _bursts(
            fields, lambda xp, kk: local.diffuse(xp, dt, diffusion, kk), iters)

    def diffuse_multi(fields, dt, coeffs, iters):
        return _bursts(
            fields, lambda xp, kk: local.diffuse_multi(xp, dt, coeffs, kk),
            iters)

    def diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, radius):
        # shard-local composition with GLOBAL coordinates (the splat tail is
        # pointwise, so composition is exact)
        f = diffuse_multi(fields, dt, coeffs, iters)
        ys_f, _, xs_f, _ = _global_grids(fields.shape[-2:])
        return ref.splat_tail(f, amps, last, radius, xs_f, ys_f)

    def divergence(u, v, half):
        uvp = _x2d(jnp.stack([u, v]), 1)
        l, r, b, t = _neighbors_2d(uvp)
        dd = (r[0] - l[0]) + (t[1] - b[1])
        return 0.5 * dd if half else dd

    def pressure_solve(div, iters):
        return _bursts(
            jnp.zeros_like(div),
            lambda pp, dd, kk: local.pressure_solve(dd, kk, init=pp),
            iters, rhs=div)

    def project(u, v, p, return_stats=False):
        l, r, b, t = _neighbors_2d(_x2d(p, 1))
        u2, v2 = u - 0.5 * (r - l), v - 0.5 * (t - b)
        if return_stats:
            return u2, v2, _vmax_repl(u2, v2)
        return u2, v2

    def _composed_pressure_project(u, v, iters, half):
        dd = divergence(u, v, half)
        p = pressure_solve(dd, iters)
        u2, v2 = project(u, v, p)
        return u2, v2, p

    def _fused_pressure_project(u, v, iters, half):
        """2-D analog of the rows-only fused projection (see
        parallel.shardmap_step._fused_pressure_project): one mirror
        exchange_2d of the velocity stack at depth k+2 yields a local
        divergence valid to depth k+1 in BOTH axes, burst 1 runs from p=0
        with no pressure exchange, and the final burst keeps a 1-deep valid
        halo so the gradient subtraction is local.  Physical-edge halos of
        the computed divergence are replaced by the even reflection of the
        core, rows first then columns of the row-fixed array — the same
        corner-carrying order as exchange_2d, so the result is exactly what
        exchange_2d(div, k+1, mirror) would have produced."""
        if iters == 0:
            return u, v, jnp.zeros_like(u)
        k = min(burst, iters)
        hd = k + 1
        nr, nc = lax.axis_size(row_axis), lax.axis_size(col_axis)
        ri, ci = lax.axis_index(row_axis), lax.axis_index(col_axis)

        uvp = _x2d(jnp.stack([u, v]), hd + 1, edge="mirror")
        dd = ((uvp[0][1:-1, 2:] - uvp[0][1:-1, :-2])
              + (uvp[1][2:, 1:-1] - uvp[1][:-2, 1:-1]))
        if half:
            dd = 0.5 * dd
        rows = dd[hd:-hd, :]
        low = jnp.where(ri == 0, jnp.flip(rows[:hd], axis=0), dd[:hd])
        high = jnp.where(ri == nr - 1, jnp.flip(rows[-hd:], axis=0),
                         dd[-hd:])
        d2 = jnp.concatenate([low, rows, high], axis=0)
        cols = d2[:, hd:-hd]
        lft = jnp.where(ci == 0, jnp.flip(cols[:, :hd], axis=1), d2[:, :hd])
        rgt = jnp.where(ci == nc - 1, jnp.flip(cols[:, -hd:], axis=1),
                        d2[:, -hd:])
        rp = jnp.concatenate([lft, cols, rgt], axis=1)  # depth hd, both axes

        p = None
        left = iters
        while left > 0:
            kk = min(k, left)
            keep = 1 if left == kk else 0
            if p is None:
                pp = local.pressure_solve(rp, kk)
                cut = hd - keep
            else:
                dep = kk + keep
                rr = (rp if dep == hd
                      else rp[hd - dep : dep - hd, hd - dep : dep - hd])
                xp = _x2d(p, dep, edge="mirror")
                pp = local.pressure_solve(rr, kk, init=xp)
                cut = kk
            p = pp[cut:-cut, cut:-cut] if cut else pp
            left -= kk

        ps = p[1:-1, 1:-1]
        u2 = u - 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
        v2 = v - 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
        return u2, v2, ps

    def pressure_project(u, v, iters, half, return_stats=False):
        kf = min(burst, max(iters, 1)) + 2
        if min(u.shape[-2], u.shape[-1]) >= kf:
            u2, v2, p = _fused_pressure_project(u, v, iters, half)
        else:
            u2, v2, p = _composed_pressure_project(u, v, iters, half)
        if return_stats:
            return u2, v2, p, _vmax_repl(u2, v2)
        return u2, v2, p

    # -- multigrid ---------------------------------------------------------------

    def _mg_neighbors(p):
        return _neighbors_2d(_x2d(p, 1))

    def _mg_smooth(p, rhs, sweeps):
        from cudafluidsimulation_tpu.ops.multigrid import _OMEGA
        from cudafluidsimulation_tpu.ops.stencil import neighbors as _nb

        hl, wl = p.shape[-2], p.shape[-1]
        left = sweeps
        while left > 0:
            k = min(left, hl, wl, 8)
            # ONE stacked (p, rhs) exchange_2d per burst (see
            # shardmap_step._mg_smooth — half the pairs)
            pr = _x2d(jnp.stack([p, rhs]), k, edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = _nb(pp)
                pp = pp + _OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            p = pp[..., k:-k, k:-k]
            left -= k
        return p

    def _mg_smooth_res(p, rhs, sweeps):
        """Pre-smooth + residual off the last burst's exchange_2d (k+1 deep,
        both axes — see shardmap_step._mg_smooth_res for the validity
        argument; here the x taps also come from the exchanged halo)."""
        from cudafluidsimulation_tpu.ops.multigrid import _OMEGA
        from cudafluidsimulation_tpu.ops.stencil import neighbors as _nb

        hl, wl = p.shape[-2], p.shape[-1]
        left = sweeps
        while left > 0:
            k = min(left, hl - 1, wl - 1, 8)
            last = left == k
            wk = k + 1 if last else k
            pr = _x2d(jnp.stack([p, rhs]), wk, edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = _nb(pp)
                pp = pp + _OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            if last:
                l, r, b, t = _nb(pp)
                res = rp - (4.0 * pp - (l + r + b + t))
                return (pp[..., wk:-wk, wk:-wk],
                        res[..., wk:-wk, wk:-wk])
            p = pp[..., wk:-wk, wk:-wk]
            left -= k
        raise AssertionError("sweeps must be >= 1")

    def pressure_solve_mg(div, cycles, tol=0.0, max_cycles=8):
        """2-D-sharded V-cycle: burst smoothing, global level hierarchy,
        sub-cap levels all-gathered along BOTH axes (tiny at that depth).
        ``tol > 0`` targets the GLOBAL rms residual (psum'd over both mesh
        axes, so every shard stops together)."""
        from cudafluidsimulation_tpu.ops import multigrid as mg

        hl, wl = div.shape
        level = mg._levels(h_global, w_global)
        local_cap = min(mg.local_levels(hl), mg.local_levels(wl))
        bottom = None
        if level > local_cap:
            from cudafluidsimulation_tpu.ops.stencil import neighbors as _loc_nb

            remaining = level - local_cap + 1
            single_vcycle, _ = mg.make_vcycle(_loc_nb)

            def bottom(p, rhs, nu1, nu2, coarse_sweeps):
                pf = lax.all_gather(p, row_axis, axis=0, tiled=True)
                pf = lax.all_gather(pf, col_axis, axis=1, tiled=True)
                rf = lax.all_gather(rhs, row_axis, axis=0, tiled=True)
                rf = lax.all_gather(rf, col_axis, axis=1, tiled=True)
                e = single_vcycle(pf, rf, remaining, nu1, nu2, coarse_sweeps)
                rr, cc = p.shape
                e = lax.dynamic_slice_in_dim(
                    e, lax.axis_index(row_axis) * rr, rr, 0)
                return lax.dynamic_slice_in_dim(
                    e, lax.axis_index(col_axis) * cc, cc, 1)

        def _mg_prolong(e_c):
            # bilinear prolongation taps 1 coarse neighbor in BOTH axes
            # (incl. the diagonal — exchange_2d carries corners); clamp
            # edges match the single-chip pad exactly
            return mg.bilinear_from_padded(_x2d(e_c, 1, edge="clamp"))

        vcycle, _apply_a, probe, finish = mg.make_vcycle(
            _mg_neighbors, smooth_fn=_mg_smooth, bottom_fn=bottom,
            prolong_fn=_mg_prolong, smooth_res_fn=_mg_smooth_res, parts=True)
        rhs = -div

        def res_mean(r):
            # psum'd GLOBAL mean of the probe's residual (rode the
            # pre-smooth's 2-D exchange) — all shards stop together
            s = lax.psum(jnp.sum(r * r), (row_axis, col_axis))
            return s / (h_global * w_global)

        return mg.run_cycles(vcycle, probe, finish, res_mean,
                             jnp.zeros_like(div), rhs,
                             min(level, local_cap), cycles, tol, max_cycles,
                             2, 2, 20)

    # -- pointwise stages ---------------------------------------------------------

    def _splat(kind):
        def splat(u, v, dye, cur, last, dt, force_scale, radius, color):
            ys_f, _, xs_f, _ = _global_grids(u.shape)
            return ref.splat_core(u, v, dye, cur, last, dt, force_scale,
                                  radius, color, xs_f, ys_f, kind)

        return splat

    def boundary_strip(u, v, dye, rows):
        _, ys_i, _, _ = _global_grids(u.shape)
        return ref.boundary_strip_core(u, v, dye, rows, ys_i)

    def apply_bloom(rgba, pos, intense, radius):
        shape = (rgba.shape[-2], rgba.shape[-1])
        ys_f, _, xs_f, _ = _global_grids(shape)
        return ref.bloom_core(rgba, pos, intense, radius, xs_f, ys_f)

    def render_frame(dye, pos, intense, radius, active):
        shape = (dye.shape[-2], dye.shape[-1])
        ys_f, _, xs_f, _ = _global_grids(shape)
        return ref.render_frame_core(dye, pos, intense, radius, active,
                                     xs_f, ys_f)

    ns.bilerp = ref.bilerp
    ns.advect_velocity = advect_velocity
    ns.advect_dye = advect_dye
    ns.advect_both = advect_both
    ns.curl = curl
    ns.vorticity_confinement_cpu = vorticity_confinement_cpu
    ns.vorticity_confinement_gpu = vorticity_confinement_gpu
    ns.diffuse = diffuse
    ns.diffuse_multi = diffuse_multi
    ns.diffuse_multi_splat = diffuse_multi_splat
    ns.divergence = divergence
    ns.pressure_solve = pressure_solve
    ns.pressure_solve_mg = pressure_solve_mg
    ns.pressure_project = pressure_project
    ns.project = project
    ns.splat_cpu = _splat("cpu")
    ns.splat_gpu = _splat("gpu")
    ns.cycle_color = ref.cycle_color
    ns.boundary_strip = boundary_strip
    ns.pack_rgba = ref.pack_rgba
    ns.apply_bloom = apply_bloom
    ns.render_frame = render_frame
    return ns


def _state_spec2d() -> FluidState:
    plane = P("rows", "cols")
    return FluidState(
        u=plane, v=plane, dye=P(None, "rows", "cols"), pressure=plane,
        t=P(), press_time=P(), time_since_press=P(), mouse=P(None), step=P(),
        vel_stats=P(None),  # replicated: the local ops pmax their stats
    )


def shard_state_2d(state: FluidState, mesh: Mesh) -> FluidState:
    spec = _state_spec2d()
    return jax.device_put(
        state, jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                            is_leaf=lambda x: isinstance(x, P)))


def _local_ops_2d(config: FluidConfig, mesh: Mesh):
    nr, nc = mesh.shape["rows"], mesh.shape["cols"]
    if config.ny % nr != 0 or config.nx % nc != 0:
        raise ValueError(
            f"grid {config.nx}x{config.ny} not divisible by mesh {nr}x{nc}")
    hl, wl = config.ny // nr, config.nx // nc
    d = config.max_displacement
    if hl < d or wl < d:
        raise ValueError(
            f"shard {wl}x{hl} smaller than max_displacement={d}; use fewer "
            f"shards, a larger grid, or a smaller bound")
    return sharded_ops_2d("rows", "cols", config.ny, config.nx, d,
                          local=get_ops(config), burst=min(BURST, hl, wl))


def make_shardmap2d_step(config: FluidConfig, mesh: Mesh):
    """jit(shard_map(step)) over a (rows x cols) spatial mesh."""
    from jax import shard_map

    from cudafluidsimulation_tpu.models.pipelines import make_step

    step = make_step(config, _local_ops_2d(config, mesh))
    ss = _state_spec2d()
    imp_spec = Impulse(pos=P(None), last_pos=P(None), pressed=P(), dt=P())
    sharded = shard_map(
        step, mesh=mesh, in_specs=(ss, imp_spec), out_specs=ss)
    return jax.jit(sharded)


def make_shardmap2d_rollout(config: FluidConfig, mesh: Mesh):
    """jit(shard_map(scan(step))) over a (rows x cols) spatial mesh."""
    from jax import shard_map

    from cudafluidsimulation_tpu.models.pipelines import make_step

    step = make_step(config, _local_ops_2d(config, mesh))

    def run(state, impulses):
        final, _ = lax.scan(lambda s, i: (step(s, i), None), state, impulses)
        return final

    ss = _state_spec2d()
    imp_spec = Impulse(pos=P(None, None), last_pos=P(None, None),
                       pressed=P(None), dt=P(None))
    sharded = shard_map(
        run, mesh=mesh, in_specs=(ss, imp_spec), out_specs=ss)
    return jax.jit(sharded)
