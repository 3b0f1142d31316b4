"""Explicit multi-device step: shard_map + ppermute halo exchange.

The auto-SPMD path (parallel.sharded) lets XLA partition the jnp stencils;
this module is the hand-laid-out alternative the 8192² config calls for
(SURVEY.md §5, BASELINE.json config 5): fields row-sharded over the "x" mesh
axis, every neighbor access an explicit ``exchange_rows`` (1-cell for
stencils, ``max_displacement`` rows for advection), boundary conditions
applied only on true domain edges.

Implementation trick: the whole physics pipeline (models.pipelines.make_step)
is written against an op *namespace*, so this module just provides a
shard-local implementation of the same op API — advection gathers locally in
the halo-padded array, Jacobi stages exchange a k-deep halo once per k local
sweeps, which run through the single-device op namespace (the CUDA kernel on
a GPU, ``ops.ref`` elsewhere) — and reuses make_step unchanged.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.ops import ref
from cudafluidsimulation_tpu.ops.backend import get_ops
from cudafluidsimulation_tpu.parallel.halo import exchange_rows, neighbors_padded
from cudafluidsimulation_tpu.state import FluidState
from cudafluidsimulation_tpu.utils.impulse import Impulse

# Jacobi sweeps per halo exchange on the sharded paths: each exchange is
# BURST rows deep and the shard runs BURST local sweeps before the next one.
BURST = 8


def _global_rows(shape, axis_name):
    """Global (float, int) row coordinates of this shard's cells."""
    hl, w = shape
    base = lax.axis_index(axis_name) * hl
    ys_i = jax.lax.broadcasted_iota(jnp.int32, (hl, w), 0) + base
    return ys_i.astype(jnp.float32), ys_i


_gather_local = ref._gather2d  # same flatten/take/reshape gather helper


def _bilerp_sharded(field, u, v, dt, h_global, d, axis_name):
    """Backtrace + bilerp within a d-row halo (vertical displacement bound
    d: taps beyond it clamp to the halo's last row)."""
    fp = exchange_rows(field, d, axis_name, edge="clamp")
    return _bilerp_padded(fp, u, v, dt, h_global, d, axis_name)


def _bilerp_padded(fp, u, v, dt, h_global, d, axis_name):
    """_bilerp_sharded on an ALREADY d-row-exchanged field ``fp`` (lets one
    exchange serve several advections)."""
    hl, w = u.shape
    ys_f, ys_i = _global_rows((hl, w), axis_name)
    xs_f = jax.lax.broadcasted_iota(jnp.float32, (hl, w), 1)

    px = xs_f - dt * u
    py = ys_f - dt * v
    x1 = jnp.trunc(px)
    y1 = jnp.trunc(py)
    tx = px - x1
    ty = py - y1

    cx1 = jnp.clip(x1, 0, w - 1).astype(jnp.int32)
    cx2 = jnp.clip(x1 + 1.0, 0, w - 1).astype(jnp.int32)
    cy1 = jnp.clip(y1, 0, h_global - 1).astype(jnp.int32)
    cy2 = jnp.clip(y1 + 1.0, 0, h_global - 1).astype(jnp.int32)
    # bound taps to the exchanged halo, then express in padded-local rows
    ly = jax.lax.broadcasted_iota(jnp.int32, (hl, w), 0)
    ry1 = jnp.clip(cy1 - ys_i, -d, d) + ly + d
    ry2 = jnp.clip(cy2 - ys_i, -d, d) + ly + d

    p00 = _gather_local(fp, ry1, cx1)
    p01 = _gather_local(fp, ry1, cx2)
    p10 = _gather_local(fp, ry2, cx1)
    p11 = _gather_local(fp, ry2, cx2)
    top = p00 * (1.0 - tx) + p01 * tx
    bot = p10 * (1.0 - tx) + p11 * tx
    return top * (1.0 - ty) + bot * ty


def sharded_ops(axis_name: str, h_global: int, d: int, local=ref,
                burst: int = BURST) -> types.SimpleNamespace:
    """Shard-local implementation of the op API consumed by make_step.

    The Jacobi stages exchange a ``burst``-deep halo once per ``burst``
    sweeps, which run on the padded shard through ``local`` — the
    single-device op namespace (``ops.ref`` or the CUDA backend's); see
    ``_bursts`` for the exactness argument."""
    ns = types.SimpleNamespace()

    def _vmax_repl(u2, v2):
        """Replicated ops.ref.vel_max of a row-sharded velocity: local
        reduction + a (2,)-element pmax over the mesh axis.  Keeps
        state.vel_stats spec P(None) truthful."""
        st = jnp.stack([jnp.max(jnp.abs(u2)), jnp.max(jnp.abs(v2))])
        return lax.pmax(st, axis_name)

    def advect_velocity(u, v, dt, decay_rate):
        # one stacked sample: a single d-row halo exchange and one set of
        # backtrace/clip index computations for both components
        decay = 1.0 / (1.0 + decay_rate * dt)
        uv = _bilerp_sharded(jnp.stack([u, v]), u, v, dt, h_global, d,
                             axis_name) * decay
        return uv[0], uv[1]

    def advect_dye(dye, u, v, dt, decay_rate):
        decay = 1.0 / (1.0 + decay_rate * dt)
        c = _bilerp_sharded(dye, u, v, dt, h_global, d, axis_name)
        return jnp.fmin(1.0, jnp.power(c, 1.005) * decay)

    def advect_both(u, v, dye, dt, decay_rate):
        """Velocity + dye advection off ONE d-deep exchange of the stacked
        5-channel (velocity, dye) halo: both advections tap PRE-advection
        data (the reference's double buffer, GPUFluidSim.cu:620-622), so the
        dye halo rides the velocity exchange even though its backtrace uses
        the NEW velocity, whose taps stay inside the same halo."""
        allp = exchange_rows(jnp.concatenate([jnp.stack([u, v]), dye]), d,
                             axis_name, edge="clamp")
        decay = 1.0 / (1.0 + decay_rate * dt)
        uv = _bilerp_padded(allp[:2], u, v, dt, h_global, d, axis_name) * decay
        u2, v2 = uv[0], uv[1]
        c = _bilerp_padded(allp[2:], u2, v2, dt, h_global, d, axis_name)
        dye2 = jnp.fmin(1.0, jnp.power(c, 1.005) * decay)
        return u2, v2, dye2

    def curl(u, v):
        # one stacked exchange for both components (half the ppermute pairs)
        uvp = exchange_rows(jnp.stack([u, v]), 1, axis_name)
        l, r, b, t = neighbors_padded(uvp)
        return 0.5 * (r[1] - l[1] - t[0] + b[0])

    def _curl_padded(u, v):
        """Curl with a 1-row valid halo from ONE 2-deep velocity exchange
        (instead of a 1-deep exchange for curl plus a second 1-deep exchange
        of the curl field — the same fold-the-dependency trick as
        _fused_pressure_project, halving the stage's exchange pairs).
        Physical-edge halo rows are replaced by the edge curl row, exactly
        what exchange_rows(curl, 1, clamp) would have supplied."""
        from cudafluidsimulation_tpu.ops.stencil import shift_x

        uvp = exchange_rows(jnp.stack([u, v]), 2, axis_name)
        vl, vr = shift_x(uvp[1], -1), shift_x(uvp[1], 1)
        we = 0.5 * (vr[1:-1] - vl[1:-1] - uvp[0][2:] + uvp[0][:-2])
        n = lax.axis_size(axis_name)
        idx = lax.axis_index(axis_name)
        low = jnp.where(idx == 0, we[1:2], we[:1])
        high = jnp.where(idx == n - 1, we[-2:-1], we[-1:])
        return jnp.concatenate([low, we[1:-1], high], axis=0)

    def vorticity_confinement_cpu(u, v, dt, vorticity):
        wp = _curl_padded(u, v)
        w = wp[1:-1]
        al, ar, ab, at = neighbors_padded(jnp.abs(wp))
        fx = 0.5 * (at - ab)
        fy = 0.5 * (ar - al)
        ln = jnp.sqrt(fx * fx + fy * fy) + 1e-4
        s = w * vorticity / ln
        return u - fx * s * dt, v - fy * s * dt

    def vorticity_confinement_gpu(u, v, dt, vorticity):
        wp = _curl_padded(u, v)
        w = wp[1:-1]
        wl, wr, wb, wt = neighbors_padded(wp)
        fx = 0.5 * (jnp.abs(wt) - jnp.abs(wb))
        fy = 0.5 * (jnp.abs(wl) - jnp.abs(wr))
        ln = jnp.sqrt(fx * fx + fy * fy) + 1e-3
        s = w * vorticity / ln
        return u + fx * s * dt, v + fy * s * dt

    def _bursts(fields, run_burst, iters, rhs=None):
        """Exchange a k-row halo once per k local sweeps.

        The local sweeps clamp at the padded array's edges.  For interior
        shards those edges are exchanged halo rows, and the error the clamp
        makes there travels one row per sweep (the trapezoid argument), so
        it stays within the k rows sliced off; at true domain edges the
        mirror fill is the clamped-edge Neumann ghost.  Net: global Jacobi,
        with 1/k-th the exchanges of a sweep-by-sweep schedule.

        ``rhs`` (e.g. the pressure divergence) is constant across bursts, so
        its halo is exchanged ONCE at full depth and sliced down for a
        smaller final partial chunk.
        """
        k = min(burst, iters)
        rp = None
        if rhs is not None:
            rp = exchange_rows(rhs, k, axis_name, edge="mirror")
        x = fields
        left = iters
        while left > 0:
            kk = min(k, left)
            xp = exchange_rows(x, kk, axis_name, edge="mirror")
            if rhs is None:
                xp = run_burst(xp, kk)
            else:
                rr = rp if kk == k else rp[..., k - kk : kk - k, :]
                xp = run_burst(xp, rr, kk)
            x = xp[..., kk:-kk, :]
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
        # shard-local composition: local diffusion, then the splat tail with
        # GLOBAL row coordinates (the single-chip fused kernel's tail is
        # pointwise, so composition is exact)
        f = diffuse_multi(fields, dt, coeffs, iters)
        ys_f, _ = _global_rows(fields.shape[-2:], axis_name)
        xs_f = jax.lax.broadcasted_iota(jnp.float32, fields.shape[-2:], 1)
        return ref.splat_tail(f, amps, last, radius, xs_f, ys_f)

    def divergence(u, v, half):
        # one stacked exchange for both components (half the ppermute pairs)
        uvp = exchange_rows(jnp.stack([u, v]), 1, axis_name)
        l, r, b, t = neighbors_padded(uvp)
        dd = (r[0] - l[0]) + (t[1] - b[1])
        return 0.5 * dd if half else dd

    def pressure_solve(div, iters):
        return _bursts(
            jnp.zeros_like(div),
            lambda pp, dd, kk: local.pressure_solve(dd, kk, init=pp),
            iters, rhs=div)

    def project(u, v, p, return_stats=False):
        pp = exchange_rows(p, 1, axis_name)
        pl, pr, pb, pt = neighbors_padded(pp)
        u2, v2 = u - 0.5 * (pr - pl), v - 0.5 * (pt - pb)
        if return_stats:
            return u2, v2, _vmax_repl(u2, v2)
        return u2, v2

    def _composed_pressure_project(u, v, iters, half):
        dd = divergence(u, v, half)
        p = pressure_solve(dd, iters)
        u2, v2 = project(u, v, p)
        return u2, v2, p

    def _fused_pressure_project(u, v, iters, half):
        """Divergence -> burst Jacobi -> project with the per-op halo
        exchanges folded into the burst exchanges (the reference launches
        all three separately, GPUFluidSim.cu:676-685).

        One mirror exchange of the velocity stack at depth k+2 makes the
        locally-computed divergence valid to depth k+1 (one derivative eats
        one row), so burst 1 runs from p=0 with NO pressure exchange (sweep 1
        of Jacobi from zero is -div/4 independent of boundary data, so the
        padded-edge corruption only reaches kk-1 rows after kk sweeps), and
        the FINAL burst exchanges one extra row (kk+1) so its retained
        pressure keeps a valid 1-row halo for a local gradient subtraction.
        Exchange pairs per projection drop from 3 + ceil(iters/k) to
        1 + (ceil(iters/k) - 1): 4 -> 1 for the cpu-parity 5 iters,
        7 -> 4 for the gpu-parity 30.

        Physical-edge halos of the computed divergence are overwritten with
        the even reflection of the core (the Neumann ghost needs
        d(-1-j) = d(j), not the divergence of mirrored velocity — same fix
        as the clamped divergence of ops.ref.divergence)."""
        from cudafluidsimulation_tpu.ops.stencil import shift_x

        if iters == 0:
            return u, v, jnp.zeros_like(u)
        k = min(burst, iters)
        hd = k + 1
        n = lax.axis_size(axis_name)
        idx = lax.axis_index(axis_name)

        uvp = exchange_rows(jnp.stack([u, v]), hd + 1, axis_name,
                            edge="mirror")
        ul, ur = shift_x(uvp[0], -1), shift_x(uvp[0], 1)
        dd = (ur[1:-1] - ul[1:-1]) + (uvp[1][2:] - uvp[1][:-2])
        if half:
            dd = 0.5 * dd
        core = dd[hd:-hd]
        low = jnp.where(idx == 0, jnp.flip(core[:hd], axis=0), dd[:hd])
        high = jnp.where(idx == n - 1, jnp.flip(core[-hd:], axis=0),
                         dd[-hd:])
        rp = jnp.concatenate([low, core, high], axis=0)  # depth hd

        p = None
        left = iters
        while left > 0:
            kk = min(k, left)
            # depth to RETAIN after this burst: 1 valid halo row on the last
            # burst (for the local project), 0 otherwise.  Corruption from
            # the padded edge reaches depth kk-1 after kk sweeps (sweep 1 is
            # -div/4 from a true-data/ghost halo, independent of p boundary
            # data), so retained rows at distance >= kk are exact.
            keep = 1 if left == kk else 0
            if p is None:  # burst 1: p=0, no pressure exchange needed
                pp = local.pressure_solve(rp, kk)
                cut = hd - keep
            else:
                dep = kk + keep
                rr = rp if dep == hd else rp[hd - dep : dep - hd]
                xp = exchange_rows(p, dep, axis_name, edge="mirror")
                pp = local.pressure_solve(rr, kk, init=xp)
                cut = kk
            p = pp[cut:-cut] if cut else pp
            left -= kk

        ps = p[1:-1]
        pl_, pr_ = shift_x(ps, -1), shift_x(ps, 1)
        u2 = u - 0.5 * (pr_ - pl_)
        v2 = v - 0.5 * (p[2:] - p[:-2])
        return u2, v2, ps

    def pressure_project(u, v, iters, half, return_stats=False):
        if u.shape[0] >= min(burst, max(iters, 1)) + 2:
            u2, v2, p = _fused_pressure_project(u, v, iters, half)
        else:
            # shards too short for the fused exchange depth
            u2, v2, p = _composed_pressure_project(u, v, iters, half)
        if return_stats:
            return u2, v2, p, _vmax_repl(u2, v2)
        return u2, v2, p

    def _splat(kind):
        def splat(u, v, dye, cur, last, dt, force_scale, radius, color):
            ys_f, _ = _global_rows(u.shape, axis_name)
            xs_f = jax.lax.broadcasted_iota(jnp.float32, u.shape, 1)
            return ref.splat_core(u, v, dye, cur, last, dt, force_scale,
                                  radius, color, xs_f, ys_f, kind)

        return splat

    def boundary_strip(u, v, dye, rows):
        _, ys_i = _global_rows(u.shape, axis_name)
        return ref.boundary_strip_core(u, v, dye, rows, ys_i)

    def apply_bloom(rgba, pos, intense, radius):
        hl, w = rgba.shape[-2], rgba.shape[-1]
        ys_f, _ = _global_rows((hl, w), axis_name)
        xs_f = jax.lax.broadcasted_iota(jnp.float32, (hl, w), 1)
        return ref.bloom_core(rgba, pos, intense, radius, xs_f, ys_f)

    def render_frame(dye, pos, intense, radius, active):
        hl, w = dye.shape[-2], dye.shape[-1]
        ys_f, _ = _global_rows((hl, w), axis_name)
        xs_f = jax.lax.broadcasted_iota(jnp.float32, (hl, w), 1)
        return ref.render_frame_core(dye, pos, intense, radius, active,
                                     xs_f, ys_f)

    ns.bilerp = ref.bilerp  # unused by the pipeline directly
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
    def _mg_neighbors(p):
        return neighbors_padded(exchange_rows(p, 1, axis_name))

    def _mg_smooth(p, rhs, sweeps):
        """Damped-Jacobi smoothing with k sweeps per halo exchange.

        Exchange a k-deep (p, rhs) halo, sweep locally on the padded arrays
        with plain clamped stencils, slice k rows off: corruption from the
        padded-array edges travels one row per sweep (trapezoid argument) so
        the kept interior is bit-exact vs sweep-by-sweep exchange; mirror
        fill at true domain edges is the Neumann ghost (the same invariant
        as ``_bursts``).  Exchanges drop ~k-fold vs a 1-row-per-sweep
        smoother."""
        from cudafluidsimulation_tpu.ops.multigrid import _OMEGA
        from cudafluidsimulation_tpu.ops.stencil import neighbors as _nb

        hl = p.shape[-2]
        left = sweeps
        while left > 0:
            k = min(left, hl, 8)
            # ONE stacked (p, rhs) exchange per burst — half the pairs of
            # exchanging them separately (r4: mg pairs were ~2x the level
            # count's floor because every burst paid 2)
            pr = exchange_rows(jnp.stack([p, rhs]), k, axis_name,
                               edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = _nb(pp)
                pp = pp + _OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            p = pp[..., k:-k, :]
            left -= k
        return p

    def _mg_smooth_res(p, rhs, sweeps):
        """Pre-smooth + residual with the residual riding the LAST burst's
        halo exchange: the final burst exchanges k+1 deep, sweeps k times
        (padded rows within distance k of the exchange edge are the only
        degraded ones), and computes rhs - A p on the padded planes — rows
        [k+1, hl+k+1) of the result are exact, which is exactly the local
        shard.  Saves the separate 1-deep residual exchange per level per
        cycle.  Mirror ghosts at the physical edge ARE the clamp ghost at
        distance 1, so the residual's edge taps stay exact."""
        from cudafluidsimulation_tpu.ops.multigrid import _OMEGA
        from cudafluidsimulation_tpu.ops.stencil import neighbors as _nb

        hl = p.shape[-2]
        left = sweeps
        while left > 0:
            k = min(left, hl - 1, 8)
            last = left == k
            wk = k + 1 if last else k
            pr = exchange_rows(jnp.stack([p, rhs]), wk, axis_name,
                               edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = _nb(pp)
                pp = pp + _OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            if last:
                l, r, b, t = _nb(pp)
                res = rp - (4.0 * pp - (l + r + b + t))
                return pp[..., wk:-wk, :], res[..., wk:-wk, :]
            p = pp[..., wk:-wk, :]
            left -= k
        raise AssertionError("sweeps must be >= 1")

    def pressure_solve_mg(div, cycles, tol=0.0, max_cycles=8):
        """Sharded V-cycle multigrid: the shared numerics from
        ops.multigrid.make_vcycle with this path's ppermute halo-exchange
        neighborhood and the burst smoother above.  The level hierarchy is
        chosen from the GLOBAL grid so results match the single-device
        solver; once a shard's rows stop halving, the remaining (tiny)
        coarse levels are all-gathered onto every device and continued with
        the single-chip V-cycle — the full hierarchy is level-equivalent to
        the single-chip solver at any shard count.  ``tol > 0`` targets the
        GLOBAL rms residual (psum'd, so every shard stops together)."""
        from cudafluidsimulation_tpu.ops import multigrid as mg

        hl, w = div.shape
        level = mg._levels(h_global, w)
        local_cap = mg.local_levels(hl)

        bottom = None
        if level > local_cap:
            from cudafluidsimulation_tpu.ops.stencil import neighbors as _loc_nb

            remaining = level - local_cap + 1
            single_vcycle, _ = mg.make_vcycle(_loc_nb)

            def bottom(p, rhs, nu1, nu2, coarse_sweeps):
                p_full = lax.all_gather(p, axis_name, axis=0, tiled=True)
                r_full = lax.all_gather(rhs, axis_name, axis=0, tiled=True)
                e = single_vcycle(p_full, r_full, remaining, nu1, nu2,
                                  coarse_sweeps)
                rows = p.shape[0]
                return lax.dynamic_slice_in_dim(
                    e, lax.axis_index(axis_name) * rows, rows, 0)

        def _mg_prolong(e_c):
            # bilinear prolongation taps 1 coarse neighbor: rows come from
            # the vertical exchange (clamped at the domain edge, exactly
            # like the single-chip pad), columns are local
            ep = exchange_rows(e_c, 1, axis_name, edge="clamp")
            return mg.bilinear_from_padded(
                jnp.pad(ep, ((0, 0), (1, 1)), mode="edge"))

        vcycle, _apply_a, probe, finish = mg.make_vcycle(
            _mg_neighbors, smooth_fn=_mg_smooth, bottom_fn=bottom,
            prolong_fn=_mg_prolong, smooth_res_fn=_mg_smooth_res, parts=True)
        rhs = -div

        def res_mean(r):
            # psum'd GLOBAL mean of the probe's residual (which rode the
            # pre-smooth's exchange) — every shard stops at the same cycle
            return lax.psum(jnp.sum(r * r), axis_name) / (h_global * w)

        return mg.run_cycles(vcycle, probe, finish, res_mean,
                             jnp.zeros_like(div), rhs,
                             min(level, local_cap), cycles, tol, max_cycles,
                             2, 2, 20)

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


def _state_spec(axis_name: str) -> FluidState:
    plane = P(axis_name, None)
    return FluidState(
        u=plane, v=plane, dye=P(None, axis_name, None), pressure=plane,
        t=P(), press_time=P(), time_since_press=P(), mouse=P(None), step=P(),
        vel_stats=P(None),  # replicated: the local ops pmax their stats
    )


def _local_ops(config: FluidConfig, mesh: Mesh, axis_name: str):
    """Validate the sharding geometry and build the shard-local op set."""
    n = mesh.shape[axis_name]
    if config.ny % n != 0:
        raise ValueError(f"ny={config.ny} not divisible by mesh axis {n}")
    hl = config.ny // n
    if hl < config.max_displacement:
        # silently tightening the advection bound would make the same config
        # produce different physics depending on device count
        raise ValueError(
            f"shard height {hl} is smaller than max_displacement="
            f"{config.max_displacement}; use fewer shards, a taller grid, or "
            f"a smaller max_displacement"
        )
    return sharded_ops(axis_name, config.ny, config.max_displacement,
                       local=get_ops(config), burst=min(BURST, hl))


def make_shardmap_step(config: FluidConfig, mesh: Mesh, axis_name: str = "x"):
    """jit(shard_map(step)): one explicit-halo-exchange step over the mesh."""
    from jax import shard_map

    from cudafluidsimulation_tpu.models.pipelines import make_step

    step = make_step(config, _local_ops(config, mesh, axis_name))

    ss = _state_spec(axis_name)
    imp_spec = Impulse(pos=P(None), last_pos=P(None), pressed=P(), dt=P())
    sharded = shard_map(
        step, mesh=mesh, in_specs=(ss, imp_spec), out_specs=ss)
    return jax.jit(sharded)


def make_shardmap_rollout(config: FluidConfig, mesh: Mesh, axis_name: str = "x"):
    """jit(shard_map(scan(step))): whole rollout with the scan inside the
    shard_map so halo exchanges need no per-step dispatch."""
    from jax import shard_map

    from cudafluidsimulation_tpu.models.pipelines import make_step

    step = make_step(config, _local_ops(config, mesh, axis_name))

    def run(state, impulses):
        final, _ = lax.scan(lambda s, i: (step(s, i), None), state, impulses)
        return final

    ss = _state_spec(axis_name)
    imp_spec = Impulse(pos=P(None, None), last_pos=P(None, None),
                       pressed=P(None), dt=P(None))
    sharded = shard_map(
        run, mesh=mesh, in_specs=(ss, imp_spec), out_specs=ss)
    return jax.jit(sharded)
