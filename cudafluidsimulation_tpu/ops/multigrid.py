"""Geometric multigrid pressure solver — the beyond-parity fast mode.

The reference (and our parity pipelines) run fixed Jacobi sweeps
(5/30/40/100 depending on config), which stall on low-frequency error: at
2048² even 100 sweeps barely move the large-scale divergence.  A V-cycle
with damped-Jacobi smoothing reduces the residual ~10x per cycle at a cost
of ~8 fine-grid-sweep equivalents, so 2-3 cycles beat hundreds of sweeps.

Solves the same discrete system the parity solver iterates,
    (4 p - pL - pR - pB - pT) = -div     (clamped / Neumann edges),
so it plugs into the pipeline as ``pressure_solver="multigrid"``
(FluidConfig) with everything else unchanged.  Restriction is 2x2 averaging,
prolongation cell-centered bilinear (9-3-3-1 weights) — nearest-neighbor
prolongation is below the order requirement for the 5-point Laplacian and
measurably injects blocky error the post-smoothing cannot remove (at 2048²
on a driven field, one NN cycle left rms residual 1.59 vs 0.134 bilinear,
from a zero-guess 0.82).  All elementwise shift/stride ops that XLA
fuses.  Requires grid dims divisible by 2**levels; levels are chosen
automatically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cudafluidsimulation_tpu.ops.stencil import neighbors

_OMEGA = 0.8  # damped-Jacobi smoothing weight


def _restrict(x):
    r = x[0::2, :] + x[1::2, :]
    return (r[:, 0::2] + r[:, 1::2]) * 0.25


def bilinear_from_padded(xp):
    """Cell-centered bilinear (9-3-3-1) prolongation from a ONE-cell-padded
    coarse array.  The caller supplies the padding — clamped domain edges
    single-chip (``jnp.pad mode='edge'``), exchanged halos on the sharded
    paths — so both use the SAME local arithmetic and sharded solves stay
    bit-identical to the single-chip solver."""
    c = xp[1:-1, 1:-1]
    u, d = xp[:-2, 1:-1], xp[2:, 1:-1]
    l, r = xp[1:-1, :-2], xp[1:-1, 2:]
    ul, ur = xp[:-2, :-2], xp[:-2, 2:]
    dl, dr = xp[2:, :-2], xp[2:, 2:]
    s = 1.0 / 16.0
    f00 = (9.0 * c + 3.0 * u + 3.0 * l + ul) * s  # fine (2i, 2j)
    f01 = (9.0 * c + 3.0 * u + 3.0 * r + ur) * s
    f10 = (9.0 * c + 3.0 * d + 3.0 * l + dl) * s
    f11 = (9.0 * c + 3.0 * d + 3.0 * r + dr) * s
    h, w = c.shape
    top = jnp.stack([f00, f01], axis=-1).reshape(h, 2 * w)
    bot = jnp.stack([f10, f11], axis=-1).reshape(h, 2 * w)
    return jnp.stack([top, bot], axis=1).reshape(2 * h, 2 * w)


def _prolong(x):
    return bilinear_from_padded(jnp.pad(x, 1, mode="edge"))


def local_levels(n: int) -> int:
    """How many V-cycle levels an extent of ``n`` cells supports before it
    stops halving cleanly (1 + the 2-adic valuation, clamped at n >= 2) —
    the shard-local coarsening cap used by the sharded solvers."""
    c = 1
    while n % 2 == 0 and n >= 2:
        n //= 2
        c += 1
    return c


def _levels(h: int, w: int, max_levels: int = 8, min_size: int = 16) -> int:
    n = 0
    while (
        n < max_levels - 1
        and h % 2 == 0 and w % 2 == 0
        and h // 2 >= min_size and w // 2 >= min_size
    ):
        h //= 2
        w //= 2
        n += 1
    return n + 1


def make_vcycle(neighbors_fn, smooth_fn=None, bottom_fn=None,
                prolong_fn=None, smooth_res_fn=None, parts: bool = False):
    """Build the V-cycle from a clamped-neighborhood function — the single
    source of the multigrid numerics.  ``neighbors_fn(p) -> (l, r, b, t)``
    supplies the operator's boundary handling: the single-chip solver passes
    the local clamped stencil, the shard_map path passes its ppermute
    halo-exchange stencil.  Restriction is local either way (shards hold
    globally contiguous rows).

    ``smooth_fn(p, rhs, sweeps)`` overrides the damped-Jacobi smoother with
    an equivalent implementation (the shard_map path substitutes a k-deep
    halo-exchange burst smoother — same sweeps, 1/k the exchanges).
    ``prolong_fn(e_c)`` overrides the bilinear prolongation (the sharded
    paths feed ``bilinear_from_padded`` a 1-deep halo exchange instead of
    the local clamped pad — same arithmetic, bit-identical results).
    ``bottom_fn(p, rhs, nu1, nu2, coarse_sweeps)`` overrides the coarsest
    level (the shard_map path gathers the sub-shard-cap levels there).
    ``smooth_res_fn(p, rhs, nu1) -> (p', rhs - A p')`` overrides the
    pre-smooth AND the residual in one call (the shard_map paths ride the
    residual on the pre-smooth's halo exchange — one fewer exchange pair
    per level per cycle).

    ``parts=True`` additionally returns the fine-level (probe, finish)
    split: ``probe(p, rhs, nu1, level) -> (p', res')`` is the top level's
    pre-smooth + residual, ``finish(p', res', rhs, level, ...)`` the rest
    of the cycle (coarse correction + post-smooth), with
    ``vcycle == finish ∘ probe`` operation-for-operation.  Residual-
    targeted stopping (run_cycles) tests convergence between them, so the
    stopping residual is the one the cycle computes anyway instead of a
    separate apply_a pass."""

    def apply_a(p):
        l, r, b, t = neighbors_fn(p)
        return 4.0 * p - (l + r + b + t)

    def default_smooth(p, rhs, sweeps: int):
        def sweep(p, _):
            l, r, b, t = neighbors_fn(p)
            p_jac = 0.25 * (l + r + b + t + rhs)
            return p + _OMEGA * (p_jac - p), None

        p, _ = jax.lax.scan(sweep, p, None, length=sweeps)
        return p

    smooth = smooth_fn or default_smooth
    prolong = prolong_fn or _prolong

    def bottom(p, rhs, nu1, nu2, coarse_sweeps):
        if bottom_fn is not None:
            return bottom_fn(p, rhs, nu1, nu2, coarse_sweeps)
        return smooth(p, rhs, coarse_sweeps)

    def probe(p, rhs, nu1, level, nu2=None, coarse_sweeps=None):
        """Top-level pre-smooth + its residual.  At level 1 the whole
        (bottom) cycle runs here and finish() is the identity, so probed
        stopping still tests the residual of a completed cycle."""
        if level == 1:
            p = bottom(p, rhs, nu1, nu2, coarse_sweeps)
        elif smooth_res_fn is not None:
            return smooth_res_fn(p, rhs, nu1)
        else:
            p = smooth(p, rhs, nu1)
        return p, rhs - apply_a(p)

    def finish(p, res, rhs, level, nu1, nu2, coarse_sweeps):
        if level == 1:
            return p
        # NOTE the scaling: restricting the residual of the unscaled 5-point
        # operator onto the coarse grid doubles the effective mesh width,
        # which for this h²-absorbed operator means the coarse RHS gains a
        # factor 4.
        rhs_c = 4.0 * _restrict(res)
        e_c = vcycle(jnp.zeros_like(rhs_c), rhs_c, level - 1, nu1, nu2,
                     coarse_sweeps)
        p = p + prolong(e_c)
        return smooth(p, rhs, nu2)

    def vcycle(p, rhs, level: int, nu1: int, nu2: int, coarse_sweeps: int):
        if level == 1:
            return bottom(p, rhs, nu1, nu2, coarse_sweeps)
        if smooth_res_fn is not None:
            p, res = smooth_res_fn(p, rhs, nu1)
        else:
            p = smooth(p, rhs, nu1)
            res = rhs - apply_a(p)
        return finish(p, res, rhs, level, nu1, nu2, coarse_sweeps)

    if parts:
        return vcycle, apply_a, probe, finish
    return vcycle, apply_a


_vcycle, _apply_a, _probe_scan, _finish_scan = make_vcycle(neighbors,
                                                           parts=True)

def probed_tol_loop(probe, finish, res_mean_fn, p0, first, tol, max_cycles):
    """Residual-targeted cycle driver with a FREE stopping test: each
    iteration completes the pending cycle then runs the NEXT cycle's
    pre-smooth ``probe(p) -> (p', res')`` — whose residual (which the cycle
    computes anyway, riding the smoothing halo exchange on the sharded
    paths) doubles as the convergence check.  The old scheme paid a
    separate apply_a + reduction per cycle (+~2 ms/cycle at 8192²).

    ``first`` is the already-computed probe of ``p0``; on a converged exit
    the returned iterate is the probed one (its rms residual is exactly the
    tested value, < tol — pre-smooths only reduce the residual further, so
    the contract holds with nu1 bonus sweeps); on a ``max_cycles`` cap exit
    it is the last COMPLETED cycle's iterate — operation-for-operation the
    fixed-``max_cycles`` result, so capped tol runs match fixed runs."""
    p1, r1 = first
    tol2 = jnp.float32(tol) ** 2

    def body(carry):
        _, p1, r1, _, i = carry
        pf = finish(p1, r1)
        p2, r2 = probe(pf)
        return pf, p2, r2, res_mean_fn(r2), i + 1

    def cond(carry):
        _, _, _, rsq, i = carry
        return (i < max_cycles) & (rsq >= tol2)

    pf, p1, _, rsq, _ = jax.lax.while_loop(
        cond, body, (p0, p1, r1, res_mean_fn(r1), jnp.int32(0))
    )
    return jnp.where(rsq < tol2, p1, pf)


def run_cycles(vcycle, probe_fn, finish_fn, res_mean_fn, p, rhs, level,
               cycles, tol, max_cycles, nu1, nu2, coarse_sweeps):
    """Drive V-cycles either a fixed ``cycles`` count (``tol <= 0``) or until
    the rms residual drops below ``tol`` (at most ``max_cycles`` cycles, via
    ``lax.while_loop`` — dynamic count, no recompiles).

    ``probe_fn``/``finish_fn`` are make_vcycle's ``parts=True`` split (the
    stopping residual rides the pre-smooth — see :func:`probed_tol_loop`);
    ``res_mean_fn(res) -> mean(res**2)`` reduces a residual array — sharded
    callers supply a psum'd global mean so every shard stops together."""

    if tol <= 0:
        for _ in range(cycles):
            p = vcycle(p, rhs, level, nu1, nu2, coarse_sweeps)
        return p

    def probe(q):
        return probe_fn(q, rhs, nu1, level, nu2, coarse_sweeps)

    def finish(q, res):
        return finish_fn(q, res, rhs, level, nu1, nu2, coarse_sweeps)

    return probed_tol_loop(probe, finish, res_mean_fn, p, probe(p), tol,
                           max_cycles)


@functools.partial(jax.jit, static_argnames=("cycles", "nu1", "nu2",
                                             "coarse_sweeps", "tol",
                                             "max_cycles"))
def pressure_solve_mg(div, cycles: int = 2, nu1: int = 2, nu2: int = 2,
                      coarse_sweeps: int = 20, tol: float = 0.0,
                      max_cycles: int = 8):
    """Multigrid solve of the pressure system from p=0 (same system and
    start state as ops.ref.pressure_solve, far better converged).

    ``tol > 0`` switches from a fixed ``cycles`` count to residual-targeted
    stopping: cycles run until rms(A p + div) < tol (cap ``max_cycles``;
    the test rides the pre-smooth's residual — see probed_tol_loop)."""
    h, w = div.shape
    lv = _levels(h, w)
    rhs = -div

    def res_mean(r):
        return jnp.mean(r * r)

    return run_cycles(_vcycle, _probe_scan, _finish_scan, res_mean,
                      jnp.zeros_like(div), rhs, lv, cycles, tol, max_cycles,
                      nu1, nu2, coarse_sweeps)


def residual_norm(p, div):
    """||A p + div||_rms — convergence diagnostic."""
    r = _apply_a(p) + div
    return jnp.sqrt(jnp.mean(r * r))
