"""Row-halo exchange over a mesh axis with lax.ppermute.

The building block of the explicit multi-device path (SURVEY.md §5): fields
are row-sharded over the "x" mesh axis; each stencil/advection op first
fetches ``width`` boundary rows from its neighbors, then computes locally on
the padded array.  Physical domain edges (first/last shard) get clamped-BC
padding instead: edge replication for 1-wide stencil halos and mirror (even)
reflection for multi-sweep Jacobi bursts, whose clamped sweeps on the padded
array then reproduce the single-device Neumann edges exactly.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _perm(n: int, up: bool):
    # up: data flows to higher rank (i -> i+1)
    return [(i, i + 1) for i in range(n - 1)] if up else [(i, i - 1) for i in range(1, n)]


def exchange_rows(a: jnp.ndarray, width: int, axis_name: str,
                  edge: str = "clamp") -> jnp.ndarray:
    """Pad local (..., Hl, W) rows with ``width`` halo rows from mesh
    neighbors; physical edges padded per ``edge``: "clamp" (replicate edge
    row) or "mirror" (even reflection, exact for Jacobi bursts)."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    top_rows = a[..., -width:, :]  # my highest rows -> neighbor above's low halo
    bot_rows = a[..., :width, :]  # my lowest rows -> neighbor below's high halo

    from_below = lax.ppermute(top_rows, axis_name, _perm(n, up=True))
    from_above = lax.ppermute(bot_rows, axis_name, _perm(n, up=False))

    if edge == "mirror":
        low_fill = jnp.flip(a[..., :width, :], axis=-2)
        high_fill = jnp.flip(a[..., -width:, :], axis=-2)
    else:
        reps = [1] * (a.ndim - 2) + [width, 1]
        low_fill = jnp.tile(a[..., :1, :], reps)
        high_fill = jnp.tile(a[..., -1:, :], reps)

    low = jnp.where(idx == 0, low_fill, from_below)
    high = jnp.where(idx == n - 1, high_fill, from_above)
    return jnp.concatenate([low, a, high], axis=-2)


def exchange_cols(a: jnp.ndarray, width: int, axis_name: str,
                  edge: str = "clamp") -> jnp.ndarray:
    """Column analog of :func:`exchange_rows` for 2-D (rows x cols) spatial
    meshes: pad local (..., Hl, Wl) columns with ``width`` halo columns from
    the mesh neighbors along ``axis_name``; physical x edges padded per
    ``edge`` ("clamp" or "mirror")."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    right_cols = a[..., :, -width:]
    left_cols = a[..., :, :width]

    from_left = lax.ppermute(right_cols, axis_name, _perm(n, up=True))
    from_right = lax.ppermute(left_cols, axis_name, _perm(n, up=False))

    if edge == "mirror":
        low_fill = jnp.flip(a[..., :, :width], axis=-1)
        high_fill = jnp.flip(a[..., :, -width:], axis=-1)
    else:
        reps = [1] * (a.ndim - 1) + [width]
        low_fill = jnp.tile(a[..., :, :1], reps)
        high_fill = jnp.tile(a[..., :, -1:], reps)

    low = jnp.where(idx == 0, low_fill, from_left)
    high = jnp.where(idx == n - 1, high_fill, from_right)
    return jnp.concatenate([low, a, high], axis=-1)


def exchange_2d(a: jnp.ndarray, width: int, row_axis: str, col_axis: str,
                edge: str = "clamp") -> jnp.ndarray:
    """k-deep halo exchange on a 2-D spatial mesh, corners included: rows
    first, then columns OF THE ROW-PADDED array — the column transfer
    carries the diagonal neighbors' rows, which k-sweep stencil bursts need
    (a 5-point stencil's k-sweep dependence is the L1 ball |dy|+|dx| <= k)."""
    return exchange_cols(exchange_rows(a, width, row_axis, edge),
                         width, col_axis, edge)


def measure_halo_traffic(config, mesh, axis_name: str = "x",
                         step_builder=None) -> dict:
    """Count the collective traffic of the shard_map step by walking its
    traced jaxpr — a measurement of the actual communication schedule (every
    ``ppermute``/``all_gather`` XLA will emit), not a hand-model.

    Returns per-DEVICE, per-STEP numbers: collective op counts, bytes moved
    between devices, and derived sweeps-per-exchange for the Jacobi stages.  Tracing
    is shape-only, so this works for 8192² without allocating fields.

    ``step_builder(config, mesh)`` overrides the step under measurement
    (e.g. ``shardmap2d.make_shardmap2d_step`` for a rows x cols mesh);
    default is the rows-only ``make_shardmap_step``.
    """
    import numpy as np

    from cudafluidsimulation_tpu.parallel.shardmap_step import make_shardmap_step
    from cudafluidsimulation_tpu.state import FluidState
    from cudafluidsimulation_tpu.utils.impulse import Impulse

    h, w = config.shape
    f32 = jnp.float32
    state = FluidState(
        u=jax.ShapeDtypeStruct((h, w), f32),
        v=jax.ShapeDtypeStruct((h, w), f32),
        dye=jax.ShapeDtypeStruct((3, h, w), f32),
        pressure=jax.ShapeDtypeStruct((h, w), f32),
        t=jax.ShapeDtypeStruct((), f32),
        press_time=jax.ShapeDtypeStruct((), f32),
        time_since_press=jax.ShapeDtypeStruct((), f32),
        mouse=jax.ShapeDtypeStruct((2,), f32),
        step=jax.ShapeDtypeStruct((), jnp.int32),
        vel_stats=jax.ShapeDtypeStruct((2,), f32),
    )
    imp = Impulse(
        pos=jax.ShapeDtypeStruct((2,), f32),
        last_pos=jax.ShapeDtypeStruct((2,), f32),
        pressed=jax.ShapeDtypeStruct((), jnp.bool_),
        dt=jax.ShapeDtypeStruct((), f32),
    )
    if step_builder is not None:
        step = step_builder(config, mesh)
    else:
        step = make_shardmap_step(config, mesh, axis_name)
    jaxpr = jax.make_jaxpr(step)(state, imp)

    counts = {"ppermute": 0, "all_gather": 0, "bytes": 0}

    def visit(jx, mult):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if name in ("ppermute", "all_gather"):
                counts[name] += mult
                for v in eqn.invars:
                    aval = getattr(v, "aval", None)
                    if aval is not None and aval.shape:
                        counts["bytes"] += mult * int(
                            np.prod(aval.shape)) * aval.dtype.itemsize
            # a collective inside a scan body executes once per trip: carry
            # the trip count down (counting it once would undercount a
            # sweep-per-exchange schedule iters-fold)
            m = mult * eqn.params.get("length", 1) if name == "scan" else mult
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "eqns"):  # raw Jaxpr (e.g. shard_map)
                        visit(sub, m)
                    elif hasattr(sub, "jaxpr"):  # ClosedJaxpr (jit/scan)
                        visit(sub.jaxpr, m)

    visit(jaxpr.jaxpr, 1)

    jacobi_sweeps = (config.diffusion_iters
                     * (5 if config.color_diffusion_enabled else 2)
                     + config.pressure_iters)
    pairs = counts["ppermute"] // 2  # exchange_rows = one up + one down
    return {
        "ppermute_per_step": counts["ppermute"],
        "exchange_pairs_per_step": pairs,
        "all_gather_per_step": counts["all_gather"],
        "halo_bytes_per_step_per_device": counts["bytes"],
        "jacobi_sweeps_per_step": jacobi_sweeps,
        # sweeps per exchange over ALL exchanges (advect/vorticity included),
        # i.e. a lower bound on the Jacobi stages' burst depth
        "sweeps_per_exchange_pair": round(jacobi_sweeps / max(1, pairs), 3),
    }


def shift_x_clamped(a: jnp.ndarray, d: int) -> jnp.ndarray:
    """x (lane) shifts never cross shards — plain clamped shift."""
    from cudafluidsimulation_tpu.ops.stencil import shift_x

    return shift_x(a, d)


def neighbors_padded(ap: jnp.ndarray, width: int = 1) -> Tuple[jnp.ndarray, ...]:
    """(left, right, below, above) for the un-padded core of an
    ``exchange_rows``-padded array (y-neighbors come from the halo)."""
    hl = ap.shape[-2] - 2 * width
    core = ap[..., width : width + hl, :]
    left = shift_x_clamped(core, -1)
    right = shift_x_clamped(core, 1)
    below = ap[..., width - 1 : width - 1 + hl, :]
    above = ap[..., width + 1 : width + 1 + hl, :]
    return left, right, below, above
