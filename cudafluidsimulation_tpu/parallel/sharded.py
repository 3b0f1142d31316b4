"""Multi-device scaling over a ``jax.sharding.Mesh``.

The reference is strictly single-GPU (SURVEY.md §2: no NCCL/MPI anywhere);
this module is where the rebuild *exceeds* it (BASELINE.json config 5:
8192² across a device mesh).

Auto-SPMD design: spatial domain decomposition by grid rows over a 1-D or
2-D mesh ("ens" x "x"), expressed with ``NamedSharding`` annotations on the
state pytree + jit.  XLA's SPMD partitioner turns the clamped-edge shifts
(concat/slice stencils in ops.stencil) into 1-cell collective-permute halo
exchanges automatically; the semi-Lagrangian gather is the one op it may
all-gather (parallel.shardmap_step bounds it with a d-row halo).  Ensemble
members ride the "ens" axis — pure data parallelism.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.models.pipelines import make_step
from cudafluidsimulation_tpu.state import FluidState
from cudafluidsimulation_tpu.utils.impulse import Impulse


def make_mesh(
    n_devices: Optional[int] = None, ens: int = 1,
    axis_names: Tuple[str, str] = ("ens", "x"), devices=None,
) -> Mesh:
    """Build an (ens, x) device mesh; "x" shards grid rows, "ens" shards
    independent ensemble members."""
    devs = devices if devices is not None else jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if n % ens != 0:
        raise ValueError(f"n_devices={n} not divisible by ens={ens}")
    arr = np.asarray(devs[:n]).reshape(ens, n // ens)
    return Mesh(arr, axis_names)


def state_sharding(mesh: Mesh, batched: bool = False) -> FluidState:
    """A FluidState of NamedShardings: fields row-sharded over "x",
    scalars replicated, optional leading ensemble axis over "ens"."""
    e = ("ens",) if batched else ()

    def ns(*spec):
        return NamedSharding(mesh, P(*e, *spec))

    plane = ns("x", None)
    return FluidState(
        u=plane,
        v=plane,
        dye=ns(None, "x", None),
        pressure=plane,
        t=ns(),
        press_time=ns(),
        time_since_press=ns(),
        mouse=ns(None),
        step=ns(),
        vel_stats=ns(None),
    )


def impulse_sharding(mesh: Mesh, batched: bool = False, time_axis: bool = True) -> Impulse:
    e = ("ens",) if batched else ()
    t = (None,) if time_axis else ()

    def ns(*spec):
        return NamedSharding(mesh, P(*e, *t, *spec))

    return Impulse(pos=ns(None), last_pos=ns(None), pressed=ns(), dt=ns())


def shard_state(state: FluidState, mesh: Mesh, batched: bool = False) -> FluidState:
    return jax.device_put(state, state_sharding(mesh, batched))


def _check_partitionable(config: FluidConfig, mesh: Mesh) -> None:
    """XLA's SPMD partitioner cannot split the CUDA kernel's custom call (it
    would replicate the whole field on every device), so on a >1-device
    mesh this path takes the jnp ops only; the shard_map paths
    (parallel.shardmap_step / shardmap2d) run the kernel per shard."""
    if mesh.size > 1 and config.resolve_backend() != "ref":
        raise ValueError(
            "the auto-SPMD path partitions the jnp ops: pass backend='ref', "
            "or use parallel.shardmap_step / shardmap2d for the kernel")


def make_sharded_step(config: FluidConfig, mesh: Mesh, batched: bool = False):
    """jit-compiled step with explicit input/output shardings.

    With ``batched`` the step is vmapped over a leading ensemble axis and the
    batch rides the "ens" mesh axis while rows ride "x" — the 2-D
    (dp x sp)-style layout.
    """
    _check_partitionable(config, mesh)
    step = make_step(config)
    if batched:
        step = jax.vmap(step)
    ss = state_sharding(mesh, batched)
    imps = impulse_sharding(mesh, batched, time_axis=False)
    return jax.jit(step, in_shardings=(ss, imps), out_shardings=ss)


def sharded_rollout(config: FluidConfig, mesh: Mesh, batched: bool = False):
    """jit-compiled lax.scan rollout with sharded carry."""
    _check_partitionable(config, mesh)
    step = make_step(config)
    if batched:
        step = jax.vmap(step)

    def run(state, impulses):
        if batched:
            # time axis second: (B, T, ...) -> scan over T
            impulses = jax.tree.map(lambda x: jnp.moveaxis(x, 0, 1), impulses)
        final, _ = jax.lax.scan(lambda s, i: (step(s, i), None), state, impulses)
        return final

    ss = state_sharding(mesh, batched)
    imps = impulse_sharding(mesh, batched, time_axis=True)
    return jax.jit(run, in_shardings=(ss, imps), out_shardings=ss)
