"""Exact temporal-blocked Jacobi sweeps on the GPU (backend ``"cuda"``).

The CUDA kernel in ``native/jacobi.cu`` loads a tile of each channel into
shared memory with a K-cell halo and runs K sweeps there before writing the
tile's core back, so the field makes one trip to device memory per K sweeps
instead of one per sweep.  Sweep s updates only the cells at least s cells
inside the tile edge, so the core is global Jacobi (``ops.ref.diffuse_multi``
and ``ops.ref.pressure_solve``) up to FMA contraction; the clamped-edge
Neumann neighbours are applied at the true domain edges on every sweep.

The library is built from ``native/jacobi.cu`` at first use
(``make -C native libjacobi.so``, which needs ``nvcc``) and its two handlers
are registered with XLA as FFI targets.  There is no interpret mode: off the
GPU, ``FluidConfig.resolve_backend`` refuses ``backend="cuda"``.

No gradient rule is defined: nothing differentiates the step.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from cudafluidsimulation_tpu.ops import ref as _ref

# (TH, TW, K) per mode: a TH x TW output tile per block, loaded with a K-cell
# halo, K sweeps per launch.  Each must be one of native/jacobi.cu's
# FLUIDS_JACOBI_TILES.  Chosen on an NVIDIA H100 80GB HBM3 at its 700 W
# power limit, ms per call (median of 5, random fields, seed 0):
#
#   tile (TH, TW, K)   diffuse 5ch x 20 sweeps        pressure sweeps
#                      960x540   2048^2   8192^2     30 @960x540  40 @2048^2  100 @8192^2
#   (32, 64, 4)        0.1979    1.1606   17.1102    0.1210       0.5590      16.8621
#   (32, 64, 8)        0.1991    1.1178   16.5809    0.1116       0.5505      18.0144
#   (32, 128, 8)       0.1862    0.9581   13.8720    0.1415       0.6184      21.3551
#   (64, 64, 8)        0.2400    1.1315   16.5087    0.1346       0.5581      17.2613
#   (64, 128, 8)       0.2371    1.2266   17.4894    0.1712       0.8817      33.5964
#   (64, 128, 16)      0.3179    2.0751   30.9369    0.1748       0.7824      28.6007
#   XLA (ops.ref)      0.3971    2.5259   36.9034    0.5212       1.2970      45.0093
TILE = {
    "diffuse": (32, 128, 8),
    "pressure": (32, 64, 8),
}
SMEM_LIMIT_BYTES = 227 * 1024  # per block on sm_90

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB = "libjacobi.so"
_DIFFUSE = "fluids_jacobi_diffuse"
_PRESSURE = "fluids_jacobi_pressure"


def tile_plan(n: int, h: int, w: int, iters: int, mode: str) -> dict:
    """The launch geometry ``native/jacobi.cu`` uses for ``n`` channels of
    an ``h x w`` field and ``iters`` sweeps: the grid (blocks along x, y and
    channels), the launches (one per K sweeps) and each block's shared
    memory (two ping-pong tiles, plus the rhs tile for pressure)."""
    th, tw, k = TILE[mode]
    tiles = 3 if mode == "pressure" else 2
    return {
        "grid": (-(-w // tw), -(-h // th), n),
        "launches": -(-iters // k),
        "smem_bytes": tiles * 4 * (th + 2 * k) * (tw + 2 * k),
    }


@functools.cache
def _register() -> None:
    """Build ``native/libjacobi.so`` if it is missing or stale, load it and
    register its handlers with XLA, once per process."""
    proc = subprocess.run(
        ["make", "-C", _NATIVE_DIR, _LIB,
         f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building {_LIB} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.cdll.LoadLibrary(os.path.join(_NATIVE_DIR, _LIB))
    jax.ffi.register_ffi_target(
        _DIFFUSE, jax.ffi.pycapsule(lib.FluidsJacobiDiffuse), platform="CUDA")
    jax.ffi.register_ffi_target(
        _PRESSURE, jax.ffi.pycapsule(lib.FluidsJacobiPressure),
        platform="CUDA")


def _call(target: str, mode: str, like, args, iters: int, **attrs):
    """One FFI call of ``iters`` sweeps.  Under vmap every input gains the
    batch axis (``broadcast_all``), and the handler folds all leading axes
    into channels.  Under shard_map the results vary over the same mesh
    axes as ``like``.  The second result is the kernel's ping-pong
    scratch."""
    _register()
    th, tw, k = TILE[mode]
    aval = jax.typeof(like)
    spec = jax.ShapeDtypeStruct(like.shape, jnp.float32,
                                sharding=aval.sharding, vma=aval.vma)
    out, _ = jax.ffi.ffi_call(target, (spec, spec),
                              vmap_method="broadcast_all")(
        *args, iters=np.int32(iters), th=np.int32(th), tw=np.int32(tw),
        k=np.int32(k), **attrs)
    return out


def _diffuse_alpha(fields, alpha, iters: int):
    """Sweeps of ``(l + r + b + t + alpha[c] x) * inv_beta[c]`` over the
    (C, H, W) ``fields`` with ``alpha`` of shape (C,), computed exactly as
    ``ops.ref.diffuse_multi`` computes its coefficients."""
    if iters == 0:
        return fields
    inv_beta = 1.0 / (4.0 + alpha)
    return _call(_DIFFUSE, "diffuse", fields, (fields, alpha, inv_beta), iters)


def diffuse(fields, dt, diffusion, iters: int):
    """``ops.ref.diffuse``: one coefficient for every channel of the
    (..., H, W) ``fields``."""
    h, w = fields.shape[-2:]
    x = fields.reshape((-1, h, w))
    alpha = jnp.broadcast_to(
        jnp.asarray(diffusion * diffusion / dt, jnp.float32), x.shape[:1])
    return _diffuse_alpha(x, alpha, iters).reshape(fields.shape)


def diffuse_multi(fields, dt, coeffs, iters: int):
    """``ops.ref.diffuse_multi``: a coefficient per channel of (C, H, W)."""
    coeffs = jnp.asarray(coeffs, jnp.float32)
    return _diffuse_alpha(fields, coeffs * coeffs / dt, iters)


def diffuse_multi_splat(fields, dt, coeffs, iters: int, amps, last, radius):
    """``ops.ref.diffuse_multi_splat``: the kernel's diffusion, then the
    splat tail, which XLA fuses into one pass."""
    f = diffuse_multi(fields, dt, coeffs, iters)
    xs, ys = _ref.coord_grids(fields.shape[-2], fields.shape[-1])
    return _ref.splat_tail(f, amps, last, radius, xs, ys)


def pressure_solve(div, iters: int, init=None):
    """``ops.ref.pressure_solve``: ``iters`` sweeps of
    ``p = (l + r + b + t - div) / 4`` from ``init`` (zero when None; the
    kernel then does not read its first input)."""
    if iters == 0:
        return jnp.zeros_like(div) if init is None else init
    p0 = div if init is None else init
    return _call(_PRESSURE, "pressure", div, (p0, div), iters,
                 zero_init=np.bool_(init is None))


def pressure_project(u, v, iters: int, half: bool, *,
                     return_stats: bool = False):
    """``ops.ref.pressure_project`` with the kernel's pressure solve; the
    divergence and the projection stay single XLA fusions."""
    d = _ref.divergence(u, v, half)
    p = pressure_solve(d, iters)
    if return_stats:
        u2, v2, st = _ref.project(u, v, p, return_stats=True)
        return u2, v2, p, st
    u2, v2 = _ref.project(u, v, p)
    return u2, v2, p


def overrides() -> dict:
    """The ops this backend replaces in the ``ops.ref`` namespace."""
    return {
        "diffuse": diffuse,
        "diffuse_multi": diffuse_multi,
        "diffuse_multi_splat": diffuse_multi_splat,
        "pressure_solve": pressure_solve,
        "pressure_project": pressure_project,
    }
