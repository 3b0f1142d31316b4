"""Backend resolution: one op API, two implementations.

Mirrors the reference's interchangeable c_/g_ backend split (cpuFluidSim.h:8-11
vs GPUFluidSIm.cuh:12-15) as a namespace of pure functions with identical
signatures, selected by config.  ``ref`` is the pure-jnp oracle, compiled by
XLA; ``cuda`` overrides the Jacobi stages with the temporal-blocked CUDA
kernel (ops/jacobi_cuda.py) and keeps ``ref`` for the rest.
"""

from __future__ import annotations

import types

from cudafluidsimulation_tpu.config import FluidConfig
from cudafluidsimulation_tpu.ops import ref as _ref

_OP_NAMES = [
    "bilerp",
    "advect_velocity",
    "advect_dye",
    "curl",
    "vorticity_confinement_cpu",
    "vorticity_confinement_gpu",
    "diffuse",
    "diffuse_multi",
    "diffuse_multi_splat",
    "divergence",
    "pressure_solve",
    "pressure_solve_mg",
    "pressure_project",
    "project",
    "splat_cpu",
    "splat_gpu",
    "cycle_color",
    "boundary_strip",
    "pack_rgba",
    "apply_bloom",
    "render_frame",
]


def _namespace(module, overrides=None) -> types.SimpleNamespace:
    ns = types.SimpleNamespace()
    for name in _OP_NAMES:
        fn = getattr(module, name)
        if overrides and name in overrides:
            fn = overrides[name]
        setattr(ns, name, fn)
    # optional hooks beyond the base API (e.g. advect_both): consumed via
    # getattr by models/pipelines.py
    for name, fn in (overrides or {}).items():
        if name not in _OP_NAMES:
            setattr(ns, name, fn)
    return ns


def get_ops(config: FluidConfig) -> types.SimpleNamespace:
    backend = config.resolve_backend()
    if backend == "ref":
        return _namespace(_ref)
    if backend == "cuda":
        from cudafluidsimulation_tpu.ops import jacobi_cuda

        return _namespace(_ref, overrides=jacobi_cuda.overrides())
    raise ValueError(f"unknown backend {backend!r}")
