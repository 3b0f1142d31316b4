"""A 2D Eulerian stable-fluids engine in JAX, run on an NVIDIA GPU.

A framework with the capabilities of the reference CUDA simulator
(Gianluca-Iacchini/CudaFluidSimulation): per step — semi-Lagrangian advection
of velocity and dye, vorticity confinement, Jacobi diffusion, Gaussian
force/dye splats, divergence -> Jacobi pressure solve -> gradient subtraction,
boundary conditions, device-side RGBA colormapping with optional bloom.

Design:
  - ``FluidState`` pytree + pure ``step`` functions; ``lax.scan`` under one jit.
  - Interchangeable op backends behind one API (mirroring the reference's
    c_/g_ split, cpuFluidSim.h:8-11 / GPUFluidSIm.cuh:12-15): ``ref`` (pure
    jnp numerics oracle, compiled by XLA) and ``cuda`` (``ref`` with the
    Jacobi sweeps in a temporal-blocked CUDA kernel).
  - Two parity *variants* of the physics pipeline: ``cpu`` replicates the
    reference CPU module's parameters/quirks (cpuFluidSim.cpp) and ``gpu``
    the CUDA module's (GPUFluidSim.cu).
  - Scripted impulse streams replace mouse callbacks; rendering is device-side
    RGBA (no OpenGL); ensembles via vmap; multi-device via shard_map + halo
    exchange over a ``jax.sharding.Mesh``.
"""

from cudafluidsimulation_tpu.config import FluidConfig, PALETTE
from cudafluidsimulation_tpu.state import FluidState, init_state
from cudafluidsimulation_tpu.models.pipelines import make_step
from cudafluidsimulation_tpu.models.simulation import Simulation, run_scan
from cudafluidsimulation_tpu.utils.impulse import (
    Impulse,
    no_impulse,
    constant_impulse,
    orbit_impulse,
    mouse_to_grid,
)

__all__ = [
    "FluidConfig",
    "PALETTE",
    "FluidState",
    "init_state",
    "make_step",
    "Simulation",
    "run_scan",
    "Impulse",
    "no_impulse",
    "constant_impulse",
    "orbit_impulse",
    "mouse_to_grid",
]

__version__ = "0.1.0"
