"""Simulation configuration.

The reference has no config system at all: the CPU module's parameters are
file-scope globals (cpuFluidSim.cpp:25-29) and the GPU module's live in a
``Config`` struct uploaded to ``__constant__`` memory with defaults baked into
``setConfig`` (GPUFluidSim.cu:30-73).  This dataclass mirrors *both* parameter
sets; ``FluidConfig.cpu_reference()`` / ``FluidConfig.gpu_reference()`` build
the exact configurations the reference ships.

Notes on reference quirks this config encodes deliberately:
  - ``config.pressure`` (GPUFluidSim.cu:33, default 1.5) is dead config — no
    kernel ever reads it.  We do not carry it.
  - ``SystemConfig.velocityIterations/pressureIterations`` (GPUFluidSim.cu:45-46)
    are dead too — the CUDA kernels hardcode 20/30 in their loops (:349, :409,
    :477).  Here the iteration counts are real, live config.
  - The CPU path's color diffusion is an observable no-op (the 5-iteration loop
    at cpuFluidSim.cpp:210-224 never swaps buffers), so
    ``color_diffusion_enabled=False`` for the cpu variant.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# 7-entry dye palette cycled through while the impulse is pressed
# (cpuFluidSim.cpp:66-72 / GPUFluidSim.cu:133-139).
PALETTE: Tuple[Tuple[float, float, float], ...] = (
    (1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0),
    (1.0, 0.0, 1.0),
    (1.0, 1.0, 0.0),
    (0.0, 1.0, 1.0),
    (1.0, 0.0, 1.0),
    (1.0, 0.5, 0.3),
)


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    """Static configuration for one simulation.

    All fields are Python scalars so a config hashes as a jit static argument.
    """

    # Grid size (cells). The reference derives this from window/scale
    # (Main.cpp:13-21): CPU 1024/8 = 128², GPU 1920/2 x 1080/2 = 960x540.
    nx: int = 256
    ny: int = 256

    # Physics-pipeline parity variant: "cpu" replicates cpuFluidSim.cpp's
    # stage order/constants, "gpu" replicates GPUFluidSim.cu's.
    variant: str = "gpu"

    # Op backend: "ref" = pure-jnp oracle compiled by XLA, "cuda" = ref with
    # the Jacobi sweeps in the CUDA kernel (ops/jacobi_cuda.py, GPU only),
    # "auto" = cuda on a GPU else ref.
    backend: str = "auto"

    # Fixed headless timestep. The reference uses the real frame dt
    # (Main.cpp:135-136); a fixed dt keeps headless dynamics reproducible.
    dt: float = 1.0 / 60.0

    # Jacobi diffusion coefficients: alpha = k^2/dt, beta = 4+alpha
    # (cpuFluidSim.cpp:184-185 / GPUFluidSim.cu:344-345,404-405).
    velocity_diffusion: float = 0.8
    color_diffusion: float = 0.8
    # Exponential advection decay rate: decay = 1/(1 + rate*dt). The CPU path
    # calls it aDecay=1.2 (cpuFluidSim.cpp:29,159); the GPU path reuses
    # densityDiffusion=1.2 for the same purpose (GPUFluidSim.cu:262,281).
    decay_rate: float = 1.2

    # Vorticity confinement strength: CPU 0.35 (cpuFluidSim.cpp:26),
    # GPU 50 (GPUFluidSim.cu:54).
    vorticity: float = 50.0

    # Gaussian splat force scale: CPU 500 (cpuFluidSim.cpp:318),
    # GPU 5000 (GPUFluidSim.cu:57,657-659).
    force_scale: float = 5000.0
    # Gaussian denominator: CPU hardcodes 10 (cpuFluidSim.cpp:317,320); GPU
    # uses radius=1600/scale^2 = 400 at the shipped scale=2 (GPUFluidSim.cu:59,146).
    splat_radius: float = 400.0

    # Jacobi iteration counts. CPU: 5/5 (cpuFluidSim.cpp:25,187,210,247);
    # GPU: 20 diffusion (GPUFluidSim.cu:349,409), 30 pressure (:477).
    diffusion_iters: int = 20
    pressure_iters: int = 30

    # Pressure solver: "jacobi" = the reference's fixed-sweep iteration
    # (parity); "multigrid" = V-cycle solver (beyond-parity fast mode,
    # ops/multigrid.py) — far better converged per FLOP, not bit-parity.
    pressure_solver: str = "jacobi"
    mg_cycles: int = 2
    # Residual-targeted multigrid stopping: when > 0, V-cycles run until
    # rms(A p + div) < mg_tol (at most mg_max_cycles, at least 1) instead of
    # the fixed mg_cycles count.  Uses lax.while_loop, so the cycle count is
    # dynamic per step with no recompiles.
    mg_tol: float = 0.0
    mg_max_cycles: int = 8

    # CPU path zeroes rows y=0..10 every step (cpuFluidSim.cpp:387-394);
    # the GPU path has no such strip.
    boundary_rows: int = 0

    # The CPU path's color diffusion never swaps buffers -> observable no-op
    # (cpuFluidSim.cpp:210-224); set False to replicate that bug faithfully.
    color_diffusion_enabled: bool = True

    # Divergence stencil scaling: GPU multiplies by 0.5 (GPUFluidSim.cu:309),
    # CPU does not (cpuFluidSim.cpp:241-243).
    half_divergence: bool = True

    # Bloom post-effect (GPU only): GPUFluidSim.cu:576-591, gated on
    # timeSincePress < 5 s (:699).
    bloom_enabled: bool = True
    bloom_intense: float = 0.1
    bloom_duration: float = 5.0

    # Advection displacement bound (cells/step) of the shard_map paths,
    # whose halo depth it sizes: sharded backtrace taps clamp to
    # +/-max_displacement rows (and columns on the 2-D mesh).  The
    # single-device step is unbounded (exact reference parity), so the same
    # config differs single-device vs sharded wherever |velocity|*dt exceeds
    # this bound; utils/health.py flags clamped backtraces via its max-speed
    # check.
    max_displacement: int = 15

    def __post_init__(self):
        if self.variant not in ("cpu", "gpu"):
            raise ValueError(f"variant must be 'cpu' or 'gpu', got {self.variant!r}")
        if self.backend not in ("ref", "cuda", "auto"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.pressure_solver not in ("jacobi", "multigrid"):
            raise ValueError(f"unknown pressure_solver {self.pressure_solver!r}")
        if self.diffusion_iters < 0 or self.pressure_iters < 0:
            raise ValueError("iteration counts must be >= 0")
        if self.mg_cycles < 1:
            # 0 cycles would silently skip the pressure solve entirely
            raise ValueError("mg_cycles must be >= 1")
        if self.mg_tol < 0:
            raise ValueError("mg_tol must be >= 0 (0 = fixed mg_cycles)")
        if self.mg_max_cycles < 1:
            raise ValueError("mg_max_cycles must be >= 1")
        if self.max_displacement < 1:
            raise ValueError("max_displacement must be >= 1")

    # -- reference configurations -------------------------------------------

    @staticmethod
    def cpu_reference(nx: int = 128, ny: int = 128, **overrides) -> "FluidConfig":
        """The reference CPU backend's exact parameter set.

        1024x1024 window / SCALE=8 -> 128² grid (Main.cpp:18-20);
        globals at cpuFluidSim.cpp:25-29.
        """
        kw = dict(
            nx=nx,
            ny=ny,
            variant="cpu",
            velocity_diffusion=0.8,
            color_diffusion=0.8,
            decay_rate=1.2,
            vorticity=0.35,
            force_scale=500.0,
            splat_radius=10.0,
            diffusion_iters=5,
            pressure_iters=5,
            boundary_rows=11,
            color_diffusion_enabled=False,
            half_divergence=False,
            bloom_enabled=False,
        )
        kw.update(overrides)
        return FluidConfig(**kw)

    @staticmethod
    def gpu_reference(nx: int = 960, ny: int = 540, **overrides) -> "FluidConfig":
        """The reference GPU backend's exact parameter set.

        1920x1080 window / SCALE=2 -> 960x540 grid (Main.cpp:14-16);
        setConfig defaults at GPUFluidSim.cu:51-73 with radius scaled by
        1/scale² at init (:146).
        """
        kw = dict(
            nx=nx,
            ny=ny,
            variant="gpu",
            velocity_diffusion=0.8,
            color_diffusion=0.8,
            decay_rate=1.2,
            vorticity=50.0,
            force_scale=5000.0,
            splat_radius=400.0,
            diffusion_iters=20,
            pressure_iters=30,
            boundary_rows=0,
            color_diffusion_enabled=True,
            half_divergence=True,
            bloom_enabled=True,
        )
        kw.update(overrides)
        return FluidConfig(**kw)

    @staticmethod
    def quality(nx: int = 2048, ny: int = 2048, **overrides) -> "FluidConfig":
        """Beyond-parity "quality" preset (CLI ``--preset quality``).

        Same physics pipeline as :meth:`gpu_reference` but with the two
        accuracy knobs the parity config leaves on the table (BASELINE.md
        "Solver frontier"):

        - multigrid pressure with residual-targeted stopping
          (rms(A p + div) < 0.05 — ~14x below what 40 Jacobi sweeps leave
          at 2048², usually 2 V-cycles) instead of fixed sweeps that stall
          on low-frequency error;
        - ``max_displacement=31``: the sharded paths' advection bound
          covers |v|*dt up to 31 cells/step (the driven 2048² orbit flow
          peaks at ~22), so their backtraces are exact rather than clamped
          (the single-device step is never bounded).
        """
        kw = dict(
            pressure_solver="multigrid",
            mg_tol=0.05,
            max_displacement=31,
        )
        kw.update(overrides)
        return FluidConfig.gpu_reference(nx=nx, ny=ny, **kw)

    # -- derived ------------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        """(ny, nx) — fields are (H, W) row-major, y is the row axis."""
        return (self.ny, self.nx)

    def palette_array(self) -> np.ndarray:
        return np.asarray(PALETTE, dtype=np.float32)

    def resolve_backend(self) -> str:
        """The op backend this config runs on JAX's default device; raises
        when ``backend="cuda"`` is forced where there is no GPU (the kernel
        has no interpret mode, and nothing falls back to ``ref``)."""
        import jax

        on_gpu = jax.default_backend() == "gpu"
        if self.backend == "auto":
            return "cuda" if on_gpu else "ref"
        if self.backend == "cuda" and not on_gpu:
            raise ValueError(
                "backend='cuda' needs a GPU, but JAX's default backend is "
                f"{jax.default_backend()!r}; use backend='ref' or 'auto'")
        return self.backend
