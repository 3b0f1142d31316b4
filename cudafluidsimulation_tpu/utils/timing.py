"""Per-stage timing and the end-of-run report.

The reference hand-rolls running averages around every stage with
``cudaDeviceSynchronize`` between kernels (cpuFluidSim.cpp:329-385,
GPUFluidSim.cu:609-712) and prints a report at exit (Main.cpp:183-206).
Syncing inside the hot loop would drain the device's queue, so the
production path times whole jitted ``lax.scan`` segments; this module
provides (a) that whole-loop timing and (b) an out-of-band per-stage
breakdown that runs each stage as its own jitted function purely for
reporting — never inside the hot loop.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import jax


@dataclass
class StageReport:
    grid: str
    steps: int
    total_s: float
    stage_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.total_s if self.total_s > 0 else float("inf")

    def format(self) -> str:
        # Same shape as the reference's exit report (Main.cpp:195-206).
        lines = [
            "================ SIMULATION END ======================",
            f"Grid: {self.grid}   Steps: {self.steps}",
            "------------------------------------------------------",
            f"Average compute time: {1000.0 * self.total_s / max(1, self.steps):.3f}ms / step",
            f"Throughput: {self.steps_per_sec:.1f} steps/s",
            "------------------------------------------------------",
        ]
        for name, ms in self.stage_ms.items():
            lines.append(f"{name} compute time: {ms:.3f}ms")
        lines.append("======================================================")
        return "\n".join(lines)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall seconds per call of a jitted fn, each call ended by
    ``block_until_ready``.  Dispatch overhead is included, so time long
    scans this way; for individual stages use :func:`time_scanned`."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_scanned(body, init_carry, n: int = 24, iters: int = 3,
                 warmup: int = 1) -> float:
    """Median wall seconds per application of ``body`` measured as one
    jitted ``lax.scan`` of ``n`` applications (one dispatch amortized over
    ``n``), each run ended by ``block_until_ready``.

    ``body(carry, eps) -> carry`` must thread its output back into its input
    so XLA cannot hoist or CSE the iterations; ``eps`` is a traced f32 scalar
    that is 0.0 at runtime — mix loop-invariant operands with ``x + eps * y``
    to create a formal (value-preserving) dependence on the previous
    iteration.
    """
    import jax.numpy as jnp

    @jax.jit
    def run(carry, epss):
        return jax.lax.scan(lambda c, e: (body(c, e), None), carry, epss)[0]

    epss = jnp.zeros((n,), jnp.float32)
    return time_fn(run, init_carry, epss, iters=iters, warmup=warmup) / n
