"""2-D (rows x cols) spatial-mesh rollout on a 2x2 mesh: four GPUs of one
host, or four virtual CPU devices.

    python examples/multichip_2d.py                    # four GPUs
    JAX_PLATFORMS=cpu python examples/multichip_2d.py  # four CPU devices
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# four host devices for the CPU platform, set BEFORE jax initializes (it
# changes nothing on the GPUs)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax
import numpy as np


def main():
    from cudafluidsimulation_tpu import FluidConfig, init_state
    from cudafluidsimulation_tpu.parallel.halo import measure_halo_traffic
    from cudafluidsimulation_tpu.parallel.shardmap2d import (
        make_mesh2d,
        make_shardmap2d_rollout,
        make_shardmap2d_step,
        shard_state_2d,
    )
    from cudafluidsimulation_tpu.utils.impulse import orbit_impulse

    devs = jax.devices()
    mesh = make_mesh2d(2, 2, devices=devs)
    print(f"mesh: 2x2 over {devs[0].platform} devices")

    n = 512
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, diffusion_iters=4,
                                    pressure_iters=10)
    run = make_shardmap2d_rollout(cfg, mesh)
    state = shard_state_2d(init_state(cfg), mesh)
    imp = orbit_impulse(50, cfg.dt, center=(n / 2, n / 2), radius=n / 8)
    out = run(state, imp)
    print("50 steps done; max |u| =", float(np.abs(np.asarray(out.u)).max()))

    traffic = measure_halo_traffic(cfg, mesh,
                                   step_builder=make_shardmap2d_step)
    print("per-device per-step collective schedule:", traffic)


if __name__ == "__main__":
    main()
