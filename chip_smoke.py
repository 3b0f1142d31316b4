"""Run the stable-fluids step on NVIDIA GPUs and check what comes out.

    python chip_smoke.py          # one GPU: main path, correctness, kernel,
                                  # and the tests marked ``gpu``
    python chip_smoke.py --four   # four GPUs: the sharded 8192² meshes
                                  # against one GPU, and nothing else

Everything runs in this one process (a second JAX process would find most
of the card's memory already reserved).  Prints the card's name and power
limit first, then each phase's checks and rates, and as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

It exits non-zero without printing that line when JAX finds no GPU, when
the package is not beside it, or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, ".smoke_out")

# Tolerances (max |got - want| over max |want|, unless stated).  No matrix
# product is on this path (the package has no dot/einsum), so TF32 cannot
# enter; the comparisons still run under default_matmul_precision("highest")
# in case one appears.
#   - one gpu-parity step, card vs CPU: the card's Jacobi kernel contracts to
#     FMA and XLA fuses in another order, so sums differ in the last bits;
#     the gpu-parity vorticity divides by |grad |w|| + 1e-3, which magnifies
#     such differences up to ~1e3-fold where that gradient vanishes.
TOL_ONE_STEP = 1e-3
#   - 20 mild steps (vorticity 0.5, force 500: not chaotic), card vs CPU.
TOL_MILD = 1e-4
#   - the north-star bound of tests/test_northstar.py: field RMSE vs the
#     NumPy oracle of the reference CPU path over 500 steps.
TOL_NORTHSTAR_RMSE = 1e-4
#   - kernel vs ops.ref on the same card: last-bit differences per sweep
#     (FMA), relative to 1 + max|want|, for up to 100 sweeps.
TOL_KERNEL = 1e-5
#   - sharded vs one card after 5 gpu-parity steps: the same per-cell
#     arithmetic, but XLA fuses the stencils around the halo exchanges
#     differently (FMA contraction), and the chaotic gpu-parity vorticity
#     amplifies those last-bit differences step by step.
TOL_SHARDED = 1e-4


def _cards() -> list:
    """One "name, power.limit" line per visible card, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def _rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _rate(run, state, imp, steps, reps=5) -> float:
    """Median steps/s of ``run(state, imp)`` after one warm-up call."""
    from cudafluidsimulation_tpu.utils.timing import time_fn

    return steps / time_fn(run, state, imp, iters=reps, warmup=1)


def _median_ms(fn, x, reps=10, n=5) -> float:
    """Median ms per application of ``fn`` over a jitted ``reps`` loop."""
    import jax

    from cudafluidsimulation_tpu.utils.timing import time_fn

    f = jax.jit(lambda x: jax.lax.fori_loop(0, reps, lambda i, y: fn(y), x))
    return 1e3 * time_fn(f, x, iters=n, warmup=1) / reps


def _check_fields(state, label):
    import numpy as np

    for name in ("u", "v", "dye", "pressure"):
        a = np.asarray(getattr(state, name))
        assert np.isfinite(a).all(), f"{label}: non-finite {name}"
    dye = np.asarray(state.dye)
    assert dye.min() >= 0.0 and dye.max() <= 2.0, (
        f"{label}: dye outside [0, 2]: [{dye.min()}, {dye.max()}]")


def _png_header(path):
    """(width, height, bit depth, colour type) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(29)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", path
    w, h, depth, ctype = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, ctype


# -- phases -----------------------------------------------------------------------


def phase_main_path(card):
    import jax
    import numpy as np

    from cudafluidsimulation_tpu import FluidConfig, Simulation, cli
    from cudafluidsimulation_tpu.utils.impulse import orbit_impulse

    # 2048² gpu-parity through the CLI, as a user runs it
    n, steps, d = 2048, 200, 31
    fields = os.path.join(OUT, "fields_2048.npz")
    frames = os.path.join(OUT, "frames_2048")
    rc = cli.main(["--grid", str(n), "--steps", str(steps),
                   "--pressure-iters", "40", "--max-displacement", str(d),
                   "--impulse", "orbit", "--save-fields", fields,
                   "--frames-dir", frames, "--frame-every", str(steps),
                   "--report"])
    assert rc == 0, f"cli.main returned {rc}"
    z = np.load(fields)
    for name in ("u", "v", "dye", "pressure"):
        assert np.isfinite(z[name]).all(), f"cli 2048^2: non-finite {name}"
    assert 0.0 <= z["dye"].min() and z["dye"].max() <= 2.0, "cli dye range"
    pngs = sorted(os.listdir(frames))
    assert len(pngs) == 1, pngs
    assert _png_header(os.path.join(frames, pngs[0])) == (n, n, 8, 6)
    print(f"main path: cli {n}^2 x{steps} ok, fields finite, dye in "
          f"[{z['dye'].min():.3f}, {z['dye'].max():.3f}], frame {n}x{n} RGBA8")

    cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=40,
                                    max_displacement=d)
    sim = Simulation(cfg)
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=n / 8,
                        omega=3.0)
    final, (dx, dy) = sim.run_displacement(sim.init(), imp)
    _check_fields(final, "2048^2")
    assert max(dx, dy) <= d, f"realized displacement {max(dx, dy)} > {d}"
    rate = _rate(sim.run, sim.init(), imp, steps)
    print(f"main path: 2048^2 backend={cfg.resolve_backend()} "
          f"realized displacement {max(dx, dy)} <= d={d}; "
          f"{rate} steps/s ({1e3 / rate} ms/step) on {card}")

    # the reference's own 960x540 workload through Simulation, with a render
    cfg = FluidConfig.gpu_reference()
    sim = Simulation(cfg)
    imp = orbit_impulse(steps, cfg.dt, center=(480.0, 270.0), radius=67.5,
                        omega=3.0)
    state = sim.run(sim.init(), imp)
    _check_fields(state, "960x540")
    frame = sim.render(state)
    assert frame.shape == (540, 960, 4) and frame.dtype == np.uint8, (
        frame.shape, frame.dtype)
    rate = _rate(sim.run, sim.init(), imp, steps)
    print(f"main path: Simulation(gpu_reference()) 960x540 x{steps} ok, "
          f"frame {frame.shape} {frame.dtype}; {rate} steps/s "
          f"({1e3 / rate} ms/step) on {card}")
    jax.clear_caches()


def phase_correctness():
    import jax
    import numpy as np

    from cudafluidsimulation_tpu import FluidConfig, Simulation
    from cudafluidsimulation_tpu.config import PALETTE
    from cudafluidsimulation_tpu.utils.impulse import orbit_impulse, slice_step

    cpu = jax.devices("cpu")[0]

    def on_cpu(cfg_ref, state, imp, run):
        with jax.default_device(cpu):
            sim = Simulation(cfg_ref)
            st = jax.device_put(state, cpu)
            im = jax.device_put(imp, cpu)
            return (sim.run if run else sim.step)(st, im)

    with jax.default_matmul_precision("highest"):
        # (a) one gpu-parity step from a developed 2048² state
        n = 2048
        cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=40)
        sim = Simulation(cfg)
        imp = orbit_impulse(51, cfg.dt, center=(n / 2, n / 2), radius=n / 8,
                            omega=3.0)
        dev = sim.run(sim.init(), jax.tree.map(lambda f: f[:50], imp))
        one = slice_step(imp, 50)
        got = sim.step(dev, one)
        want = on_cpu(FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=40,
                                                backend="ref"),
                      dev, one, run=False)
        errs = {k: _rel_err(getattr(got, k), getattr(want, k))
                for k in ("u", "v", "dye", "pressure")}
        print(f"correctness (a) one 2048^2 step from a 50-step state, card "
              f"({cfg.resolve_backend()}) vs CPU (ref): max rel err {errs} "
              f"(tol {TOL_ONE_STEP})")
        assert max(errs.values()) <= TOL_ONE_STEP, errs

        # (b) 20 mild steps at 960x540, card vs CPU
        mild = dict(vorticity=0.5, force_scale=500.0)
        cfg = FluidConfig.gpu_reference(**mild)
        sim = Simulation(cfg)
        imp = orbit_impulse(20, cfg.dt, center=(480.0, 270.0), radius=67.5,
                            omega=3.0)
        got = sim.run(sim.init(), imp)
        want = on_cpu(FluidConfig.gpu_reference(backend="ref", **mild),
                      sim.init(), imp, run=True)
        errs = {k: _rel_err(getattr(got, k), getattr(want, k))
                for k in ("u", "v", "dye", "pressure")}
        print(f"correctness (b) 20 mild 960x540 steps, card vs CPU: max rel "
              f"err {errs} (tol {TOL_MILD})")
        assert max(errs.values()) <= TOL_MILD, errs

        # (c) north star on the card: cpu-parity 128² x500 vs NumPy oracle
        sys.path.insert(0, os.path.join(REPO, "tests"))
        import oracle

        cfg = FluidConfig.cpu_reference(nx=128, ny=128)
        sim = Simulation(cfg)
        steps = 500
        imp = orbit_impulse(steps, cfg.dt, center=(64.0, 64.0), radius=20.0,
                            omega=3.0)
        imp_np = jax.tree.map(np.asarray, imp)
        state = sim.init()
        orc = oracle.OracleSim(cfg, PALETTE)
        for i in range(steps):
            state = sim.step(state, slice_step(imp, i))
            orc.step(imp_np.pos[i], imp_np.last_pos[i],
                     bool(imp_np.pressed[i]), float(imp_np.dt[i]))
        rmse = {name: float(np.sqrt(np.mean((np.asarray(got) - exp) ** 2)))
                for name, got, exp in (("u", state.u, orc.u),
                                       ("v", state.v, orc.v),
                                       ("dye", state.dye, orc.dye))}
        print(f"correctness (c) north star on the card "
              f"({cfg.resolve_backend()}), 128^2 x{steps} vs NumPy oracle: "
              f"RMSE {rmse} (bound {TOL_NORTHSTAR_RMSE})")
        assert max(rmse.values()) <= TOL_NORTHSTAR_RMSE, rmse
    jax.clear_caches()


def phase_kernel(card):
    import jax
    import jax.numpy as jnp

    from cudafluidsimulation_tpu import FluidConfig, Simulation
    from cudafluidsimulation_tpu.ops import jacobi_cuda as jc
    from cudafluidsimulation_tpu.ops import ref
    from cudafluidsimulation_tpu.utils.impulse import orbit_impulse

    dt = jnp.float32(1.0 / 60.0)
    coeffs = jnp.asarray([0.8] * 5, jnp.float32)
    key = jax.random.PRNGKey(0)
    sizes = [(540, 960, 30), (2048, 2048, 40), (8192, 8192, 100)]
    with jax.default_matmul_precision("highest"):
        for h, w, pit in sizes:
            kx, kd = jax.random.split(jax.random.fold_in(key, h))
            x = jax.random.normal(kx, (5, h, w), jnp.float32)
            div = jax.random.normal(kd, (h, w), jnp.float32)
            pairs = {
                "diffuse 5ch x20": (
                    lambda y: jc.diffuse_multi(y, dt, coeffs, 20),
                    lambda y: ref.diffuse_multi(y, dt, coeffs, 20), x),
                f"pressure x{pit}": (
                    lambda y: jc.pressure_solve(y, pit),
                    lambda y: ref.pressure_solve(y, pit), div),
            }
            for name, (kern, plain, arg) in pairs.items():
                got, want = jax.jit(kern)(arg), jax.jit(plain)(arg)
                err = float(jnp.max(jnp.abs(got - want)))
                lim = TOL_KERNEL * (1.0 + float(jnp.max(jnp.abs(want))))
                k_ms, x_ms = _median_ms(kern, arg), _median_ms(plain, arg)
                print(f"kernel {w}x{h} {name}: max abs err {err} (tol {lim}); "
                      f"kernel {k_ms} ms vs XLA {x_ms} ms on {card}")
                assert err <= lim, (name, err, lim)
    for h, w, pit in sizes:
        steps = 50 if h < 8192 else 10
        rates = {}
        for backend in ("ref", "cuda"):
            cfg = FluidConfig.gpu_reference(nx=w, ny=h, pressure_iters=pit,
                                            backend=backend)
            sim = Simulation(cfg)
            imp = orbit_impulse(steps, cfg.dt, center=(w / 2, h / 2),
                                radius=min(w, h) / 8, omega=3.0)
            rates[backend] = _rate(sim.run, sim.init(), imp, steps, reps=3)
        print(f"kernel step {w}x{h} p{pit}: cuda {1e3 / rates['cuda']} "
              f"ms/step vs XLA (ref) {1e3 / rates['ref']} ms/step on {card}")
    jax.clear_caches()


def phase_gpu_tests():
    import pytest

    class Passed:
        n = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.n += 1

    passed = Passed()
    rc = int(pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "-p", "no:randomly", os.path.join(REPO, "tests")],
                         plugins=[passed]))
    print(f"gpu-marked tests: pytest exit code {rc}, {passed.n} passed")
    assert rc == 0 and passed.n > 0, f"gpu-marked tests: rc {rc}"


def phase_four(card):
    """8192² gpu-parity, 100 pressure iterations, on a 4x1 rows mesh and a
    2x2 mesh, each against the same steps on one card."""
    import jax

    from cudafluidsimulation_tpu import FluidConfig, Simulation, init_state
    from cudafluidsimulation_tpu.parallel.sharded import make_mesh, shard_state
    from cudafluidsimulation_tpu.parallel.shardmap2d import (
        make_mesh2d, make_shardmap2d_rollout, shard_state_2d,
    )
    from cudafluidsimulation_tpu.parallel.shardmap_step import (
        make_shardmap_rollout,
    )
    from cudafluidsimulation_tpu.utils.impulse import orbit_impulse

    assert len(jax.devices()) >= 4, f"--four needs 4 GPUs, have {jax.devices()}"
    n, steps, d = 8192, 5, 31
    cfg = FluidConfig.gpu_reference(nx=n, ny=n, pressure_iters=100,
                                    max_displacement=d)
    # a slow orbit keeps every backtrace inside the sharded halo (d cells),
    # where the sharded advection is exact
    imp = orbit_impulse(steps, cfg.dt, center=(n / 2, n / 2), radius=64.0,
                        omega=3.0)
    sim = Simulation(cfg)
    single, (dx, dy) = sim.run_displacement(sim.init(), imp)
    print(f"four: realized displacement {max(dx, dy)} cells (d={d})")
    assert max(dx, dy) < d, (dx, dy)
    _check_fields(single, "8192^2 one card")
    rate1 = _rate(sim.run, sim.init(), imp, steps, reps=3)
    print(f"four: one card {rate1} steps/s ({1e3 / rate1} ms/step) on {card}")
    meshes = {
        "rows 4x1": (make_mesh(4, ens=1), make_shardmap_rollout, shard_state),
        "2d 2x2": (make_mesh2d(2, 2), make_shardmap2d_rollout,
                   shard_state_2d),
    }
    for name, (mesh, build, place) in meshes.items():
        run = build(cfg, mesh)
        out = run(place(init_state(cfg), mesh), imp)
        _check_fields(out, f"8192^2 {name}")
        errs = {k: _rel_err(getattr(out, k), getattr(single, k))
                for k in ("u", "v", "dye", "pressure")}
        print(f"four: {name} vs one card after {steps} steps: max rel err "
              f"{errs} (tol {TOL_SHARDED})")
        assert max(errs.values()) <= TOL_SHARDED, (name, errs)
        rate = _rate(run, place(init_state(cfg), mesh), imp, steps, reps=3)
        print(f"four: {name} {rate} steps/s ({1e3 / rate} ms/step), "
              f"{rate / rate1}x one card, on 4x {card}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU sharded phase")
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cudafluidsimulation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    cards = _cards()
    for line in cards:
        print(f"card: {line}")
    card = cards[0]
    print(f"jax {jax.__version__}, devices {jax.devices()}")

    if args.four:
        phases = [("four", lambda: phase_four(card))]
    else:
        phases = [("main path", lambda: phase_main_path(card)),
                  ("correctness", phase_correctness),
                  ("kernel", lambda: phase_kernel(card)),
                  ("gpu tests", phase_gpu_tests)]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
