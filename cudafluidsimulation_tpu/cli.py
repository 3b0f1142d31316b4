"""Headless CLI — the app shell the reference never had.

The reference's only "configuration" is a compile-time macro and a mouse
(Main.cpp:13-21, 213-243).  This CLI runs scripted simulations of either
parity variant at any size, dumps frames/fields/checkpoints, and prints the
end-of-run timing report in the reference's format (Main.cpp:195-206).

    python -m cudafluidsimulation_tpu.cli --grid 512 --steps 300 \
        --impulse orbit --frames-dir out/ --report
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stable-fluids simulator in JAX")
    p.add_argument("--grid", type=int, default=512, help="square grid size")
    p.add_argument("--nx", type=int, default=0)
    p.add_argument("--ny", type=int, default=0)
    p.add_argument("--variant", choices=["cpu", "gpu"], default="gpu",
                   help="reference parity variant (parameter set + quirks)")
    p.add_argument("--backend", choices=["auto", "ref", "cuda"], default="auto",
                   help="ref = jnp ops compiled by XLA; cuda = ref with the "
                   "Jacobi sweeps in the CUDA kernel (GPU only); auto = cuda "
                   "on a GPU, else ref")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--dt", type=float, default=1.0 / 60.0)
    p.add_argument("--diffusion-iters", type=int, default=-1,
                   help="-1 = variant default (cpu:5, gpu:20)")
    p.add_argument("--pressure-iters", type=int, default=-1,
                   help="-1 = variant default (cpu:5, gpu:30)")
    p.add_argument("--preset", choices=["parity", "quality"],
                   default=None,
                   help="parity = the reference gpu pipeline as shipped "
                   "(the default config); quality = beyond-parity accuracy "
                   "(multigrid pressure with residual-targeted stopping "
                   "rms<0.05 + sharded advection bound d=31 — the "
                   "BASELINE.md solver-frontier config).  Explicit flags "
                   "override the preset")
    p.add_argument("--pressure-solver", choices=["jacobi", "multigrid"],
                   default=None,
                   help="jacobi = reference-parity fixed sweeps (default); "
                   "multigrid = V-cycle solver (far smaller residual "
                   "divergence per step — see BASELINE.md)")
    p.add_argument("--mg-cycles", type=int, default=None,
                   help="V-cycles per step with --pressure-solver multigrid "
                   "(default 2; ignored when --mg-tol is set)")
    p.add_argument("--mg-tol", type=float, default=None,
                   help="with --pressure-solver multigrid: run V-cycles "
                   "until rms(A p + div) < TOL (at most --mg-max-cycles) "
                   "instead of a fixed --mg-cycles count")
    p.add_argument("--mg-max-cycles", type=int, default=None,
                   help="cycle cap for --mg-tol (default 8)")
    p.add_argument("--max-displacement", type=int, default=0,
                   help="advection backtrace bound in cells of the --mesh "
                   "paths (their halo depth); 0 = config default (15).  "
                   "Raise for exactness on fast flows — d=31 covers the "
                   "driven orbit flow at 2048^2")
    p.add_argument("--impulse", choices=["orbit", "center", "none"], default="orbit")
    p.add_argument("--impulse-file", default="",
                   help="JSON impulse script ([x,y,pressed] per step or "
                   "{pos,pressed,dt} dicts); overrides --impulse/--steps")
    p.add_argument("--frames-dir", default="", help="dump PNG frames here")
    p.add_argument("--frame-every", type=int, default=10)
    p.add_argument("--apng", default="",
                   help="write the collected frames as one animated PNG")
    p.add_argument("--apng-fps", type=float, default=30.0)
    p.add_argument("--video", default="",
                   help="write an AVI (MJPEG when the native encoder is "
                   "available, else uncompressed RGB; plays in VLC/mpv/"
                   "ffmpeg — no dependencies): headless runs write the "
                   "collected frames, --view runs record the live session "
                   "frame by frame")
    p.add_argument("--video-fps", type=float, default=30.0)
    p.add_argument("--video-codec", choices=["auto", "mjpeg", "rgb"],
                   default="auto",
                   help="auto = MJPEG if the native JPEG encoder builds, "
                   "else lossless uncompressed RGB")
    p.add_argument("--video-quality", type=int, default=None,
                   help="MJPEG quality 1-100 (default 90 ~ visually "
                   "lossless; ignored with --video-codec rgb)")
    p.add_argument("--save-fields", default="", help="npz path for final fields")
    p.add_argument("--checkpoint", default="", help="save final state pytree here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save the state to --checkpoint every N steps "
                   "(long-run resilience; 0 = only at the end)")
    p.add_argument("--resume", default="", help="resume from a state checkpoint")
    p.add_argument("--report", action="store_true", help="per-stage timing report")
    p.add_argument("--health", nargs="?", const=0.0, type=float, default=None,
                   metavar="MAX_SPEED",
                   help="check field health between segments (NaN/Inf always; "
                   "velocity blow-up when MAX_SPEED > 0) — fails fast naming "
                   "the bad segment instead of only at the end")
    p.add_argument("--health-every", type=int, default=100,
                   help="steps per health-check segment")
    p.add_argument("--report-mode", choices=["sampled", "decomposed",
                                             "instrumented"],
                   default="sampled",
                   help="sampled = out-of-band timing of the stages the "
                   "pipeline ACTUALLY runs, fused buckets included (fast); "
                   "decomposed = reference-style in-run accumulation with "
                   "the fused ops split back into the reference's stage "
                   "buckets — NOTE this times unfused kernels the "
                   "production step does not run (re-runs the rollout "
                   "un-jitted, slow).  'instrumented' is a deprecated "
                   "alias for 'decomposed'")
    p.add_argument("--profile-dir", default="",
                   help="capture a jax.profiler trace of the rollout")
    p.add_argument("--view", choices=["none", "term", "http"], default="none",
                   help="live view: 'term' renders frames as ANSI "
                   "half-blocks; 'http' serves a browser live stream "
                   "(multipart PNG) on --http-port")
    p.add_argument("--http-port", type=int, default=0,
                   help="port for --view http (0 = pick a free one)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="bind address for --view http (default loopback; "
                   "0.0.0.0 exposes the stream AND the /input steering "
                   "route to the network — opt-in deliberately)")
    p.add_argument("--interactive", action="store_true",
                   help="steer the fluid live — the reference's mouse "
                   "capture: with --view term, mouse drag or WASD+space in "
                   "the terminal; with --view http, drag in the browser "
                   "page itself (q quits in both)")
    p.add_argument("--pipelined", action="store_true",
                   help="with --view: overlap step dispatch with frame "
                   "readback (one frame of latency, much higher FPS on "
                   "high-latency links)")
    p.add_argument("--mesh", choices=["none", "rows", "2d"], default="none",
                   help="shard the rollout over the available devices: "
                   "'rows' = 1-D row decomposition (shard_map + ppermute "
                   "halo exchanges), '2d' = rows x cols decomposition; the "
                   "grid must be divisible by the mesh shape")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="device count for --mesh (0 = all visible devices)")
    return p


def _save_fields(path: str, state) -> None:
    """--save-fields writer; creates the parent directory like the
    checkpoint writer does (utils.checkpoint.save_state)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    np.savez_compressed(
        path,
        u=np.asarray(state.u), v=np.asarray(state.v),
        dye=np.asarray(state.dye), pressure=np.asarray(state.pressure),
    )


def _clamp_warning(cfg, state, mesh: str):
    """Warning string when the run's final state shows realized advection
    displacement beyond ``max_displacement`` on an execution path that
    clamps backtrace taps there (the sharded meshes); None when the path
    is exact or the flow stayed within the bound."""
    from cudafluidsimulation_tpu.utils import health

    axes = health.clamp_axes(mesh)
    if not axes:
        return None
    # the projection-emitted bound of the final state's velocity — an
    # 8-byte host transfer instead of two full-field reductions
    au, av = (float(x) for x in state.vel_stats)
    import math

    if not (math.isfinite(au) and math.isfinite(av)):
        return None  # blow-up reporting is the health check's job
    h = health.Health(True, 0.0, 0.0, au, av)
    return health.displacement_check(h, cfg.dt, cfg.max_displacement, axes)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cudafluidsimulation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from cudafluidsimulation_tpu import FluidConfig, Simulation
    from cudafluidsimulation_tpu.utils import impulse as imps
    from cudafluidsimulation_tpu.utils.checkpoint import (
        load_state_with_fallback, save_state,
    )
    from cudafluidsimulation_tpu.utils.png import write_png
    from cudafluidsimulation_tpu.utils.timing import StageReport

    if args.checkpoint_every < 0:
        raise SystemExit("--checkpoint-every must be >= 0")
    nx = args.nx or args.grid
    ny = args.ny or args.grid
    maker = FluidConfig.cpu_reference if args.variant == "cpu" else FluidConfig.gpu_reference
    overrides = dict(backend=args.backend, dt=args.dt)
    if args.preset == "quality":
        # the BASELINE.md solver-frontier config; explicit flags below win
        if args.variant == "cpu":
            raise SystemExit("--preset quality applies to the gpu variant")
        overrides.update(pressure_solver="multigrid", mg_tol=0.05,
                         max_displacement=31)
    if args.diffusion_iters >= 0:
        overrides["diffusion_iters"] = args.diffusion_iters
    if args.pressure_iters >= 0:
        overrides["pressure_iters"] = args.pressure_iters
    if args.pressure_solver is not None:
        overrides["pressure_solver"] = args.pressure_solver
    if overrides.get("pressure_solver") == "multigrid":
        if args.mg_cycles is not None:
            overrides["mg_cycles"] = args.mg_cycles
        if args.mg_tol is not None:
            overrides["mg_tol"] = args.mg_tol
        if args.mg_max_cycles is not None:
            overrides["mg_max_cycles"] = args.mg_max_cycles
        if args.pressure_iters >= 0:
            print("note: --pressure-iters is ignored with --pressure-solver "
                  "multigrid (use --mg-cycles / --mg-tol)")
        if args.mg_cycles is not None and overrides.get("mg_tol", 0.0) > 0:
            print("note: --mg-cycles is ignored when --mg-tol is set "
                  "(cycles run until the residual target, up to "
                  "--mg-max-cycles)")
    else:
        for flag, name in [(args.mg_cycles, "--mg-cycles"),
                           (args.mg_tol, "--mg-tol"),
                           (args.mg_max_cycles, "--mg-max-cycles")]:
            if flag is not None:
                print(f"note: {name} is ignored with --pressure-solver "
                      "jacobi (pass --pressure-solver multigrid or "
                      "--preset quality)")
    if args.max_displacement < 0:
        raise SystemExit("--max-displacement must be >= 0 (0 = default)")
    if args.max_displacement > 0:
        overrides["max_displacement"] = args.max_displacement
    cfg = maker(nx=nx, ny=ny, **overrides)
    sim = Simulation(cfg)

    if args.impulse_file:
        imp = imps.impulse_from_file(args.impulse_file, cfg.dt)
        args.steps = int(imp.pressed.shape[0])
    elif args.impulse == "orbit":
        imp = imps.orbit_impulse(args.steps, cfg.dt, center=(nx / 2, ny / 2),
                                 radius=min(nx, ny) / 8, omega=3.0)
    elif args.impulse == "center":
        imp = imps.constant_impulse(args.steps, cfg.dt, pos=(nx / 2, ny / 2),
                                    last_pos=(nx / 2 - 3, ny / 2 - 2))
    else:
        imp = imps.no_impulse(args.steps, cfg.dt)

    video_quality = 90 if args.video_quality is None else args.video_quality
    if args.video_quality is not None and args.video_codec == "rgb":
        print("note: --video-quality is ignored with --video-codec rgb "
              "(lossless uncompressed frames)")
    if args.report_mode == "instrumented":
        print("note: --report-mode instrumented is now called 'decomposed' "
              "(it splits the fused production ops back into the "
              "reference's stage buckets)")
        args.report_mode = "decomposed"

    if args.resume:
        # fallback loader: a checkpoint torn by a pre-atomic writer (or a
        # partial disk) falls back to the rotated .prev.npz copy
        state = load_state_with_fallback(args.resume)
        if tuple(state.u.shape) != (ny, nx):
            raise SystemExit(
                f"checkpoint grid {state.u.shape[1]}x{state.u.shape[0]} does not "
                f"match requested --grid {nx}x{ny}; pass the matching size"
            )
    else:
        state = sim.init()

    if args.view != "none" and args.mesh != "none":
        print(f"note: --mesh is ignored with --view {args.view} "
              "(the live frame loop is single-device)")

    if args.view != "none":
        # interactive-style frame loop with a live view (ANSI terminal or
        # browser HTTP stream); honors the chosen impulse script and the
        # save/checkpoint flags
        from cudafluidsimulation_tpu.models.app import (
            FluidApp, orbit_source, replay_source,
        )

        if args.impulse_file:
            # replay the loaded script frame-by-frame (dt comes from the
            # frame loop; see models.app.replay_source)
            source = replay_source(imp)
        elif args.impulse == "orbit":
            source = orbit_source(cfg)
        elif args.impulse == "center":
            def source(t, _c=(nx / 2.0, ny / 2.0)):
                return _c, (_c[0] - 3.0, _c[1] - 2.0), True
        else:
            def source(t, _c=(0.0, 0.0)):
                return _c, _c, False

        for flag, name in [(args.frames_dir, "--frames-dir"),
                           (args.apng, "--apng")]:
            if flag:
                print(f"note: {name} is ignored with --view {args.view} "
                      "(frames go to the live view)")
        if args.health is not None:
            print(f"note: --health is ignored with --view {args.view} "
                  "(the frame loop surfaces failures per frame)")

        # periodic checkpointing works in the frame loop too (long
        # interactive sessions should survive a crash/Ctrl-C)
        ckpt_every_view = args.checkpoint_every if args.checkpoint else 0
        if args.checkpoint_every and not args.checkpoint:
            print("note: --checkpoint-every needs --checkpoint; ignored")

        def on_frame(state, nframes, _every=ckpt_every_view):
            if _every and nframes % _every == 0:
                save_state(args.checkpoint, state)

        on_frame = on_frame if ckpt_every_view > 0 else None

        if args.view == "http":
            from cudafluidsimulation_tpu.utils.http_view import HttpViewer

            viewer = HttpViewer(port=args.http_port, width=nx, height=ny,
                                host=args.http_host)
            print(f"live view: {'  '.join(viewer.urls)}  "
                  f"(bound on {args.http_host}; Ctrl-C to stop)")
        else:
            from cudafluidsimulation_tpu.utils.term_view import TermViewer

            viewer = TermViewer()

        # --video records the live session: the AVI writer streams each
        # frame to disk (flat memory), so a tee costs one encode per frame.
        # Wall-clock pacing varies in a live loop; the file plays back at
        # the fixed --video-fps.
        avi = None
        sink = viewer
        if args.video:
            from cudafluidsimulation_tpu.utils.video import AviWriter

            avi = AviWriter(args.video, nx, ny, fps=args.video_fps,
                            codec=args.video_codec,
                            quality=video_quality)

            def sink(frame, _v=viewer, _a=avi):
                _v(frame)
                _a.add(frame)

        if args.interactive and args.view == "http":
            # live input FROM the browser page itself: the stream page posts
            # pointer drags back to /input, the source polls them per frame
            # (Main.cpp:213-243, browser edition)
            app = FluidApp(cfg, input_source=viewer.input_source(nx, ny),
                           frame_sink=sink, fixed_dt=args.dt)
            app.state = state
            try:
                report = app.run(max_frames=args.steps or None,
                                 pipelined=args.pipelined,
                                 stop_when=lambda: viewer.quit_requested,
                                 on_frame=on_frame)
            except KeyboardInterrupt:
                report = None
            state = app.state
        elif args.interactive:
            # live input: mouse drag / WASD — the reference's interactive
            # loop (Main.cpp:213-243), terminal edition, sized to the TERM
            # viewer so mouse cells land on the rendered pixels
            import shutil

            from cudafluidsimulation_tpu.utils.term_input import TermInput

            size = shutil.get_terminal_size((80, 24))
            cols = min(size.columns, 120)
            rows = min(size.lines - 2, 48)
            cols = viewer.cols or cols
            rows = viewer.rows or rows
            viewer.cols, viewer.rows = cols, rows
            tin = TermInput(nx, ny, cols, rows)
            with tin:
                app = FluidApp(cfg, input_source=tin.source(),
                               frame_sink=sink, fixed_dt=args.dt)
                app.state = state
                try:
                    # cbreak keeps ISIG, so Ctrl-C raises here rather than
                    # reaching TermInput's \x03 handler — the session's
                    # state must still reach the save/checkpoint flags below
                    report = app.run(max_frames=args.steps or None,
                                     pipelined=args.pipelined,
                                     stop_when=lambda: tin.quit,
                                     on_frame=on_frame)
                except KeyboardInterrupt:
                    report = None
            state = app.state
        else:
            app = FluidApp(cfg, input_source=source,
                           frame_sink=sink, fixed_dt=args.dt)
            app.state = state
            try:
                report = app.run(max_frames=args.steps or None,
                                 pipelined=args.pipelined,
                                 on_frame=on_frame)
            except KeyboardInterrupt:
                report = None
            state = app.state
        if args.view == "http":
            viewer.close()
        if avi is not None:
            avi.close()
            print(f"recorded {app.frames}-frame {avi.codec.upper()} AVI of "
                  f"the session to {args.video}")
        if args.save_fields:
            _save_fields(args.save_fields, state)
            print(f"saved fields to {args.save_fields}")
        if args.checkpoint:
            save_state(args.checkpoint, state)
            print(f"saved checkpoint to {args.checkpoint}")
        warn = _clamp_warning(cfg, state, args.mesh)
        if warn:
            print(f"warning: {warn}")
        if report is not None:
            print(report.format())
        return 0

    import contextlib

    import jax

    from cudafluidsimulation_tpu.utils.health import HealthError, check_health
    from cudafluidsimulation_tpu.utils.impulse import Impulse

    # --mesh: swap the rollout for a shard_map'd one over a device mesh
    # (the multi-chip path the reference never had, SURVEY.md §5); state
    # is sharded in place, frames/fields/checkpoints gather transparently
    run_fn = sim.jit_run
    if args.mesh != "none":
        ndev = args.mesh_devices or len(jax.devices())
        if args.mesh == "rows":
            from cudafluidsimulation_tpu.parallel.sharded import (
                make_mesh, shard_state,
            )
            from cudafluidsimulation_tpu.parallel.shardmap_step import (
                make_shardmap_rollout,
            )

            mesh = make_mesh(ndev, ens=1)
            run_fn = make_shardmap_rollout(cfg, mesh)
            state = shard_state(state, mesh)
            print(f"mesh: {ndev} devices, rows-only decomposition")
        else:
            from cudafluidsimulation_tpu.parallel.shardmap2d import (
                make_mesh2d, make_shardmap2d_rollout, shard_state_2d,
            )

            nr = 1
            for cand in range(int(ndev ** 0.5), 0, -1):
                if ndev % cand == 0:
                    nr = cand
                    break
            mesh = make_mesh2d(nr, ndev // nr)
            run_fn = make_shardmap2d_rollout(cfg, mesh)
            state = shard_state_2d(state, mesh)
            print(f"mesh: {ndev} devices, {nr}x{ndev // nr} rows x cols")

    collect = bool(args.frames_dir or args.apng or args.video)
    health_on = args.health is not None
    max_speed = args.health if (health_on and args.health > 0) else None

    # One segmented rollout serves frame collection, between-segment health
    # checks, and min/max frame-time accounting (Main.cpp:199-200's analog);
    # with none of those active it is a single full-length scan.
    n_total = int(imp.pressed.shape[0])
    if collect and n_total == 0:
        raise SystemExit("nothing to run: --steps 0 (or an empty impulse "
                         "script) collects no frames")
    ckpt_every = args.checkpoint_every if args.checkpoint else 0
    if args.checkpoint_every and not args.checkpoint:
        print("note: --checkpoint-every needs --checkpoint; ignored")
    if collect:
        seg = max(1, args.frame_every)
    elif health_on:
        seg = max(1, args.health_every)
    elif ckpt_every:
        seg = max(1, ckpt_every)
    elif args.report:
        seg = max(1, -(-n_total // 10))
    else:
        seg = max(1, n_total)

    frames = []
    seg_stats = []  # (wall seconds, steps) per compiled segment

    # compile every segment shape OUTSIDE both the timed loop and the
    # profiler capture: the full segment AND the shorter remainder (a
    # remainder compiling inside the loop would bill its compile to Max
    # frame / the trace).  AOT lower+compile, and the loop calls the
    # compiled executables directly — no throwaway segment executions, no
    # re-trace on first call.
    compiled = {}
    if n_total:
        lengths = {seg, n_total % seg} - {0}
        for k in lengths:
            compiled[k] = run_fn.lower(
                state, Impulse(*(f[:k] for f in imp))).compile()

    def run_segment(st, part):
        fn = compiled.get(int(part.pressed.shape[0]))
        return fn(st, part) if fn is not None else run_fn(st, part)

    profile_ctx = (jax.profiler.trace(args.profile_dir) if args.profile_dir
                   else contextlib.nullcontext())
    with profile_ctx:
        t0 = time.perf_counter()
        start = 0
        last_good = state
        steps_since_ckpt = 0
        clamp_warned = False
        while start < n_total:
            end = min(start + seg, n_total)
            part = Impulse(*(f[start:end] for f in imp))
            s0 = time.perf_counter()
            state = run_segment(state, part)
            jax.block_until_ready(state.u)
            seg_stats.append((time.perf_counter() - s0, end - start))
            if collect:
                frames.append(sim.frame_image(sim._jit_render(state)))
            if health_on:
                try:
                    h = check_health(state, max_speed=max_speed)
                    # per-segment clamp observability: transient fast flow
                    # is visible here even if the final state has calmed
                    from cudafluidsimulation_tpu.utils.health import (
                        clamp_axes, displacement_check,
                    )

                    axes = clamp_axes(args.mesh)
                    w = (displacement_check(h, cfg.dt, cfg.max_displacement,
                                            axes) if axes else None)
                    if w and not clamp_warned:
                        print(f"warning: {w}")
                        clamp_warned = True
                except HealthError as e:
                    # salvage the last healthy state so a long run is not a
                    # total loss (the recovery layer the reference lacks)
                    if args.checkpoint:
                        save_state(args.checkpoint, last_good)
                        print(f"saved last healthy state (step "
                              f"{int(last_good.step)}) to {args.checkpoint}")
                    raise SystemExit(f"health check failed: {e}")
                last_good = state
            if ckpt_every:
                steps_since_ckpt += end - start
                if steps_since_ckpt >= ckpt_every:
                    save_state(args.checkpoint, state)
                    steps_since_ckpt = 0
            start = end
        wall = time.perf_counter() - t0
    frames = np.stack(frames) if frames else frames

    if args.frames_dir:
        os.makedirs(args.frames_dir, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(args.frames_dir, f"frame_{i:05d}.png"), frame)
        print(f"wrote {len(frames)} frames to {args.frames_dir}")

    if args.apng:
        from cudafluidsimulation_tpu.utils.png import write_apng

        write_apng(args.apng, list(frames), fps=args.apng_fps)
        print(f"wrote {len(frames)}-frame animation to {args.apng}")

    if args.video:
        from cudafluidsimulation_tpu.utils.video import write_avi

        used = write_avi(args.video, list(frames), fps=args.video_fps,
                         codec=args.video_codec, quality=video_quality)
        print(f"wrote {len(frames)}-frame {used.upper()} AVI to {args.video} "
              "(ffmpeg -i ... out.mp4 to transcode)")

    if args.save_fields:
        _save_fields(args.save_fields, state)
        print(f"saved fields to {args.save_fields}")

    if args.checkpoint:
        save_state(args.checkpoint, state)
        print(f"saved checkpoint to {args.checkpoint}")

    if not clamp_warned:
        warn = _clamp_warning(cfg, state, args.mesh)
        if warn:
            print(f"warning: {warn}")

    rep = StageReport(grid=f"{nx}x{ny}", steps=args.steps, total_s=wall)
    if args.report and args.mesh != "none":
        print("note: per-stage --report sampling reflects the single-chip "
              "op set; skipped with --mesh (whole-step timings above are "
              "the sharded rollout's)")
    elif args.report:
        if args.report_mode == "decomposed":
            from cudafluidsimulation_tpu.utils.instrument import run_instrumented

            _, irep = run_instrumented(cfg, sim.init(), imp)
            rep.stage_ms = irep.stage_ms
        else:
            # sample stages from the rollout's FINAL state: advect cost is
            # flow-dependent (window width follows realized |v|*dt), so a
            # zero-state sample would report quiet-flow numbers for a
            # driven run
            rep.stage_ms = sim.stage_timings(state=state).stage_ms
    if len(seg_stats) > 1:
        # per-step min/max over steady-state segments (Main.cpp:199-200)
        per_step = [w / k for w, k in seg_stats]
        rep.stage_ms["Min frame"] = 1000.0 * min(per_step)
        rep.stage_ms["Max frame"] = 1000.0 * max(per_step)
    print(rep.format())
    return 0


if __name__ == "__main__":
    sys.exit(main())
