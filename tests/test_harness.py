"""Harness utilities: checkpointing, PNG writer, impulses, graft entry, CLI."""

import os
import sys
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cudafluidsimulation_tpu import FluidConfig, Simulation
from cudafluidsimulation_tpu.utils.checkpoint import load_state, save_state
from cudafluidsimulation_tpu.utils.impulse import (
    concat_impulses,
    constant_impulse,
    mouse_to_grid,
    no_impulse,
    orbit_impulse,
)
from cudafluidsimulation_tpu.utils.png import write_png


def test_checkpoint_roundtrip(tmp_path):
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref")
    sim = Simulation(cfg)
    imp = constant_impulse(8, cfg.dt, pos=(32.0, 32.0), last_pos=(30.0, 30.0))
    state = sim.run(sim.init(), imp)

    path = str(tmp_path / "ckpt.npz")
    save_state(path, state)
    restored = load_state(path)
    for a, b in zip(state, restored):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resume must continue identically to an uninterrupted run
    more = no_impulse(5, cfg.dt)
    cont = sim.run(restored, more)
    full = sim.run(sim.init(), concat_impulses(imp, more))
    np.testing.assert_allclose(np.asarray(cont.u), np.asarray(full.u), atol=1e-6)


def test_png_writer(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (32, 48, 4), dtype=np.uint8)
    img[..., 3] = 255
    path = str(tmp_path / "x.png")
    write_png(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # decode the IDAT scanlines back and compare
    idat_off = data.index(b"IDAT") + 4
    idat_len = int.from_bytes(data[idat_off - 8 : idat_off - 4], "big")
    raw = zlib.decompress(data[idat_off : idat_off + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(32, 1 + 48 * 4)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(32, 48, 4), img)


def test_mouse_to_grid_both_variants():
    # cpu: cpuFluidSim.cpp:301-303 (1024² window, 128² grid)
    gx, gy = mouse_to_grid(512.0, 0.0, (1024, 1024), (128, 128), "cpu")
    assert gx == 64.0
    assert gy == (1024 - 1) * 128 / 1024  # top of window -> top row
    # gpu: Main.cpp:155 (1920x1080 window, scale 2)
    gx, gy = mouse_to_grid(960.0, 1080.0, (1920, 1080), (960, 540), "gpu")
    assert (gx, gy) == (480.0, 0.0)


def test_graft_entry_single_chip():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.u.shape == (512, 512)
    assert bool(jnp.isfinite(out.u).all())


def test_graft_entry_multichip():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


def test_cli_headless(tmp_path):
    from cudafluidsimulation_tpu.cli import main

    frames = tmp_path / "frames"
    fields = tmp_path / "fields.npz"
    rc = main([
        "--grid", "64", "--steps", "12", "--backend", "ref",
        "--impulse", "center", "--frame-every", "6",
        "--frames-dir", str(frames), "--save-fields", str(fields),
    ])
    assert rc == 0
    assert len(list(frames.glob("*.png"))) == 2
    with np.load(fields) as d:
        assert d["u"].shape == (64, 64)
        assert d["dye"].shape == (3, 64, 64)
        assert np.abs(d["dye"]).max() > 0


def test_stage_timing_report():
    # gpu variant runs the FUSED ops (splat in the last diffusion burst,
    # divergence/project in the pressure bursts); the sampled report shows
    # the same fused buckets the pipeline pays for
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref")
    sim = Simulation(cfg)
    rep = sim.stage_timings(iters=2)
    for name in ("Advect", "Vorticity", "Diffuse+Force", "Pressure+Project",
                 "Paint+Bloom"):
        assert name in rep.stage_ms
    assert "Force" not in rep.stage_ms and "Project" not in rep.stage_ms
    assert "Paint" not in rep.stage_ms  # fused render -> one bucket
    text = rep.format()
    assert "SIMULATION END" in text

    # cpu variant: no fused splat (splat_cpu geometry), decomposed buckets
    cfg2 = FluidConfig.cpu_reference(nx=64, ny=64)
    rep2 = Simulation(cfg2).stage_timings(iters=2)
    for name in ("Diffuse", "Force", "Pressure+Project"):
        assert name in rep2.stage_ms


def test_apng_writer(tmp_path, rng):
    from cudafluidsimulation_tpu.utils.png import write_apng

    frames = [rng.integers(0, 255, (16, 24, 4), dtype=np.uint8) for _ in range(4)]
    path = str(tmp_path / "anim.png")
    write_apng(path, frames, fps=20)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data.count(b"fcTL") == 4  # one frame-control per frame
    assert data.count(b"fdAT") == 3  # frames 2..4 as fdAT
    import struct as _s

    actl = data.index(b"acTL") + 4
    n_frames, loops = _s.unpack(">II", data[actl:actl + 8])
    assert (n_frames, loops) == (4, 0)


def test_cli_apng(tmp_path):
    from cudafluidsimulation_tpu.cli import main

    out = tmp_path / "run.png"
    rc = main([
        "--grid", "64", "--steps", "12", "--backend", "ref",
        "--impulse", "center", "--frame-every", "4", "--apng", str(out),
        "--diffusion-iters", "2", "--pressure-iters", "2",
    ])
    assert rc == 0
    data = out.read_bytes()
    assert data.count(b"fcTL") == 3


def test_impulse_from_file(tmp_path):
    import json

    from cudafluidsimulation_tpu.utils.impulse import impulse_from_file

    path = tmp_path / "script.json"
    path.write_text(json.dumps([
        [10.0, 20.0, True],
        [12.0, 21.0, True],
        {"pos": [14.0, 22.0], "pressed": False, "dt": 0.02},
    ]))
    imp = impulse_from_file(str(path), dt=1 / 60)
    assert imp.pos.shape == (3, 2)
    np.testing.assert_allclose(np.asarray(imp.last_pos[0]), [10.0, 20.0])
    np.testing.assert_allclose(np.asarray(imp.last_pos[2]), [12.0, 21.0])
    assert not bool(imp.pressed[2])
    np.testing.assert_allclose(float(imp.dt[2]), 0.02)


def test_replay_source_replays_then_releases():
    from cudafluidsimulation_tpu.models.app import replay_source
    from cudafluidsimulation_tpu.utils.impulse import impulse_from_file

    import json, tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump([[1.0, 2.0, True], [3.0, 4.0, False]], f)
        path = f.name
    src = replay_source(impulse_from_file(path, dt=1 / 60))
    p1, l1, pr1 = src(0.0)
    assert p1 == (1.0, 2.0) and l1 == (1.0, 2.0) and pr1
    p2, l2, pr2 = src(0.1)
    assert p2 == (3.0, 4.0) and l2 == (1.0, 2.0) and not pr2
    p3, _, pr3 = src(0.2)  # past the script's end: press released
    assert p3 == (3.0, 4.0) and not pr3
    os.unlink(path)


def test_cli_term_view_honors_impulse_file(tmp_path, capsys):
    import json

    from cudafluidsimulation_tpu.cli import main

    script = tmp_path / "s.json"
    script.write_text(json.dumps([[32.0, 32.0, True]] * 6))
    fields = tmp_path / "f.npz"
    rc = main(["--grid", "64", "--backend", "ref", "--view", "term",
               "--impulse-file", str(script),
               "--diffusion-iters", "2", "--pressure-iters", "2",
               "--save-fields", str(fields)])
    assert rc == 0
    capsys.readouterr()  # drain the ANSI frames
    with np.load(fields) as d:
        # the replayed press must actually drive the sim (round-1 bug: the
        # term branch silently rebuilt an orbit source instead)
        assert np.abs(d["dye"]).max() > 0
        assert np.abs(d["dye"][:, 28:36, 28:36]).max() > 0.1


def test_cli_view_records_video(tmp_path, capsys):
    """--video composes with --view: the live session streams to an AVI
    (every frame, not --frame-every sampling)."""
    import struct

    from cudafluidsimulation_tpu.cli import main

    out = tmp_path / "session.avi"
    rc = main(["--grid", "64", "--steps", "8", "--backend", "ref",
               "--view", "term", "--impulse", "center",
               "--video", str(out), "--video-codec", "rgb",
               "--diffusion-iters", "2", "--pressure-iters", "2"])
    assert rc == 0
    capsys.readouterr()
    data = out.read_bytes()
    assert data[:4] == b"RIFF"
    avih = data.index(b"avih") + 8
    n_frames = struct.unpack("<14I", data[avih:avih + 56])[4]
    assert n_frames == 8  # one chunk per live frame


def test_cli_pressure_solver_multigrid(tmp_path):
    """--pressure-solver multigrid runs end-to-end and leaves less residual
    divergence than the parity Jacobi run at the same step count."""
    from cudafluidsimulation_tpu.cli import main
    from cudafluidsimulation_tpu.ops import ref

    outs = {}
    for solver in ("jacobi", "multigrid"):
        f = tmp_path / f"{solver}.npz"
        rc = main(["--grid", "64", "--steps", "15", "--backend", "ref",
                   "--impulse", "center", "--pressure-solver", solver,
                   "--diffusion-iters", "2", "--save-fields", str(f)])
        assert rc == 0
        with np.load(f) as d:
            div = ref.divergence(jnp.asarray(d["u"]), jnp.asarray(d["v"]),
                                 True)
            outs[solver] = float(jnp.sqrt(jnp.mean(div ** 2)))
    assert np.isfinite(outs["multigrid"])
    assert outs["multigrid"] < outs["jacobi"]


def test_cli_max_displacement(tmp_path):
    """--max-displacement widens the advection bound; on the ref backend it
    sizes nothing (single-chip ref is unbounded) but must parse and run."""
    from cudafluidsimulation_tpu.cli import main

    f = tmp_path / "f.npz"
    rc = main(["--grid", "64", "--steps", "6", "--backend", "ref",
               "--impulse", "center", "--max-displacement", "31",
               "--diffusion-iters", "2", "--pressure-iters", "2",
               "--save-fields", str(f)])
    assert rc == 0
    with np.load(f) as d:
        assert np.isfinite(d["u"]).all()


def test_cli_health_segments(tmp_path, capsys):
    from cudafluidsimulation_tpu.cli import main

    rc = main(["--grid", "64", "--steps", "12", "--backend", "ref",
               "--impulse", "center", "--health", "--health-every", "4",
               "--diffusion-iters", "2", "--pressure-iters", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Min frame" in out and "Max frame" in out


def test_cli_health_catches_blowup(tmp_path):
    import pytest

    from cudafluidsimulation_tpu.cli import main

    with pytest.raises(SystemExit, match="health check failed"):
        main(["--grid", "64", "--steps", "12", "--backend", "ref",
              "--impulse", "center", "--health", "1e-6", "--health-every", "4",
              "--diffusion-iters", "2", "--pressure-iters", "2"])


def test_cli_impulse_file(tmp_path):
    import json

    from cudafluidsimulation_tpu.cli import main

    script = tmp_path / "s.json"
    script.write_text(json.dumps([[32.0, 32.0, True]] * 8))
    fields = tmp_path / "f.npz"
    rc = main(["--grid", "64", "--backend", "ref", "--impulse-file", str(script),
               "--diffusion-iters", "2", "--pressure-iters", "2",
               "--save-fields", str(fields)])
    assert rc == 0
    with np.load(fields) as d:
        assert np.abs(d["dye"]).max() > 0


def test_avi_writer_roundtrip(tmp_path, rng):
    """Parse the written AVI back: container structure, frame count, and
    pixel-exact recovery of the RGB data."""
    import struct

    from cudafluidsimulation_tpu.utils.video import write_avi

    h, w, n = 16, 24, 3
    frames = [rng.integers(0, 255, (h, w, 4), dtype=np.uint8) for _ in range(n)]
    path = str(tmp_path / "run.avi")
    assert write_avi(path, frames, fps=20, codec="rgb") == "rgb"
    data = open(path, "rb").read()

    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    assert b"00db" in data and b"idx1" in data

    # main header: frame count + dims
    avih_off = data.index(b"avih") + 8
    vals = struct.unpack("<14I", data[avih_off:avih_off + 56])
    assert vals[4] == n and (vals[8], vals[9]) == (w, h)

    # decode the first frame chunk: bottom-up padded BGR rows
    movi = data.index(b"movi")
    c0 = data.index(b"00db", movi)
    size = struct.unpack("<I", data[c0 + 4:c0 + 8])[0]
    stride = (w * 3 + 3) & ~3
    assert size == stride * h
    rows = np.frombuffer(data[c0 + 8:c0 + 8 + size], np.uint8).reshape(h, stride)
    rgb = rows[:, :w * 3].reshape(h, w, 3)[::-1, :, ::-1]
    np.testing.assert_array_equal(rgb, frames[0][..., :3])

    # idx1 entries: one keyframe per frame, first offset = 4
    idx = data.index(b"idx1") + 8
    ck, flags, off, sz = struct.unpack("<4sIII", data[idx:idx + 16])
    assert (ck, flags, off, sz) == (b"00db", 0x10, 4, size)


def test_avi_explicit_mjpeg_fails_fast_without_encoder(tmp_path, monkeypatch):
    """An explicit mjpeg request on a toolchain-less box must fail at
    writer construction — before hours of simulation are invested — while
    'auto' silently degrades to rgb."""
    from cudafluidsimulation_tpu.utils import jpeg
    from cudafluidsimulation_tpu.utils.video import AviWriter, write_avi

    monkeypatch.setattr(jpeg, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="native JPEG encoder"):
        AviWriter(str(tmp_path / "x.avi"), 16, 16, codec="mjpeg")
    frames = [np.zeros((16, 16, 4), np.uint8)]
    assert write_avi(str(tmp_path / "y.avi"), frames, codec="auto") == "rgb"


def test_avi_writer_mjpeg(tmp_path):
    """MJPEG AVI: container structure + per-chunk baseline JPEGs that a
    real decoder accepts, near-lossless at quality 95 on smooth content."""
    import struct

    from cudafluidsimulation_tpu.utils import jpeg
    from cudafluidsimulation_tpu.utils.video import write_avi

    if not jpeg.native_available():
        pytest.skip("no native toolchain")

    h, w, n = 32, 48, 3
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.zeros((h, w, 4), np.uint8)
    base[..., 0] = (xx * 255 / w).astype(np.uint8)
    base[..., 1] = (yy * 255 / h).astype(np.uint8)
    base[..., 3] = 255
    frames = [np.roll(base, i, axis=1) for i in range(n)]
    path = str(tmp_path / "run_mjpeg.avi")
    assert write_avi(path, frames, fps=20, quality=95) == "mjpeg"
    data = open(path, "rb").read()

    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert b"MJPG" in data and b"00dc" in data and b"idx1" in data
    assert b"00db" not in data

    movi = data.index(b"movi")
    c0 = data.index(b"00dc", movi)
    size = struct.unpack("<I", data[c0 + 4:c0 + 8])[0]
    payload = data[c0 + 8:c0 + 8 + size]
    assert payload[:2] == b"\xff\xd8" and payload[-2:] == b"\xff\xd9"
    assert size < frames[0][..., :3].nbytes  # actually compressed

    try:  # decode with a REAL jpeg decoder when one exists in the env
        import io

        from PIL import Image  # test-only dependency, skipped if absent
    except ImportError:
        return
    dec = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"),
                     np.float32)
    ref = frames[0][..., :3].astype(np.float32)
    rmse = float(np.sqrt(((dec - ref) ** 2).mean()))
    assert rmse < 6.0, rmse


def test_jpeg_matches_source_on_gradient():
    """The native encoder round-trips smooth content near-losslessly and
    tracks libjpeg's rate/distortion at the same quality setting."""
    from cudafluidsimulation_tpu.utils import jpeg

    if not jpeg.native_available():
        pytest.skip("no native toolchain")
    h, w = 40, 56
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = (xx * 255 / w).astype(np.uint8)
    img[..., 1] = (yy * 255 / h).astype(np.uint8)
    img[..., 2] = 96
    data = jpeg.jpeg_bytes(img, quality=90)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert b"JFIF" in data[:32]
    try:
        import io

        from PIL import Image
    except ImportError:
        return
    dec = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)
    rmse = float(np.sqrt(((dec - img.astype(np.float32)) ** 2).mean()))
    assert rmse < 3.0, rmse


def test_jpeg_fuzz_sizes_and_qualities(rng):
    """Encoder edge coverage: non-multiple-of-16 dims (partial MCUs with
    edge replication), extreme aspect ratios, 1x1, quality extremes — every
    stream must parse in a real decoder at the exact declared size."""
    from cudafluidsimulation_tpu.utils import jpeg

    if not jpeg.native_available():
        pytest.skip("no native toolchain")
    try:
        import io

        from PIL import Image
    except ImportError:
        pytest.skip("no PIL to decode")

    for (h, w) in [(1, 1), (7, 9), (16, 16), (17, 23), (100, 3), (3, 100),
                   (33, 48)]:
        for q in (1, 50, 100):
            img = rng.integers(0, 255, (h, w, 4), dtype=np.uint8)
            img[: max(1, h // 2)] = np.linspace(
                0, 255, w, dtype=np.uint8)[None, :, None]
            data = jpeg.jpeg_bytes(img, quality=q)
            dec = Image.open(io.BytesIO(data))
            assert dec.size == (w, h), (h, w, q)
            arr = np.asarray(dec.convert("RGB"), np.float32)
            ref = img[..., :3].astype(np.float32)
            if q >= 50:
                # distortion must track a REAL encoder at the same settings
                # (absolute thresholds are meaningless when noise rows share
                # a DCT block with the smooth ones on tiny images)
                b = io.BytesIO()
                Image.fromarray(img[..., :3]).save(
                    b, "JPEG", quality=q, subsampling=2)
                libarr = np.asarray(Image.open(
                    io.BytesIO(b.getvalue())).convert("RGB"), np.float32)
                ours = float(np.sqrt(((arr - ref) ** 2).mean()))
                theirs = float(np.sqrt(((libarr - ref) ** 2).mean()))
                assert ours <= theirs * 1.3 + 2.0, (h, w, q, ours, theirs)


def test_jpeg_multithreaded_bands_decode_identically(rng):
    """threads>1 row-stripes the entropy coding into restart-marker bands
    (native/jpeg_encode.h): the stream must carry a DRI marker, stay a
    valid baseline JFIF, and decode BIT-identically to the single-threaded
    stream — restart markers only repackage the entropy coding, the
    DCT/quantization path is shared.  Covers partial-MCU heights, band
    counts above the MCU-row count, and the threads=0 (auto) path."""
    from cudafluidsimulation_tpu.utils import jpeg

    if not jpeg.native_available():
        pytest.skip("no native toolchain")
    try:
        import io

        from PIL import Image
    except ImportError:
        pytest.skip("no PIL to decode")

    for (h, w) in [(64, 48), (17, 33), (15, 256), (540, 96)]:
        img = rng.integers(0, 255, (h, w, 4), dtype=np.uint8)
        img[: max(1, h // 2)] = np.linspace(
            0, 255, w, dtype=np.uint8)[None, :, None]
        st = jpeg.jpeg_bytes(img, quality=90, threads=1)
        ref = np.asarray(
            Image.open(io.BytesIO(st)).convert("RGB"), np.int16)
        for threads in (2, 3, 8, 0, 999):
            mt = jpeg.jpeg_bytes(img, quality=90, threads=threads)
            assert mt[:2] == b"\xff\xd8" and mt[-2:] == b"\xff\xd9"
            mcuy = (h + 15) // 16
            if threads > 1 and mcuy > 1:
                assert b"\xff\xdd" in mt, (h, w, threads)  # DRI present
            dec = np.asarray(
                Image.open(io.BytesIO(mt)).convert("RGB"), np.int16)
            assert (dec == ref).all(), (h, w, threads)
    # single-MCU-row images cannot band: the stream stays the
    # single-threaded one, bit for bit (no DRI, no restart markers)
    tiny = rng.integers(0, 255, (16, 64, 4), dtype=np.uint8)
    assert jpeg.jpeg_bytes(tiny, 90, threads=8) == jpeg.jpeg_bytes(
        tiny, 90, threads=1)


def test_cli_http_interactive(tmp_path):
    """--view http --interactive end-to-end: a 'browser' posts a press to
    /input (dye must appear), then q — the run exits cleanly and the final
    state lands in --save-fields."""
    import socket
    import threading
    import time
    import urllib.request

    from cudafluidsimulation_tpu.cli import main

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    fields = tmp_path / "f.npz"
    rc = {}

    def run():
        rc["v"] = main([
            "--grid", "64", "--steps", "0", "--view", "http",
            "--interactive", "--http-port", str(port), "--backend", "ref",
            "--diffusion-iters", "2", "--pressure-iters", "2",
            "--save-fields", str(fields),
        ])

    t = threading.Thread(target=run)
    t.start()
    base = f"http://localhost:{port}/"
    for _ in range(150):  # wait for the server + first frame
        try:
            urllib.request.urlopen(base + "frame", timeout=2)
            break
        except Exception:
            time.sleep(0.2)
    urllib.request.urlopen(base + "input?x=32&y=32&p=1", timeout=5)
    time.sleep(1.0)  # a few pressed frames
    urllib.request.urlopen(base + "input?x=32&y=32&p=0&q=1", timeout=5)
    t.join(timeout=90)
    assert not t.is_alive(), "CLI did not exit on browser q"
    assert rc["v"] == 0
    with np.load(fields) as d:
        assert np.abs(d["dye"]).max() > 0  # the posted press splatted dye


def test_cli_video(tmp_path):
    from cudafluidsimulation_tpu.cli import main

    out = tmp_path / "run.avi"
    rc = main([
        "--grid", "64", "--steps", "12", "--backend", "ref",
        "--impulse", "center", "--frame-every", "4", "--video", str(out),
        "--video-codec", "rgb",
        "--diffusion-iters", "2", "--pressure-iters", "2",
    ])
    assert rc == 0
    data = out.read_bytes()
    assert data[:4] == b"RIFF" and data.count(b"00db") >= 3 + 1  # chunks+idx1


def test_cli_checkpoint_every(tmp_path):
    """Periodic checkpointing: the file exists and is resumable mid-run."""
    from cudafluidsimulation_tpu.cli import main
    from cudafluidsimulation_tpu.utils.checkpoint import load_state

    ck = tmp_path / "c.npz"
    rc = main(["--grid", "64", "--steps", "12", "--backend", "ref",
               "--impulse", "center", "--checkpoint", str(ck),
               "--checkpoint-every", "4",
               "--diffusion-iters", "2", "--pressure-iters", "2"])
    assert rc == 0
    st = load_state(str(ck))
    assert int(st.step) == 12  # final save overwrote the periodic ones


def test_cli_health_failure_saves_last_good(tmp_path):
    """On a blow-up the last HEALTHY segment state is checkpointed."""
    import pytest

    from cudafluidsimulation_tpu.cli import main
    from cudafluidsimulation_tpu.utils.checkpoint import load_state

    ck = tmp_path / "salvage.npz"
    with pytest.raises(SystemExit, match="health check failed"):
        main(["--grid", "64", "--steps", "12", "--backend", "ref",
              "--impulse", "center", "--health", "1e-6", "--health-every", "4",
              "--checkpoint", str(ck),
              "--diffusion-iters", "2", "--pressure-iters", "2"])
    # the fixture fails at the FIRST health check, so the salvage is the
    # (healthy) initial state
    st = load_state(str(ck))
    assert int(st.step) == 0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
@pytest.mark.parametrize("mesh", ["rows", "2d"])
def test_cli_mesh_matches_single_device(tmp_path, mesh, capsys):
    """--mesh runs the shard_map rollout from the CLI and produces the same
    fields as the single-device run (frames/fields/checkpoints gather)."""
    from cudafluidsimulation_tpu.cli import main

    f_single = tmp_path / "single.npz"
    f_mesh = tmp_path / "mesh.npz"
    # 128 so 8 row-shards stay >= max_displacement; 4 steps because the
    # default gpu parameter set is chaotic (CLAUDE.md: cross-implementation
    # comparisons use short runs or mild parameters)
    base = ["--grid", "128", "--steps", "4", "--backend", "ref",
            "--impulse", "orbit"]
    assert main(base + ["--save-fields", str(f_single)]) == 0
    assert main(base + ["--save-fields", str(f_mesh), "--mesh", mesh,
                        "--mesh-devices", "8", "--report"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 8 devices" in out
    with np.load(f_single) as a, np.load(f_mesh) as b:
        for k in ("u", "v", "dye", "pressure"):
            np.testing.assert_allclose(b[k], a[k], atol=5e-5, rtol=1e-4,
                                       err_msg=k)


def test_cli_preset_quality(capsys):
    from cudafluidsimulation_tpu.cli import main

    rc = main(["--grid", "64", "--steps", "4", "--backend", "ref",
               "--preset", "quality", "--impulse", "center"])
    assert rc == 0


def test_cli_preset_quality_flag_overrides(capsys):
    """Explicit flags must override the preset (documented contract)."""
    from cudafluidsimulation_tpu.cli import main

    rc = main(["--grid", "64", "--steps", "2", "--backend", "ref",
               "--preset", "quality", "--pressure-solver", "jacobi",
               "--impulse", "none"])
    assert rc == 0


def test_cli_mg_flag_notes(capsys):
    from cudafluidsimulation_tpu.cli import main

    main(["--grid", "64", "--steps", "1", "--backend", "ref",
          "--mg-cycles", "3", "--impulse", "none"])
    out = capsys.readouterr().out
    assert "note: --mg-cycles is ignored" in out

    main(["--grid", "64", "--steps", "1", "--backend", "ref",
          "--pressure-solver", "multigrid", "--mg-cycles", "3",
          "--mg-tol", "0.05", "--impulse", "none"])
    out = capsys.readouterr().out
    assert "note: --mg-cycles is ignored when --mg-tol" in out


def test_cli_clamp_warning_printed(capsys):
    """A driven run whose realized |v|*dt exceeds max_displacement on a
    clamping path (a sharded mesh, whose halo bounds backtraces) must
    print the advection-clamp warning (clamping must never be silent)."""
    from cudafluidsimulation_tpu.cli import main

    rc = main(["--grid", "64", "--steps", "12", "--backend", "ref",
               "--mesh", "rows", "--mesh-devices", "2",
               "--max-displacement", "1", "--impulse", "center"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "advection clamp" in out and "max_displacement=1" in out


def test_cli_no_clamp_warning_on_exact_path(capsys):
    """backend=ref single-chip is exact — no warning regardless of speed."""
    from cudafluidsimulation_tpu.cli import main

    rc = main(["--grid", "64", "--steps", "12", "--backend", "ref",
               "--max-displacement", "1", "--impulse", "center"])
    assert rc == 0
    assert "advection clamp" not in capsys.readouterr().out


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "scripts/bench_suite.py"])
def test_gpu_entry_points_refuse_the_cpu(script, capsys, monkeypatch):
    """Without a GPU the chip smoke test and both benchmarks exit non-zero
    and print no result: a CPU number is not a measurement of this
    program."""
    import importlib.util

    monkeypatch.setattr(sys, "argv", [script])

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), script)
    spec = importlib.util.spec_from_file_location("entry_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main() != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "GPU" in out.err


@pytest.mark.parametrize("env_dir", [None, "cache-from-env"])
def test_compile_cache_location(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code;
    otherwise the cache is a fixed directory inside the checkout."""
    import jax

    from cudafluidsimulation_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env_dir))
    try:
        got = compile_cache.enable_compile_cache()
        if env_dir is None:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got == str(tmp_path / env_dir)
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
