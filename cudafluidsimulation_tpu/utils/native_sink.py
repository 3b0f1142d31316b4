"""ctypes binding for the native asynchronous frame sink.

The reference streams pixels through a native display path (CUDA surface ->
GL texture -> blit, GPUFluidSim.cu:594-601 / Main.cpp:166-180); this is its
headless analog: frames are pushed non-blocking into a C++ ring
buffer and a background thread PNG-encodes and writes them, so the simulation
loop never stalls on IO.  Falls back to the pure-Python writer
(utils.png.write_png) when the shared library is unavailable.

The library auto-builds once via `make` in native/ (g++ + zlib, both in the
base image).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_load_lock = threading.Lock()
_loaded: dict = {}  # so filename -> CDLL, or None when the build failed


def load_native_lib(so_name: str, bind) -> Optional[ctypes.CDLL]:
    """Build + dlopen one of the native/ shared libraries, once per process.

    The ONE build-and-bind idiom for every ctypes module here (frame sink,
    HTTP view, JPEG encoder): run ``make -C native/`` (a cheap no-op when
    the .so is fresh, a rebuild when its source changed), dlopen, and call
    ``bind(lib)`` to declare the ctypes signatures.  Returns None — latched,
    so the toolchain is probed once — when building or loading fails.
    """
    with _load_lock:
        if so_name in _loaded:
            return _loaded[so_name]
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True, capture_output=True, timeout=120,
            )
            lib = ctypes.CDLL(os.path.join(_NATIVE_DIR, so_name))
            bind(lib)
        except Exception:
            lib = None
        _loaded[so_name] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int]
    lib.fs_push.restype = ctypes.c_int
    lib.fs_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fs_flush.argtypes = [ctypes.c_void_p]
    lib.fs_frames_written.restype = ctypes.c_uint64
    lib.fs_frames_written.argtypes = [ctypes.c_void_p]
    lib.fs_frames_dropped.restype = ctypes.c_uint64
    lib.fs_frames_dropped.argtypes = [ctypes.c_void_p]
    lib.fs_close.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    return load_native_lib("libframesink.so", _bind)


def native_available() -> bool:
    return _load() is not None


class FrameSink:
    """Async PNG frame writer. Push (H, W, 4) uint8 frames; they are written
    as frame_XXXXXXXX.png under ``directory`` by a native background thread.

    ``capacity`` bounds the in-flight queue; like a saturated real-time
    display, excess frames are dropped (count via ``dropped``).
    """

    def __init__(self, directory: str, width: int, height: int,
                 capacity: int = 16, force_python: bool = False):
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._w = width
        self._h = height
        self._count = 0
        self._lib = None if force_python else _load()
        self._handle = None
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.fs_open(
                directory.encode(), width, height, capacity))

    def push(self, frame: np.ndarray) -> bool:
        """Enqueue a frame (always accepted); returns False when the queue
        was full and the OLDEST queued frame was evicted to make room
        (real-time display semantics — the newest content always survives)."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != (self._h, self._w, 4):
            raise ValueError(f"expected ({self._h}, {self._w}, 4), got {frame.shape}")
        if self._handle is not None:
            ok = self._lib.fs_push(self._handle, frame.tobytes())
            return bool(ok)
        from cudafluidsimulation_tpu.utils.png import write_png

        write_png(os.path.join(self._dir, f"frame_{self._count:08d}.png"), frame)
        self._count += 1
        return True

    def flush(self) -> None:
        if self._handle is not None:
            self._lib.fs_flush(self._handle)

    @property
    def written(self) -> int:
        if self._handle is not None:
            return int(self._lib.fs_frames_written(self._handle))
        return self._count

    @property
    def dropped(self) -> int:
        if self._handle is not None:
            return int(self._lib.fs_frames_dropped(self._handle))
        return 0

    def close(self) -> None:
        if self._handle is not None:
            self._lib.fs_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
