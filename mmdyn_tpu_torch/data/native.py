"""ctypes bindings of the native (C++) ingest library (port of
``mmdyn_tpu/data/native.py``).

The library is the repository's ``native/ingest.cpp``, compiled unchanged
with g++ at first use (never at import) into this package's own build
directory, ``mmdyn_tpu_torch/data/_build/``, one library per host (it is
built for the host's ISA), and rebuilt when the source is newer than it. It decodes PNGs and runs the whole per-frame compile (bbox ->
crop -> bicubic 256 -> seg zeroing -> availability flags -> bilinear 64),
OpenMP-parallel over frames: the host side of compiling a corpus.

Where g++ or zlib is missing the build fails: ``available()`` is False,
``build_error()`` says why, and ``compile_dataset(engine="auto")`` takes the
PIL path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "ingest.cpp"
_BUILD = Path(__file__).resolve().parent / "_build"
# -march=native ties a build to its host's ISA: the library's name carries
# the host, so a tree copied to another machine builds its own copy
_HOST = hashlib.sha1(f"{platform.node()}/{platform.machine()}".encode()).hexdigest()[:12]
_LIB = _BUILD / f"libmmdyn_ingest-{_HOST}.so"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_intp = ctypes.POINTER(ctypes.c_int)
_paths = ctypes.POINTER(ctypes.c_char_p)

_lib = None
_error = None     # why the build failed, once it has


def build(force=False) -> Optional[Path]:
    """Compile the shared library if it is missing or older than its source;
    its path, or None when the build fails (``build_error()`` says why)."""
    global _error
    if _LIB.exists() and not force and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")   # one per building process
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           str(_SRC), "-lz", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        _error = f"{' '.join(cmd)}: {e.stderr.strip()}"
        return None
    except FileNotFoundError as e:
        _error = f"{' '.join(cmd)}: {e}"
        return None
    tmp.replace(_LIB)      # a half-written library never sits at _LIB
    return _LIB


def load():
    """The loaded library, building it first if needed; None when it does
    not build."""
    global _lib
    if _lib is not None:
        return _lib
    if _error is not None:
        return None
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.mmdyn_decode_png.restype = ctypes.c_int
    lib.mmdyn_decode_png.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_longlong, _intp, _intp]
    lib.mmdyn_compile_frames.restype = ctypes.c_int
    lib.mmdyn_compile_frames.argtypes = [ctypes.c_int, _paths, _paths, _paths,
                                         _u8p, _u8p, _u8p, _f32p, ctypes.c_int]
    lib.mmdyn_compile_final.restype = ctypes.c_int
    lib.mmdyn_compile_final.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                        _u8p, _u8p, ctypes.c_int]
    _lib = lib
    return lib


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError(f"native ingest library unavailable: {_error}")
    return lib


def build_error():
    """g++'s message when the build failed, else None."""
    return _error


def decode_png(path, max_bytes=256 * 1024 * 1024):
    """Decode a PNG -> (H, W, C) uint8. Palette PNGs decode to their raw
    indices (1 channel), as PIL reads P-mode images."""
    lib = _require()
    buf = np.empty(32 * 1024 * 1024, np.uint8)
    while True:
        w, h = ctypes.c_int(), ctypes.c_int()
        c = lib.mmdyn_decode_png(str(path).encode(), buf.ctypes.data_as(_u8p),
                                 ctypes.c_longlong(buf.nbytes), ctypes.byref(w),
                                 ctypes.byref(h))
        if c == -1:      # larger than the buffer: grow and retry
            if buf.nbytes >= max_bytes:
                raise ValueError(f"PNG too large: {path}")
            buf = np.empty(buf.nbytes * 4, np.uint8)
            continue
        if c <= 0:
            raise ValueError(f"native PNG decode failed for {path}")
        return buf[: w.value * h.value * c].reshape(h.value, w.value, c).copy()


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def compile_frames(seg_paths, vis_paths, tac_paths, crop=True):
    """Per-frame compile of a sequence -> (vis, tac, seg) (N, 64, 64, 3)
    uint8 and avail (N, 2) float32. ``crop=False`` skips the seg-bbox
    re-crop (the --no-crop variant)."""
    lib = _require()
    n = len(seg_paths)
    if not n == len(vis_paths) == len(tac_paths):
        raise ValueError("seg, visual and tactile paths differ in number")
    out_vis, out_tac, out_seg = (np.empty((n, 64, 64, 3), np.uint8) for _ in range(3))
    out_avail = np.empty((n, 2), np.float32)
    seg_a, vis_a, tac_a = (_paths_array(p) for p in (seg_paths, vis_paths, tac_paths))
    failures = lib.mmdyn_compile_frames(
        n, seg_a, vis_a, tac_a, out_vis.ctypes.data_as(_u8p),
        out_tac.ctypes.data_as(_u8p), out_seg.ctypes.data_as(_u8p),
        out_avail.ctypes.data_as(_f32p), 1 if crop else 0)
    if failures:
        raise RuntimeError(f"native compile failed on {failures}/{n} frames")
    return out_vis, out_tac, out_seg, out_avail


def compile_final(seg_path, vis_path, tac_path, crop=True):
    """A sequence's final-frame targets -> (vis, tac) (64, 64, 3) uint8."""
    lib = _require()
    out_vis = np.empty((64, 64, 3), np.uint8)
    out_tac = np.empty((64, 64, 3), np.uint8)
    rc = lib.mmdyn_compile_final(
        str(seg_path).encode(), str(vis_path).encode(), str(tac_path).encode(),
        out_vis.ctypes.data_as(_u8p), out_tac.ctypes.data_as(_u8p), 1 if crop else 0)
    if rc != 0:
        raise RuntimeError(f"native final-frame compile failed ({rc}) for {seg_path}")
    return out_vis, out_tac


def available() -> bool:
    return load() is not None
