"""ctypes bridge to the native C++ image loader ``native/tileloader.cc``
(counterpart of ``mpi4dl_tpu/data_native.py``).

The loader is built with ``g++`` from the source in the repository on first
use, into ``build/native/libtileloader-<hash>.so`` at the repository root
(git-ignored; ``<hash>`` covers the source, so an edited source is rebuilt).
The build probes for the system libjpeg and libpng as the JAX package's
does: with both, with one, then with neither (PPM and BMP are built in).
Every entry point returns None (or False) when no compiler is available,
and ``data.py`` then decodes with PIL or numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "tileloader.cc"
BUILD_DIR = ROOT / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(src: Path, out: Path) -> bool:
    """Compile the loader into ``out``, full codec set first, then fewer
    (``data_native.py:33-51``); the file appears whole (written under a
    temporary name, then renamed), so ranks building at once do not load
    each other's half-written output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    base = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(src)]
    variants = [
        base + ["-DHAVE_LIBJPEG", "-DHAVE_LIBPNG", "-ljpeg", "-lpng"],
        base + ["-DHAVE_LIBJPEG", "-ljpeg"],
        base + ["-DHAVE_LIBPNG", "-lpng"],
        base,
    ]
    try:
        for cmd in variants:
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                return False
            if r.returncode == 0 and os.path.getsize(tmp) > 0:
                os.replace(tmp, out)
                return True
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libtileloader-{digest}.so"


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None when it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            return None
        so = library_path()
        if not so.exists() and not _build(SOURCE, so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:  # built on another machine: build it here
            if not _build(SOURCE, so):
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                return None
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.tl_load_rgb.argtypes = [ctypes.c_char_p, ctypes.c_int, f32]
        lib.tl_load_rgb.restype = ctypes.c_int
        lib.tl_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                      ctypes.c_int, f32]
        lib.tl_load_batch.restype = ctypes.c_int
        lib.tl_crop_tiles.argtypes = [f32] + [ctypes.c_int] * 8 + [f32]
        lib.tl_crop_tiles.restype = None
        lib.tl_load_image.argtypes = [ctypes.c_char_p, ctypes.c_int, f32]
        lib.tl_load_image.restype = ctypes.c_int
        lib.tl_codecs.argtypes = []
        lib.tl_codecs.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def codecs() -> dict:
    """Which optional codecs the native build carries."""
    lib = get_lib()
    bits = lib.tl_codecs() if lib is not None else 0
    return {"jpeg": bool(bits & 1), "png": bool(bits & 2)}


def load_image(path: str, image_size: int) -> Optional[np.ndarray]:
    """Native decode of an ENCODED image (PPM/BMP always; JPEG/PNG when the
    build found the system codecs) → [S, S, 3] float32 in [0, 1]; None when
    the loader is unavailable or this build lacks the format."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((image_size, image_size, 3), np.float32)
    if lib.tl_load_image(path.encode(), image_size, out) != 0:
        return None
    return out


def load_rgb(path: str, image_size: int) -> Optional[np.ndarray]:
    """Native load of one raw interleaved-RGB file → [S, S, 3] float32."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((image_size, image_size, 3), np.float32)
    if lib.tl_load_rgb(path.encode(), image_size, out) != 0:
        return None
    return out


def load_batch(paths: Sequence[str], image_size: int) -> Optional[np.ndarray]:
    """Native load of a batch of raw-RGB files → [N, S, S, 3] float32."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if lib.tl_load_batch(arr, n, image_size, out) != -1:
        return None
    return out


def crop_tiles(batch: np.ndarray, row: int, col: int, grid_h: int,
               grid_w: int) -> Optional[np.ndarray]:
    """Tile ``(row, col)`` of a ``grid_h x grid_w`` grid over ``[N, H, W, C]``."""
    lib = get_lib()
    if lib is None:
        return None
    batch = np.ascontiguousarray(batch, np.float32)
    n, h, w, c = batch.shape
    out = np.empty((n, h // grid_h, w // grid_w, c), np.float32)
    lib.tl_crop_tiles(batch, n, h, w, c, row, col, grid_h, grid_w, out)
    return out
