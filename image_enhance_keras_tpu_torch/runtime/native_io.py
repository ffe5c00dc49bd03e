"""ctypes binding of the native image codec (mirror of ``runtime/native_io.py``).

API as JAX's: ``imread(path) -> RGB uint8 | None``, ``imwrite(path, arr) ->
bool``, ``imread_batch(paths, threads)`` for the threaded directory loader
and ``gather_patches`` for the training sampler's host loop, over the entry
points ``iek_imread``, ``iek_imwrite``, ``iek_imread_batch`` and
``iek_gather_patches`` of ``native/iek_io.cpp`` (PNG through libpng, BMP,
PPM).

The library builds at first use from that source with ``g++ -O3 -fPIC
-std=c++17 -shared ... -lpng -lz -lpthread`` into
``_build/libiek_io-<hash>.so`` (the hash covers the source and the flags;
written to a temporary name, then renamed).  When it cannot be built (no
``g++``, no ``png.h``, no source) or loaded, :func:`available` is False and
:func:`unavailable_reason` says why: callers fall back to the other codecs,
as JAX's do when its library is absent.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "unavailable_reason", "imread", "imwrite", "imread_batch", "gather_patches"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "iek_io.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-lz", "-lpthread")


def _target() -> str:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libiek_io-{h.hexdigest()[:16]}.so")


def _build() -> str:
    """The library's path, compiled first if this source and these flags have no build yet."""
    target = _target()
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [CXX, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"{CXX} could not run: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}): "
                               f"{(proc.stderr or proc.stdout).strip()[-2000:]}")
        os.replace(tmp, target)
    return target


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.iek_imread.argtypes = [ctypes.c_char_p, ctypes.POINTER(u8p), ip, ip]
    lib.iek_imread.restype = ctypes.c_int
    lib.iek_imwrite.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
    lib.iek_imwrite.restype = ctypes.c_int
    lib.iek_free.argtypes = [u8p]
    lib.iek_imread_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(u8p), ip, ip, ip]
    lib.iek_imread_batch.restype = ctypes.c_int
    lib.iek_gather_patches.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ip, ip, ctypes.c_int,
                                       ctypes.c_int, u8p]
    lib.iek_gather_patches.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _load() -> tuple[ctypes.CDLL | None, str | None]:
    """(the library, None), or (None, why it could not be built or loaded)."""
    try:
        return _declare(ctypes.CDLL(_build())), None
    except (OSError, RuntimeError) as e:
        return None, str(e)


def _lib() -> ctypes.CDLL | None:
    return _load()[0]


def available() -> bool:
    """True when the library built (or was built before) and loaded."""
    return _lib() is not None


def unavailable_reason() -> str | None:
    """Why the library is not available (the compiler's or the loader's message), or None."""
    return _load()[1]


def _take(lib, ptr, h, w) -> np.ndarray:
    buf = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * (h * w * 3))).contents
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(h, w, 3).copy()
    lib.iek_free(ptr)
    return arr


def imread(path: str) -> np.ndarray | None:
    """PNG, BMP or PPM -> RGB uint8 (H, W, 3); None when the codec cannot read it."""
    lib = _lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.iek_imread(os.fsencode(path), ctypes.byref(out), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return _take(lib, out, h.value, w.value)


def imwrite(path: str, arr: np.ndarray) -> bool:
    """Write (H, W, 3) by the suffix (.png, .bmp, .ppm); False (nothing written)
    for another suffix or shape.  Non-uint8 values are rounded and clipped."""
    lib = _lib()
    if lib is None:
        return False
    arr = np.asarray(arr)
    if arr.ndim != 3 or arr.shape[2] != 3:
        return False
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr.astype(np.float32)), 0, 255)
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return lib.iek_imwrite(os.fsencode(path), ptr, arr.shape[0], arr.shape[1]) == 0


def imread_batch(paths: list[str], threads: int = 8) -> list[np.ndarray | None]:
    """Decode many files concurrently in native threads (the GIL released)."""
    lib = _lib()
    if lib is None:
        return [imread(p) for p in paths]
    n = len(paths)
    if n == 0:
        return []
    u8p = ctypes.POINTER(ctypes.c_uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    outs = (u8p * n)()
    hs, ws, rcs = ((ctypes.c_int * n)() for _ in range(3))
    lib.iek_imread_batch(c_paths, n, threads, outs, hs, ws, rcs)
    return [_take(lib, outs[i], hs[i], ws[i]) if rcs[i] == 0 else None for i in range(n)]


def gather_patches(img: np.ndarray, ys: np.ndarray, xs: np.ndarray, p: int) -> np.ndarray:
    """(H, W, 3) uint8 and corner lists -> (N, p, p, 3) uint8.

    Corners must lie in [0, H-p] x [0, W-p]; others raise (the C side also
    clamps, so no request reads past the image)."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"gather_patches needs (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    ys = np.asarray(ys, np.int64)
    xs = np.asarray(xs, np.int64)
    if len(ys) != len(xs):
        raise ValueError(f"len(ys)={len(ys)} != len(xs)={len(xs)}")
    if p <= 0 or p > h or p > w:
        raise ValueError(f"patch {p} does not fit a {h}x{w} image")
    if len(ys) and (ys.min() < 0 or xs.min() < 0 or ys.max() > h - p or xs.max() > w - p):
        raise ValueError(f"patch corners out of range for {h}x{w} image with p={p}")
    n = len(ys)
    if n == 0:
        return np.empty((0, p, p, 3), np.uint8)
    lib = _lib()
    if lib is None:
        return np.stack([img[y : y + p, x : x + p] for y, x in zip(ys, xs)])
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty((n, p, p, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.iek_gather_patches(img.ctypes.data_as(u8p), h, w, (ctypes.c_int * n)(*map(int, ys)),
                           (ctypes.c_int * n)(*map(int, xs)), n, p, out.ctypes.data_as(u8p))
    return out
