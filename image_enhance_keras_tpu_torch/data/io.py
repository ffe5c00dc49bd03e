"""Image file IO (mirror of ``data/io.py``).

Decode order: PIL when importable, else a pure-numpy 24/32-bit BMP codec.
Both return RGB uint8 (H, W, 3).  The native codec comes in a later slice.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["imread", "imwrite", "list_images"]

_IMG_EXTS = (".png", ".bmp", ".jpg", ".jpeg", ".ppm", ".tif", ".tiff", ".webp")


def list_images(path: str) -> list[str]:
    """Sorted image files directly inside a directory."""
    return [os.path.join(path, f) for f in sorted(os.listdir(path)) if f.lower().endswith(_IMG_EXTS)]


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def imread(path: str) -> np.ndarray:
    """Read an image file as RGB uint8 (H, W, 3)."""
    image_mod = _pil()
    if image_mod is not None:
        with image_mod.open(path) as im:
            return np.asarray(im.convert("RGB"))
    return _bmp_read(path)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write RGB uint8 (or float 0..255, rounded and clipped) to a file by extension."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    image_mod = _pil()
    if image_mod is not None:
        image_mod.fromarray(arr).save(path)
        return
    if path.lower().endswith(".bmp"):
        _bmp_write(path, arr)
        return
    raise RuntimeError(f"no codec available for {path}: PIL is missing and only .bmp has a numpy codec")


def _bmp_read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file and no other codec available")
    pix_off = struct.unpack_from("<I", data, 10)[0]
    hdr_sz = struct.unpack_from("<I", data, 14)[0]
    if hdr_sz < 40:
        raise ValueError("unsupported BMP header")
    w, h = struct.unpack_from("<ii", data, 18)
    _, bpp = struct.unpack_from("<HH", data, 26)
    comp = struct.unpack_from("<I", data, 30)[0]
    if comp != 0 or bpp not in (24, 32):
        raise ValueError(f"unsupported BMP: bpp={bpp} compression={comp}")
    flip = h > 0
    h = abs(h)
    nb = bpp // 8
    stride = (w * nb + 3) & ~3
    img = np.frombuffer(data, np.uint8, stride * h, pix_off).reshape(h, stride)
    img = img[:, : w * nb].reshape(h, w, nb)
    if flip:
        img = img[::-1]
    return img[..., 2::-1].copy()  # BGR(A) -> RGB


def _bmp_write(path: str, arr: np.ndarray) -> None:
    h, w = arr.shape[:2]
    bgr = arr[..., ::-1]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    pix = rows[::-1].tobytes()
    hdr = b"BM" + struct.pack("<IHHI", 54 + len(pix), 0, 0, 54)
    hdr += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pix), 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(hdr + pix)
