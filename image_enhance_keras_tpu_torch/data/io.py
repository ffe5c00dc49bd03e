"""Image file IO (mirror of ``data/io.py``).

Decode order, as JAX's: the native codec (``runtime/native_io.py``: PNG,
BMP, PPM) when it builds, else PIL when importable, else a numpy + zlib PNG
decoder (8-bit grey, RGB, RGBA and palette, non-interlaced; anything else
raises), else a numpy 24/32-bit BMP codec.  All return RGB uint8 (H, W, 3),
as PIL's ``convert("RGB")`` does: grey is replicated, alpha is dropped.
Writes go to the native codec, then PIL; without either only BMP can be
written.  The native PNG writer's files are 8-bit RGB, non-interlaced, so
the numpy decoder reads them too.
"""

from __future__ import annotations

import os
import struct
import zlib

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


def _native():
    """The native codec module when its library builds and loads, else None."""
    from image_enhance_keras_tpu_torch.runtime import native_io

    return native_io if native_io.available() else None


def imread(path: str) -> np.ndarray:
    """Read an image file as RGB uint8 (H, W, 3)."""
    native = _native()
    if native is not None:
        arr = native.imread(path)
        if arr is not None:
            return arr
    image_mod = _pil()
    if image_mod is not None:
        with image_mod.open(path) as im:
            return np.asarray(im.convert("RGB"))
    with open(path, "rb") as f:
        head = f.read(len(_PNG_SIGNATURE))
    if head == _PNG_SIGNATURE:
        return _png_read(path)
    return _bmp_read(path)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write RGB uint8 (or float 0..255, rounded and clipped) to a file by extension."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    native = _native()
    if native is not None and native.imwrite(path, arr):
        return
    image_mod = _pil()
    if image_mod is not None:
        image_mod.fromarray(arr).save(path)
        return
    if path.lower().endswith(".bmp"):
        _bmp_write(path, arr)
        return
    raise RuntimeError(f"no codec available for {path}: the native codec and PIL are missing and only "
                       ".bmp has a numpy codec")


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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> samples per pixel, for the colour types the decoder takes
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


def _png_chunks(data: bytes, path: str):
    """(type, payload) of every chunk, CRCs checked, up to IEND."""
    pos = len(_PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without IEND")


def _png_unfilter(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Undo the five PNG row filters of (H, W, bpp) filtered samples.

    Byte x of a row depends on the bytes left, above and above-left of it,
    so all bytes on one anti-diagonal (row + column constant) are
    independent: the loop runs over the H + W - 1 anti-diagonals and each
    step handles every filter type at once."""
    h, w, _ = filt.shape
    out = np.zeros((h + 1, w + 1, filt.shape[2]), np.int16)  # a zero row above, a zero column left
    raw = filt.astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a = out[r + 1, x]      # left
        b = out[r, x + 1]      # above
        c = out[r, x]          # above-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [types[r, None] == 1, types[r, None] == 2, types[r, None] == 3, types[r, None] == 4],
            [a, b, (a + b) >> 1, paeth],
            0,
        )
        out[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _png_read(path: str) -> np.ndarray:
    """8-bit grey, RGB, RGBA or palette, non-interlaced PNG -> RGB uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[: len(_PNG_SIGNATURE)] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _png_chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype[0] & 0x20 == 0 and ctype != b"IEND":  # an unknown critical chunk
            raise ValueError(f"{path}: unsupported critical PNG chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or comp != 0 or filt_method != 0 or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, interlace {interlace}); "
            "the numpy decoder reads 8-bit grey, RGB, RGBA and palette, non-interlaced"
        )
    bpp = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: PNG image data holds {rows.size} bytes, expected {h * (w * bpp + 1)}")
    rows = rows.reshape(h, w * bpp + 1)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter type {int(types.max())} is not one of 0-4")
    img = _png_unfilter(rows[:, 1:].reshape(h, w, bpp), types)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        if img.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: PNG palette index beyond its {len(palette)} entries")
        return palette[img[..., 0]]
    if ctype == 0:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
