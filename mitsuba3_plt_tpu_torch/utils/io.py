"""Image I/O by file extension: PFM, NPY, OpenEXR (`exr.py`) and PNG, the
JAX package's `utils/io.py`. PNG is written with the standard library
(zlib and struct: 8-bit RGB, no filter), to the pixels of `tonemap_srgb`;
reading a PNG or writing a JPEG needs PIL and raises without it (bitmap
textures are ROADMAP A10). EXR, PFM and NPY stay linear; an 8-bit file is
taken from sRGB to linear on read."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def srgb_to_linear(x):
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


def tonemap_srgb(img, exposure: float = 1.0):
    """Linear -> 8-bit sRGB, after scaling by `exposure`."""
    x = np.clip(np.asarray(img, np.float32) * exposure, 0.0, None)
    srgb = np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(np.maximum(x, 1e-9), 1 / 2.4) - 0.055)
    return (np.clip(srgb, 0, 1) * 255 + 0.5).astype(np.uint8)


def write_pfm(path: str, img):
    """Portable FloatMap: colour "PF" or grey "Pf", little-endian, rows
    bottom-up."""
    img = np.asarray(img, np.float32)
    color = img.ndim == 3 and img.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(img).tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        color = f.readline().strip() == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    return np.flipud(img).copy()


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb8):
    """An 8-bit RGB image [H, W, 3] as a PNG, with the standard library."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w, _ = rgb8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb8.reshape(h, 3 * w)], axis=1)  # filter 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _rgb8(img, exposure):
    arr = tonemap_srgb(img, exposure)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    return arr[..., :3]


def write_bitmap(path: str, img, exposure: float = 1.0):
    """By extension: .npy, .exr (half floats, ZIP), .pfm, .png (tonemapped,
    standard library) or .jpg (tonemapped, through PIL)."""
    img = np.asarray(img)
    low = path.lower()
    if low.endswith(".npy"):
        np.save(path, img)
    elif low.endswith(".exr"):
        from .exr import write_exr

        write_exr(path, img, ["R", "G", "B"]
                  if img.ndim == 3 and img.shape[2] == 3 else None)
    elif low.endswith(".pfm"):
        write_pfm(path, img)
    elif low.endswith(".png"):
        write_png(path, _rgb8(img, exposure))
    elif low.endswith((".jpg", ".jpeg")):
        from PIL import Image

        Image.fromarray(_rgb8(img, exposure)).save(path)
    else:
        raise ValueError(f"unsupported image format: {path}")


def read_bitmap(path: str) -> np.ndarray:
    """An image file as linear float32 [h, w, 3]: .exr, .pfm, .npy, or an
    8-bit file through PIL (which raises ImportError where PIL is
    missing)."""
    low = path.lower()
    if low.endswith(".exr"):
        from .exr import read_exr_rgb

        return read_exr_rgb(path)
    if low.endswith((".pfm", ".npy")):
        img = (read_pfm(path) if low.endswith(".pfm")
               else np.load(path).astype(np.float32))
        return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(arr)
