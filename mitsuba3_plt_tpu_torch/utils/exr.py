"""OpenEXR scanline images: the container, NONE / ZIPS / ZIP blocks on
read and ZIP on write (the JAX package's `utils/exr.py`). PIZ blocks raise:
their decoder is ROADMAP A10's, with the environment map that reads
them."""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x01312F76

# compression codes (OpenEXR's)
NO_COMPRESSION = 0
RLE_COMPRESSION = 1
ZIPS_COMPRESSION = 2
ZIP_COMPRESSION = 3
PIZ_COMPRESSION = 4
_LINES_PER_BLOCK = {NO_COMPRESSION: 1, ZIPS_COMPRESSION: 1,
                    ZIP_COMPRESSION: 16}

# pixel types
UINT, HALF, FLOAT = 0, 1, 2
_DTYPE = {UINT: np.dtype("<u4"), HALF: np.dtype("<f2"), FLOAT: np.dtype("<f4")}


def _parse_header(data: bytes):
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    if version & 0x1000:
        raise ValueError("multi-part EXR not supported")
    off, attrs = 8, {}
    while data[off] != 0:
        end = data.index(b"\x00", off)
        name = data[off:end].decode()
        off = end + 1
        end = data.index(b"\x00", off)
        typ = data[off:end].decode()
        off = end + 1
        (size,) = struct.unpack_from("<i", data, off)
        off += 4
        attrs[name] = (typ, data[off:off + size])
        off += size
    return attrs, off + 1


def _parse_chlist(val: bytes):
    """[(name, pixel type)] in the file's (alphabetical) order."""
    chans, o = [], 0
    while val[o] != 0:
        e = val.index(b"\x00", o)
        name = val[o:e].decode()
        o = e + 1
        (ptype,) = struct.unpack_from("<i", val, o)
        # type(4) pLinear(1) reserved(3) xSampling(4) ySampling(4)
        xs, ys = struct.unpack_from("<ii", val, o + 8)
        if xs != 1 or ys != 1:
            raise ValueError("subsampled channels not supported")
        o += 16
        chans.append((name, ptype))
    return chans


def _unpredict(buf: bytes) -> bytes:
    """Undo the ZIP blocks' byte transform: the delta, then the split of
    even and odd bytes."""
    raw = np.frombuffer(buf, np.uint8)
    d = (np.cumsum(raw.astype(np.int64) - 128) + 128).astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty(len(d), np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _predict(data: bytes) -> bytes:
    """The ZIP blocks' byte transform before deflate."""
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    split = np.empty(len(arr), np.uint8)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    s = split.astype(np.int64)
    d = np.empty(len(arr), np.int64)
    d[0] = s[0]
    d[1:] = s[1:] - s[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str):
    """(channels, attrs) of a scanline EXR: channel name -> float32 [h, w]
    (UINT channels stay uint32)."""
    with open(path, "rb") as f:
        data = f.read()
    attrs, off = _parse_header(data)
    chans = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp == PIZ_COMPRESSION:
        raise NotImplementedError("PIZ-compressed EXR is not ported: "
                                  "ROADMAP A10")
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"unsupported compression {comp}")
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[comp]
    nblocks = (h + lpb - 1) // lpb
    offsets = struct.unpack_from(f"<{nblocks}q", data, off)
    row_bytes = sum(w * _DTYPE[pt].itemsize for _, pt in chans)
    out = {name: np.empty((h, w), _DTYPE[pt]) for name, pt in chans}
    for o in offsets:
        y, nbytes = struct.unpack_from("<ii", data, o)
        o += 8
        y0 = y - ymin
        ny = min(lpb, h - y0)
        raw_size = row_bytes * ny
        chunk = data[o:o + nbytes]
        if comp == NO_COMPRESSION or nbytes >= raw_size:
            raw = chunk[:raw_size]
        else:
            raw = _unpredict(zlib.decompress(chunk))
        ro = 0  # scanline-interleaved: a line, then each channel
        for ly in range(ny):
            for name, pt in chans:
                nb = w * _DTYPE[pt].itemsize
                out[name][y0 + ly] = np.frombuffer(raw[ro:ro + nb],
                                                   _DTYPE[pt])
                ro += nb
    channels = {name: out[name].astype(np.float32) if pt != UINT
                else out[name] for name, pt in chans}
    return channels, attrs


def read_exr_rgb(path: str) -> np.ndarray:
    """An EXR as [h, w, 3] float32 (R, G, B); a single channel is
    broadcast, alpha dropped."""
    channels, _ = read_exr(path)
    if all(k in channels for k in "RGB"):
        return np.stack([channels["R"], channels["G"], channels["B"]], -1)
    if "Y" in channels:
        return np.repeat(channels["Y"][..., None], 3, -1)
    vals = list(channels.values())
    if len(vals) == 1:
        return np.repeat(vals[0][..., None], 3, -1)
    raise ValueError(f"unsupported channel set {sorted(channels)}")


def _attr(name: str, typ: str, val: bytes) -> bytes:
    return (name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(val)) + val)


def write_exr(path: str, img, channel_names=None, half=True):
    """[h, w] or [h, w, C] float data as a ZIP-compressed scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    if channel_names is None:
        channel_names = ["Y"] if nc == 1 else list("RGBA"[:nc])
    if len(channel_names) != nc:
        raise ValueError(f"{len(channel_names)} names for {nc} channels")
    ptype = HALF if half else FLOAT
    dt = _DTYPE[ptype]
    order = sorted(range(nc), key=lambda i: channel_names[i])
    chlist = b"".join(channel_names[i].encode() + b"\x00"
                      + struct.pack("<i", ptype) + b"\x00" * 4
                      + struct.pack("<ii", 1, 1) for i in order) + b"\x00"
    dw = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        struct.pack("<ii", MAGIC, 2),
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression", bytes([ZIP_COMPRESSION])),
        _attr("dataWindow", "box2i", dw),
        _attr("displayWindow", "box2i", dw),
        _attr("lineOrder", "lineOrder", b"\x00"),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\x00",
    ])
    lpb = _LINES_PER_BLOCK[ZIP_COMPRESSION]
    blocks = []
    for y0 in range(0, h, lpb):
        raw = b"".join(img[ly, :, i].astype(dt).tobytes()
                       for ly in range(y0, min(y0 + lpb, h)) for i in order)
        comp = zlib.compress(_predict(raw), 6)
        blocks.append((y0, comp if len(comp) < len(raw) else raw))
    pos = len(header) + 8 * len(blocks)
    offsets = []
    for _, comp in blocks:
        offsets.append(pos)
        pos += 8 + len(comp)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{len(blocks)}q", *offsets))
        for y0, comp in blocks:
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)
