"""Colormaps, side-by-side panels and PNG files, on the host with numpy
(the port's own copy of ``neusky_tpu/utils/viz.py``).  ``save_png``,
``save_png_u8`` and ``load_png`` write and read PNGs with ``zlib`` and
``struct`` alone: the card's machine has no Pillow."""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

# a compact viridis approximation (32 anchor points, linearly interpolated)
_VIRIDIS = np.array([
    [0.267004, 0.004874, 0.329415], [0.277018, 0.050344, 0.375715],
    [0.282327, 0.094955, 0.417331], [0.282884, 0.13592, 0.453427],
    [0.278012, 0.180367, 0.486697], [0.269308, 0.218818, 0.509577],
    [0.257322, 0.25613, 0.526563], [0.243113, 0.292092, 0.538516],
    [0.225863, 0.330805, 0.547314], [0.210503, 0.363727, 0.552206],
    [0.19586, 0.395433, 0.555276], [0.182256, 0.426184, 0.55712],
    [0.168126, 0.459988, 0.558082], [0.15627, 0.489624, 0.557936],
    [0.144759, 0.519093, 0.556572], [0.133743, 0.548535, 0.553541],
    [0.119423, 0.581687, 0.547445], [0.12478, 0.610259, 0.538982],
    [0.143303, 0.640828, 0.524396], [0.180653, 0.668054, 0.50586],
    [0.226397, 0.695213, 0.478603], [0.281477, 0.719538, 0.445772],
    [0.344074, 0.741564, 0.406889], [0.421908, 0.761208, 0.35767],
    [0.496615, 0.777248, 0.307244], [0.575563, 0.791076, 0.251217],
    [0.657642, 0.802588, 0.188385], [0.751884, 0.812524, 0.114392],
    [0.83527, 0.819205, 0.060309], [0.916242, 0.826646, 0.0941],
    [0.975158, 0.836934, 0.175382], [0.993248, 0.906157, 0.143936],
])


def apply_colormap(x: np.ndarray) -> np.ndarray:
    """Scalar [H, W] or [H, W, 1] in [0, 1] → RGB [H, W, 3] (viridis)."""
    if x.ndim == 3:
        x = x[..., 0]
    pos = np.clip(x, 0.0, 1.0) * (len(_VIRIDIS) - 1)
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, len(_VIRIDIS) - 1)
    t = (pos - lo)[..., None]
    return (1 - t) * _VIRIDIS[lo] + t * _VIRIDIS[hi]


def apply_depth_colormap(
    depth: np.ndarray,
    accumulation: Optional[np.ndarray] = None,
    near_plane: Optional[float] = None,
    far_plane: Optional[float] = None,
) -> np.ndarray:
    """Depth normalised to [near, far] (default: its range), colormapped,
    optionally faded by the accumulation."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    near = float(depth.min()) if near_plane is None else near_plane
    far = float(depth.max()) if far_plane is None else far_plane
    rgb = apply_colormap((depth - near) / max(far - near, 1e-10))
    if accumulation is not None:
        if accumulation.ndim == 3:
            accumulation = accumulation[..., 0]
        rgb = rgb * accumulation[..., None]
    return rgb


def side_by_side(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GT | prediction, concatenated along the width."""
    return np.concatenate([a, b], axis=1)


def normalised_error_map(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Min-max normalised squared-error heatmap."""
    err = (pred - gt) ** 2
    err = (err - err.min()) / max(err.max() - err.min(), 1e-10)
    return apply_colormap(err.mean(axis=-1))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each PNG colour type: grey, RGB, palette index,
# grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def save_png_u8(path, image: np.ndarray):
    """Write a uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA)
    image as an 8-bit PNG, its bytes as they are."""
    arr = np.ascontiguousarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"save_png_u8 takes uint8, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        colour_type = 0
    elif arr.ndim == 3 and arr.shape[2] in (3, 4):
        colour_type = 2 if arr.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot write an image of shape {arr.shape} as PNG")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0 per row
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_png(path: str, image: np.ndarray):
    """Write an [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) image
    in [0, 1] as an 8-bit PNG."""
    save_png_u8(path, np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8))


def _png_chunks(data: bytes, path) -> list:
    """[(kind, payload)] of a PNG file's bytes, each CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    chunks, pos = [], 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        chunks.append((kind, payload))
        pos += 12 + n
        if kind == b"IEND":
            break
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    return chunks


def _unfilter_row(filt: int, row: np.ndarray, prev: np.ndarray, bpp: int, path) -> np.ndarray:
    """One scanline (uint8) with its PNG filter (0 none, 1 sub, 2 up,
    3 average, 4 Paeth) undone; ``prev`` is the previous reconstructed row
    (zeros above the first).  Sub and up are array sums (uint8 wraps mod
    256); average and Paeth depend on the byte just reconstructed, so they
    run byte by byte."""
    if filt == 0:
        return row
    if filt == 1:
        return (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8).reshape(-1)
    if filt == 2:
        return row + prev
    if filt not in (3, 4):
        raise ValueError(f"{path}: unknown PNG row filter {filt}")
    cur, up = row.tolist(), prev.tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if filt == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def png_header(path) -> dict:
    """``width``, ``height``, ``bit_depth``, ``colour_type`` and
    ``interlace`` of a PNG file, read from its IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", head[16:29])
    return {"width": w, "height": h, "bit_depth": depth, "colour_type": colour, "interlace": interlace}


def load_png(path) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG with ``zlib`` and ``struct``
    alone, to the array ``np.asarray(PIL.Image.open(path))`` gives: uint8
    [H, W] for grey and for a palette image (its indices, the palette not
    applied), [H, W, 2] grey + alpha, [H, W, 3] RGB, [H, W, 4] RGBA.
    Raises, naming the file, for any other bit depth or an interlaced
    file."""
    with open(path, "rb") as f:
        chunks = _png_chunks(f.read(), path)
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if colour not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit PNGs are decoded")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG; only non-interlaced PNGs are decoded")
    bpp = _PNG_CHANNELS[colour]
    stride = w * bpp
    raw = zlib.decompress(b"".join(payload for kind, payload in chunks if kind == b"IDAT"))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG data is {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp, path)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def load_image(path) -> np.ndarray:
    """An image file as ``np.asarray(PIL.Image.open(path))`` gives it: a
    PNG through :func:`load_png`, any other format (NeRF-OSR's JPEGs)
    through Pillow, which it needs."""
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_SIGNATURE
    if is_png:
        return load_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path} is not a PNG; decoding it needs Pillow, which is not installed") from e
    with Image.open(path) as im:
        return np.asarray(im)


def image_size(path) -> tuple:
    """(width, height) of an image file: from a PNG's header, else from the
    decoded image (:func:`load_image`)."""
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_SIGNATURE
    if is_png:
        hdr = png_header(path)
        return hdr["width"], hdr["height"]
    h, w = load_image(path).shape[:2]
    return w, h
