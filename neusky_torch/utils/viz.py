"""Colormaps, side-by-side panels and PNG output, on the host with numpy
(the port's own copy of ``neusky_tpu/utils/viz.py``).  ``save_png`` writes
the file with ``zlib`` and ``struct`` alone."""

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


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def save_png(path: str, image: np.ndarray):
    """Write an [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) image
    in [0, 1] as an 8-bit PNG."""
    arr = np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)
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
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))
