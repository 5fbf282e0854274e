"""Pose normalisation on the host with numpy (the port's own copy of
``neusky_tpu/data/dataparsers/pose_utils.py``, equal to it bit for bit):
nerfstudio's ``camera_utils.auto_orient_and_center_poses`` as the
NeRF-OSR and Blender-synthetic parsers use it."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        if c > 0:
            return np.eye(3)
        # opposite: rotate 180° about any perpendicular axis
        perp = np.array([1.0, 0.0, 0.0])
        if abs(a[0]) > 0.9:
            perp = np.array([0.0, 1.0, 0.0])
        v = np.cross(a, perp)
        v /= np.linalg.norm(v)
        return 2.0 * np.outer(v, v) - np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient (mean camera up → +z) and center a [N, 4, 4] pose stack.

    Returns (oriented poses [N, 4, 4], applied transform [3, 4]).
    ``center_method`` ``"focus"`` centres on the mean origin, as in JAX
    (its focus-point solve is omitted there too)."""
    origins = poses[:, :3, 3]
    if center_method in ("poses", "focus"):
        translation = origins.mean(axis=0)
    else:
        translation = np.zeros(3)

    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        rotation = rotation_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(method)

    transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=1)
    new_poses = np.einsum("ij,njk->nik", transform[:3, :3], poses[:, :3, :])
    new_poses[:, :3, 3] += transform[:3, 3]
    out = np.tile(np.eye(4, dtype=poses.dtype)[None], (poses.shape[0], 1, 1))
    out[:, :3, :] = new_poses
    return out, transform
