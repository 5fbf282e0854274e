"""NeRF-OSR (cityscapes-masked) dataparser on the host with numpy (mirror
of ``neusky_tpu/data/dataparsers/nerfosr.py``):

  - per-image ``intrinsics/*.txt`` + ``pose/*.txt`` (4×4 matrices);
    OpenCV→OpenGL flip of the y/z columns;
  - joint auto-orient/center/scale across ALL splits so train/val/test share
    one normalised frame;
  - crop/pad-to-equal-size via principal-point adjustment (min/max cx, cy);
  - session discovery from ``ENV_MAP_CC/<session>/`` folder names matched
    against image filenames; session↔index maps + holdout indices;
  - cityscapes semantic masks / out-of-view-frustum object masks / NeRF-OSR
    test eval masks (by filename match).

Returns a plain dict ("dataparser outputs"): perspective ``Cameras`` on the
CPU (the ``DataManager`` moves them to its device), filename lists, session
maps, scene box, metadata — consumed by ``NeuSkyDataset``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from neusky_torch.core.cameras import Cameras, CameraType
from neusky_torch.data.dataparsers.pose_utils import auto_orient_and_center_poses

CITYSCAPE_CLASSES: Dict[str, list] = {
    "classes": [
        "road", "sidewalk", "building", "wall", "fence", "pole",
        "traffic light", "traffic sign", "vegetation", "terrain", "sky",
        "person", "rider", "car", "truck", "bus", "train", "motorcycle",
        "bicycle",
    ],
    "colours": [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ],
}

IMAGE_EXTS = ["*.png", "*.jpg", "*.JPG", "*.PNG"]
_SCENE_ALIASES = {"site1": "lk2", "site2": "st", "site3": "lwp"}
_NO_SESSION_SCENES = ("trevi", "europa", "rathaus", "schloss")


@dataclasses.dataclass(frozen=True)
class NeRFOSRDataparserConfig:
    data: str = "data/nerfosr"
    scene: str = "site1"
    scene_scale: float = 1.0
    scale_factor: float = 1.0
    auto_scale_poses: bool = True
    orientation_method: str = "up"
    center_method: str = "poses"
    crop_to_equal_size: bool = True
    pad_to_equal_size: bool = False
    mask_source: str = "cityscapes"  # none | original | cityscapes
    mask_vegetation: bool = True
    mask_out_of_view_frustum_objects: bool = True
    include_sidewalk_in_ground_mask: bool = True
    session_holdout_indices: Tuple[int, ...] = (0, 0, 0, 0, 0)


def parse_holdout_arg(s) -> Tuple[int, ...]:
    """CLI ``--session-holdout-indices`` "0,1,0" → (0, 1, 0)."""
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).split(",") if x.strip() != "")


def find_files(directory: str, exts: List[str], recursive: bool = False) -> List[str]:
    """Sorted paths in ``directory`` matching any of the glob ``exts`` (none
    when it does not exist)."""
    if not os.path.isdir(directory):
        return []
    out: List[str] = []
    for ext in exts:
        pattern = os.path.join(directory, "**", ext) if recursive else os.path.join(directory, ext)
        out.extend(glob.glob(pattern, recursive=recursive))
    return sorted(out)


def _parse_matrix_txt(path: str) -> np.ndarray:
    nums = Path(path).read_text().split()
    return np.asarray([float(x) for x in nums], np.float32).reshape(4, 4)


def _load_split_cameras(scene_dir: str, split: str) -> Tuple[np.ndarray, np.ndarray, int]:
    split_dir = f"{scene_dir}/{split}"
    intr_files = find_files(f"{split_dir}/intrinsics", ["*.txt"])
    pose_files = find_files(f"{split_dir}/pose", ["*.txt"])
    n = len(pose_files)
    intr, c2w = [], []
    for i in range(n):
        intr.append(_parse_matrix_txt(intr_files[i]))
        pose = _parse_matrix_txt(pose_files[i])
        pose[0:3, 1:3] *= -1  # OpenCV → OpenGL
        c2w.append(pose)
    if n == 0:
        return np.zeros((0, 4, 4), np.float32), np.zeros((0, 4, 4), np.float32), 0
    return np.stack(intr), np.stack(c2w), n


def perspective_cameras(c2w: np.ndarray, fx, fy, cx, cy, width_height) -> Cameras:
    """Host (CPU) perspective cameras from [N, 3, 4] poses and [N]
    intrinsics, their float32 bits kept."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return Cameras(
        camera_to_worlds=t(c2w), fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy),
        width=width_height[0] if width_height else 0,
        height=width_height[1] if width_height else 0,
        camera_type=int(CameraType.PERSPECTIVE),
    )


def parse_nerfosr_scene(config: NeRFOSRDataparserConfig, split: str = "train") -> Dict:
    if config.crop_to_equal_size and config.pad_to_equal_size:
        raise ValueError("Cannot crop and pad at the same time")
    scene = _SCENE_ALIASES.get(config.scene, config.scene)
    split = "validation" if split == "val" else split
    sub = "final_clean" if scene == "trevi" else "final"
    scene_dir = f"{config.data}/{scene}/{sub}"
    split_dir = f"{scene_dir}/{split}"

    intr_tr, c2w_tr, n_train = _load_split_cameras(scene_dir, "train")
    intr_va, c2w_va, n_val = _load_split_cameras(scene_dir, "validation")
    intr_te, c2w_te, n_test = _load_split_cameras(scene_dir, "test")

    intrinsics = np.concatenate([intr_tr, intr_va, intr_te], axis=0)
    c2w_all = np.concatenate([c2w_tr, c2w_va, c2w_te], axis=0)

    width_height: Optional[List[int]] = None
    if config.crop_to_equal_size:
        min_cx = intrinsics[:, 0, 2].min()
        min_cy = intrinsics[:, 1, 2].min()
        width_height = [int(min_cx * 2), int(min_cy * 2)]
        intrinsics[:, 0, 2] = min_cx
        intrinsics[:, 1, 2] = min_cy
    if config.pad_to_equal_size:
        max_cx = intrinsics[:, 0, 2].max()
        max_cy = intrinsics[:, 1, 2].max()
        width_height = [int(max_cx * 2), int(max_cy * 2)]
        intrinsics[:, 0, 2] = max_cx
        intrinsics[:, 1, 2] = max_cy

    # one normalised frame for all splits
    c2w_all, transform = auto_orient_and_center_poses(c2w_all, config.orientation_method, config.center_method)
    c2w_all[:, 2, 3] -= c2w_all[:, 2, 3].mean()
    scale = 1.0
    if config.auto_scale_poses:
        scale /= np.abs(c2w_all[:, :3, 3]).max()
    c2w_all[:, :3, 3] *= scale * config.scale_factor

    if split == "train":
        sel = slice(0, n_train)
    elif split == "validation":
        sel = slice(n_train, n_train + n_val)
    else:
        sel = slice(n_train + n_val, None)
    c2w = c2w_all[sel]
    intr = intrinsics[sel]

    if width_height is None and len(intr):
        width_height = [int(intr[0, 0, 2] * 2), int(intr[0, 1, 2] * 2)]

    cameras = perspective_cameras(c2w[:, :3, :4], intr[:, 0, 0], intr[:, 1, 1], intr[:, 0, 2], intr[:, 1, 2],
                                  width_height)

    image_filenames = find_files(f"{split_dir}/rgb", IMAGE_EXTS)
    envmap_filenames = find_files(f"{scene_dir}/ENV_MAP_CC", IMAGE_EXTS, recursive=True)

    # session maps
    session_to_indices = None
    indices_to_session = None
    session_names = None
    if scene not in _NO_SESSION_SCENES:
        sessions = [os.path.basename(x) for x in sorted(glob.glob(f"{scene_dir}/ENV_MAP_CC/*"))]
        s2i = defaultdict(list)
        for idx, filename in enumerate(image_filenames):
            for session in sessions:
                if session in filename:
                    s2i[session].append(idx)
        # latent-slot order = the sorted session-directory order (not the
        # images' order), so slot s always matches ``session_names[s]``
        session_names = [s for s in sessions if s in s2i]
        session_to_indices = {i: s2i[k] for i, k in enumerate(session_names)}
        indices_to_session = {}
        for s_idx, idxs in session_to_indices.items():
            for idx in idxs:
                indices_to_session[idx] = s_idx
        if split in ("validation", "test") and len(config.session_holdout_indices) != len(session_to_indices):
            raise ValueError(
                f"number of relative eval indices ({len(config.session_holdout_indices)}) must match number "
                f"of unique sessions ({len(session_to_indices)})"
            )

    # masks
    mask_filenames = None
    segmentation_filenames = None
    if config.mask_source == "original":
        mask_filenames = find_files(f"{split_dir}/mask", IMAGE_EXTS)
    elif config.mask_source == "cityscapes":
        seg_dir = f"{split_dir}/cityscapes_mask"
        if not os.path.isdir(seg_dir):
            raise FileNotFoundError(f"cityscapes mask folder missing: {seg_dir} (run segmentation offline)")
        segmentation_filenames = find_files(seg_dir, IMAGE_EXTS)

    # out-of-view-frustum object masks
    object_masks: List[Optional[str]] = [None] * len(image_filenames)
    ofd = f"{split_dir}/out_of_view_frustum_objects_mask"
    if config.mask_out_of_view_frustum_objects and os.path.isdir(ofd):
        stem_to_mask = {Path(f).stem: f for f in find_files(ofd, IMAGE_EXTS)}
        for idx, f in enumerate(image_filenames):
            object_masks[idx] = stem_to_mask.get(Path(f).stem)

    # NeRF-OSR test eval masks
    test_eval_mask_dict: Dict[int, str] = {}
    if split == "test" and scene not in _NO_SESSION_SCENES:
        stem_to_idx = {Path(f).stem: i for i, f in enumerate(image_filenames)}
        for mask_path in find_files(f"{split_dir}/mask", IMAGE_EXTS):
            stem = Path(mask_path).stem
            if stem in stem_to_idx:
                test_eval_mask_dict[stem_to_idx[stem]] = mask_path
        if session_to_indices is not None:
            holdout = [session_to_indices[k][i]
                       for k, i in zip(session_to_indices.keys(), config.session_holdout_indices)]
            for idx in holdout:
                if idx in test_eval_mask_dict:
                    raise ValueError(f"image {idx} is both holdout and eval — fix session_holdout_indices")

    aabb = config.scene_scale
    return {
        "cameras": cameras,
        "image_filenames": image_filenames,
        "segmentation_filenames": segmentation_filenames,
        "mask_filenames": mask_filenames,
        "envmap_filenames": envmap_filenames,
        "scene_aabb": np.array([[-aabb] * 3, [aabb] * 3], np.float32),
        "session_to_indices": session_to_indices,
        "indices_to_session": indices_to_session,
        "session_names": session_names,
        "session_holdout_indices": list(config.session_holdout_indices),
        "test_eval_mask_dict": test_eval_mask_dict,
        "out_of_view_frustum_objects_masks": object_masks,
        "width_height": width_height,
        "transform": transform,
        "scale": scale * config.scale_factor,
        "config": config,
    }
