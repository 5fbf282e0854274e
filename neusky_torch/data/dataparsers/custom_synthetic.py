"""Blender-synthetic multi-illumination dataparser on the host with numpy
(mirror of ``neusky_tpu/data/dataparsers/custom_synthetic.py``):

  - ``transforms.json`` with per-frame intrinsics + envmap name/rotation
    (instant-ngp/BlenderNeRF format, OpenGL poses);
  - joint pose normalisation across all splits; optional SfM-point-cloud
    robust centering/scaling (outlier percentile filter + percentile-radius
    scale) with a numpy PLY loader when ``plyfile`` is not installed;
  - GT EXR layer discovery (albedo/normal/depth/roughness/metallic/ior/
    transmission, aligned by filename stem) and GT HDRI resolution from
    sibling ``hdris``/``hdris_16k`` directories.

The image size is read from the first image's PNG header
(:func:`~neusky_torch.utils.viz.image_size`), not decoded with Pillow.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from neusky_torch.data.dataparsers.nerfosr import IMAGE_EXTS, find_files, perspective_cameras
from neusky_torch.data.dataparsers.pose_utils import auto_orient_and_center_poses
from neusky_torch.utils.viz import image_size

GT_LAYER_NAMES = [
    "albedo", "normal", "depth", "roughness", "metallic", "ior", "transmission",
]


@dataclasses.dataclass(frozen=True)
class CustomSyntheticDataparserConfig:
    data: str = "path/to/data"
    transforms_filename: str = "transforms.json"
    scene_scale: float = 1.0
    scale_factor: float = 1.0
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    mask_vegetation: bool = False
    include_sidewalk_in_ground_mask: bool = True
    center_method_sfm: bool = False
    sfm_outlier_percentile: float = 95.0
    sfm_scale_percentile: float = 50.0
    sfm_target_radius: float = 0.5
    points3d_filename: str = "points3d.ply"


def load_ply_points(ply_path: Path) -> Optional[np.ndarray]:
    """PLY xyz [N, 3] float32: through ``plyfile`` when it is installed,
    else read here (binary_little_endian x, y, z, r, g, b or ASCII); None
    when the file cannot be read."""
    try:
        from plyfile import PlyData
    except ImportError:
        PlyData = None
    if PlyData is not None:
        try:
            v = PlyData.read(str(ply_path))["vertex"]
        except Exception:  # any unreadable file: no SfM centering, as in JAX
            return None
        return np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    try:
        with open(ply_path, "rb") as f:
            header = []
            while True:
                line = f.readline().decode("ascii").strip()
                header.append(line)
                if line == "end_header":
                    break
            n_vertices = 0
            is_binary = False
            for line in header:
                if line.startswith("element vertex"):
                    n_vertices = int(line.split()[-1])
                if "binary_little_endian" in line:
                    is_binary = True
            if n_vertices == 0:
                return None
            if is_binary:
                dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                  ("red", "u1"), ("green", "u1"), ("blue", "u1")])
                data = np.frombuffer(f.read(n_vertices * dtype.itemsize), dtype=dtype)
                return np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
            data = np.loadtxt(f, max_rows=n_vertices)
            return data[:, :3].astype(np.float32)
    except Exception:  # any unreadable file: no SfM centering, as in JAX
        return None


def compute_sfm_centering(
    points: np.ndarray,
    outlier_percentile: float = 95.0,
    scale_percentile: float = 50.0,
    target_radius: float = 0.5,
) -> Tuple[np.ndarray, float]:
    """Robust centre + scale from an SfM cloud."""
    median = np.median(points, axis=0)
    dists = np.linalg.norm(points - median, axis=1)
    inliers = points[dists <= np.percentile(dists, outlier_percentile)]
    center = inliers.mean(axis=0)
    d = np.linalg.norm(inliers - center, axis=1)
    target = np.percentile(d, scale_percentile)
    return center, target_radius / max(float(target), 1e-6)


def parse_custom_synthetic_scene(config: CustomSyntheticDataparserConfig, split: str = "train") -> Dict:
    data = Path(config.data)
    meta = json.loads((data / config.transforms_filename).read_text())
    d_fx, d_fy = float(meta["fl_x"]), float(meta["fl_y"])
    d_cx, d_cy = float(meta["cx"]), float(meta["cy"])
    frame_data = {}
    for frame in meta["frames"]:
        frame_data[frame["file_path"]] = {
            "c2w": np.asarray(frame["transform_matrix"], np.float32),
            "fx": float(frame.get("fl_x", d_fx)),
            "fy": float(frame.get("fl_y", d_fy)),
            "cx": float(frame.get("cx", d_cx)),
            "cy": float(frame.get("cy", d_cy)),
            "envmap_name": frame.get("envmap_name"),
            "envmap_rotation": frame.get("envmap_rotation"),
        }

    all_c2w, all_intr = [], []
    per_split: Dict[str, Dict[str, list]] = {}
    for s in ("train", "val", "test"):
        sname = "validation" if s == "val" else s
        rgb_files = find_files(str(data / sname / "rgb"), IMAGE_EXTS)
        mask_files = find_files(str(data / sname / "cityscapes_mask"), IMAGE_EXTS)
        mask_by_stem = {Path(m).stem: m for m in mask_files}
        imgs, msks, envs = [], [], []
        for img in rgb_files:
            rel = str(Path(img).relative_to(data))
            if rel not in frame_data:
                continue
            fd = frame_data[rel]
            all_c2w.append(fd["c2w"])
            all_intr.append((fd["fx"], fd["fy"], fd["cx"], fd["cy"]))
            imgs.append(img)
            msks.append(mask_by_stem.get(Path(img).stem))
            envs.append({"name": fd["envmap_name"], "rotation": fd["envmap_rotation"]})
        per_split[s] = {"images": imgs, "masks": msks, "envmaps": envs}

    counts = {s: len(per_split[s]["images"]) for s in per_split}
    if sum(counts.values()) == 0:
        raise ValueError(f"no frames matched transforms in {data}")

    c2w = np.stack(all_c2w)
    intr = np.asarray(all_intr, np.float32)

    if config.center_method_sfm:
        c2w, transform = auto_orient_and_center_poses(c2w, config.orientation_method, "none")
        orientation_rotation = transform[:3, :3].copy()
        points = load_ply_points(data / config.points3d_filename)
        if points is not None:
            points = (transform[:3, :3] @ points.T).T + transform[:3, 3]
            center, scale = compute_sfm_centering(
                points, config.sfm_outlier_percentile, config.sfm_scale_percentile, config.sfm_target_radius,
            )
            c2w[:, :3, 3] -= center
            c2w[:, :3, 3] *= scale * config.scale_factor
        else:
            c2w[:, 2, 3] -= c2w[:, 2, 3].mean()
            if config.auto_scale_poses:
                c2w[:, :3, 3] *= (1.0 / np.abs(c2w[:, :3, 3]).max()) * config.scale_factor
    else:
        c2w, transform = auto_orient_and_center_poses(c2w, config.orientation_method, config.center_method)
        orientation_rotation = transform[:3, :3].copy()
        c2w[:, 2, 3] -= c2w[:, 2, 3].mean()
        if config.auto_scale_poses:
            scale = 1.0
            scale /= np.abs(c2w[:, :3, 3]).max()
            c2w[:, :3, 3] *= scale * config.scale_factor

    query = "val" if split in ("val", "validation") else split
    if counts.get(query, 0) == 0:
        query = "train"
    offset = 0
    for s in ("train", "val", "test"):
        if s == query:
            break
        offset += counts[s]
    sl = slice(offset, offset + counts[query])

    image_filenames = per_split[query]["images"]
    w0, h0 = image_size(image_filenames[0]) if image_filenames else (None, None)
    width_height = [w0, h0] if w0 else None
    cameras = perspective_cameras(c2w[sl][:, :3, :4], intr[sl, 0], intr[sl, 1], intr[sl, 2], intr[sl, 3],
                                  width_height)

    # GT layers: aligned by stem, all or nothing per layer
    gt_layers: Dict[str, List[Optional[str]]] = {}
    sname = "validation" if query == "val" else query
    stem_to_idx = {Path(p).stem: i for i, p in enumerate(image_filenames)}
    for layer in GT_LAYER_NAMES:
        exrs = find_files(str(data / sname / layer), ["*.exr", "*.EXR"])
        if not exrs:
            continue
        by_stem = {Path(e).stem: e for e in exrs}
        aligned: List[Optional[str]] = [None] * len(image_filenames)
        if all(stem in by_stem for stem in stem_to_idx):
            for stem, i in stem_to_idx.items():
                aligned[i] = by_stem[stem]
            gt_layers[f"gt_{layer}_filenames"] = aligned

    # GT HDRIs from sibling hdris/ dirs
    hdri_dirs = [data.parent.parent / "hdris", data.parent.parent / "hdris_16k"]
    gt_envmap_info: List[Optional[dict]] = []
    for info in per_split[query]["envmaps"]:
        name = info.get("name")
        found = None
        if name is not None:
            for d in hdri_dirs:
                cand = d / f"{name}.exr"
                if cand.exists():
                    found = {"path": str(cand), "rotation": info.get("rotation")}
                    break
        gt_envmap_info.append(found)

    aabb = config.scene_scale
    seg = per_split[query]["masks"]
    return {
        "cameras": cameras,
        "image_filenames": image_filenames,
        "segmentation_filenames": seg if all(m is not None for m in seg) and seg else None,
        "mask_filenames": None,
        "envmap_filenames": [],
        "scene_aabb": np.array([[-aabb] * 3, [aabb] * 3], np.float32),
        "session_to_indices": None,
        "indices_to_session": None,
        "session_holdout_indices": [],
        "test_eval_mask_dict": {},
        "out_of_view_frustum_objects_masks": [None] * len(image_filenames),
        "width_height": width_height,
        "orientation_rotation": orientation_rotation,
        "gt_envmap_info": gt_envmap_info,
        "transform": transform,
        "scale": config.scale_factor,
        "config": config,
        **gt_layers,
    }
