"""Fabricated NeRF-OSR and Blender-synthetic dataset fixtures (mirror of
``neusky_tpu/data/fixtures.py``): the same random stream, arrays, poses,
intrinsics and ``transforms.json``; the PNGs are written by
:func:`~neusky_torch.utils.viz.save_png_u8` (no Pillow) and decode to the
same arrays.

The NeRF-OSR fixture is structurally complete and multi-session:
per-split ``intrinsics/ pose/ rgb/ cityscapes_mask/`` directories,
``ENV_MAP_CC/<session>/`` folders driving the session↔image maps, and
NeRF-OSR ``test/mask`` eval masks, in the real on-disk layout that
``data/dataparsers/nerfosr.py`` reads.

The imagery is a simple lit scene: sky gradient tinted per session above
the horizon, a "building" block whose brightness depends on the session's
sun tint, and a road strip — enough structure for training dynamics and
masked metrics to be meaningful.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from neusky_torch.data.dataparsers.nerfosr import CITYSCAPE_CLASSES
from neusky_torch.utils.viz import save_png_u8

_COLOURS = {c: np.array(col, np.uint8) for c, col in zip(CITYSCAPE_CLASSES["classes"], CITYSCAPE_CLASSES["colours"])}

# per-session sky tints (linear RGB) — the "relighting" signal
_SESSION_TINTS = [
    np.array([1.0, 0.85, 0.6]),   # warm
    np.array([0.6, 0.75, 1.0]),   # cool
    np.array([0.9, 0.9, 0.9]),    # neutral
    np.array([1.0, 0.7, 0.7]),    # sunset
]


def _render_view(w: int, h: int, cam_x: float, tint: np.ndarray, rng) -> Dict:
    """(rgb uint8, semantic uint8) for a camera at offset cam_x."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    horizon = int(h * 0.45)
    ground_row = int(h * 0.8)
    rgb = np.zeros((h, w, 3), np.float32)
    sem = np.zeros((h, w, 3), np.uint8)

    # sky: vertical gradient in the session tint
    grad = (1.0 - ys / max(horizon, 1))[:, :, None].clip(0.3, 1.0)
    rgb[:horizon] = (tint[None, None, :] * grad[:horizon]).clip(0, 1)
    sem[:horizon] = _COLOURS["sky"]

    # building block: brightness modulated by tint luminance; its screen
    # position shifts with the camera for parallax
    b_left = int(w * 0.25 - cam_x * w * 0.05) % w
    b_right = min(w - 1, b_left + int(w * 0.4))
    lum = float(tint.mean())
    rgb[horizon:ground_row] = 0.15
    sem[horizon:ground_row] = _COLOURS["terrain"]
    rgb[horizon:ground_row, b_left:b_right] = 0.45 * lum * np.array([0.8, 0.75, 0.7])
    sem[horizon:ground_row, b_left:b_right] = _COLOURS["building"]

    # road strip
    rgb[ground_row:] = 0.25 * lum
    sem[ground_row:] = _COLOURS["road"]

    # small transient car in some views
    if rng.uniform() < 0.5:
        cx = rng.integers(0, w - 4)
        rgb[ground_row - 3:ground_row, cx:cx + 4] = [0.7, 0.1, 0.1]
        sem[ground_row - 3:ground_row, cx:cx + 4] = _COLOURS["car"]

    return {
        "rgb": (rgb * 255).astype(np.uint8),
        "sem": sem,
        "building_mask": (sem == _COLOURS["building"]).all(-1),
    }


def make_nerfosr_fixture(
    root: str | Path,
    num_sessions: int = 3,
    train_per_session: int = 3,
    test_per_session: int = 2,
    width: int = 32,
    height: int = 24,
    seed: int = 0,
) -> Path:
    """Build the fixture under ``root`` (the dataparser's ``data`` dir for
    scene ``site1``).  Test split: image 0 of each session is the latent
    holdout (``session_holdout_indices=(0,...)``), the rest get NeRF-OSR
    eval masks (building-masked compare set)."""
    root = Path(root)
    scene_dir = root / "lk2" / "final"
    rng = np.random.default_rng(seed)
    sessions = [f"session_{chr(65 + s)}" for s in range(num_sessions)]
    for s_i, s in enumerate(sessions):
        d = scene_dir / "ENV_MAP_CC" / s
        d.mkdir(parents=True, exist_ok=True)
        # GT envmap capture: equirect sky gradient in the session tint
        tint = _SESSION_TINTS[s_i % len(_SESSION_TINTS)]
        ew, eh = 64, 32
        ys = np.linspace(0.0, 1.0, eh)[:, None, None]
        env = np.clip(tint[None, None, :] * (1.0 - 0.7 * ys), 0, 1)
        env = np.broadcast_to(env, (eh, ew, 3))
        save_png_u8(d / "envmap.png", (env * 255).astype(np.uint8))

    fl = width * 1.2
    for split, per_session in (("train", train_per_session), ("validation", 1), ("test", test_per_session)):
        for sub in ("intrinsics", "pose", "rgb", "cityscapes_mask", "mask"):
            (scene_dir / split / sub).mkdir(parents=True, exist_ok=True)
        idx = 0
        for s_i, session in enumerate(sessions):
            tint = _SESSION_TINTS[s_i % len(_SESSION_TINTS)]
            for j in range(per_session):
                name = f"{session}_{idx:04d}"
                cam_x = (idx - per_session * num_sessions / 2) * 0.15
                K = np.eye(4)
                K[0, 0] = K[1, 1] = fl
                K[0, 2], K[1, 2] = width / 2, height / 2
                (scene_dir / split / "intrinsics" / f"{name}.txt").write_text(" ".join(str(x) for x in K.reshape(-1)))
                pose = np.eye(4)
                pose[:3, 3] = [cam_x, 0.1 * np.sin(idx), 1.5]
                (scene_dir / split / "pose" / f"{name}.txt").write_text(" ".join(str(x) for x in pose.reshape(-1)))
                view = _render_view(width, height, cam_x, tint, rng)
                save_png_u8(scene_dir / split / "rgb" / f"{name}.png", view["rgb"])
                save_png_u8(scene_dir / split / "cityscapes_mask" / f"{name}.png", view["sem"])
                if split == "test" and j > 0:
                    # NeRF-OSR eval mask: metrics restricted to buildings
                    m = (view["building_mask"] * 255).astype(np.uint8)
                    save_png_u8(scene_dir / split / "mask" / f"{name}.png", np.stack([m] * 3, -1))
                idx += 1
    return root


def make_blender_fixture(
    root: str | Path,
    num_train: int = 4,
    num_val: int = 2,
    width: int = 32,
    height: int = 24,
    seed: int = 0,
) -> Path:
    """Fabricated Blender-synthetic dataset for the ``custom_neusky``
    dataparser: ``transforms.json`` with per-frame intrinsics, c2w
    matrices, envmap name/rotation metadata, plus rgb PNGs rendered with
    the same lit-scene generator as the NeRF-OSR fixture (no segmentation —
    synthetic data carries no cityscapes masks, the dataset defaults to
    all-static)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    fl = width * 1.2
    frames = []
    tint = _SESSION_TINTS[0]
    for split, n in (("train", num_train), ("validation", num_val)):
        (root / split / "rgb").mkdir(parents=True, exist_ok=True)
        for i in range(n):
            name = f"{split}/rgb/{i:04d}.png"
            cam_x = (i - n / 2) * 0.15
            view = _render_view(width, height, cam_x, tint, rng)
            save_png_u8(root / name, view["rgb"])
            c2w = np.eye(4)
            c2w[:3, 3] = [cam_x, 0.1 * np.sin(i), 1.5]
            frames.append({
                "file_path": name,
                "transform_matrix": c2w.tolist(),
                "envmap_name": f"sky_{i % 2}",
                "envmap_rotation": [0.0, 0.0, 0.1 * i],
            })
    meta = {"fl_x": fl, "fl_y": fl, "cx": width / 2, "cy": height / 2, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root
