"""NeuSky dataset: image loading + 4-channel mask construction, into host
numpy arrays for the ``DataManager`` (mirror of
``neusky_tpu/data/dataset.py``):

  - image loading with centre-crop / pad-to-equal-size;
  - the 4-channel mask tensor [static, fg, ground, sky] built from
    cityscapes semantic colour maps: transients (people, vehicles,
    optionally vegetation) are cut from the static channel,
    buildings/roads/etc form the fg channel, road(+sidewalk) the ground
    channel, sky the sky channel;
  - out-of-view-frustum object masks ANDed into static+fg;
  - NeRF-OSR test eval masks override the static channel on the test split.

Images are decoded by :func:`~neusky_torch.utils.viz.load_image` (PNG
without Pillow; JPEG through Pillow).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from neusky_torch.data.dataparsers.nerfosr import CITYSCAPE_CLASSES
from neusky_torch.utils.viz import load_image

_TRANSIENT_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]
_FG_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "terrain",
]


def _open_image(path: str) -> np.ndarray:
    img = load_image(path)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img[:, :, :3]


def _center_crop(img: np.ndarray, tw: int, th: int) -> np.ndarray:
    h, w = img.shape[:2]
    left = max((w - tw) // 2, 0)
    top = max((h - th) // 2, 0)
    return img[top:top + th, left:left + tw]


def _center_pad(img: np.ndarray, tw: int, th: int) -> np.ndarray:
    h, w = img.shape[:2]
    out = np.zeros((th, tw, *img.shape[2:]), img.dtype)
    top = (th - h) // 2
    left = (tw - w) // 2
    out[top:top + h, left:left + w] = img
    return out


def _class_mask(semantic_rgb: np.ndarray, class_names: List[str]) -> np.ndarray:
    """Boolean mask of pixels whose colour matches any class."""
    classes = CITYSCAPE_CLASSES["classes"]
    colours = np.asarray(CITYSCAPE_CLASSES["colours"], np.int32)
    out = np.zeros(semantic_rgb.shape[:2], bool)
    sem = semantic_rgb[:, :, :3].astype(np.int32)
    for name in class_names:
        col = colours[classes.index(name)]
        out |= np.all(sem == col[None, None, :], axis=2)
    return out


def build_mask_from_semantics(
    semantic_rgb: np.ndarray,
    mask_vegetation: bool = True,
    include_sidewalk_in_ground: bool = True,
    object_mask: Optional[np.ndarray] = None,
    test_eval_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The 4-channel [static, fg, ground, sky] mask."""
    transient = list(_TRANSIENT_CLASSES)
    fg = list(_FG_CLASSES)
    if mask_vegetation:
        transient.append("vegetation")
    else:
        fg.append("vegetation")

    if test_eval_mask is not None:
        static = test_eval_mask.astype(np.float32)
    else:
        static = (~_class_mask(semantic_rgb, transient)).astype(np.float32)

    fg_mask = _class_mask(semantic_rgb, fg).astype(np.float32)
    ground_classes = ["road"] + (["sidewalk"] if include_sidewalk_in_ground else [])
    ground = _class_mask(semantic_rgb, ground_classes).astype(np.float32)
    sky = _class_mask(semantic_rgb, ["sky"]).astype(np.float32)

    if object_mask is not None:
        keep = (~(object_mask > 0.5)).astype(np.float32)
        static = static * keep
        fg_mask = fg_mask * keep

    return np.stack([static, fg_mask, ground, sky], axis=-1)


@dataclasses.dataclass
class NeuSkyDataset:
    """Materialises images + masks for a parsed split into arrays."""

    parser_outputs: Dict
    split: str = "train"
    downscale_factor: int = 1

    def load(self) -> Dict[str, np.ndarray]:
        po = self.parser_outputs
        cfg = po["config"]
        wh = po["width_height"]
        images, masks = [], []
        n = len(po["image_filenames"])
        for idx in range(n):
            img = _open_image(po["image_filenames"][idx]).astype(np.float32) / 255.0
            sem = None
            if po.get("segmentation_filenames"):
                sem = _open_image(po["segmentation_filenames"][idx])

            obj = None
            om = po["out_of_view_frustum_objects_masks"][idx]
            if om is not None:
                obj = _open_image(om)[:, :, 0].astype(np.float32) / 255.0

            test_mask = None
            if self.split == "test" and idx in po["test_eval_mask_dict"]:
                tm = _open_image(po["test_eval_mask_dict"][idx])
                test_mask = tm[:, :, 0].astype(np.float32) / 255.0

            if sem is not None:
                mask = build_mask_from_semantics(
                    sem,
                    mask_vegetation=cfg.mask_vegetation,
                    include_sidewalk_in_ground=cfg.include_sidewalk_in_ground_mask,
                    object_mask=obj,
                    test_eval_mask=test_mask,
                )
            else:
                mask = np.ones((*img.shape[:2], 4), np.float32)
                mask[..., 2] = 0.0
                mask[..., 3] = 0.0

            if getattr(cfg, "crop_to_equal_size", False) and wh:
                img = _center_crop(img, wh[0], wh[1])
                mask = _center_crop(mask, wh[0], wh[1])
            if getattr(cfg, "pad_to_equal_size", False) and wh:
                img = _center_pad(img, wh[0], wh[1])
                mask = _center_pad(mask, wh[0], wh[1])
            if self.downscale_factor > 1:
                f = self.downscale_factor
                img = img[::f, ::f]
                mask = mask[::f, ::f]
            images.append(img)
            masks.append(mask)

        cameras = po["cameras"]
        if self.downscale_factor > 1:
            cameras = downscale_cameras(cameras, self.downscale_factor)
        return {
            "images": np.stack(images),
            "masks": np.stack(masks),
            "cameras": cameras,
        }


def downscale_cameras(cameras, factor: int):
    """Scale intrinsics for integer image downscaling."""
    return dataclasses.replace(
        cameras,
        fx=cameras.fx / factor,
        fy=cameras.fy / factor,
        cx=cameras.cx / factor,
        cy=cameras.cy / factor,
        width=cameras.width // factor,
        height=cameras.height // factor,
    )
