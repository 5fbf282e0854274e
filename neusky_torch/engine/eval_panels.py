"""Eval image panels and GT-layer metrics (mirror of
``neusky_tpu/engine/eval_panels.py``): the GT | prediction panels (rgb,
accumulation, depth, normal, normalised error, albedo, per-proposal
depth), the decoded envmap (LDR | HDR heatmap), and on synthetic splits the
GT-layer metrics (albedo PSNR/SSIM after a per-channel least-squares
rescale, normal mean angular error, depth MSE after a scale-and-shift
alignment).  Panels and metrics are host numpy; the envmap decode and
LPIPS run on the model's device."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from neusky_torch.core.colour import linear_to_sRGB
from neusky_torch.engine import metrics as M
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.sampling.illumination import EquirectangularSampler
from neusky_torch.utils.viz import apply_colormap, apply_depth_colormap, normalised_error_map, side_by_side


def _srgb(x: np.ndarray) -> np.ndarray:
    return linear_to_sRGB(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def normalized_depth_scale_and_shift(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> Tuple[float, float]:
    """Least-squares (scale, shift) aligning ``pred`` to ``gt`` on the
    masked pixels, in float64; (1, 0) when the system is singular."""
    m = mask.astype(np.float64).reshape(-1)
    p = pred.astype(np.float64).reshape(-1)
    g = gt.astype(np.float64).reshape(-1)
    a00, a01, a11 = np.sum(m * p * p), np.sum(m * p), np.sum(m)
    b0, b1 = np.sum(m * p * g), np.sum(m * g)
    det = a00 * a11 - a01 * a01
    if abs(det) < 1e-12:
        return 1.0, 0.0
    return float((a11 * b0 - a01 * b1) / det), float((-a01 * b0 + a00 * b1) / det)


@torch.inference_mode()
def render_reni_envmap(model: NeuSkyModel, params, latent_slot: int, width: int = 128,
                       use_eval_latents: bool = True) -> Dict[str, np.ndarray]:
    """The sky of latent slot ``latent_slot`` (eval or train group) decoded
    on a ``width`` × width/2 equirectangular grid: sRGB LDR, heatmap of the
    HDR channel mean, and the two side by side."""
    sampler = EquirectangularSampler(width=width)
    dirs = sampler(model.device)
    group = params["eval_latents"] if use_eval_latents else params["illumination_field"]
    z = group["eval_latents" if use_eval_latents else "train_latents"][latent_slot]
    s = group["eval_scale" if use_eval_latents else "train_scale"][latent_slot:latent_slot + 1]
    m = dirs.shape[0]
    out = model.illumination.apply(params["illumination_decoder"], dirs, z[None].expand(m, *z.shape), s.expand(m))
    hdr_t = model.illumination.unnormalise(out["rgb"])
    h = sampler.height
    ldr = linear_to_sRGB(hdr_t).cpu().numpy().reshape(h, width, 3)
    hdr_mean = hdr_t.cpu().numpy().reshape(h, width, 3).mean(axis=-1, keepdims=True)
    heat = apply_depth_colormap(hdr_mean, near_plane=hdr_mean.min(), far_plane=hdr_mean.max())
    return {"ldr": ldr, "hdr_heatmap": heat, "panel": side_by_side(ldr, heat)}


def image_metrics_and_panels(
    model: NeuSkyModel,
    params,
    outputs: Dict[str, np.ndarray],
    batch: Dict[str, Any],
    height: int,
    width: int,
    latent_slot: int = 0,
    gt_layers: Optional[Dict[str, np.ndarray]] = None,
    graphed: Optional[bool] = None,
) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
    """(metrics, panels) of one rendered image: ``outputs`` are the flat
    [H·W, C] maps of :func:`~neusky_torch.engine.eval_loop.render_camera`,
    ``batch`` the ground truth of ``DataManager.eval_image_bundle``;
    ``gt_layers`` (``albedo``, ``normal``, ``depth``) adds the GT-layer
    metrics; ``graphed`` as LPIPS's (``engine/lpips.py``)."""
    H, W = height, width
    rgb = outputs["rgb"].reshape(H, W, 3)
    gt = np.asarray(batch["image"]).reshape(H, W, 3)
    mask = np.asarray(batch["mask"]).reshape(H, W, 4)
    acc = outputs["accumulation"].reshape(H, W, 1)
    depth = outputs["depth"].reshape(H, W, 1)
    normal = outputs["normal"].reshape(H, W, 3)

    images: Dict[str, np.ndarray] = {
        "img": side_by_side(gt, rgb),
        "accumulation": side_by_side(apply_colormap(mask[..., 1]), apply_colormap(acc[..., 0])),
        "depth": apply_depth_colormap(depth, accumulation=acc),
        "normal": side_by_side(0 * gt + 0.5, (normal + 1.0) / 2.0),
        "normalised_error": normalised_error_map(rgb, gt),
        "albedo": outputs["albedo"].reshape(H, W, 3),
    }
    for k in outputs:
        if k.startswith("prop_depth_"):
            images[k] = apply_depth_colormap(outputs[k].reshape(H, W, 1), accumulation=acc)

    metrics = {
        "psnr": M.psnr(rgb, gt),
        "ssim": M.ssim_image(rgb, gt),
        "mse": M.mse(rgb, gt),
        "lpips": M.lpips_image(rgb, gt, model.device, graphed),
    }
    images["reni_envmap"] = render_reni_envmap(model, params, latent_slot)["panel"]

    fg = mask[..., 1:2]
    sel = fg[..., 0] > 0.5
    if gt_layers and "albedo" in gt_layers:
        gt_alb = _srgb(gt_layers["albedo"])
        pred_alb = _srgb(images["albedo"]).copy()
        if sel.any():
            for c in range(3):
                p, g = pred_alb[..., c][sel], gt_alb[..., c][sel]
                denom = float((p * p).sum())
                if denom > 1e-8:
                    pred_alb[..., c] *= float((g * p).sum()) / denom
        metrics["albedo_psnr"] = M.psnr(pred_alb * fg, gt_alb * fg)
        metrics["albedo_ssim"] = M.ssim_image(pred_alb * fg, gt_alb * fg)
        images["gt_vs_pred_albedo"] = side_by_side(gt_alb, pred_alb)
    if gt_layers and "normal" in gt_layers:
        gt_n = gt_layers["normal"]
        gt_n = gt_n / np.maximum(np.linalg.norm(gt_n, axis=-1, keepdims=True), 1e-12)
        pr_n = normal / np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
        if sel.any():
            cos = np.clip((gt_n[sel] * pr_n[sel]).sum(-1), -1, 1)
            metrics["normal_mae"] = float(np.degrees(np.arccos(cos)).mean())
        images["gt_vs_pred_normal"] = side_by_side((gt_n + 1) / 2, (pr_n + 1) / 2)
    if gt_layers and "depth" in gt_layers:
        gt_d = gt_layers["depth"].reshape(H, W)
        valid = (gt_d > 0) & sel
        if valid.any():
            s, t = normalized_depth_scale_and_shift(depth[..., 0], gt_d, valid)
            aligned = depth[..., 0] * s + t
            metrics["depth_mse"] = float(((aligned - gt_d) ** 2)[valid].mean())
            images["gt_vs_pred_depth"] = side_by_side(apply_depth_colormap(gt_d[..., None]),
                                                      apply_depth_colormap(aligned[..., None]))
    return metrics, images
