"""Scene and DDF losses (mirror of ``neusky_tpu/models/losses.py``)."""

from __future__ import annotations

import torch

from benchmark.reference.plain.device import device_constant

EPS = 1.0e-7


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative: +1 at x = 0 (torch.abs gives 0 there).
    It matters where a prediction clamped to 1 meets a saturated target."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(_abs(pred - target))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def _safe_norm(x: torch.Tensor, dim=-1, eps: float = 1e-12) -> torch.Tensor:
    """Norm with a finite gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def cosine_colour_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    num = torch.sum(pred * target, dim=-1)
    return torch.mean(1.0 - num / (_safe_norm(pred) * _safe_norm(target)))


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    pred = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -torch.mean(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred))


def eikonal_loss(gradients: torch.Tensor) -> torch.Tensor:
    """((‖∇sdf‖ − 1)²).mean()."""
    return torch.mean((_safe_norm(gradients) - 1.0) ** 2)


def fg_mask_loss(weights_sum: torch.Tensor, fg_mask: torch.Tensor) -> torch.Tensor:
    ws = torch.clamp(weights_sum, 1e-3, 1.0 - 1e-3)
    ws = torch.nan_to_num(ws, nan=0.5)
    return binary_cross_entropy(ws, fg_mask)


def monosdf_normal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    pred_n = pred / _safe_norm(pred)[..., None]
    gt_n = gt / _safe_norm(gt)[..., None]
    l1 = torch.mean(torch.sum(_abs(pred_n - gt_n), dim=-1))
    cos = torch.mean(1.0 - torch.sum(pred_n * gt_n, dim=-1))
    return l1 + cos


def sky_pixel_loss(
    pred_sky_srgb: torch.Tensor,
    gt_image: torch.Tensor,
    sky_mask: torch.Tensor,
    cosine_weight: float = 0.1,
) -> torch.Tensor:
    """Masked MSE + α(1 − cos) between decoded sky colour and GT sky pixels."""
    inputs = pred_sky_srgb * sky_mask
    targets = gt_image * sky_mask
    mse = torch.mean((inputs - targets) ** 2)
    num = torch.sum(inputs * targets, dim=-1)
    cos_loss = 1.0 - torch.mean(num / (_safe_norm(inputs) * _safe_norm(targets)))
    return mse + cosine_weight * cos_loss


def _outer_measure(t0_starts, t0_ends, t1_starts, t1_ends, y1) -> torch.Tensor:
    """Sum of y1 over env bins overlapping each query interval (outer
    measure of the mip-NeRF-360 proposal loss).  All args [..., S]."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    # searchsorted == the JAX comparison counts (t1 edges are sorted)
    idx_lo = torch.searchsorted(t1_starts.contiguous(), t0_starts.contiguous(), right=True) - 1
    idx_lo = torch.clamp(idx_lo, 0, y1.shape[-1] - 1)
    idx_hi = torch.searchsorted(t1_ends.contiguous(), t0_ends.contiguous(), right=False)
    idx_hi = torch.clamp(idx_hi, 0, y1.shape[-1] - 1)
    return torch.gather(cy1, -1, idx_hi + 1) - torch.gather(cy1, -1, idx_lo)


def interlevel_loss(weights_list, samples_list) -> torch.Tensor:
    """Proposal distillation: each proposal histogram must upper-bound the
    (stop-gradient) final histogram on the s-domain."""
    final = samples_list[-1]
    w_final = weights_list[-1][..., 0].detach()
    c_starts = final.spacing_starts[..., 0].detach()
    c_ends = final.spacing_ends[..., 0].detach()
    total = 0.0
    for rs, w in zip(samples_list[:-1], weights_list[:-1]):
        w_outer = _outer_measure(
            c_starts, c_ends, rs.spacing_starts[..., 0], rs.spacing_ends[..., 0], w[..., 0]
        )
        total = total + torch.mean(torch.clamp(w_final - w_outer, min=0.0) ** 2 / (w_final + EPS))
    return total


def hashgrid_density_loss(grid_alphas: torch.Tensor) -> torch.Tensor:
    return torch.mean(_abs(grid_alphas))


def ground_plane_loss(normal_pred: torch.Tensor, ground_mask: torch.Tensor) -> torch.Tensor:
    up = device_constant((0.0, 0.0, 1.0), torch.float32, normal_pred.device)
    gm = ground_mask.reshape(-1, 1)
    return monosdf_normal_loss(normal_pred * gm, up.expand_as(normal_pred) * gm)


def visibility_sigmoid_loss(
    visibility_threshold: torch.Tensor,
    sigmoid_scale: torch.Tensor,
    target_min_bias: float,
    target_max_scale: float,
    optimise_bias: bool,
    optimise_scale: bool,
) -> torch.Tensor:
    loss = torch.zeros((), device=visibility_threshold.device)
    if optimise_bias:
        loss = loss + (visibility_threshold - target_min_bias) ** 2
    if optimise_scale:
        loss = loss + (sigmoid_scale / target_max_scale - 1.0) ** 2
    return loss.squeeze()


def scale_loss_dict(loss_dict: dict, coefficients: dict) -> dict:
    return {k: v * coefficients.get(k, 1.0) for k, v in loss_dict.items()}


# ---------- DDF losses (mirror of ``neusky_tpu/models/losses.py:180-223``) ----------


def ddf_depth_loss(
    expected_dist: torch.Tensor,
    gt_dist: torch.Tensor,
    mask: torch.Tensor,
    ddf_radius: float,
    mask_to_circumference: bool = False,
    distance_weight=None,
    inverse_depth_weight: bool = False,
    use_l2: bool = False,
) -> torch.Tensor:
    """Depth supervision of the DDF, masked to hits (or, with
    ``mask_to_circumference``, with misses set to the sphere's diameter)."""
    if mask_to_circumference:
        gt = torch.where(mask == 0, torch.full_like(gt_dist, ddf_radius * 2.0), gt_dist)
        pred = expected_dist
    else:
        gt = gt_dist * mask
        pred = expected_dist * mask
    err = (pred - gt) ** 2 if use_l2 else _abs(pred - gt)
    if inverse_depth_weight:
        err = err / (gt + 1e-6)
    if distance_weight is not None:
        err = err * distance_weight
    return torch.mean(err)


def ddf_sdf_level_loss(sdf_at_termination: torch.Tensor, mask: torch.Tensor, use_l2: bool) -> torch.Tensor:
    """The SDF at the predicted termination point should be zero."""
    v = sdf_at_termination * mask
    return torch.mean(v**2) if use_l2 else torch.mean(_abs(v))


def ddf_multi_view_loss(expected: torch.Tensor, max_allowed: torch.Tensor) -> torch.Tensor:
    """Predictions may not exceed the known distance to a GT surface point
    seen from another sphere point."""
    return torch.mean(torch.relu(expected - max_allowed) ** 2)


def ddf_sky_ray_loss(expected: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(_abs(expected - gt))


def ddf_prob_hit_loss(prob: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return binary_cross_entropy(prob, mask)
