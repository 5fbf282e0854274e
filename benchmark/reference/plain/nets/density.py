"""NeuS alpha (mirror of ``neusky_tpu/nets/density.py::neus_alpha``)."""

from __future__ import annotations

import torch


def neus_alpha(
    sdf: torch.Tensor,
    gradients: torch.Tensor,
    directions: torch.Tensor,
    deltas: torch.Tensor,
    inv_s: torch.Tensor,
    cos_anneal_ratio: float = 1.0,
) -> torch.Tensor:
    """NeuS alpha from SDF + spatial gradient (nerfstudio ``get_alpha``).
    sdf/deltas: [N, S, 1]; gradients/directions: [N, S, 3]."""
    true_cos = torch.sum(directions * gradients, dim=-1, keepdim=True)
    iter_cos = -(
        torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
        + torch.relu(-true_cos) * cos_anneal_ratio
    )
    est_next_sdf = sdf + iter_cos * deltas * 0.5
    est_prev_sdf = sdf - iter_cos * deltas * 0.5
    prev_cdf = torch.sigmoid(est_prev_sdf * inv_s)
    next_cdf = torch.sigmoid(est_next_sdf * inv_s)
    p = prev_cdf - next_cdf
    c = prev_cdf
    return torch.clamp((p + 1e-5) / (c + 1e-5), 0.0, 1.0)
