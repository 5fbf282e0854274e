"""Proposal-network sampling (mirror of ``neusky_tpu/sampling/proposal.py``):
jittered uniform bins in the normalised s-domain, then rounds of
proposal-density evaluation and inverse-CDF resampling, then the final
NeuS sample set.

Randomness is explicit: ``jitters`` holds one [N, 1] uniform draw per
round (round 0 = the initial bins' stratified jitter, then one per
inverse-CDF resampling, the last for the final samples) — the JAX
package's ``jax.random.uniform(keys[i], (N, 1))``.  Missing draws are taken
from ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from benchmark.reference.plain.core.rays import RayBundle, RaySamples, weights_from_densities


@dataclasses.dataclass(frozen=True)
class ProposalSamplerConfig:
    num_proposal_samples: Tuple[int, ...] = (256, 96)
    num_final_samples: int = 48
    single_jitter: bool = True
    histogram_padding: float = 0.01
    anneal_slope: float = 10.0
    anneal_max_num_iters: int = 1000


def s_to_euclidean(s: torch.Tensor, nears: torch.Tensor, fars: torch.Tensor) -> torch.Tensor:
    """Piecewise linear/disparity map from s ∈ [0, 1] to euclidean t."""
    g_near = torch.where(nears < 1.0, nears / 2.0, 1.0 - 1.0 / (2.0 * torch.clamp(nears, min=1e-12)))
    g_far = torch.where(fars < 1.0, fars / 2.0, 1.0 - 1.0 / (2.0 * torch.clamp(fars, min=1e-12)))
    gs = g_near + s * (g_far - g_near)
    return torch.where(gs < 0.5, 2.0 * gs, 1.0 / torch.clamp(2.0 - 2.0 * gs, min=1e-12))


def _draw(jitter, shape, generator, device):
    if jitter is not None:
        return jitter
    return torch.rand(shape, generator=generator, device=device)


def uniform_lindisp_samples(
    ray_bundle: RayBundle,
    num_samples: int,
    single_jitter: bool = True,
    train: bool = True,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Initial s-domain bin edges [N, S+1], stratified-jittered in training."""
    n = ray_bundle.num_rays
    device = ray_bundle.origins.device
    edges = torch.linspace(0.0, 1.0, num_samples + 1, device=device)[None, :].expand(n, -1)
    if not train:
        return edges.contiguous()
    shape = (n, 1) if single_jitter else (n, num_samples + 1)
    jitter = _draw(jitter, shape, generator, device)
    jittered = edges + (jitter - 0.5) * (1.0 / num_samples)
    return torch.clamp(jittered, 0.0, 1.0)


@torch.no_grad()
def pdf_sample_bins(
    bins_s: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    histogram_padding: float = 0.01,
    single_jitter: bool = True,
    train: bool = True,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF resampling of bin edges; not differentiated through.
    bins_s [N, S+1], weights [N, S, 1] → new edges [N, num_samples+1]."""
    n, s = weights.shape[0], weights.shape[1]
    w = weights[..., 0] + histogram_padding
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.relu(1e-5 - w_sum)
    w = w + padding / s
    w_sum = w_sum + padding
    pdf = w / w_sum
    cdf = torch.cat([torch.zeros((n, 1), device=w.device), torch.cumsum(pdf, dim=-1)], dim=-1)
    cdf = torch.clamp(cdf, max=1.0)

    m = num_samples + 1
    base = torch.linspace(0.0, 1.0 - 1.0 / m, m, device=w.device)[None, :]
    if train:
        shape = (n, 1) if single_jitter else (n, m)
        u = base + _draw(jitter, shape, generator, w.device) / m
    else:
        u = (base + 0.5 / m).expand(n, -1)
    u = u.contiguous()
    # searchsorted(side="right") == the JAX count of cdf entries ≤ u
    # (cdf is non-decreasing)
    idx = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(idx - 1, 0, s)
    above = torch.clamp(idx, 0, s)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins_s, -1, below)
    bins_above = torch.gather(bins_s, -1, above)
    gap = cdf_above - cdf_below
    denom = torch.where(gap < 1e-10, torch.ones_like(gap), gap)
    t = torch.clamp((u - cdf_below) / denom, 0.0, 1.0)
    new_bins = bins_below + t * (bins_above - bins_below)
    return torch.sort(new_bins, dim=-1).values


def bins_to_ray_samples(ray_bundle: RayBundle, bins_s: torch.Tensor) -> RaySamples:
    n, sp1 = bins_s.shape
    s = sp1 - 1
    starts_s = bins_s[:, :-1, None]
    ends_s = bins_s[:, 1:, None]
    nears = ray_bundle.nears[:, :, None]
    fars = ray_bundle.fars[:, :, None]
    starts = s_to_euclidean(starts_s, nears, fars)
    ends = s_to_euclidean(ends_s, nears, fars)
    return RaySamples(
        origins=ray_bundle.origins[:, None, :].expand(n, s, 3),
        directions=ray_bundle.directions[:, None, :].expand(n, s, 3),
        starts=starts,
        ends=ends,
        pixel_area=ray_bundle.pixel_area[:, None, :].expand(n, s, 1),
        camera_indices=ray_bundle.camera_indices[:, None, :].expand(n, s, 1),
        deltas=ends - starts,
        spacing_starts=starts_s,
        spacing_ends=ends_s,
    )


def anneal_bias(x, slope: float):
    """nerfacto proposal-weight anneal: b(x, s) = s·x / ((s−1)·x + 1)."""
    return slope * x / ((slope - 1.0) * x + 1.0)


def proposal_anneal(step, config: ProposalSamplerConfig):
    """The exponent of the proposal weights at training step ``step``: a
    float for a float step, a 0-d float32 tensor for a tensor step (JAX's
    ``jnp.clip`` on a traced step, so a captured step reads it on the
    device), 1.0 for None."""
    if step is None:
        return 1.0
    if isinstance(step, torch.Tensor):
        x = torch.clamp(step.to(torch.float32) / config.anneal_max_num_iters, 0.0, 1.0)
    else:
        x = min(max(step / config.anneal_max_num_iters, 0.0), 1.0)
    return anneal_bias(x, config.anneal_slope)


def proposal_sample(
    ray_bundle: RayBundle,
    density_fns: List[Callable[[torch.Tensor], torch.Tensor]],
    config: ProposalSamplerConfig,
    train: bool = True,
    step=None,
    jitters: Optional[Sequence[Optional[torch.Tensor]]] = None,
    generator: Optional[torch.Generator] = None,
):
    """Full proposal pass → (final RaySamples, weights_list, samples_list).
    ``density_fns[i](positions [N, S, 3]) → densities [N, S, 1]``; ``step``
    (a float, a 0-d tensor or None) anneals the weights
    (:func:`proposal_anneal`)."""
    num_iters = len(config.num_proposal_samples)
    anneal = proposal_anneal(step, config)
    jitters = list(jitters) if jitters is not None else [None] * (num_iters + 1)

    weights_list, samples_list = [], []
    bins = weights = None
    for i in range(num_iters):
        if i == 0:
            bins = uniform_lindisp_samples(
                ray_bundle, config.num_proposal_samples[i], config.single_jitter,
                train, jitters[i], generator,
            )
        else:
            bins = pdf_sample_bins(
                bins, torch.pow(weights.detach(), anneal), config.num_proposal_samples[i],
                config.histogram_padding, config.single_jitter, train,
                jitters[i], generator,
            )
        rs = bins_to_ray_samples(ray_bundle, bins)
        density = density_fns[i](rs.start_positions())
        weights = weights_from_densities(density, rs.deltas)
        weights_list.append(weights)
        samples_list.append(rs)

    final_bins = pdf_sample_bins(
        bins, torch.pow(weights.detach(), anneal), config.num_final_samples,
        config.histogram_padding, config.single_jitter, train,
        jitters[-1], generator,
    )
    return bins_to_ray_samples(ray_bundle, final_bins), weights_list, samples_list
