"""NeuSky model (mirror of ``neusky_tpu/models/neusky.py``).

Plain orchestrator over an explicit params dict whose top-level groups are
the optimizer groups: ``fields``, ``proposal_networks_{i}``,
``illumination_field``, ``eval_latents``, ``illumination_decoder``,
``visibility_sigmoid`` and ``ddf_field``.  The forward runs the proposal
sampler through the two hash-grid density fields, the SDF/albedo field
with analytic d/dx, the frozen RENI++ decoder, the DDF visibility of every
(ray, upper-hemisphere light direction) pair with the SDF at a strided
subset of the DDF's termination points, Lambertian shading and the scene
losses.  ``generate_ddf_ground_truth`` renders the DDF's supervision from
the SDF.

Not ported yet: ``forward_with_ddf_gt`` (the fused scene and ground-truth
pass), the GT-illumination probe and Blinn-Phong shading; a config that
asks for them raises ``NotImplementedError``.

Randomness: ``forward`` takes ``draws``, a dict of explicit random draws
(see :meth:`NeuSkyModel.draw`); any draw it lacks comes from ``generator``.
The keys and their JAX sources (``jax.random`` calls under the key tree of
``forward``):

- ``proposal_jitters``: [N, 1] uniforms per proposal round + final round;
- ``proposal_stoch_u``: [N·S_i] uniforms per proposal field (``stoch_u``);
- ``sdf_salt``: uint32 salt of the SDF stochastic table gradient (the
  scene's ``field_outputs`` and the level-set query at the DDF's
  termination points share it, as in JAX);
- ``light_rotation``: the four normals of the light-direction rotation;
- ``grid_jitter`` [R³, 3] uniforms, ``grid_dirs`` [R³, 3] normals and
  ``grid_salt``: the hash-grid density prior's perturbed grid.

``generate_ddf_ground_truth`` takes ``proposal_stoch_u`` and ``sdf_salt``
of its own (:meth:`NeuSkyModel.draw_ddf_gt`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from neusky_torch.core.colour import linear_to_sRGB
from neusky_torch.core.rays import (
    RayBundle,
    RaySamples,
    render_accumulation,
    render_depth,
    render_normal,
    render_rgb_with_background,
    weights_and_transmittance_from_alphas,
)
from neusky_torch.core.scene import aabb_collider, sphere_collider
from neusky_torch.core.spherical import ray_sphere_intersection
from neusky_torch.device import resolve_device
from neusky_torch.fields.density_field import DensityFieldConfig, HashMLPDensityField
from neusky_torch.fields.reni import RENIField, RENIFieldConfig
from neusky_torch.fields.sdf_albedo import SDFAlbedoField, SDFAlbedoFieldConfig
from neusky_torch.models import losses as L
from neusky_torch.models.ddf_model import DDFModel, DDFModelConfig
from neusky_torch.nets.density import neus_alpha
from neusky_torch.sampling.illumination import IcosahedronSampler
from neusky_torch.sampling.proposal import ProposalSamplerConfig, proposal_sample
from neusky_torch.shading.lambertian import lambertian_composite
from neusky_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LossInclusions:
    rgb_l1: bool = True
    rgb_l2: bool = False
    cosine_colour: bool = False
    eikonal: bool = True
    fg_mask: bool = True
    normal: bool = False
    depth: bool = False
    sdf_level_set_visibility: bool = True
    interlevel: bool = True
    sky_pixel: bool = True
    sky_pixel_cosine_weight: float = 0.1
    hashgrid_density: bool = True
    hashgrid_density_grid_resolution: int = 10
    ground_plane: bool = True
    vis_sigmoid_method: str = "learnable"
    vis_optimise_sigmoid_bias: bool = True
    vis_optimise_sigmoid_scale: bool = False
    vis_target_min_bias: float = 0.1
    vis_target_max_scale: float = 25.0
    vis_steps_until_min_bias: int = 50000


_DEFAULT_COEFFS = (
    ("rgb_l1_loss", 1.0), ("rgb_l2_loss", 0.0), ("cosine_colour_loss", 1.0),
    ("eikonal_loss", 0.1), ("fg_mask_loss", 1.0), ("normal_loss", 1.0),
    ("depth_loss", 1.0), ("sdf_level_set_visibility_loss", 1.0),
    ("interlevel_loss", 1.0), ("sky_pixel_loss", 1.0),
    ("hashgrid_density_loss", 1e-4), ("ground_plane_loss", 0.1),
    ("visibility_sigmoid_loss", 0.01),
)


@dataclasses.dataclass(frozen=True)
class NeuSkyModelConfig:
    sdf_field: SDFAlbedoFieldConfig = SDFAlbedoFieldConfig()
    proposal: ProposalSamplerConfig = ProposalSamplerConfig()
    proposal_fields: Tuple[DensityFieldConfig, ...] = (DensityFieldConfig(), DensityFieldConfig())
    illumination: RENIFieldConfig = RENIFieldConfig()
    illumination_prior_dir: Optional[str] = None
    ddf: Optional[DDFModelConfig] = DDFModelConfig()
    num_illumination_directions: int = 512
    illumination_sampler_random_rotation: bool = True
    fix_test_illumination_directions: bool = True
    use_visibility: bool = True
    fit_visibility_field: bool = True
    sdf_to_visibility_stop_gradients: str = "depth"
    only_upperhemisphere_visibility: bool = True
    lower_hemisphere_visibility: bool = True
    visibility_sigmoid_scale: float = 25.0
    scene_contraction_order: str = "l2"
    collider_shape: str = "sphere"
    collider_radius: float = 1.0
    collider_near: float = 0.05
    scene_aabb_scale: float = 1.0
    ddf_radius: float = 1.0
    num_train_data: int = 1
    num_eval_data: int = 1
    losses: LossInclusions = LossInclusions()
    loss_coefficients: tuple = _DEFAULT_COEFFS
    render_ambient_light: bool = False
    eval_latent_optimise_method: str = "per_image"
    optimise_compare_eval_scale: bool = False
    mask_to_building_in_metrics: bool = False
    visibility_query_chunk: int = 16384
    visibility_remat_policy: str = "full"
    sdf_query_chunk: int = 0
    cos_anneal_ratio: float = 1.0
    gt_illumination_probe: bool = False
    gt_probe_background: tuple = (0.35, 0.55, 0.95)
    fused_ddf_gt_pass: bool = False
    sdf_level_set_subset: int = 64


def freeze_decoder_params(params):
    """Detach a RENI params tree so only latents/scales get gradients
    (the JAX ``stop_gradient`` of ``fixed_decoder=True``)."""
    return tree_map(lambda t: t.detach(), params)


def _u32_salt(generator, device) -> torch.Tensor:
    return torch.randint(0, 2**32, (), generator=generator, device=device, dtype=torch.int64)


def visibility_query_directions(config: NeuSkyModelConfig, num_directions: int) -> int:
    """The light directions each ray's visibility queries: with
    ``only_upperhemisphere_visibility`` (and more than 8 directions) the
    top k = min(D, D//2 + 8) by z, else all D."""
    if config.only_upperhemisphere_visibility and num_directions > 8:
        return min(num_directions, num_directions // 2 + 8)
    return num_directions


def top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of ``values`` [D] in ``jax.lax.top_k``'s
    order: descending, equal values by index (a stable sort)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def _chunked_apply(fn, args: Tuple[torch.Tensor, ...], chunk: int, remat_policy: str = "full"):
    """``fn`` over the leading axis in chunks of ``chunk`` rows, each chunk
    under ``torch.utils.checkpoint`` when autograd records (its activations
    are recomputed in the backward): bounds the peak memory of the N·D
    visibility queries.  Exact,
    since ``fn`` is row-wise and the chunks' results are concatenated.
    ``fn`` returns a dict of tensors."""
    if remat_policy != "full":
        raise NotImplementedError(f"visibility_remat_policy {remat_policy!r} is not ported yet")
    m = args[0].shape[0]
    run = (lambda *a: checkpoint(fn, *a, use_reentrant=False)) if torch.is_grad_enabled() else fn
    outs = [run(*(a[s:s + chunk] for a in args)) for s in range(0, m, chunk)]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


class NeuSkyModel:
    """See the module docstring.  Entry point: runs on ``device``
    (default CUDA; raises without a card unless ``device="cpu"``)."""

    def __init__(self, config: NeuSkyModelConfig, device="cuda"):
        if config.sdf_query_chunk:
            raise NotImplementedError("a chunked level-set SDF query (sdf_query_chunk > 0) is not ported yet")
        if config.gt_illumination_probe or config.sdf_field.predict_shininess:
            raise NotImplementedError("the GT-illumination probe and Blinn-Phong shading are not ported yet")
        self.config = config
        self.device = resolve_device(device)
        self.field = SDFAlbedoField(config.sdf_field)
        self.proposal_fields = [HashMLPDensityField(c) for c in config.proposal_fields]
        self.illumination = RENIField(config.illumination)
        self.illumination_sampler = IcosahedronSampler(
            num_directions=config.num_illumination_directions,
            apply_random_rotation=config.illumination_sampler_random_rotation,
        )
        self.num_directions = self.illumination_sampler.actual_num_directions
        self.ddf = DDFModel(config.ddf, ddf_radius=config.ddf_radius) if config.ddf is not None else None

    # ------------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        c = self.config
        dev = self.device
        lat = c.illumination.latent_dim
        params = {
            "fields": self.field.init(generator, dev),
            "illumination_field": {
                "train_latents": torch.zeros((c.num_train_data, lat, 3), device=dev),
                "train_scale": torch.ones((c.num_train_data,), device=dev),
            },
            "eval_latents": {
                "eval_latents": torch.zeros((c.num_eval_data, lat, 3), device=dev),
                "eval_scale": torch.ones((c.num_eval_data,), device=dev),
                "eval_rotation": torch.ones((c.num_eval_data,), device=dev),
            },
            "illumination_decoder": self.illumination.init(generator, dev),
        }
        for i, pf in enumerate(self.proposal_fields):
            params[f"proposal_networks_{i}"] = pf.init(generator, dev)
        if self.ddf is not None:
            params["ddf_field"] = self.ddf.init(generator, dev)
        if c.losses.vis_sigmoid_method == "learnable":
            scale = 1.0 if c.losses.vis_optimise_sigmoid_scale else c.visibility_sigmoid_scale
            params["visibility_sigmoid"] = {
                "visibility_threshold": torch.tensor(c.ddf_radius * 2.0, device=dev),
                "sigmoid_scale": torch.tensor(float(scale), device=dev),
            }
        return params

    def draw(self, draws: Optional[dict], generator: Optional[torch.Generator], n_rays: int) -> dict:
        """Complete ``draws`` with everything one training ``forward`` of
        ``n_rays`` rays consumes (see the module docstring)."""
        c = self.config
        dev = self.device
        d = dict(draws or {})
        rounds = len(c.proposal.num_proposal_samples) + 1
        if "proposal_jitters" not in d:
            d["proposal_jitters"] = [torch.rand((n_rays, 1), generator=generator, device=dev) for _ in range(rounds)]
        d.update(self.draw_ddf_gt(d, generator, n_rays))
        if "light_rotation" not in d:
            d["light_rotation"] = torch.randn((4,), generator=generator, device=dev)
        if c.losses.hashgrid_density:
            r3 = c.losses.hashgrid_density_grid_resolution ** 3
            if "grid_jitter" not in d:
                d["grid_jitter"] = torch.rand((r3, 3), generator=generator, device=dev)
            if "grid_dirs" not in d:
                d["grid_dirs"] = torch.randn((r3, 3), generator=generator, device=dev)
            if "grid_salt" not in d:
                d["grid_salt"] = _u32_salt(generator, dev)
        return d

    def draw_ddf_gt(self, draws: Optional[dict], generator: Optional[torch.Generator], n_rays: int) -> dict:
        """Complete ``draws`` with the stochastic table gradients' draws of
        one proposal-and-field pass over ``n_rays`` rays:
        ``proposal_stoch_u`` and ``sdf_salt`` (all that
        :meth:`generate_ddf_ground_truth` consumes)."""
        d = dict(draws or {})
        if "proposal_stoch_u" not in d:
            d["proposal_stoch_u"] = [
                torch.rand((n_rays * s,), generator=generator, device=self.device)
                for s in self.config.proposal.num_proposal_samples
            ]
        if "sdf_salt" not in d:
            d["sdf_salt"] = _u32_salt(generator, self.device)
        return d

    # ------------------------------------------------------------------

    def apply_collider(self, ray_bundle: RayBundle) -> RayBundle:
        c = self.config
        if c.collider_shape == "sphere":
            return sphere_collider(ray_bundle, c.collider_radius, c.collider_near)
        s = c.scene_aabb_scale
        aabb = torch.tensor([[-s] * 3, [s] * 3], dtype=torch.float32, device=ray_bundle.origins.device)
        return aabb_collider(ray_bundle, aabb, c.collider_near)

    def _field_salt(self, salt: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The stochastic-corner table-gradient salt, or None (exact) when
        ``stochastic_table_grads`` is off or no salt is given."""
        if salt is None or not self.field.config.stochastic_table_grads:
            return None
        return salt

    def density_fns(self, params, stoch_us=None):
        """Proposal density callables; ``stoch_us[i]`` ([N·S_i] uniforms)
        enables field i's stochastic-corner table gradient."""
        stoch_us = stoch_us or [None] * len(self.proposal_fields)
        return [
            (lambda p, _pf=pf, _pp=params[f"proposal_networks_{i}"], _u=stoch_us[i]: _pf.apply(_pp, p, _u))
            for i, pf in enumerate(self.proposal_fields)
        ]

    def _select_latents(self, params, train: bool, fitting_eval_latents: bool):
        """(latents [I, L, 3], scales [I]): the train group while training,
        the eval group in eval mode and while the eval latents are fitted."""
        if train and not fitting_eval_latents:
            g = params["illumination_field"]
            return g["train_latents"], g["train_scale"]
        g = params["eval_latents"]
        return g["eval_latents"], g["eval_scale"]

    def sample_illumination(
        self,
        params,
        ray_bundle: RayBundle,
        image_indices: torch.Tensor,
        ray_image_idx: torch.Tensor,
        train: bool,
        rotation_normals: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        fitting_eval_latents: bool = False,
        rotation: Optional[torch.Tensor] = None,
    ):
        """→ (illum_dirs [D, 3], hdr_light_colours [N, D, 3],
        hdr_background [N, 3]); the RENI decode is a static [U·D] batch.
        ``rotation`` ([3, 3], or [U, 3, 3] one per image) rotates the
        decoded sky."""
        c = self.config
        apply_rot = False if (not train and c.fix_test_illumination_directions) else None
        dirs = self.illumination_sampler(
            ray_bundle.origins.device, rotation_normals, generator, apply_random_rotation=apply_rot
        )
        d = dirs.shape[0]
        u = image_indices.shape[0]
        latents, scales = self._select_latents(params, train, fitting_eval_latents)
        z_img = latents[image_indices]  # [U, L, 3]
        s_img = scales[image_indices]  # [U]
        per_image = rotation is not None and rotation.dim() == 3
        decoder = params["illumination_decoder"]
        if c.illumination.fixed_decoder:
            decoder = freeze_decoder_params(decoder)
        out = self.illumination.apply(
            decoder, dirs.repeat(u, 1), z_img.repeat_interleave(d, 0), s_img.repeat_interleave(d, 0),
            rotation.repeat_interleave(d, 0) if per_image else rotation,
        )
        hdr = self.illumination.unnormalise(out["rgb"]).reshape(u, d, 3)
        hdr_light = hdr[ray_image_idx]  # [N, D, 3]
        bg = self.illumination.apply(
            decoder, ray_bundle.directions, z_img[ray_image_idx], s_img[ray_image_idx],
            rotation[ray_image_idx] if per_image else rotation,
        )
        return dirs, hdr_light, self.illumination.unnormalise(bg["rgb"])

    def compute_visibility(
        self,
        params,
        ray_samples: RaySamples,
        p2p_depth: torch.Tensor,
        illumination_directions: torch.Tensor,
        threshold_distance: torch.Tensor,
        sigmoid_scale: torch.Tensor,
        stop_sdf_gradients: bool,
        compute_sdf_at_termination: bool,
        stoch_salt: Optional[torch.Tensor] = None,
    ) -> dict:
        """DDF visibility of each ray's surface point toward each light
        direction: ``visibility`` [N, 1, D], ``difference`` [N, D],
        ``expected_termination_dist`` [N·k] (+ ``sdf_at_termination``).

        With ``only_upperhemisphere_visibility`` (and D > 8) only the top
        k = min(D, D//2 + 8) directions by z are queried, in the order of
        ``jax.lax.top_k`` (:func:`top_k_indices`); the lower hemisphere
        takes the configured constant.  Surface points outside the DDF
        sphere are pulled back just inside along their ray.
        Each (point, direction) pair queries the DDF from where the ray
        from the point leaves the sphere, looking back; the occlusion is a
        sigmoid of how far the DDF's surface lies before the point.  The
        SDF is evaluated at a strided subset of ``sdf_level_set_subset``
        directions' termination points (all of them when 0)."""
        c = self.config
        r = c.ddf_radius
        n = ray_samples.num_rays
        dirs_full = illumination_directions
        d_full = dirs_full.shape[0]
        upper_prune = c.only_upperhemisphere_visibility and d_full > 8
        dmask = None
        if upper_prune:
            top_idx = top_k_indices(dirs_full[:, 2], visibility_query_directions(c, d_full))
            dirs = dirs_full[top_idx]
            dmask = (dirs[:, 2] > 0).to(dirs.dtype)
        else:
            dirs = dirs_full
            if c.only_upperhemisphere_visibility:
                dmask = (dirs[:, 2] > 0).to(dirs.dtype)
        d = dirs.shape[0]

        origins = ray_samples.origins[:, 0, :]
        ray_dirs = ray_samples.directions[:, 0, :]
        positions = origins + ray_dirs * p2p_depth
        inside = torch.linalg.norm(positions, dim=-1, keepdim=True) < r
        boundary = ray_sphere_intersection(origins, ray_dirs, r) - 0.01 * r * ray_dirs
        positions = torch.where(inside, positions, boundary)

        pos_nd = torch.repeat_interleave(positions, d, dim=0)  # [N·D, 3]
        dir_nd = dirs.repeat(n, 1)
        sphere_pts = ray_sphere_intersection(pos_nd, dir_nd, r)
        dist_to_origins = torch.clamp(torch.linalg.norm(sphere_pts - pos_nd, dim=-1), max=2.0 * r)

        ddf_params = params["ddf_field"]
        out = _chunked_apply(
            lambda o, dd: self.ddf.apply(ddf_params, o, dd), (sphere_pts, -dir_nd),
            c.visibility_query_chunk, c.visibility_remat_policy,
        )
        expected = out["expected_termination_dist"]  # [N·D]

        difference = dist_to_origins - expected
        occlusion = torch.sigmoid(sigmoid_scale * (difference - threshold_distance))
        visibility = (1.0 - occlusion).reshape(n, d)
        fill = 1.0 if c.lower_hemisphere_visibility else 0.0
        if dmask is not None:
            visibility = visibility * dmask[None, :] + fill * (1.0 - dmask[None, :])
        difference = difference.reshape(n, d)
        if upper_prune:
            visibility = torch.full((n, d_full), fill, dtype=visibility.dtype, device=visibility.device
                                    ).index_copy(1, top_idx, visibility)
            difference = torch.zeros((n, d_full), dtype=difference.dtype, device=difference.device
                                     ).index_copy(1, top_idx, difference)
        result = {
            "visibility": visibility[:, None, :],
            "difference": difference,
            "expected_termination_dist": expected,
        }
        if compute_sdf_at_termination:
            term_points = sphere_pts + (-dir_nd) * expected[..., None]
            field_params = params["fields"]
            if stop_sdf_gradients:
                field_params = tree_map(lambda t: t.detach(), field_params)
            sub = c.sdf_level_set_subset
            if sub and sub < d:
                stride = d // sub
                term_points = term_points.reshape(n, d, 3)[:, ::stride, :][:, :sub, :].reshape(-1, 3)
            result["sdf_at_termination"] = self.field.sdf_only(field_params, term_points, stoch_salt)
        return result

    def _visibility_threshold(self, params, step: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(threshold distance, sigmoid scale) of the occlusion sigmoid:
        learnable, exponentially decayed over the steps, or fixed."""
        c = self.config
        m = c.losses.vis_sigmoid_method
        if m == "learnable":
            vs = params["visibility_sigmoid"]
            return vs["visibility_threshold"], vs["sigmoid_scale"]
        scale = torch.tensor(c.visibility_sigmoid_scale, device=self.device)
        if m == "exponential_decay":
            start = c.ddf_radius * 2.0
            end = c.losses.vis_target_min_bias
            steps = c.losses.vis_steps_until_min_bias
            if step >= steps:
                return torch.tensor(end, device=self.device), scale
            rate = -math.log(end / start) / steps
            return start * torch.exp(torch.tensor(-rate * step, device=self.device)), scale
        return torch.tensor(c.losses.vis_target_min_bias, device=self.device), scale

    def _hashgrid_density_samples(self, params, jitter, dirs, salt) -> torch.Tensor:
        """NeuS alphas on a perturbed regular grid (empty-space prior)."""
        c = self.config
        res = c.losses.hashgrid_density_grid_resolution
        s = c.scene_aabb_scale
        lin = torch.linspace(-s, s, res, device=self.device)
        X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
        pos = torch.stack([X, Y, Z], -1).reshape(-1, 3)
        gap = 2.0 * s / res
        pos = pos + (jitter - 0.5) * gap
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        sdf, _, grad = self.field.geo_with_grad(params["fields"], pos, self._field_salt(salt))
        inv_s = self.field.inv_s(params["fields"])
        return neus_alpha(
            sdf[None], grad[None], dirs[None],
            torch.full((1, pos.shape[0], 1), gap, device=pos.device), inv_s, c.cos_anneal_ratio,
        )

    # ------------------------------------------------------------------

    def forward(
        self,
        params,
        ray_bundle: RayBundle,
        image_indices: torch.Tensor,
        ray_image_idx: torch.Tensor,
        step: float = 0.0,
        train: bool = True,
        draws: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        fitting_eval_latents: bool = False,
        rotation: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """The per-ray forward graph (JAX ``forward`` + ``_compose_outputs``).
        The sky is decoded from the train latents while training and from
        the eval latents in eval mode (``train=False``) or while they are
        fitted (``fitting_eval_latents``); ``rotation`` rotates it (see
        :meth:`sample_illumination`).  Eval mode draws nothing and skips the
        level-set SDF query, which only a training loss reads."""
        c = self.config
        if train:
            draws = self.draw(draws, generator, ray_bundle.num_rays)
        else:
            draws = {}
        rb = self.apply_collider(ray_bundle)
        rs, weights_list, samples_list = proposal_sample(
            rb, self.density_fns(params, draws.get("proposal_stoch_u")),
            c.proposal, train=train, step=step, jitters=draws.get("proposal_jitters"),
            generator=generator,
        )
        field_out = self.field.field_outputs(
            params["fields"], rs, True, c.cos_anneal_ratio, self._field_salt(draws.get("sdf_salt")),
        )
        weights, trans = weights_and_transmittance_from_alphas(field_out["alpha"])

        bg_transmittance = trans[:, -1, :]
        weights_list = weights_list + [weights]
        samples_list = samples_list + [rs]
        illum_dirs, hdr_light, hdr_background = self.sample_illumination(
            params, rb, image_indices, ray_image_idx, train, draws.get("light_rotation"), generator,
            fitting_eval_latents=fitting_eval_latents, rotation=rotation,
        )
        p2p = render_depth(weights, rs)
        accumulation = render_accumulation(weights)
        vis_dict = None
        if c.use_visibility and self.ddf is not None:
            stop_depth = c.sdf_to_visibility_stop_gradients in ("depth", "both")
            stop_sdf = c.sdf_to_visibility_stop_gradients in ("sdf", "both")
            thr, sig_scale = self._visibility_threshold(params, step)
            vis_dict = self.compute_visibility(
                params, rs, p2p.detach() if stop_depth else p2p, illum_dirs, thr, sig_scale,
                stop_sdf_gradients=stop_sdf,
                compute_sdf_at_termination=train and c.losses.sdf_level_set_visibility,
                stoch_salt=self._field_salt(draws.get("sdf_salt")),
            )
        rgb = lambertian_composite(
            field_out["albedo"], field_out["normal"], illum_dirs, hdr_light,
            vis_dict["visibility"] if vis_dict is not None else None, hdr_background, weights,
            clip_output=not train,
        )
        normal = render_normal(weights, field_out["normal"])
        outputs = {
            "rgb": rgb,
            "albedo": render_rgb_with_background(weights, field_out["albedo"], torch.ones(3, device=rgb.device)),
            "accumulation": accumulation,
            "depth": p2p / rb.directions_norm,
            "p2p_dist": p2p,
            "normal": normal,
            "normal_vis": (normal + 1.0) / 2.0,
            "weights": weights,
            "hdr_background_colours": hdr_background,
            "directions_norm": rb.directions_norm,
            "bg_transmittance": bg_transmittance,
            "eik_grad": field_out["gradient"],
            "weights_list": weights_list,
            "samples_list": samples_list,
        }
        if vis_dict is not None:
            outputs["visibility"] = vis_dict["visibility"]
            if "sdf_at_termination" in vis_dict:
                outputs["sdf_at_termination"] = vis_dict["sdf_at_termination"]
        for i in range(len(weights_list) - 1):
            outputs[f"prop_depth_{i}"] = render_depth(weights_list[i], samples_list[i])
        if train and c.losses.hashgrid_density:
            outputs["grid_density"] = self._hashgrid_density_samples(
                params, draws["grid_jitter"], draws["grid_dirs"], draws["grid_salt"]
            )
        return outputs

    def generate_ddf_ground_truth(
        self,
        params,
        ray_bundle: RayBundle,
        mask_threshold: float = 0.0,
        stop_gradients: bool = False,
        draws: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The DDF's supervision rendered from the scene SDF: accumulation,
        hit mask, termination distance (clamped to the sphere's diameter) and
        normals.  The sampler runs in eval mode (no jitter) with the proposal
        PDF un-annealed, as JAX's DDF-fit call (``step=None``) does.  With
        ``stop_gradients=False`` (canonical) the DDF losses reach the SDF
        field through it, by the stochastic table gradient of ``draws``
        (:meth:`draw_ddf_gt`); the proposal encodes feed only the
        resampling and take no gradient."""
        c = self.config
        with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_gradients):
            d = {} if stop_gradients else self.draw_ddf_gt(draws, generator, ray_bundle.num_rays)
            rb = self.apply_collider(ray_bundle)
            rs, _, _ = proposal_sample(
                rb, self.density_fns(params, d.get("proposal_stoch_u")), c.proposal, train=False, step=None,
            )
            field_out = self.field.field_outputs(
                params["fields"], rs, True, c.cos_anneal_ratio, self._field_salt(d.get("sdf_salt")),
            )
            weights, _ = weights_and_transmittance_from_alphas(field_out["alpha"])
            accum = render_accumulation(weights)
            return {
                "accumulations": accum,
                "mask": (accum > mask_threshold).to(accum.dtype),
                "termination_dist": torch.clamp(render_depth(weights, rs), max=2.0 * c.ddf_radius),
                "normals": render_normal(weights, field_out["normal"]),
            }

    # ------------------------------------------------------------------

    def loss_dict(self, params, outputs, batch, train: bool = True,
                  fitting_eval_latents: bool = False) -> Dict[str, torch.Tensor]:
        """``batch`` carries ``image`` [N, 3] and ``mask`` [N, 4] (static,
        fg, ground, sky).  The scene-only terms count while training, not
        while the eval latents are fitted."""
        c = self.config
        li = c.losses
        image = batch["image"]
        fg_mask = batch["mask"][..., 1]
        ground_mask = batch["mask"][..., 2]
        sky_mask = batch["mask"][..., 3]
        not_sky = (1.0 - sky_mask)[..., None]
        ld: Dict[str, torch.Tensor] = {}
        masked_img = image * not_sky
        masked_pred = outputs["rgb"] * not_sky
        if li.rgb_l1:
            ld["rgb_l1_loss"] = L.l1_loss(masked_img, masked_pred)
        if li.rgb_l2:
            ld["rgb_l2_loss"] = L.mse_loss(masked_img, masked_pred)
        if li.cosine_colour:
            ld["cosine_colour_loss"] = L.cosine_colour_loss(masked_img, masked_pred)
        if train and not fitting_eval_latents:
            if li.eikonal:
                ld["eikonal_loss"] = L.eikonal_loss(outputs["eik_grad"])
            if li.fg_mask:
                ws = torch.sum(outputs["weights"], dim=1)
                ld["fg_mask_loss"] = L.fg_mask_loss(ws, fg_mask[..., None])
            if li.normal and "normal" in batch:
                ld["normal_loss"] = L.monosdf_normal_loss(outputs["normal"], batch["normal"])
            if li.depth and "depth" in batch:
                ld["depth_loss"] = L.mse_loss(outputs["depth"], batch["depth"].reshape(outputs["depth"].shape))
            if li.interlevel:
                ld["interlevel_loss"] = L.interlevel_loss(outputs["weights_list"], outputs["samples_list"])
            if li.hashgrid_density and "grid_density" in outputs:
                ld["hashgrid_density_loss"] = L.hashgrid_density_loss(outputs["grid_density"])
            if li.ground_plane:
                ld["ground_plane_loss"] = L.ground_plane_loss(outputs["normal"], ground_mask)
            if li.vis_sigmoid_method == "learnable" and "visibility_sigmoid" in params:
                vs = params["visibility_sigmoid"]
                ld["visibility_sigmoid_loss"] = L.visibility_sigmoid_loss(
                    vs["visibility_threshold"], vs["sigmoid_scale"],
                    li.vis_target_min_bias, li.vis_target_max_scale,
                    li.vis_optimise_sigmoid_bias, li.vis_optimise_sigmoid_scale,
                )
            if li.sdf_level_set_visibility and "sdf_at_termination" in outputs:
                ld["sdf_level_set_visibility_loss"] = torch.mean(outputs["sdf_at_termination"] ** 2)
        if li.sky_pixel and (train or c.eval_latent_optimise_method != "nerf_osr_envmap"):
            ld["sky_pixel_loss"] = L.sky_pixel_loss(
                linear_to_sRGB(outputs["hdr_background_colours"]),
                image, sky_mask[..., None], li.sky_pixel_cosine_weight,
            )
        return L.scale_loss_dict(ld, dict(c.loss_coefficients))

    def metrics_dict(self, params, outputs, batch) -> Dict[str, torch.Tensor]:
        mse = torch.mean((outputs["rgb"] - batch["image"]) ** 2)
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
        inv_s = self.field.inv_s(params["fields"])
        m = {"psnr": psnr, "inv_s": inv_s[0], "s_val": 1.0 / inv_s[0]}
        if "mask" in batch:
            fg = batch["mask"][..., 1:2]
            mse_fg = torch.sum(fg * (outputs["rgb"] - batch["image"]) ** 2) / (
                3.0 * torch.clamp(torch.sum(fg), min=1.0)
            )
            m["psnr_fg"] = -10.0 * torch.log10(torch.clamp(mse_fg, min=1e-10))
        if "visibility_sigmoid" in params:
            m["visibility_threshold"] = params["visibility_sigmoid"]["visibility_threshold"]
        return {k: v.detach() for k, v in m.items()}
