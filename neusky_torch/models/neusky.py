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

``forward_with_ddf_gt`` (``fused_ddf_gt_pass``) runs the scene rays and the
DDF's ground-truth rays through one proposal and field pass.

``gt_illumination_probe`` replaces the RENI decode with a learnable
per-direction HDR light table (``gt_probe_illumination/log_light``, shared
by every image, the light directions unrotated) and the fixed analytic sky
``gt_probe_background``: the synthetic scene's quality ceiling.  A field
with ``predict_shininess`` is shaded Blinn-Phong, else Lambertian.

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
of its own (:meth:`NeuSkyModel.draw_ddf_gt`).  ``forward_with_ddf_gt``
takes the draws of one ``forward`` over the scene and ground-truth rays
together (JAX's key tree of ``forward_with_ddf_gt``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from neusky_torch.core.colour import linear_to_sRGB, sRGB_to_linear
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
from neusky_torch.ops import ddf_film_cuda
from neusky_torch.ops.hashgrid import salt_with_lanes
from neusky_torch.parallel import collectives
from neusky_torch.sampling.illumination import IcosahedronSampler
from neusky_torch.sampling.proposal import ProposalSamplerConfig, proposal_sample
from neusky_torch.shading.lambertian import blinn_phong_composite, lambertian_composite
from neusky_torch.tree import tree_items, tree_map, unflatten
from neusky_torch.utils.profiling import span


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
    """sRGB sky behind the scene in probe mode (the synthetic scene's
    ``sky_colour``)."""
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


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the output of every
    matrix product without a batch dimension (``mm``, ``addmm``, any
    overload: the bf16 product is ``mm.dtype``) for the backward, recompute
    the rest."""
    if getattr(op, "overloadpacket", None) in (torch.ops.aten.mm, torch.ops.aten.addmm):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _chunked_apply(fn, args: Tuple[torch.Tensor, ...], chunk: int, remat_policy: str = "full"):
    """``fn`` over the leading axis in chunks of ``chunk`` rows, each chunk
    under ``torch.utils.checkpoint`` when autograd records: bounds the peak
    memory of the N·D visibility queries.  ``remat_policy="full"``
    recomputes a chunk's activations in the backward; ``"dots"`` keeps its
    matrix products' outputs and recomputes the rest (more memory, fewer
    products).  Exact, since ``fn`` is row-wise and the chunks' results are
    concatenated.  ``fn`` returns a dict of tensors."""
    if remat_policy not in ("full", "dots"):
        raise ValueError(f"visibility_remat_policy {remat_policy!r}: 'full' or 'dots'")
    m = args[0].shape[0]
    run = fn
    if torch.is_grad_enabled():
        kw = {} if remat_policy == "full" else {
            "context_fn": functools.partial(create_selective_checkpoint_contexts, _save_dots)}
        run = lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)  # noqa: E731
    outs = [run(*(a[s:s + chunk] for a in args)) for s in range(0, m, chunk)]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


class _FusedDDFChunk(torch.autograd.Function):
    """One ``"full"``-policy visibility chunk whose forward is the fused DDF
    kernel (:meth:`DDFModel.fused_query`).  It saves the chunk's inputs
    alone, as the full checkpoint does; its backward recomputes the chunk
    through the plain query and takes the checkpoint's gradients from it.
    ``inputs``: the chunk's origins and world directions, then the DDF's
    parameter leaves, in ``plain``'s order."""

    @staticmethod
    def forward(ctx, fused, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return fused(*inputs[:2])

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(ctx.plain(*inputs), [t for t in inputs if t.requires_grad], g,
                                             allow_unused=True))
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def _rows(rays, rows: slice):
    """The rays ``rows`` of a RayBundle or a RaySamples."""
    return type(rays)(**{f.name: getattr(rays, f.name)[rows] for f in dataclasses.fields(rays)})


class NeuSkyModel:
    """See the module docstring.  Entry point: runs on ``device``
    (default CUDA; raises without a card unless ``device="cpu"``)."""

    def __init__(self, config: NeuSkyModelConfig, device="cuda"):
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
        self.mesh = None
        self._constant_cache: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _constants(self, device) -> Dict[str, torch.Tensor]:
        """The config's constants that the forward reads, as tensors built
        once per device (a step builds no tensor from host data, so it can
        be captured): the AABB, the occlusion sigmoid's fixed scale, the
        threshold's decay ends and log rate (float32, as JAX's), the probe's
        linear background."""
        device = torch.device(device)
        if device not in self._constant_cache:
            c = self.config
            s = c.scene_aabb_scale
            start, end = c.ddf_radius * 2.0, c.losses.vis_target_min_bias
            f32 = dict(dtype=torch.float32, device=device)
            self._constant_cache[device] = {
                "aabb": torch.tensor([[-s] * 3, [s] * 3], **f32),
                "sigmoid_scale": torch.tensor(c.visibility_sigmoid_scale, **f32),
                "vis_end": torch.tensor(end, **f32),
                "vis_log_rate": torch.log(torch.tensor(end / start, **f32)) / c.losses.vis_steps_until_min_bias,
                "probe_background": sRGB_to_linear(torch.tensor(c.gt_probe_background, **f32)),
            }
        return self._constant_cache[device]

    def set_mesh(self, mesh) -> "NeuSkyModel":
        """Run as one rank of ``mesh`` (a ``DeviceMesh`` with axes
        ``("data",)`` or ``("data", "dirs")``, :func:`~neusky_torch.parallel.
        mesh.make_mesh`), or alone with None.  On a ``data`` axis the
        training forward takes this rank's rays of the global batch: it
        draws the global draws and keeps its rows, and hashes the
        stochastic table gradients at the global lanes.  On a ``dirs``
        axis the visibility queries split over the ranks of a ``dirs``
        group (:meth:`compute_visibility`).  Every rank must run the same
        calls: the split ones meet in collectives."""
        self.mesh = mesh
        return self

    def _data_rows(self, n_rays: int, n_extra: int) -> Tuple[Optional[torch.Tensor], int]:
        """(rows, global rows): with a ``data`` axis of size > 1, the row of
        the global batch of each of this rank's ``n_rays`` scene rays (shard
        ``coord`` of equal shards), then of the ``n_extra`` rays every rank
        holds whole, which follow the global scene rays; else (None,
        ``n_rays + n_extra``)."""
        axis = collectives.mesh_axis(self.mesh, "data")
        if axis is None or axis[1] == 1:
            return None, n_rays + n_extra
        coord, size = axis
        rows = torch.cat([torch.arange(n_rays, device=self.device) + coord * n_rays,
                          torch.arange(n_extra, device=self.device) + size * n_rays])
        return rows, size * n_rays + n_extra

    def _dirs_share(self, d: int) -> Optional[Tuple[int, int]]:
        """[start, stop) of the ``d`` queried directions this rank queries
        on a ``dirs`` axis of size > 1 (contiguous, the first ``d % size``
        ranks one more), else None."""
        axis = collectives.mesh_axis(self.mesh, "dirs")
        if axis is None or axis[1] == 1:
            return None
        coord, size = axis
        if d < size:
            raise ValueError(f"{d} queried directions cannot split over {size} 'dirs' ranks")
        return collectives.split_range(d, size, coord)

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
        if c.gt_illumination_probe:
            # log-parameterised: the table spans HDR decades and stays
            # positive; it starts at the background's linear level
            log_bg = torch.log(torch.clamp(self._gt_probe_background(), min=1e-4))
            params["gt_probe_illumination"] = {"log_light": log_bg[None, :].repeat(self.num_directions, 1)}
        if c.losses.vis_sigmoid_method == "learnable":
            scale = 1.0 if c.losses.vis_optimise_sigmoid_scale else c.visibility_sigmoid_scale
            params["visibility_sigmoid"] = {
                "visibility_threshold": torch.tensor(c.ddf_radius * 2.0, device=dev),
                "sigmoid_scale": torch.tensor(float(scale), device=dev),
            }
        return params

    def draw(self, draws: Optional[dict], generator: Optional[torch.Generator], n_rays: int,
             n_extra: int = 0) -> dict:
        """Complete ``draws`` with everything one training ``forward`` of
        ``n_rays`` scene rays and ``n_extra`` more (the fused pass's
        ground-truth rays) consumes (see the module docstring).  On a
        ``data`` mesh axis the draws are the global batch's, given or drawn
        (every rank draws the same from the same generator state), and this
        rank keeps its rows of the per-ray ones; ``rows`` then holds the
        global row of each of its rays.  Draws that hold ``rows`` already
        (this method's output, as ``pipeline.draw_step`` hands it to the
        step) are this rank's and are not cut again."""
        c = self.config
        dev = self.device
        d = dict(draws or {})
        rows, n_all = self._data_rows(n_rays, n_extra)
        rounds = len(c.proposal.num_proposal_samples) + 1
        if "proposal_jitters" not in d:
            d["proposal_jitters"] = [torch.rand((n_all, 1), generator=generator, device=dev) for _ in range(rounds)]
        d.update(self.draw_ddf_gt(d, generator, n_all))
        if rows is not None and "rows" not in d:
            d["proposal_jitters"] = [j[rows] for j in d["proposal_jitters"]]
            d["proposal_stoch_u"] = [u.reshape(n_all, -1)[rows].reshape(-1) for u in d["proposal_stoch_u"]]
            d["rows"] = rows
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
        return aabb_collider(ray_bundle, self._constants(ray_bundle.origins.device)["aabb"], c.collider_near)

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

    def _gt_probe_background(self) -> torch.Tensor:
        """The probe's sky background, linear [3]."""
        return self._constants(self.device)["probe_background"]

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
        decoded sky.  In probe mode (``gt_illumination_probe``) the light
        is the table for every ray and the background the fixed sky."""
        c = self.config
        apply_rot = False if (c.gt_illumination_probe or (not train and c.fix_test_illumination_directions)) else None
        dirs = self.illumination_sampler(
            ray_bundle.origins.device, rotation_normals, generator, apply_random_rotation=apply_rot
        )
        d = dirs.shape[0]
        if c.gt_illumination_probe:
            n = ray_bundle.num_rays
            light = torch.exp(params["gt_probe_illumination"]["log_light"])  # [D, 3]
            return dirs, light[None].expand(n, d, 3), self._gt_probe_background()[None].expand(n, 3)
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
        ray_rows: Optional[torch.Tensor] = None,
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
        directions' termination points (all of them when 0).

        On a ``dirs`` mesh axis each rank of a ``dirs`` group (which holds
        the same rays) queries the DDF for its contiguous share of the
        queried directions, in its own ``visibility_query_chunk`` chunks,
        and the SDF at the level-set subset's directions in that share; the
        termination distances and the SDF values are then gathered in
        JAX's order (:func:`~neusky_torch.parallel.collectives.gather_slots`,
        whose backward sums over the group) and the rest is computed whole
        on every rank.  The level-set query hashes its stochastic table
        gradient at JAX's lanes: the point's index in the global [N·k]
        query (``ray_rows``: the global row of each ray on a ``data`` mesh
        axis), modulo JAX's chunk (``sdf_query_chunk``, times the mesh size
        on a ``dirs`` axis) when chunked."""
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

        share = self._dirs_share(d)
        lo, hi = share or (0, d)
        mine = lambda x: x.reshape(n, d, 3)[:, lo:hi].reshape(-1, 3)  # noqa: E731
        expected = self._ddf_query(params["ddf_field"], mine(sphere_pts), mine(-dir_nd))
        if share is not None:
            expected = collectives.gather_slots(expected.reshape(n, hi - lo, *expected.shape[1:]), lo, d,
                                                self.mesh.get_group("dirs")).reshape(-1, *expected.shape[1:])

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
            stride, count = (d // sub, sub) if (sub and sub < d) else (1, d)
            # the subset's directions k·stride in [lo, hi)
            k_lo, k_hi = (min(-(-x // stride), count) for x in (lo, hi))
            if k_hi == k_lo:
                raise ValueError(f"directions [{lo}, {hi}) hold none of the level-set subset's "
                                 f"{count}: fewer 'dirs' ranks or a larger sdf_level_set_subset")
            term_points = term_points.reshape(n, d, 3)[:, ::stride][:, k_lo:k_hi].reshape(-1, 3)
            rows = ray_rows[:n] if ray_rows is not None else torch.arange(n, device=self.device)
            lanes = (rows[:, None] * count + torch.arange(k_lo, k_hi, device=self.device)[None]).reshape(-1)
            if c.sdf_query_chunk:
                dirs_axis = self.mesh is not None and "dirs" in self.mesh.mesh_dim_names
                lanes = lanes % (c.sdf_query_chunk * (self.mesh.size() if dirs_axis else 1))
            query = lambda p, ln: {"sdf": self.field.sdf_only(  # noqa: E731
                field_params, p, None if stoch_salt is None else salt_with_lanes(stoch_salt, ln))}
            if c.sdf_query_chunk:
                sdf = _chunked_apply(query, (term_points, lanes), c.sdf_query_chunk)["sdf"]
            else:
                sdf = query(term_points, lanes)["sdf"]
            if share is not None:
                sdf = collectives.gather_slots(sdf.reshape(n, k_hi - k_lo, *sdf.shape[1:]), k_lo, count,
                                               self.mesh.get_group("dirs")).reshape(-1, *sdf.shape[1:])
            result["sdf_at_termination"] = sdf
        return result

    def _fuses_ddf(self, rows: torch.Tensor, records: bool) -> bool:
        """Whether the visibility query takes the fused DDF kernel
        (:meth:`DDFModel.fused_query`): the kernel computes this field
        (:meth:`DirectionalDistanceField.film_kernel_takes`) at rows like
        ``rows`` (:func:`~neusky_torch.ops.ddf_film_cuda.takes`), and
        autograd records nothing or the ``"full"`` policy keeps no activation
        of a chunk's forward anyway."""
        return (ddf_film_cuda.takes(rows) and self.ddf.field.film_kernel_takes()
                and (not records or self.config.visibility_remat_policy == "full"))

    def _ddf_query(self, ddf_params, origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
        """The DDF's ``expected_termination_dist`` at the visibility's
        (origin, world direction) rows.  Where it takes the fused kernel
        (:meth:`_fuses_ddf`): every row in one launch when autograd records
        nothing, else a :class:`_FusedDDFChunk` each
        ``visibility_query_chunk`` rows.  Otherwise the plain query in
        checkpointed chunks (:func:`_chunked_apply`)."""
        c = self.config
        leaves = dict(tree_items(ddf_params))
        records = torch.is_grad_enabled() and any(t.requires_grad for t in (origins, directions, *leaves.values()))
        if not self._fuses_ddf(origins, records):
            query = lambda o, dd: self.ddf.apply(ddf_params, o, dd)  # noqa: E731
            return _chunked_apply(query, (origins, directions), c.visibility_query_chunk,
                                  c.visibility_remat_policy)["expected_termination_dist"]
        fused = self.ddf.fused_query(ddf_params)
        if not records:
            return fused(origins, directions)
        names = list(leaves)
        plain = lambda o, dd, *lv: self.ddf.apply(  # noqa: E731
            unflatten(dict(zip(names, lv))), o, dd)["expected_termination_dist"]
        chunk = c.visibility_query_chunk
        return torch.cat([_FusedDDFChunk.apply(fused, plain, origins[s:s + chunk], directions[s:s + chunk],
                                               *leaves.values()) for s in range(0, origins.shape[0], chunk)])

    def _visibility_threshold(self, params, step) -> Tuple[torch.Tensor, torch.Tensor]:
        """(threshold distance, sigmoid scale) of the occlusion sigmoid:
        learnable, exponentially decayed over the steps, or fixed.  ``step``
        is a float or a 0-d tensor; the decay is JAX's float32 ``jnp.where``
        (``neusky_tpu/models/neusky.py:616-618``), on the device for a tensor
        step."""
        c = self.config
        m = c.losses.vis_sigmoid_method
        if m == "learnable":
            vs = params["visibility_sigmoid"]
            return vs["visibility_threshold"], vs["sigmoid_scale"]
        k = self._constants(self.device)
        if m != "exponential_decay":
            return k["vis_end"], k["sigmoid_scale"]
        steps = c.losses.vis_steps_until_min_bias
        start = c.ddf_radius * 2.0
        if not isinstance(step, torch.Tensor):
            return (k["vis_end"] if step >= steps else start * torch.exp(k["vis_log_rate"] * step)), k["sigmoid_scale"]
        step = step.to(torch.float32)
        return torch.where(step >= steps, k["vis_end"], start * torch.exp(k["vis_log_rate"] * step)), k["sigmoid_scale"]

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
        draws = self.draw(draws, generator, ray_bundle.num_rays) if train else {}
        rb = self.apply_collider(ray_bundle)
        rs, weights_list, samples_list, field_out, weights, trans = self._field_pass(
            params, rb, step, train, draws, generator)
        return self._compose_outputs(
            params, rb, rs, field_out, weights, trans, weights_list, samples_list, image_indices,
            ray_image_idx, step, train, draws, generator, fitting_eval_latents, rotation,
        )

    def forward_with_ddf_gt(
        self,
        params,
        ray_bundle: RayBundle,
        image_indices: torch.Tensor,
        ray_image_idx: torch.Tensor,
        gt_ray_bundle: RayBundle,
        step: float = 0.0,
        train: bool = True,
        draws: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        gt_mask_threshold: float = 0.0,
    ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """The scene forward and the DDF's ground truth from ONE proposal
        and field pass over the scene rays and ``gt_ray_bundle``
        concatenated (JAX ``forward_with_ddf_gt``): the scene outputs,
        interlevel inputs included, come from the head slice, the ground
        truth (``generate_ddf_ground_truth``'s keys) from the tail.  The
        ground-truth rays go through the sampler as the scene rays do (in
        training: jittered, annealed, with the stochastic table gradients);
        in one pass the hash-grid encodes run, and K1 launches, once for
        both.  ``draws`` are those of one ``forward`` over all the rays."""
        n = ray_bundle.num_rays
        rb_s, rb_g = self.apply_collider(ray_bundle), self.apply_collider(gt_ray_bundle)
        rb = RayBundle(**{f.name: torch.cat([getattr(rb_s, f.name), getattr(rb_g, f.name)], dim=0)
                          for f in dataclasses.fields(RayBundle)})
        draws = self.draw(draws, generator, n, rb_g.num_rays) if train else {}
        rs, weights_list, samples_list, field_out, weights, trans = self._field_pass(
            params, rb, step, train, draws, generator)
        head, tail = slice(0, n), slice(n, None)
        outputs = self._compose_outputs(
            params, _rows(rb, head), _rows(rs, head), {k: v[head] for k, v in field_out.items()},
            weights[head], trans[head], [w[head] for w in weights_list], [_rows(r, head) for r in samples_list],
            image_indices, ray_image_idx, step, train, draws, generator, False, None,
        )
        return outputs, self._ground_truth(weights[tail], _rows(rs, tail), field_out["normal"][tail],
                                           gt_mask_threshold)

    def _field_pass(self, params, rb: RayBundle, step, train: bool, draws: dict, generator):
        """Proposal sampling and the SDF field over ``rb`` → (ray samples,
        proposal weights and samples, field outputs, weights,
        transmittance).  The SDF's stochastic table gradient hashes sample
        s of the ray of row r at lane r·S + s, as JAX's global encode does:
        r is the ray's global row, ``draws["rows"]``, on a ``data`` mesh
        axis, else its index."""
        c = self.config
        with span("field"):
            rs, weights_list, samples_list = proposal_sample(
                rb, self.density_fns(params, draws.get("proposal_stoch_u")),
                c.proposal, train=train, step=step, jitters=draws.get("proposal_jitters"),
                generator=generator,
            )
            salt = self._field_salt(draws.get("sdf_salt"))
            if salt is not None:
                s = rs.num_samples
                rows = draws["rows"] if "rows" in draws else torch.arange(rb.num_rays, device=self.device)
                salt = salt_with_lanes(
                    salt, (rows[:, None] * s + torch.arange(s, device=self.device)[None]).reshape(-1))
            field_out = self.field.field_outputs(params["fields"], rs, True, c.cos_anneal_ratio, salt)
            weights, trans = weights_and_transmittance_from_alphas(field_out["alpha"])
        return rs, weights_list, samples_list, field_out, weights, trans

    def _compose_outputs(self, params, rb, rs, field_out, weights, trans, weights_list, samples_list,
                         image_indices, ray_image_idx, step, train, draws, generator, fitting_eval_latents,
                         rotation) -> Dict[str, Any]:
        """Everything after the field pass (JAX ``_compose_outputs``): the
        sky, visibility, shading, renders and the density-grid samples."""
        c = self.config
        bg_transmittance = trans[:, -1, :]
        weights_list = weights_list + [weights]
        samples_list = samples_list + [rs]
        with span("sky"):
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
            with span("visibility"):
                thr, sig_scale = self._visibility_threshold(params, step)
                vis_dict = self.compute_visibility(
                    params, rs, p2p.detach() if stop_depth else p2p, illum_dirs, thr, sig_scale,
                    stop_sdf_gradients=stop_sdf,
                    compute_sdf_at_termination=train and c.losses.sdf_level_set_visibility,
                    stoch_salt=self._field_salt(draws.get("sdf_salt")), ray_rows=draws.get("rows"),
                )
        with span("shading"):
            visibility = vis_dict["visibility"] if vis_dict is not None else None
            if "shininess" in field_out:
                rgb = blinn_phong_composite(
                    field_out["albedo"], field_out["normal"], illum_dirs, hdr_light, visibility, hdr_background,
                    weights, field_out["shininess"], -rb.directions, clip_output=not train,
                )
            else:
                rgb = lambertian_composite(
                    field_out["albedo"], field_out["normal"], illum_dirs, hdr_light, visibility, hdr_background,
                    weights, clip_output=not train,
                )
            normal = render_normal(weights, field_out["normal"])
            outputs = {
                "rgb": rgb,
                "albedo": render_rgb_with_background(weights, field_out["albedo"],
                                                     torch.ones(3, device=rgb.device)),
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
            if "rows" in draws:
                outputs["ray_rows"] = draws["rows"][:rb.num_rays]
            if vis_dict is not None:
                outputs["visibility"] = vis_dict["visibility"]
                if "sdf_at_termination" in vis_dict:
                    outputs["sdf_at_termination"] = vis_dict["sdf_at_termination"]
            for i in range(len(weights_list) - 1):
                outputs[f"prop_depth_{i}"] = render_depth(weights_list[i], samples_list[i])
        if train and c.losses.hashgrid_density:
            with span("density_grid"):
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
        step: Optional[float] = None,
    ) -> Dict[str, torch.Tensor]:
        """The DDF's supervision rendered from the scene SDF: accumulation,
        hit mask, termination distance (clamped to the sphere's diameter) and
        normals.  The sampler runs in eval mode (no jitter) with the proposal
        PDF un-annealed, as JAX's DDF-fit call (``step=None``) does; a
        ``step`` anneals it as the scene pass's.  With
        ``stop_gradients=False`` (canonical) the DDF losses reach the SDF
        field through it, by the stochastic table gradient of ``draws``
        (:meth:`draw_ddf_gt`); the proposal encodes feed only the
        resampling and take no gradient."""
        c = self.config
        with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_gradients):
            d = {} if stop_gradients else self.draw_ddf_gt(draws, generator, ray_bundle.num_rays)
            rb = self.apply_collider(ray_bundle)
            rs, _, _ = proposal_sample(
                rb, self.density_fns(params, d.get("proposal_stoch_u")), c.proposal, train=False, step=step,
            )
            field_out = self.field.field_outputs(
                params["fields"], rs, True, c.cos_anneal_ratio, self._field_salt(d.get("sdf_salt")),
            )
            weights, _ = weights_and_transmittance_from_alphas(field_out["alpha"])
            return self._ground_truth(weights, rs, field_out["normal"], mask_threshold)

    def _ground_truth(self, weights, rs, normals, mask_threshold: float) -> Dict[str, torch.Tensor]:
        accum = render_accumulation(weights)
        return {
            "accumulations": accum,
            "mask": (accum > mask_threshold).to(accum.dtype),
            "termination_dist": torch.clamp(render_depth(weights, rs), max=2.0 * self.config.ddf_radius),
            "normals": render_normal(weights, normals),
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
        """PSNR (and over the foreground mask), ``inv_s`` and the
        visibility threshold, from sums: outputs of a rank's rays of a
        ``data`` mesh axis (``ray_rows``) sum them over the data shards
        first, so the metrics are the global batch's."""
        sq = (outputs["rgb"] - batch["image"]) ** 2
        sums = [sq.sum(), sq.new_full((), float(sq.numel()))]
        if "mask" in batch:
            fg = batch["mask"][..., 1:2]
            sums += [torch.sum(fg * sq), torch.sum(fg)]
        sums = torch.stack(sums)
        if "ray_rows" in outputs:
            sums = collectives.all_sum(sums, self.mesh.get_group("data"))
        psnr = -10.0 * torch.log10(torch.clamp(sums[0] / sums[1], min=1e-10))
        inv_s = self.field.inv_s(params["fields"])
        m = {"psnr": psnr, "inv_s": inv_s[0], "s_val": 1.0 / inv_s[0]}
        if "mask" in batch:
            mse_fg = sums[2] / (3.0 * torch.clamp(sums[3], min=1.0))
            m["psnr_fg"] = -10.0 * torch.log10(torch.clamp(mse_fg, min=1e-10))
        if "visibility_sigmoid" in params:
            # a copy: the step's update moves the parameter in place
            m["visibility_threshold"] = params["visibility_sigmoid"]["visibility_threshold"].clone()
        return {k: v.detach() for k, v in m.items()}
