"""Evaluation (mirror of ``neusky_tpu/engine/eval_loop.py``): chunked
full-image renders, the test-time fit of the eval latents, per-image
PSNR / SSIM / LPIPS / MSE with rays/s and fps, and the NeRF-OSR relighting
protocol.

The eval forward (``train=False``) draws nothing: the proposal sampler runs
without jitter and the light directions are the fixed icosphere, so these
functions take no generator.  The fit updates only the eval group
(``eval_latents``, ``eval_scale``, ``eval_rotation``): every other leaf is
detached, so autograd records just the RENI decode → Lambertian branch and
no hash-table gradient (K1) runs.

On the card the render chunk, the eval-latent fit and the rotation fit run
as CUDA graph replays (``neusky_torch/parallel/graphs.py``), as JAX jits
them; ``graphed=False`` runs them eagerly, op by op, and ``graphed=True``
on the CPU raises.

``run_eval``, ``run_nerfosr_eval`` and ``run_render`` are ``cli eval``,
``cli eval --protocol nerfosr`` and ``cli render``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from neusky_torch.core.rays import RayBundle
from neusky_torch.core.spherical import rot_z
from neusky_torch.data.datamanager import DataManager, batch_to_device
from neusky_torch.data.nerfosr_eval import global_least_squares_scale
from neusky_torch.engine import metrics as M
from neusky_torch.engine.checkpoint import prior_init_latent
from neusky_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig, build_eval_latent_optimizer
from neusky_torch.engine.reni_trainer import fit_latents_to_envmaps
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import eval_latent_loss_fn
from neusky_torch.parallel.graphs import CapturedStep, use_graph
from neusky_torch.parallel.mesh import make_eval_latent_step
from neusky_torch.tree import tree_map
from neusky_torch.utils import profiling
from neusky_torch.utils.profiling import span

RENDER_KEYS = ("rgb", "albedo", "accumulation", "depth", "p2p_dist", "normal")


@contextlib.contextmanager
def eval_grad_mode(model: NeuSkyModel):
    """The eval forward's autograd mode: ``torch.inference_mode`` where the
    field's spatial gradient is analytic, autograd on (for d/dx only)
    where autograd takes it."""
    analytic = model.field.config.gradient_mode == "forward"
    with torch.inference_mode(analytic), torch.set_grad_enabled(not analytic):
        yield


def render_chunk(model: NeuSkyModel, params, ray_bundle: RayBundle, image_indices: torch.Tensor,
                 rotation: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The eval forward of one chunk of rays with the sky of eval slot
    ``image_indices`` ([1] int, on the rays' device; ``rotation`` [3, 3]
    rotates the sky) → :data:`RENDER_KEYS`, under :func:`eval_grad_mode`.
    Builds no tensor from host data and reads nothing on the host, so it
    can be captured."""
    with eval_grad_mode(model), span("render", model.device):
        out = model.forward(
            params, ray_bundle, image_indices,
            torch.zeros((ray_bundle.num_rays,), dtype=torch.long, device=ray_bundle.origins.device),
            step=0.0, train=False, rotation=rotation,
        )
        return {k: out[k].detach() for k in RENDER_KEYS}


def _graphed_render(model: NeuSkyModel, graphed: Optional[bool]) -> bool:
    return use_graph(graphed, model.device, "with a mesh: the mesh forward runs eagerly (its collectives are "
                     "not captured)" if model.mesh is not None else None)


# each model's captured render chunks, by chunk size, then by rotation or not
_captured_chunks: "weakref.WeakKeyDictionary[NeuSkyModel, Dict]" = weakref.WeakKeyDictionary()


def make_render_chunk_fn(model: NeuSkyModel, chunk_size: int = 4096,
                         graphed: Optional[bool] = None) -> Tuple[Callable, int]:
    """(chunk_fn, chunk_size): ``chunk_fn(params, ray_bundle, image_idx,
    rotation=None)`` is :func:`render_chunk` of ``chunk_size`` rays with the
    sky of eval slot ``image_idx`` (an int or a [1] device tensor).

    On the card (``graphed`` None or True) it is one CUDA graph replay a
    chunk, JAX's jitted chunk (``neusky_tpu/engine/eval_loop.py:51``): the
    rays, the slot and the rotation are the graph's inputs and the params
    are copied into the graph's own when they change, so one graph (one
    for the calls without ``rotation``, one for those with it) serves every
    chunk of every image; it takes chunks of ``chunk_size`` rays only
    (:func:`render_camera` pads the last).  The graphs are kept per (model,
    ``chunk_size``) and shared by every caller: ``chunk_fn.captured`` maps
    ``rotation is not None`` to its
    :class:`~neusky_torch.parallel.graphs.CapturedStep`.  They hold the
    model weakly, so a dropped model frees them."""
    captured = _graphed_render(model, graphed)
    graphs: Dict[bool, CapturedStep] = (_captured_chunks.setdefault(model, {}).setdefault(chunk_size, {})
                                        if captured else {})
    model_ref = weakref.ref(model)

    def chunk_fn(params, ray_bundle: RayBundle, image_idx, rotation: Optional[torch.Tensor] = None):
        with span("render.chunk"):
            dev = ray_bundle.origins.device
            idx = image_idx if isinstance(image_idx, torch.Tensor) else torch.tensor([image_idx], device=dev)
            if not captured:
                return render_chunk(model, params, ray_bundle, idx, rotation)
            if ray_bundle.num_rays != chunk_size:
                raise ValueError(f"a captured render chunk takes {chunk_size} rays, not {ray_bundle.num_rays}")
            rotated = rotation is not None
            if rotated not in graphs:
                graphs[rotated] = CapturedStep(lambda p, _, rb, i, r: render_chunk(model_ref(), p, rb, i, r))
            return graphs[rotated](params, None, ray_bundle, idx, rotation)

    chunk_fn.captured = graphs
    return chunk_fn, chunk_size


def pad_rays(ray_bundle: RayBundle, multiple: int) -> RayBundle:
    """``ray_bundle`` padded with copies of its last ray to a multiple of
    ``multiple`` rays (JAX ``render_camera``'s padding)."""
    extra = -ray_bundle.num_rays % multiple
    if not extra:
        return ray_bundle

    def pad(v: torch.Tensor) -> torch.Tensor:
        return torch.cat([v, v[-1:].expand(extra, *v.shape[1:])], dim=0)

    return RayBundle(**{f.name: pad(getattr(ray_bundle, f.name)) for f in dataclasses.fields(RayBundle)})


def render_camera(
    model: NeuSkyModel,
    params,
    camera_ray_bundle: RayBundle,
    image_idx: int,
    chunk_fn: Optional[Callable] = None,
    chunk_size: int = 4096,
    rotation: Optional[torch.Tensor] = None,
    graphed: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Chunked full-image render → host numpy maps [N, C].  The rays are
    padded with copies of the last to whole chunks and the outputs cut
    back to N, as JAX does (``neusky_tpu/engine/eval_loop.py:67-76``), so
    every chunk has one shape.  ``chunk_fn`` None takes the model's shared
    :func:`make_render_chunk_fn` (``graphed`` as its)."""
    if chunk_fn is None:
        chunk_fn, chunk_size = make_render_chunk_fn(model, chunk_size, graphed)
    n = camera_ray_bundle.num_rays
    padded = pad_rays(camera_ray_bundle, chunk_size)
    idx = torch.tensor([image_idx], device=camera_ray_bundle.origins.device)
    outs = [chunk_fn(params, padded.slice(s, chunk_size), idx, rotation)
            for s in range(0, padded.num_rays, chunk_size)]
    with span("render.to_host"):
        maps = {k: torch.cat([o[k] for o in outs], dim=0)[:n].cpu().numpy() for k in outs[0]}
    profiling.collect()
    return maps


def _eval_fit_params(params, init_latent):
    """Detached params with a fresh eval group: latents at ``init_latent``
    ([L, 3], broadcast to every slot) when its shape fits, else zeros;
    scales at one."""
    params = tree_map(lambda t: t.detach(), params)
    g = {k: v.clone() for k, v in params["eval_latents"].items()}
    cur = g["eval_latents"]
    if init_latent is not None and tuple(np.shape(init_latent)) == tuple(cur.shape[1:]):
        cur.copy_(torch.as_tensor(np.asarray(init_latent), dtype=cur.dtype, device=cur.device)[None])
    else:
        cur.zero_()
    g["eval_scale"].fill_(1.0)
    return {**params, "eval_latents": g}


def _stack_batches(batches: List[Dict], device, squeeze: bool = False) -> Dict:
    """Host batches of one shape → one device batch with a leading step
    axis (dropped with ``squeeze``), in one copy per key; ``cameras`` is
    the first batch's."""
    stacked = {k: np.stack([np.asarray(b[k]) for b in batches]) for k in batches[0] if k != "cameras"}
    if squeeze:
        stacked = {k: v[0] for k, v in stacked.items()}
    return batch_to_device(stacked, batches[0].get("cameras"), device)


def fit_eval_latents(
    model: NeuSkyModel,
    params,
    datamanager: DataManager,
    image_idx: Optional[int] = None,
    steps: int = 250,
    lr: float = 1e-1,
    lr_final: float = 1e-7,
    sample_region: str = "full_image",
    host_loop: bool = False,
    batch_fn: Optional[Callable[[], Dict]] = None,
    scale_only: bool = False,
    init_latent="auto",
) -> Tuple[Dict, List[float]]:
    """Test-time latent fit: reset the eval group (latents to
    ``init_latent``, scales to one), then ``steps`` Adam updates of the RGB
    and sky-pixel losses with everything else frozen → (params with the
    fitted eval group, the loss of every step).  ``params`` is not
    modified; the returned tree shares its other leaves' storage.

    ``init_latent``: ``"auto"`` takes the configured prior's mean-sky latent
    (:func:`~neusky_torch.engine.checkpoint.prior_init_latent`), None
    zeros, or an explicit [L, 3] array.  ``image_idx``: None cycles every
    eval slot round-robin over the steps (each slot's latent gets its own
    images), an int fits that slot alone.  ``batch_fn`` (() → host batch)
    replaces the datamanager's region batches.

    Default path: all ``steps`` batches are drawn on the host first,
    copied to the device at once, and the loss trace is read once at the
    end; on the card (the model without a mesh) each step copies its slice
    of the batches into the captured step's buffers and replays it
    (``make_eval_latent_step``'s default ``graphed``), as JAX runs the fit
    as one ``lax.scan``.  ``host_loop=True`` draws, copies and reads step by
    step, eagerly (the reference the tests hold the default path to)."""
    if batch_fn is None:
        if image_idx is None:
            n_eval = max(datamanager.num_eval, 1)
            counter = itertools.count()
            batch_fn = lambda: datamanager.eval_latent_batch(next(counter) % n_eval, sample_region)
        else:
            batch_fn = lambda: datamanager.eval_latent_batch(image_idx, sample_region)
    if isinstance(init_latent, str) and init_latent == "auto":
        init_latent = prior_init_latent(model.config)
    params = _eval_fit_params(params, init_latent)
    optimizer = build_eval_latent_optimizer(params, lr, lr_final, steps, scale_only=scale_only)
    step_fn = make_eval_latent_step(model, optimizer, graphed=False if host_loop else None)

    if host_loop:
        return params, [float(step_fn(params, _stack_batches([batch_fn()], model.device, squeeze=True), float(i)))
                        for i in range(steps)]

    stacked = _stack_batches([batch_fn() for _ in range(steps)], model.device)
    cameras = stacked.pop("cameras")
    trace = [step_fn(params, {**{k: v[i] for k, v in stacked.items()}, "cameras": cameras}, float(i))
             for i in range(steps)]
    return params, torch.stack(trace).cpu().tolist()


def rotation_fit_loss(model: NeuSkyModel, params, q: Dict[str, torch.Tensor], batch, step) -> torch.Tensor:
    """The ``nerf_osr_envmap`` rotation fit's loss: the eval-latent loss of
    ``batch`` with ``params``' eval latents and each image's sky rotated
    about z by its session's angle (``q["rot_logit"]`` [S], sigmoid-bounded
    to [0, 2π)) and scaled by ``q["scale"]`` [S]."""
    rot = rot_z(torch.sigmoid(q["rot_logit"]) * 2.0 * math.pi)[batch["image_indices"]]  # [U, 3, 3]
    p = {**params, "eval_latents": {**params["eval_latents"], "eval_scale": q["scale"]}}
    return eval_latent_loss_fn(model, p, batch, step, rotation=rot)


def _rotation_fit_params(params, gt_latents: torch.Tensor):
    """Detached ``params`` with the eval latents at ``gt_latents``."""
    frozen = tree_map(lambda t: t.detach(), params)
    return {**frozen, "eval_latents": {**frozen["eval_latents"], "eval_latents": gt_latents.detach()}}


def make_rotation_fit_step(model: NeuSkyModel, params, gt_latents: torch.Tensor, steps: int = 250,
                           lr: float = 1e-1, lr_final: float = 1e-7, graphed: Optional[bool] = None):
    """(step_fn, q): ``step_fn(q, step, batch)`` is one Adam update (eps
    1e-15, exponential decay ``lr`` → ``lr_final`` over ``steps``) of ``q``
    (``rot_logit`` [S], from ``eval_rotation`` where it has one entry a
    session, else ones; ``scale`` [S], ones) on :func:`rotation_fit_loss`
    with the eval latents fixed at ``gt_latents`` [S, D, 3] → the loss,
    detached.  On the card (``graphed`` None or True) a CUDA graph replay
    at a device step count."""
    s, dev = gt_latents.shape[0], model.device
    rot0 = params["eval_latents"].get("eval_rotation")
    if rot0 is None or rot0.shape[0] != s:
        rot0 = torch.ones((s,), device=dev)
    q = {"rot_logit": rot0.detach().clone(), "scale": torch.ones((s,), device=dev)}
    optimizer = GroupedAdam(q, {"q": OptimizerGroupConfig(lr=lr, eps=1e-15, schedule="exponential",
                                                          lr_final=lr_final, max_steps=steps)},
                            label_fn=lambda path: "q")
    fixed = _rotation_fit_params(params, gt_latents.to(dev))

    def step_fn(q, step, batch):
        optimizer.zero_grad()
        total = rotation_fit_loss(model, fixed, q, batch, step)
        total.backward()
        optimizer.step()
        return total.detach()

    if use_graph(graphed, dev):
        return CapturedStep(step_fn, optimizer), q
    return step_fn, q


def fit_eval_rotation(
    model: NeuSkyModel,
    params,
    protocol,
    gt_latents: torch.Tensor,  # [S, latent_dim, 3], fitted to the sessions' envmaps
    steps: int = 250,
    lr: float = 1e-1,
    lr_final: float = 1e-7,
    graphed: Optional[bool] = None,
) -> Tuple[Dict, np.ndarray, List[float]]:
    """The ``nerf_osr_envmap`` eval fit: the eval latents are fixed at
    ``gt_latents`` and only a per-session rotation about z and the eval
    scale are fitted (:func:`make_rotation_fit_step`) over ``steps``
    compare-pool batches drawn up front → (params with the fitted eval
    group, the angles [S] in radians, the loss of every step).  On the
    card (``graphed`` None or True) each step is one CUDA graph replay, as
    JAX runs the fit as one ``lax.scan``
    (``neusky_tpu/engine/eval_loop.py:134``); the loss trace is read once
    at the end."""
    dev = model.device
    step_fn, q = make_rotation_fit_step(model, params, gt_latents, steps, lr, lr_final, graphed)
    stacked = _stack_batches([protocol.lighting_eval_batch("compare") for _ in range(steps)], dev)
    cameras = stacked.pop("cameras")
    trace = [step_fn(q, float(i), {**{k: v[i] for k, v in stacked.items()}, "cameras": cameras})
             for i in range(steps)]
    gamma = (torch.sigmoid(q["rot_logit"]) * 2.0 * math.pi).detach().cpu().numpy()
    fixed = _rotation_fit_params(params, gt_latents.to(dev))["eval_latents"]
    out = {**params, "eval_latents": {**fixed, "eval_scale": q["scale"].detach(),
                                      "eval_rotation": q["rot_logit"].detach()}}
    return out, gamma, torch.stack(trace).cpu().tolist()


def eval_image_metrics(
    model: NeuSkyModel,
    params,
    datamanager: DataManager,
    image_idx: int,
    chunk_fn: Optional[Callable] = None,
    chunk_size: int = 4096,
    mask_to_building: bool = False,
    graphed: Optional[bool] = None,
) -> Dict[str, Any]:
    """Render eval image ``image_idx`` with its eval slot's sky and score
    it: ``psnr``, ``ssim``, ``lpips``, ``mse``, ``num_rays_per_sec`` and
    ``fps`` of the render (which ends when its maps are on the host), and
    the maps under ``outputs``.  ``mask_to_building`` multiplies the render
    and the image by mask channel 0 first: the NeRF-OSR building mask on
    the test split only (elsewhere channel 0 is the static mask).
    ``graphed`` as :func:`make_render_chunk_fn`'s, for the render and
    LPIPS."""
    rb, batch = datamanager.eval_image_bundle(image_idx)
    cams = datamanager.eval_cameras if datamanager.eval_cameras is not None else datamanager.train_cameras
    h, w = cams.height, cams.width
    t0 = time.perf_counter()
    outputs = render_camera(model, params, rb, image_idx, chunk_fn, chunk_size, graphed=graphed)
    dt = time.perf_counter() - t0
    pred = outputs["rgb"].reshape(h, w, 3)
    gt = np.asarray(batch["image"]).reshape(h, w, 3)
    if mask_to_building:
        building = np.asarray(batch["mask"]).reshape(h, w, 4)[..., 0:1]
        pred, gt = pred * building, gt * building
    return {
        "psnr": M.psnr(pred, gt),
        "ssim": M.ssim_image(pred, gt),
        "lpips": M.lpips_image(pred, gt, model.device, graphed),
        "mse": M.mse(pred, gt),
        "num_rays_per_sec": h * w / dt,
        "fps": 1.0 / dt,
        "outputs": outputs,
    }


def average_eval_metrics(
    model: NeuSkyModel,
    params,
    datamanager: DataManager,
    num_images: Optional[int] = None,
    chunk_size: int = 4096,
    fit_latents_first: bool = True,
    graphed: Optional[bool] = None,
) -> Dict[str, float]:
    """Mean of :func:`eval_image_metrics` over the first ``num_images``
    eval images (default: all), after fitting the eval latents; the
    throughput fields leave out image 0, which pays the first-call costs,
    when there is more than one image.  ``graphed`` as
    :func:`make_render_chunk_fn`'s, for the fit, the renders and LPIPS."""
    if fit_latents_first:
        params, _ = fit_eval_latents(model, params, datamanager, host_loop=graphed is False)
    chunk_fn, chunk_size = make_render_chunk_fn(model, chunk_size, graphed)
    n = num_images or max(datamanager.num_eval, 1)
    per_image = []
    for i in range(n):
        m = eval_image_metrics(model, params, datamanager, i, chunk_fn, chunk_size, graphed=graphed)
        m.pop("outputs")
        per_image.append(m)
    out = {k: float(np.mean([m[k] for m in per_image])) for k in per_image[0] if per_image[0][k] is not None}
    if len(per_image) > 1:
        for k in ("num_rays_per_sec", "fps"):
            out[k] = float(np.mean([m[k] for m in per_image[1:]]))
    return out


# ---------------------------------------------------------------------------
# the NeRF-OSR relighting protocol (session holdout → compare, building-masked)


def run_nerfosr_protocol(
    model: NeuSkyModel,
    params,
    protocol,
    fit_steps: int = 250,
    chunk_size: int = 4096,
    least_squares_scale: bool = False,
    optimise_compare_eval_scale: bool = False,
    gt_envmaps: Optional[np.ndarray] = None,  # [S, H, W, 3] linear HDR, one a session → envmap mode
    graphed: Optional[bool] = None,
) -> Dict[str, Any]:
    """The NeRF-OSR relighting benchmark on ``protocol``
    (:class:`~neusky_torch.data.nerfosr_eval.NeRFOSREvalProtocol`):

    1. fit the eval latents (one slot a lighting session) on the
       optimise pool; with ``optimise_compare_eval_scale``, fit only the
       eval scale on the compare pool (the latents stay at their reset
       value, as in the reference); with ``gt_envmaps``, fit latents to the
       envmaps with the decoder frozen, then a rotation about z and the
       scale per session on the compare pool (:func:`fit_eval_rotation`);
    2. render every compare image with its session's sky;
    3. score it inside the building mask (mask channel 0 of the test
       split), optionally after the one least-squares scale.

    → ``per_image``, ``mean`` (PSNR, SSIM, LPIPS, MSE and rays/s, which
    leaves out image 0 when there are more), ``fit_loss_first``,
    ``fit_loss_last``, ``num_sessions``, ``lpips_flavour`` and, in envmap
    mode, ``envmap_fit_psnr`` and ``session_rotation_rad``.  ``graphed``
    as :func:`make_render_chunk_fn`'s, for the fits, the renders and
    LPIPS."""
    dev = model.device
    session_rot = None
    envmap_info = None
    if gt_envmaps is not None:
        gt_latents, envmap_psnr = fit_latents_to_envmaps(
            model.illumination, params["illumination_decoder"], np.asarray(gt_envmaps), steps=fit_steps,
            graphed=graphed)
        params, gamma, fit_losses = fit_eval_rotation(model, params, protocol, torch.from_numpy(gt_latents).to(dev),
                                                      steps=fit_steps, graphed=graphed)
        envmap_info = {"envmap_fit_psnr": [float(x) for x in envmap_psnr],
                       "session_rotation_rad": [float(g) for g in gamma]}
        # the fitted rotation is applied at render time, as in JAX: the
        # reference registers eval_rotation but renders with the identity
        # (``neusky_pipeline.py:423``); rendering with the rotation the scale
        # was fitted under is the consistent choice
        session_rot = rot_z(torch.as_tensor(gamma, dtype=torch.float32, device=dev))
    else:
        fit_pool = "compare" if optimise_compare_eval_scale else "optimise"
        params, fit_losses = fit_eval_latents(model, params, None, steps=fit_steps,
                                              batch_fn=lambda: protocol.lighting_eval_batch(fit_pool),
                                              scale_only=optimise_compare_eval_scale, host_loop=graphed is False)

    chunk_fn, chunk_size = make_render_chunk_fn(model, chunk_size, graphed)
    h, w = protocol.cameras.height, protocol.cameras.width
    per_image = []
    for i in range(len(protocol.compare_indices)):
        image_idx, slot, rb, gt_batch = protocol.compare_image(i)
        t0 = time.perf_counter()
        out = render_camera(model, params, rb, slot, chunk_fn, chunk_size,
                            rotation=session_rot[slot] if session_rot is not None else None)
        dt = time.perf_counter() - t0
        building = np.asarray(gt_batch["mask"]).reshape(h, w, 4)[..., 0:1]
        pred = out["rgb"].reshape(h, w, 3) * building
        gt = np.asarray(gt_batch["image"]).reshape(h, w, 3) * building
        if least_squares_scale:
            pred = np.clip(global_least_squares_scale(pred, gt), 0.0, None)
        per_image.append({
            "image_idx": int(image_idx),
            "session": int(slot),
            "psnr": M.psnr(pred, gt),
            "ssim": M.ssim_image(pred, gt),
            "lpips": M.lpips_image(pred, gt, dev, graphed),
            "mse": M.mse(pred, gt),
            "num_rays_per_sec": h * w / dt,
        })
    keys = [k for k in ("psnr", "ssim", "lpips", "mse", "num_rays_per_sec")
            if per_image and per_image[0][k] is not None]
    mean = {k: float(np.mean([p[k] for p in per_image])) for k in keys}
    if len(per_image) > 1 and "num_rays_per_sec" in keys:
        # image 0 pays the first-call costs (the same rule as average_eval_metrics)
        mean["num_rays_per_sec"] = float(np.mean([p["num_rays_per_sec"] for p in per_image[1:]]))
    result = {
        "per_image": per_image,
        "mean": mean,
        "fit_loss_first": fit_losses[0],
        "fit_loss_last": fit_losses[-1],
        "num_sessions": protocol.num_sessions,
    }
    if envmap_info is not None:
        result.update(envmap_info)
    if "lpips" in keys:
        # random-VGG LPIPS is a valid distance but not comparable to
        # published (pretrained) numbers: always name the flavour
        result["lpips_flavour"] = M.lpips_flavour()
    return result


def _load_session_envmaps(po: Dict[str, Any], width: int = 128) -> np.ndarray:
    """One envmap a lighting session (``ENV_MAP_CC/<session>/``, in the
    parser's session order) → [S, width / 2, width, 3] linear HDR: decoded
    (PNG without Pillow, other formats through it), made RGB as Pillow's
    ``convert("RGB")`` does, resized with Pillow's bilinear filter
    (:func:`~neusky_torch.utils.viz.resize_bilinear_u8`) and linearised
    from sRGB."""
    from neusky_torch.core.colour import sRGB_to_linear
    from neusky_torch.utils.viz import PNG_SIGNATURE, load_image, png_header, resize_bilinear_u8

    files = po.get("envmap_filenames") or []
    if not files:
        raise SystemExit("eval_latent_optimise_method=nerf_osr_envmap needs envmap images under ENV_MAP_CC/<session>/")
    # slot s is the parser's session_names[s]
    sessions = po.get("session_names") or sorted({os.path.basename(os.path.dirname(f)) for f in files})
    out = []
    for s in sessions:
        f = next((x for x in files if os.path.basename(os.path.dirname(x)) == s), None)
        if f is None:
            raise SystemExit(f"session {s!r} has no png/jpg envmap directly under ENV_MAP_CC/{s}/ "
                             f"(found files: {len(files)} across sessions)")
        with open(f, "rb") as fh:
            if fh.read(8) == PNG_SIGNATURE and png_header(f)["colour_type"] == 3:
                raise ValueError(f"{f}: palette PNG envmaps are not decoded")
        img = load_image(f)
        if img.ndim == 2:  # grey
            img = img[..., None]
        img = np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] in (1, 2) else img[..., :3]
        ldr = resize_bilinear_u8(img, width, width // 2).astype(np.float32) / 255.0
        out.append(sRGB_to_linear(torch.from_numpy(ldr)).numpy())
    return np.stack(out)


def run_nerfosr_eval(args, overrides):
    """``cli eval --protocol nerfosr``: the test split of ``--data`` and its
    sessions, the checkpoint under ``--load-dir`` (every group but the
    per-image latents), :func:`run_nerfosr_protocol`, the result written as
    JSON to ``--output`` (``nerfosr_eval.json`` when it is the render
    default ``render.npy``; any other suffix becomes ``.json``) and its mean
    printed."""
    from neusky_torch.cli import _apply_overrides
    from neusky_torch.configs import METHOD_REGISTRY
    from neusky_torch.data.dataparsers.nerfosr import NeRFOSRDataparserConfig, parse_holdout_arg, parse_nerfosr_scene
    from neusky_torch.data.dataset import NeuSkyDataset
    from neusky_torch.data.nerfosr_eval import NeRFOSREvalProtocol
    from neusky_torch.device import resolve_device
    from neusky_torch.engine.checkpoint import load_param_subtrees

    if not args.load_dir:
        raise SystemExit("--load-dir required for the nerfosr protocol")
    bundle = _apply_overrides(METHOD_REGISTRY[args.method].build(), overrides)
    model_config = bundle["model_config"]
    parser_cfg = NeRFOSRDataparserConfig(
        data=args.data, scene=args.scene,
        session_holdout_indices=parse_holdout_arg(getattr(args, "session_holdout_indices", "0,0,0,0,0")),
    )
    train_po = parse_nerfosr_scene(parser_cfg, "train")
    test_po = parse_nerfosr_scene(parser_cfg, "test")
    test_data = NeuSkyDataset(test_po, "test", args.downscale).load()
    device = resolve_device(args.device)
    protocol = NeRFOSREvalProtocol(
        cameras=test_data["cameras"].to(device),
        images=test_data["images"],
        masks=test_data["masks"],
        session_to_indices=test_po["session_to_indices"],
        indices_to_session=test_po["indices_to_session"],
        session_holdout_indices=test_po["session_holdout_indices"],
        test_eval_mask_indices=sorted(test_po["test_eval_mask_dict"].keys()),
    )
    # eval slots are lighting sessions; the train latents are sized as the
    # training run's, though the protocol neither reads nor restores them
    model_config = dataclasses.replace(model_config, num_train_data=len(train_po["image_filenames"]),
                                       num_eval_data=protocol.num_sessions)
    model = NeuSkyModel(model_config, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    # the per-image latent groups are left out: the eval latents are refit
    # (a slot a session here), and the train latents belong to the training
    # images, so a run with another train-image count still restores
    params = load_param_subtrees(Path(args.load_dir), None, params, exclude=("eval_latents", "illumination_field"))
    gt_envmaps = None
    if model_config.eval_latent_optimise_method == "nerf_osr_envmap":
        gt_envmaps = _load_session_envmaps(test_po, width=128)
    pipe_cfg = bundle.get("pipeline_config")
    result = run_nerfosr_protocol(
        model, params, protocol,
        least_squares_scale=bool(getattr(pipe_cfg, "least_squares_global_scale", False)),
        optimise_compare_eval_scale=model_config.optimise_compare_eval_scale,
        gt_envmaps=gt_envmaps,
        graphed=cli_graphed(args),
    )
    # --output is shared with ``render``, whose default is render.npy
    raw_out = getattr(args, "output", "")
    if not raw_out or raw_out == "render.npy":
        raw_out = "nerfosr_eval.json"
    out_path = Path(raw_out)
    if out_path.suffix != ".json":
        out_path = out_path.with_suffix(".json")
    out_path.write_text(json.dumps(result, indent=2))
    print(json.dumps(result["mean"]), flush=True)
    print(f"wrote {out_path}")
    return result


# ---------------------------------------------------------------------------
# CLI glue


def cli_graphed(args) -> Optional[bool]:
    """``graphed`` of a command: False with ``--eager``, else None (captured
    on the card)."""
    return False if getattr(args, "eager", False) else None


def _load_run(args, overrides):
    """(model, params, datamanager) of a ``cli eval`` / ``cli render`` run on
    ``args.device``: the method's configs with the overrides, latent counts
    from the data, params from ``model.init`` restored from the newest
    checkpoint under ``--load-dir`` (the optimizer's state is the template
    and is dropped).  Without ``--load-dir`` the params stay as initialised,
    with no prior loaded, as in JAX."""
    from neusky_torch.cli import _apply_overrides, _build_datamanager
    from neusky_torch.configs import METHOD_REGISTRY
    from neusky_torch.device import resolve_device
    from neusky_torch.engine.checkpoint import load_checkpoint
    from neusky_torch.engine.optimizers import GroupedAdam, default_neusky_optimizer_groups

    bundle = _apply_overrides(METHOD_REGISTRY[args.method].build(), overrides)
    model_config = bundle["model_config"]
    dm = _build_datamanager(args, model_config, bundle.get("dataparser", "nerfosr"))
    model_config = dataclasses.replace(model_config, num_train_data=dm.num_train, num_eval_data=max(dm.num_eval, 1))
    model = NeuSkyModel(model_config, device=args.device)
    params = model.init(torch.Generator(device=resolve_device(args.device)).manual_seed(0))
    if args.load_dir:
        optimizer = GroupedAdam(params, bundle.get("optimizer_groups") or default_neusky_optimizer_groups(10))
        params, _, _ = load_checkpoint(Path(args.load_dir), None, params, optimizer.state_dict())
    return model, params, dm


def run_eval(args, overrides):
    """``cli eval``: fit the eval latents (when there is an eval split),
    render and score every eval image, print the mean metrics as JSON."""
    model, params, dm = _load_run(args, overrides)
    metrics = average_eval_metrics(model, params, dm, fit_latents_first=dm.num_eval > 0, graphed=cli_graphed(args))
    print(json.dumps(metrics), flush=True)
    return metrics


def run_render(args, overrides):
    """``cli render``: render eval image ``--image-idx`` with its eval
    slot's sky and save its ``rgb`` [H, W, 3] to ``--output`` (``.npy``)."""
    model, params, dm = _load_run(args, overrides)
    rb, _ = dm.eval_image_bundle(args.image_idx)
    out = render_camera(model, params, rb, args.image_idx, graphed=cli_graphed(args))
    cams = dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras
    img = out["rgb"].reshape(cams.height, cams.width, 3)
    np.save(args.output, img)
    print(f"saved render to {args.output} ({img.shape})")
    return img
