"""Evaluation (mirror of ``neusky_tpu/engine/eval_loop.py``): chunked
full-image renders, the test-time fit of the eval latents, and per-image
PSNR / SSIM / LPIPS / MSE with rays/s and fps.

The eval forward (``train=False``) draws nothing: the proposal sampler runs
without jitter and the light directions are the fixed icosphere, so these
functions take no generator.  The fit updates only the eval group
(``eval_latents``, ``eval_scale``, ``eval_rotation``): every other leaf is
detached, so autograd records just the RENI decode → Lambertian branch and
no hash-table gradient (K1) runs.

``run_eval`` and ``run_render`` are ``cli eval`` and ``cli render``.

Not ported yet: ``fit_eval_rotation`` and the NeRF-OSR protocol
(``run_nerfosr_protocol``, ``run_nerfosr_eval``, ``_load_session_envmaps``).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from neusky_torch.core.rays import RayBundle
from neusky_torch.data.datamanager import DataManager, batch_to_device
from neusky_torch.engine import metrics as M
from neusky_torch.engine.checkpoint import prior_init_latent
from neusky_torch.engine.optimizers import build_eval_latent_optimizer
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.parallel.mesh import make_eval_latent_step
from neusky_torch.tree import tree_map

RENDER_KEYS = ("rgb", "albedo", "accumulation", "depth", "p2p_dist", "normal")


def make_render_chunk_fn(model: NeuSkyModel, chunk_size: int = 4096) -> Tuple[Callable, int]:
    """(chunk_fn, chunk_size): ``chunk_fn(params, ray_bundle, image_idx,
    rotation=None)`` is the eval forward of one chunk of rays with the sky
    of eval slot ``image_idx`` (``rotation`` [3, 3] rotates it), returning
    :data:`RENDER_KEYS`.  It runs under ``torch.inference_mode`` (with
    autograd on only for a field whose spatial gradient needs it)."""
    analytic = model.field.config.gradient_mode == "forward"

    def chunk_fn(params, ray_bundle: RayBundle, image_idx: int, rotation: Optional[torch.Tensor] = None):
        dev = ray_bundle.origins.device
        with torch.inference_mode(analytic), torch.set_grad_enabled(not analytic):
            out = model.forward(
                params, ray_bundle, torch.tensor([image_idx], device=dev),
                torch.zeros((ray_bundle.num_rays,), dtype=torch.long, device=dev),
                step=0.0, train=False, rotation=rotation,
            )
            return {k: out[k].detach() for k in RENDER_KEYS}

    return chunk_fn, chunk_size


def render_camera(
    model: NeuSkyModel,
    params,
    camera_ray_bundle: RayBundle,
    image_idx: int,
    chunk_fn: Optional[Callable] = None,
    chunk_size: int = 4096,
    rotation: Optional[torch.Tensor] = None,
) -> Dict[str, np.ndarray]:
    """Chunked full-image render → host numpy maps [N, C].  The last chunk
    may be short (no padding): every output is per ray."""
    if chunk_fn is None:
        chunk_fn, chunk_size = make_render_chunk_fn(model, chunk_size)
    n = camera_ray_bundle.num_rays
    outs = [chunk_fn(params, camera_ray_bundle.slice(s, chunk_size), image_idx, rotation)
            for s in range(0, n, chunk_size)]
    return {k: torch.cat([o[k] for o in outs], dim=0).cpu().numpy() for k in outs[0]}


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
    end.  ``host_loop=True`` draws, copies and reads step by step (the
    reference the tests hold the default path to)."""
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
    step_fn = make_eval_latent_step(model, optimizer)

    if host_loop:
        return params, [float(step_fn(params, _stack_batches([batch_fn()], model.device, squeeze=True), float(i)))
                        for i in range(steps)]

    stacked = _stack_batches([batch_fn() for _ in range(steps)], model.device)
    cameras = stacked.pop("cameras")
    trace = [step_fn(params, {**{k: v[i] for k, v in stacked.items()}, "cameras": cameras}, float(i))
             for i in range(steps)]
    return params, torch.stack(trace).cpu().tolist()


def eval_image_metrics(
    model: NeuSkyModel,
    params,
    datamanager: DataManager,
    image_idx: int,
    chunk_fn: Optional[Callable] = None,
    chunk_size: int = 4096,
) -> Dict[str, Any]:
    """Render eval image ``image_idx`` with its eval slot's sky and score
    it: ``psnr``, ``ssim``, ``lpips``, ``mse``, ``num_rays_per_sec`` and
    ``fps`` of the render (which ends when its maps are on the host), and
    the maps under ``outputs``."""
    rb, batch = datamanager.eval_image_bundle(image_idx)
    cams = datamanager.eval_cameras if datamanager.eval_cameras is not None else datamanager.train_cameras
    h, w = cams.height, cams.width
    t0 = time.perf_counter()
    outputs = render_camera(model, params, rb, image_idx, chunk_fn, chunk_size)
    dt = time.perf_counter() - t0
    pred = outputs["rgb"].reshape(h, w, 3)
    gt = np.asarray(batch["image"]).reshape(h, w, 3)
    return {
        "psnr": M.psnr(pred, gt),
        "ssim": M.ssim_image(pred, gt),
        "lpips": M.lpips_image(pred, gt, model.device),
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
) -> Dict[str, float]:
    """Mean of :func:`eval_image_metrics` over the first ``num_images``
    eval images (default: all), after fitting the eval latents; the
    throughput fields leave out image 0, which pays the first-call costs,
    when there is more than one image."""
    if fit_latents_first:
        params, _ = fit_eval_latents(model, params, datamanager)
    chunk_fn, chunk_size = make_render_chunk_fn(model, chunk_size)
    n = num_images or max(datamanager.num_eval, 1)
    per_image = []
    for i in range(n):
        m = eval_image_metrics(model, params, datamanager, i, chunk_fn, chunk_size)
        m.pop("outputs")
        per_image.append(m)
    out = {k: float(np.mean([m[k] for m in per_image])) for k in per_image[0] if per_image[0][k] is not None}
    if len(per_image) > 1:
        for k in ("num_rays_per_sec", "fps"):
            out[k] = float(np.mean([m[k] for m in per_image[1:]]))
    return out


# ---------------------------------------------------------------------------
# CLI glue


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
    metrics = average_eval_metrics(model, params, dm, fit_latents_first=dm.num_eval > 0)
    print(json.dumps(metrics), flush=True)
    return metrics


def run_render(args, overrides):
    """``cli render``: render eval image ``--image-idx`` with its eval
    slot's sky and save its ``rgb`` [H, W, 3] to ``--output`` (``.npy``)."""
    model, params, dm = _load_run(args, overrides)
    rb, _ = dm.eval_image_bundle(args.image_idx)
    out = render_camera(model, params, rb, args.image_idx)
    cams = dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras
    img = out["rgb"].reshape(cams.height, cams.width, 3)
    np.save(args.output, img)
    print(f"saved render to {args.output} ({img.shape})")
    return img
