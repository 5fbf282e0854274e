"""The training window: ``Trainer.run``'s own loop, as ``cli train`` runs it
on a site's images.

Set-up builds the ``DataManager`` as ``cli.py::_build_datamanager``'s
real-site branch does (U = min(16, images) images × rays_per_batch // U
rays, the numpy pixel sampler, an eval split) on the benchmark's scene,
the model and the ``Trainer`` of the recipe the registry builds, loads the
benchmark's weights into it and seeds its draws.  It then drives that
trainer through its first three steps (eager, captured, replayed), which
the reference follows, and a few more to warm up and to size the window.
The window is ``Trainer.run`` over as many steps as fill ``--seconds`` at
the warm-up's pace, ended by a synchronise; its rays are counted by the
training loop's rule (``counts.rays_per_step``)."""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Dict

import torch

from benchmark import common, counts, scene, spans, trace
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

FIRST_STEPS = 3  # the steps the reference follows
WARM_STEPS = 4  # replays after them that pace the window
PROFILED_STEPS = 4


def _first_moments(trainer) -> Dict[str, torch.Tensor]:
    """Each trainable leaf's Adam first moment (host)."""
    from neusky_torch.tree import tree_items

    state = trainer.optimizer.optimizer.state
    return {k: (state[t]["exp_avg"].detach().cpu().clone() if t in state else torch.zeros(t.shape))
            for k, t in tree_items(trainer.params) if t.requires_grad}


def _grads_from_moments(moments) -> list:
    """Each step's gradients as the optimizer got them, from its first
    moment after each step: m_k = beta1 · m_(k-1) + (1 − beta1) · g_k."""
    b1, prev, out = ref_train.BETA1, None, []
    for m in moments:
        out.append({k: (v - b1 * prev[k]) / (1.0 - b1) if prev else v / (1.0 - b1) for k, v in m.items()})
        prev = m
    return out


def _host_params(trainer) -> Dict[str, torch.Tensor]:
    from neusky_torch.tree import tree_items

    return {k: t.detach().cpu().clone() for k, t in tree_items(trainer.params)}


def _load_weights(trainer, weights) -> None:
    from neusky_torch.tree import tree_items

    mine, theirs = list(tree_items(trainer.params)), list(tree_items(weights))
    if [k for k, _ in mine] != [k for k, _ in theirs]:
        raise ValueError("the program's parameter tree differs from the benchmark's")
    with torch.no_grad():
        for (k, t), (_, w) in zip(mine, theirs):
            if t.shape != w.shape or t.dtype != w.dtype:
                raise ValueError(f"{k}: the program holds {tuple(t.shape)} {t.dtype}, the benchmark "
                                 f"{tuple(w.shape)} {w.dtype}")
            t.copy_(w)


def build(cell: Dict, config: Dict, seeds: common.Seeds, device):
    """(trainer, scene) of the cell, with the benchmark's weights and
    seeds."""
    from neusky_torch.core import cameras as cameras_module
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.engine.trainer import Trainer
    from neusky_torch.models.neusky import NeuSkyModel

    bundle = common.program_bundle(config)
    common.note("imported the program")
    traffic, a = cell["traffic"], config["assumed"]
    sc = scene.make_scene(seeds.scene, a["train_images"], a["eval_images"], a["width"], a["height"])
    common.note("made the scene")
    tr, ev = sc["train"], sc["eval"]
    u = min(traffic["images_per_batch"], tr["images"].shape[0])
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=u,
                                                           rays_per_image=traffic["rays_per_batch"] // u),
                          num_sky_rays=traffic["sky_rays"], seed=seeds.sampler),
        scene.cameras(tr, cameras_module), tr["images"], tr["masks"],
        scene.cameras(ev, cameras_module), ev["images"], ev["masks"], device=device,
    )
    model_config = dataclasses.replace(bundle["model_config"], num_train_data=dm.num_train,
                                       num_eval_data=max(dm.num_eval, 1))
    common.check_prior(config, model_config)
    common.note("built the data manager")
    model = NeuSkyModel(model_config, device=device)
    tcfg = dataclasses.replace(bundle["trainer_config"], seed=seeds.weights,
                               output_dir=str(common.ROOT / ".bench" / "outputs"))
    trainer = Trainer(tcfg, model, bundle["pipeline_config"], dm, optimizer_groups=bundle["optimizer_groups"],
                      device=device)
    common.note("built the trainer")
    _load_weights(trainer, ref_model.make_params(config, seeds.weights, device))
    trainer.generator.manual_seed(seeds.draws)
    return trainer, sc


def scene_rays(traffic: Dict, n_images: int) -> int:
    """A batch's scene rays: U = min(U, images) images × rays_per_batch // U."""
    u = min(traffic["images_per_batch"], n_images)
    return u * (traffic["rays_per_batch"] // u)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Dict, config: Dict, seeds: common.Seeds, seconds: float, traced: bool, device) -> Dict[str, Any]:
    trainer, sc = build(cell, config, seeds, device)
    common.note("loaded the benchmark's weights")
    traffic, recipe = cell["traffic"], ref_model.recipe(config)
    mc, pc = recipe["model_config"], recipe["pipeline_config"]
    n_scene = scene_rays(traffic, trainer.datamanager.num_train)
    rays = counts.rays_per_step(mc, pc, n_scene, traffic["sky_rays"])
    program: Dict[str, Any] = {"losses": []}
    start, moments = _host_params(trainer), []
    for _ in range(FIRST_STEPS):
        trainer.run(1)
        program["losses"].append(trainer.history[-1]["total_loss"])
        moments.append(_first_moments(trainer))
        common.note(f"step {len(moments)} (loss {program['losses'][-1]!r})")
    program["grads"] = _grads_from_moments(moments)
    program["params"] = (start, _host_params(trainer))
    del moments
    t0 = time.perf_counter()
    trainer.run(WARM_STEPS)
    _sync(device)
    pace = (time.perf_counter() - t0) / WARM_STEPS
    n_steps = max(FIRST_STEPS, math.ceil(seconds / pace))
    common.note(f"warm-up: {pace * 1e3:.3f} ms a step; the window runs {n_steps} steps")

    recorder = spans.Recorder(enabled=traced)
    recorder.wrap(trainer.datamanager, "next_train")
    recorder.wrap(trainer, "train_step")
    history_from = len(trainer.history)
    window_start = time.time()
    p0 = time.perf_counter()
    trainer.run(n_steps)
    _sync(device)
    window_s = time.perf_counter() - p0
    window_losses = [r["total_loss"] for r in trainer.history[history_from:] if "total_loss" in r]
    failed = n_steps if not all(math.isfinite(x) for x in window_losses) else 0

    common.note(f"window: {n_steps} steps in {window_s:.3f} s")
    profiled = None
    if traced and device.type == "cuda":  # the CPU has no device trace
        profiled = trace.profile(lambda: (trainer.run(PROFILED_STEPS), PROFILED_STEPS)[1], device,
                                 "bench.next_train")
        common.note(f"profiled {PROFILED_STEPS} steps: {len(profiled.device)} device operations")
    recorder.unwrap()
    peak = int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0
    info = common.device_info(device)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    reference = ref_train.run_steps(config, sc["train"], traffic, seeds, FIRST_STEPS, device)
    numbers = ref_train.compare(program, reference)
    common.note("the reference's steps and the comparison")
    record = {
        "kind": "train", "window_start": window_start, "window_s": window_s, "steps": n_steps,
        "rays": n_steps * rays, "rays_per_step": rays, "peak_mem_bytes": peak, "device": info,
        "attempted": n_steps, "failed": failed, "numbers": numbers, "spans": recorder.durations,
        "trace": profiled, "leaf_norms": ref_train.leaf_norms(program, reference),
    }
    if traced:
        record["flops_per_step"] = ref_train.count_step_flops(config, sc["train"], traffic, seeds, device)
        common.note("counted the step's FLOPs on the reference")
        record["k1_bound_ms_per_step"] = counts.k1_step_bound_ms(mc, pc, n_scene)
    return record
