"""The training window on a mesh: ``neusky.train``'s step as the ranks of a
``("data",)`` mesh, one process and one card a rank, over NCCL (gloo on
the CPU), as ``Trainer(mesh=...)`` runs it.

The ranks are started by ``neusky_torch/parallel/launch.py::run_ranks``.
Each builds the trainer as ``loops/train.py::build`` does, with the mesh
(``make_mesh(world, backend=..., rank=r, ...)``), loads the benchmark's
weights and broadcasts rank 0's, and seeds its draws alike: every rank
draws the global batch (``cli train``'s U images × R rays and the sky rays)
and trains on its shard of the scene rays, with the DDF fit's vMF rays and
the sky rays whole on every rank, the gradients averaged in one all-reduce
a step.  The ranks run their first three steps (eager, captured,
replayed), which the reference follows on rank 0's gradients (the global
step's), and four to warm up; rank 0 sizes the window and every rank runs
it.  The window is on rank 0's clock, from a barrier to a barrier and a
synchronise; its rays are the global batch's by the training loop's rule.
The peak memory is the largest of the ranks'.  Traced, rank 0 profiles four
steps after the window."""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict

import torch

from benchmark import common, counts, scene, spans, trace
from benchmark.loops.train import (
    FIRST_STEPS, PROFILED_STEPS, WARM_STEPS, _first_moments, _grads_from_moments, _host_params, _load_weights,
    _sync, scene_rays,
)
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

RANK_TIMEOUT_S = 900.0  # set-up, warm-up, the reference: what the ranks take besides the window


def build(cell: Dict, config: Dict, seeds: common.Seeds, device, mesh):
    """(trainer, scene) of one rank, with the benchmark's weights (rank
    0's, broadcast) and seeds."""
    import torch.distributed as dist

    from neusky_torch.core import cameras as cameras_module
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.engine.trainer import Trainer
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.tree import tree_items

    bundle = common.program_bundle(config)
    traffic, a = cell["traffic"], config["assumed"]
    sc = scene.make_scene(seeds.scene, a["train_images"], a["eval_images"], a["width"], a["height"])
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
    model = NeuSkyModel(model_config, device=device)
    tcfg = dataclasses.replace(bundle["trainer_config"], seed=seeds.weights,
                               output_dir=str(common.ROOT / ".bench" / "outputs"))
    trainer = Trainer(tcfg, model, bundle["pipeline_config"], dm, optimizer_groups=bundle["optimizer_groups"],
                      device=device, mesh=mesh)
    _load_weights(trainer, ref_model.make_params(config, seeds.weights, device))
    with torch.no_grad():
        for _, t in tree_items(trainer.params):
            dist.broadcast(t, src=0)
    trainer.generator.manual_seed(seeds.draws)
    return trainer, sc


def _barrier(device) -> None:
    import torch.distributed as dist

    dist.barrier(device_ids=[device.index]) if device.type == "cuda" else dist.barrier()
    _sync(device)


def rank_run(rank: int, world_size: int, init_method: str, cell: Dict, config: Dict, seeds: common.Seeds,
             seconds: float, traced: bool, backend: str) -> Dict[str, Any]:
    """One rank's part (``run_ranks``' target): rank 0 returns the record
    less the peak memory, every rank its peak."""
    import torch.distributed as dist

    from neusky_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    mesh = make_mesh(world_size, backend=backend, rank=rank, init_method=init_method, device=device)
    lead, notes, began = rank == 0, [], time.time()

    def note(msg: str) -> None:  # rank 0's, kept for the harness's standard error
        if lead:
            notes.append(f"[rank 0, {time.time() - began:8.2f} s] {msg}")
    trainer, sc = build(cell, config, seeds, device, mesh)
    note(f"rank 0 of {world_size} ({backend}): built the trainer")
    traffic, recipe = cell["traffic"], ref_model.recipe(config)
    n_scene = scene_rays(traffic, trainer.datamanager.num_train)
    rays = counts.rays_per_step(recipe["model_config"], recipe["pipeline_config"], n_scene, traffic["sky_rays"])
    program: Dict[str, Any] = {"losses": []}
    start, moments = (_host_params(trainer) if lead else None), []
    for _ in range(FIRST_STEPS):
        trainer.run(1)
        if lead:
            program["losses"].append(trainer.history[-1]["total_loss"])
            moments.append(_first_moments(trainer))
            note(f"step {len(moments)} (loss {program['losses'][-1]!r})")
    if lead:
        program["grads"] = _grads_from_moments(moments)
        program["params"] = (start, _host_params(trainer))
    del moments
    _barrier(device)
    t0 = time.perf_counter()
    trainer.run(WARM_STEPS)
    _sync(device)
    pace = (time.perf_counter() - t0) / WARM_STEPS
    n = torch.tensor([max(FIRST_STEPS, math.ceil(seconds / pace))], device=device)
    dist.broadcast(n, src=0)  # rank 0's pace sizes every rank's window
    n_steps = int(n.item())
    note(f"warm-up: {pace * 1e3:.3f} ms a step; the window runs {n_steps} steps")

    history_from = len(trainer.history)
    _barrier(device)
    window_start = time.time()
    p0 = time.perf_counter()
    trainer.run(n_steps)
    _barrier(device)
    window_s = time.perf_counter() - p0
    window_losses = [r["total_loss"] for r in trainer.history[history_from:] if "total_loss" in r]
    failed = n_steps if not all(math.isfinite(x) for x in window_losses) else 0
    note(f"window: {n_steps} steps in {window_s:.3f} s")

    profiled = None
    if traced and device.type == "cuda":  # the CPU has no device trace
        if lead:
            recorder = spans.Recorder(enabled=True)
            recorder.wrap(trainer.datamanager, "next_train")
            profiled = trace.profile(lambda: (trainer.run(PROFILED_STEPS), PROFILED_STEPS)[1], device,
                                     "bench.next_train")
            recorder.unwrap()
            note(f"profiled {PROFILED_STEPS} steps on rank 0: {len(profiled.device)} device operations")
        else:
            trainer.run(PROFILED_STEPS)
        _barrier(device)
    peak = int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0
    if not lead:
        return {"peak_mem_bytes": peak}
    info = common.device_info(device)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = ref_train.run_steps(config, sc["train"], traffic, seeds, FIRST_STEPS, device)
    note("the reference's steps and the comparison")
    return {
        "kind": "train", "window_start": window_start, "window_s": window_s, "steps": n_steps,
        "rays": n_steps * rays, "rays_per_step": rays, "peak_mem_bytes": peak, "device": info,
        "attempted": n_steps, "failed": failed, "numbers": ref_train.compare(program, reference), "spans": {},
        "trace": profiled, "leaf_norms": ref_train.leaf_norms(program, reference), "notes": notes,
    }


def run(cell: Dict, config: Dict, seeds: common.Seeds, seconds: float, traced: bool, device) -> Dict[str, Any]:
    from neusky_torch.parallel.launch import run_ranks

    world = cell["chips"]
    backend = "nccl" if device.type == "cuda" else "gloo"
    out = run_ranks("benchmark.loops.train_mesh:rank_run", world,
                    {"cell": cell, "config": config, "seeds": seeds, "seconds": seconds, "traced": traced,
                     "backend": backend}, timeout_s=RANK_TIMEOUT_S + seconds)
    record = out[0]
    for line in record.pop("notes"):
        print(line, file=sys.stderr)
    record["peak_mem_bytes"] = max(r["peak_mem_bytes"] for r in out)
    record["device"] = {**record["device"], "count": world, "memory_peak_bytes": record["peak_mem_bytes"]}
    return record
