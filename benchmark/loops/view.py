"""The viewer's window: one client in a closed loop asks
``viewer.py::ViewerState.render`` for the ``rgb`` image of the next pose
and waits for it, as the viewer's page does on every slider move.

Poses are drawn from the seed over the page's slider ranges.  Set-up builds
the recipe's model, hands it the benchmark's weights and renders a few
warm-up poses (the eager chunk, its capture, replays); the window renders
pose after pose until ``--seconds`` have passed, each frame timed from the
call to the host-side image."""

from __future__ import annotations

import gc
import time
from typing import Any, Dict

import numpy as np
import torch

from benchmark import common, spans, trace
from benchmark.reference import model as ref_model
from benchmark.reference import view as ref_view

POSE_LOW = (-180.0, -80.0, 0.5)  # azimuth and elevation in degrees, distance
POSE_HIGH = (180.0, 80.0, 3.0)
PROFILED_FRAMES = 4


def _query(pose) -> Dict:
    return {"mode": ["rgb"], "az": [str(pose[0])], "el": [str(pose[1])], "dist": [str(pose[2])]}


def run(cell: Dict, config: Dict, seeds: common.Seeds, seconds: float, traced: bool, device) -> Dict[str, Any]:
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.viewer import ViewerState

    traffic = cell["traffic"]
    bundle = common.program_bundle(config)
    common.note("imported the program")
    common.check_prior(config, bundle["model_config"])
    res = traffic["resolution"]
    model = NeuSkyModel(bundle["model_config"], device=device)
    state = ViewerState(model, ref_model.make_params(config, seeds.weights, device), resolution=res)
    rng = np.random.default_rng([seeds.window, 1])
    warm = rng.uniform(POSE_LOW, POSE_HIGH, size=(traffic["warmup_frames"], 3))
    poses = rng.uniform(POSE_LOW, POSE_HIGH, size=(traffic["poses"], 3))
    common.note("built the model and the viewer state")
    for p in warm:
        state.render(_query(p))
    common.note(f"warmed up on {len(warm)} frames")

    frame_s, images = [], []
    window_start = time.time()
    p0 = time.perf_counter()
    while time.perf_counter() - p0 < seconds:
        pose = poses[len(images) % len(poses)]
        t0 = time.perf_counter()
        img = state.render(_query(pose))
        frame_s.append(time.perf_counter() - t0)
        images.append(img)
    window_s = time.perf_counter() - p0
    failed = sum(1 for img in images if not np.all(np.isfinite(img)))
    common.note(f"window: {len(images)} frames in {window_s:.3f} s")

    profiled = None
    if traced and device.type == "cuda":  # the CPU has no device trace
        extra = rng.uniform(POSE_LOW, POSE_HIGH, size=(PROFILED_FRAMES, 3))
        recorder = spans.Recorder(enabled=True)
        recorder.wrap(state, "render")
        profiled = trace.profile(lambda: sum(1 for p in extra if state.render(_query(p)) is not None), device,
                                 "bench.render")
        recorder.unwrap()
        common.note(f"profiled {PROFILED_FRAMES} frames: {len(profiled.device)} device operations")
    peak = int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0
    info = common.device_info(device)
    del state, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    pick = np.random.default_rng([seeds.window, 2]).choice(len(images), size=min(traffic["check_frames"],
                                                                                  len(images)), replace=False)
    picked = [poses[i % len(poses)] for i in pick]
    reference = ref_view.render_frames(config, seeds, picked, res, device)
    numbers = ref_view.compare([images[i] for i in pick], reference)
    common.note(f"the reference's {len(picked)} frames and the comparison")
    record = {
        "kind": "view", "window_start": window_start, "window_s": window_s, "frames": len(images),
        "rays": len(images) * res * res, "frame_ms": [1e3 * s for s in frame_s], "peak_mem_bytes": peak,
        "device": info, "attempted": len(images), "failed": failed, "numbers": numbers, "spans": {},
        "trace": profiled,
    }
    if traced:
        record["flops_per_frame"] = ref_view.count_frame_flops(config, seeds, picked[0], res, device)
    return record
