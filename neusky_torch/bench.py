"""The port's bench: counted rays/s of the joint NeuSky training step on one
CUDA card (counterpart of root ``bench.py``).

    python -m neusky_torch.bench [--trace]

It builds what ``bench.py:85-118`` builds: ``apply_env_knobs(
neusky_model_config(8, 2))`` with ``NEUSKY_BF16_MAPPING=1`` unless the
variable is set, bench's pipeline (8 × 128 vMF rays at κ = 20, 256 sky
rays), the synthetic scene (8 cameras, 64×64) with 8 × 128 rays a step from
the C++ sampler, seed-0 params with the converted prior and the five Adam
groups for 100,001 steps, and the fused step, captured as a CUDA graph
(``parallel/graphs.py``).  It takes 3 warm-up steps on one batch (the
first eager, the second captures the step, the third replays), one
discarded loop, then ``NEUSKY_BENCH_REPEATS`` loops of
``NEUSKY_BENCH_STEPS`` replayed steps on fresh batches, each loop ended by
``torch.cuda.synchronize()``, and prints one JSON line whose ``value`` is
the median loop's rays/s, the rays counted as ``Trainer`` counts them
(scene + DDF-fit + sky: 2,304 a step), with ``graphed`` and the capture's
wall time ``capture_s``.

Knobs (JAX's): ``NEUSKY_BENCH_NATIVE`` (default 1; 0, "" or false: the
numpy sampler), ``NEUSKY_BENCH_SPLIT`` (set: the split step),
``NEUSKY_BENCH_STEPS`` (36), ``NEUSKY_BENCH_REPEATS`` (3),
``NEUSKY_BENCH_VERBOSE`` (set: a synchronise and a stderr line each step),
``--trace`` (3 steps in one loop under ``torch.profiler``, a Chrome trace
under ``NEUSKY_TRACE_DIR``, default ``outputs/bench_trace``), and every
``NEUSKY_*`` model knob of ``configs/env_overrides.py``.

Runs on the card only: without one it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from neusky_torch.configs.env_overrides import apply_env_knobs, effective_summary, knob_summary
from neusky_torch.configs.neusky_config import neusky_model_config
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.device import resolve_device
from neusky_torch.engine.checkpoint import load_illumination_prior
from neusky_torch.engine.optimizers import GroupedAdam, default_neusky_optimizer_groups
from neusky_torch.engine.trainer import count_rays
from neusky_torch.models.neusky import NeuSkyModel, NeuSkyModelConfig
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.parallel.mesh import make_train_step, make_train_step_split
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

METRIC = "joint_train_rays_per_sec_per_chip"
WARMUP_STEPS = 3


def pipeline() -> PipelineConfig:
    """``bench.py:91-97``: 8 × 128 vMF rays at κ = 20, 256 sky rays."""
    return PipelineConfig(visibility_train_sampler=DDFSamplerConfig(
        num_samples_on_sphere=8, num_rays_per_sample=128, only_sample_upper_hemisphere=True, concentration=20.0),
        num_sky_rays=256)


def model_config() -> NeuSkyModelConfig:
    """The bench's model: ``neusky_model_config(8, 2)`` under the set
    ``NEUSKY_*`` knobs."""
    return apply_env_knobs(neusky_model_config(num_train_data=8, num_eval_data=2))


@dataclasses.dataclass
class Bench:
    """What :func:`build` returns: the step (``step(params, batch, step,
    generator=)`` → aux, the params updated in place) and all it runs on."""

    config: NeuSkyModelConfig
    model: NeuSkyModel
    pipeline: PipelineConfig
    datamanager: DataManager
    params: dict
    optimizer: GroupedAdam
    step: Callable
    generator: torch.Generator
    rays_per_step: int


def datamanager(device) -> DataManager:
    """``bench.py:99-111``: the synthetic scene (8 cameras, 64×64), 8 × 128
    rays and 256 sky rays a step, from the C++ sampler unless
    ``NEUSKY_BENCH_NATIVE`` is 0, "" or false."""
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=64, height=64))
    native = os.environ.get("NEUSKY_BENCH_NATIVE", "1") not in ("0", "", "false")
    return DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128),
                                         num_sky_rays=256, use_native_sampler=native),
                       scene["cameras"], scene["images"], scene["masks"], device=device)


def build(device="cuda", config: Optional[NeuSkyModelConfig] = None, graphed: Optional[bool] = None) -> Bench:
    """The bench's step and everything it runs on, as the module docstring
    says, on ``device`` (the card unless ``device="cpu"``), for ``config``
    (default :func:`model_config`).  The params are drawn from a generator
    seeded 0; the steps draw from one seeded 1.  ``graphed`` as
    ``make_train_step``'s (default: captured on the card)."""
    cfg = config or model_config()
    model = NeuSkyModel(cfg, device=device)
    pipe = pipeline()
    dm = datamanager(device)
    params = load_illumination_prior(model.init(torch.Generator(model.device).manual_seed(0)), cfg)
    optimizer = GroupedAdam(params, default_neusky_optimizer_groups(100001))
    make = make_train_step_split if os.environ.get("NEUSKY_BENCH_SPLIT", "") else make_train_step
    rays = count_rays(model, pipe, dm.next_train(0))
    return Bench(cfg, model, pipe, dm, params, optimizer, make(model, pipe, optimizer, graphed=graphed),
                 torch.Generator(model.device).manual_seed(1), rays)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_loops(b: Bench, n_steps: int, n_loops: int, n_discard: int, verbose: bool) -> list:
    """``n_discard`` + ``n_loops`` loops of ``n_steps`` steps on fresh
    batches, each ended by a synchronise → the rays/s of the kept loops."""
    rates, step_i = [], 0
    for rep in range(n_loops + n_discard):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            ts = time.perf_counter()
            batch = b.datamanager.next_train(step_i)
            tb = time.perf_counter()
            b.step(b.params, batch, float(step_i + 1), generator=b.generator)
            step_i += 1
            if verbose:
                torch.cuda.synchronize()
                print(f"step {step_i - 1}: batch {tb - ts:.3f}s  step {time.perf_counter() - tb:.3f}s",
                      file=sys.stderr)
        torch.cuda.synchronize()
        if rep >= n_discard:
            rates.append(b.rays_per_step * n_steps / (time.perf_counter() - t0))
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Counted rays/s of the joint training step on one CUDA card.")
    ap.add_argument("--trace", action="store_true", help="3 steps under torch.profiler; no throughput measurement")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")  # raises without a card
    os.environ.setdefault("NEUSKY_BF16_MAPPING", "1")  # bench.py:85
    b = build(device)
    chip = card_line()
    torch.cuda.reset_peak_memory_stats()
    batch = b.datamanager.next_train(0)
    for w in range(WARMUP_STEPS):
        aux = b.step(b.params, batch, float(w), generator=b.generator)
    torch.cuda.synchronize()
    del batch, aux

    trace_dir = os.environ.get("NEUSKY_TRACE_DIR", "outputs/bench_trace") if args.trace else None
    n_steps = 3 if trace_dir else int(os.environ.get("NEUSKY_BENCH_STEPS", "36"))
    n_repeats = 1 if trace_dir else int(os.environ.get("NEUSKY_BENCH_REPEATS", "3"))
    verbose = os.environ.get("NEUSKY_BENCH_VERBOSE", "") != ""
    load_before = os.getloadavg()[0]
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rates = timed_loops(b, n_steps, n_repeats, 0, verbose)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "bench_trace.json"))
        print(f"trace written to {trace_dir}", file=sys.stderr)
    else:
        rates = timed_loops(b, n_steps, n_repeats, 1, verbose)
    load_after = os.getloadavg()[0]

    rays_per_sec = sorted(rates)[len(rates) // 2]  # median loop rate
    mean = sum(rates) / len(rates)
    stddev = (sum((r - mean) ** 2 for r in rates) / len(rates)) ** 0.5
    out = {
        "metric": METRIC,
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "absolute_rays_per_sec": round(rays_per_sec, 1),
        "chip": chip,
        "loop_rates": [round(r, 1) for r in rates],
        "stddev": round(stddev, 1),
        "loadavg_before": round(load_before, 2),
        "loadavg_after": round(load_after, 2),
        "steps_per_loop": n_steps,
    }
    knobs = knob_summary()
    if knobs:
        out["knobs"] = knobs
    out["effective"] = effective_summary(b.config)
    # JAX's contamination rules: unstable loop rates or a loaded host mean
    # the value is not a throughput measurement of the card
    if len(rates) > 1 and stddev / max(mean, 1e-9) > 0.10:
        out["warning"] = (f"unstable: loop-rate stddev {stddev:.0f} is {100 * stddev / mean:.0f}% of mean — "
                          "host contention suspected")
    if load_before > 1.5:
        out["warning"] = f"contaminated: loadavg {load_before:.2f} before the bench — wall-clock rate unreliable"
    if trace_dir:
        out["traced"] = True
        out["warning"] = "PROFILER RUN — 3 steps under torch.profiler; value is NOT a throughput measurement"
    captured = getattr(b.step, "captured", None)
    out["graphed"] = captured is not None
    out["capture_s"] = captured.capture_s if captured is not None else None
    out["rays_per_step"] = b.rays_per_step
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
