"""The RENI++ prior-training window: ``RENITrainer``'s captured step, as
``neusky_torch/tools/train_reni_prior.py`` runs it.

Set-up builds the recipe the tool builds with its defaults (the decoder of
``prior_field_config(False)``, ``RENITrainerConfig`` from the tool's
arguments) with the traffic's pixels a step, refuses it unless it is the
configuration file's, makes the tool's Preetham-sky corpus
(``generate_sky_corpus``) and the trainer over its training skies, loads
the benchmark's weights and seeds the trainer's draws.  It then drives
``train_step`` through its first three steps (eager, captured, replayed),
which the reference follows, and one chunk of ``run`` to warm up and to
size the window.  The window is ``run`` over whole chunks of
``steps_per_call`` that fill ``--seconds`` at the warm-up's pace, ended by
a synchronise; a step's rays are its decoded pixels.

Traced, the program's tracing is on from before the trainer is built, its
tables are emptied before the window and read right after it
(``record["program"]``), and four steps after it run under the profiler."""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import time
from typing import Any, Dict

import torch

from benchmark import cfgjson, common, reni_counts, spans, trace
from benchmark.loops.train import _first_moments, _grads_from_moments, _host_params, _load_weights, _sync
from benchmark.reference import reni as ref_reni
from benchmark.reference import train as ref_train

FIRST_STEPS = 3  # the steps the reference follows
PROFILED_STEPS = 4


def program_recipe(config: Dict[str, Any], pixels_per_step: int, seed: int):
    """The ``RENITrainerConfig`` that ``train_reni_prior`` builds from the
    configuration file's ``tool_args`` (none: the tool's defaults), with
    ``pixels_per_step`` and ``seed``; raises unless the recipe, at the
    tool's own pixels a step and seed, and the tool's corpus are the
    file's."""
    from neusky_torch.engine.reni_trainer import RENITrainerConfig
    from neusky_torch.tools.train_reni_prior import parse_args, prior_field_config

    args = parse_args(list(config["tool_args"]))
    tcfg = RENITrainerConfig(
        field=prior_field_config(args.quick), lr=args.lr, latent_lr=args.latent_lr,
        kl_weight=1e-5 if args.autodecoder else args.kl_weight, variational=not args.autodecoder,
        num_steps=args.steps, pixels_per_step=args.pixels_per_step, steps_per_call=min(100, args.steps),
        seed=args.seed,
    )
    got = json.loads(json.dumps(cfgjson.encode(tcfg)))
    want = config["bundle"]["trainer_config"]
    if got != want:
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise ValueError(f"the program's RENI recipe differs from benchmark/configs/{config['name']}.json "
                         f"under {diff}")
    a = config["assumed"]
    if (args.num_skies, args.holdout, args.width, args.width // 2) != (
            a["train_images"], a["eval_images"], a["width"], a["height"]):
        raise ValueError("the tool's corpus differs from the configuration file's")
    return dataclasses.replace(tcfg, pixels_per_step=pixels_per_step, seed=seed)


def build(cell: Dict, config: Dict, seeds: common.Seeds, device):
    """(trainer, training skies) of the cell, with the benchmark's weights
    and seeds."""
    from neusky_torch.data.sky_generator import generate_sky_corpus
    from neusky_torch.engine.reni_trainer import RENITrainer

    tcfg = program_recipe(config, cell["traffic"]["pixels_per_step"], seeds.draws)
    common.note("imported the program")
    a = config["assumed"]
    corpus = generate_sky_corpus(a["train_images"] + a["eval_images"], width=a["width"], seed=seeds.scene)
    skies = corpus[:a["train_images"]]
    common.note(f"made the corpus: {corpus.shape[0]} skies of {a['height']} x {a['width']}")
    trainer = RENITrainer(tcfg, skies, device=device)
    _load_weights(trainer, ref_reni.make_params(config, skies.shape[0], seeds.weights, device))
    trainer.generator.manual_seed(seeds.draws)
    common.note("built the trainer")
    return trainer, skies


def _steps(trainer, n: int) -> None:
    """``n`` steps as a chunk of ``run`` makes them: the draws, then the
    steps."""
    for d in [trainer.draw() for _ in range(n)]:
        trainer.train_step(d)


def run(cell: Dict, config: Dict, seeds: common.Seeds, seconds: float, traced: bool, device) -> Dict[str, Any]:
    from neusky_torch.utils import profiling

    if traced:
        profiling.enable()
    trainer, skies = build(cell, config, seeds, device)
    p = cell["traffic"]["pixels_per_step"]
    program: Dict[str, Any] = {"losses": []}
    start, moments = _host_params(trainer), []
    for _ in range(FIRST_STEPS):
        out = trainer.train_step(trainer.draw())
        program["losses"].append(float(out["total"]))
        moments.append(_first_moments(trainer))
        common.note(f"step {len(moments)} (loss {program['losses'][-1]!r})")
    program["grads"] = _grads_from_moments(moments)
    program["params"] = (start, _host_params(trainer))
    del moments
    per_call = trainer.config.steps_per_call
    t0 = time.perf_counter()
    trainer.run(per_call)
    _sync(device)
    pace = (time.perf_counter() - t0) / per_call
    n_steps = per_call * max(1, math.ceil(seconds / (pace * per_call)))
    common.note(f"warm-up: {pace * 1e3:.3f} ms a step; the window runs {n_steps} steps")

    if traced:
        profiling.reset()
    history_from = len(trainer.history)
    window_start = time.time()
    p0 = time.perf_counter()
    trainer.run(n_steps)
    _sync(device)
    window_s = time.perf_counter() - p0
    snapshot = profiling.snapshot() if traced else None
    totals = [r["total"] for r in trainer.history[history_from:]]
    failed = n_steps if not totals or not all(math.isfinite(x) for x in totals) else 0
    common.note(f"window: {n_steps} steps in {window_s:.3f} s")

    recorder = spans.Recorder(enabled=traced)
    profiled = None
    if traced and device.type == "cuda":  # the CPU has no device trace
        recorder.wrap(trainer, "train_step")
        profiled = trace.profile(lambda: (_steps(trainer, PROFILED_STEPS), PROFILED_STEPS)[1], device,
                                 "bench.train_step")
        recorder.unwrap()
        common.note(f"profiled {PROFILED_STEPS} steps: {len(profiled.device)} device operations")
    if traced:
        profiling.enable(False)
    peak = int(torch.cuda.max_memory_reserved(device)) if device.type == "cuda" else 0
    info = common.device_info(device)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    reference = ref_reni.run_steps(config, skies, p, seeds, FIRST_STEPS, device)
    numbers = ref_reni.compare(program, reference)
    common.note("the reference's steps and the comparison")
    record = {
        "kind": "train", "window_start": window_start, "window_s": window_s, "steps": n_steps,
        "rays": n_steps * p, "rays_per_step": p, "peak_mem_bytes": peak, "device": info,
        "attempted": n_steps, "failed": failed, "numbers": numbers, "spans": recorder.durations,
        "trace": profiled, "leaf_norms": ref_train.leaf_norms(program, reference),
    }
    if traced:
        record["program"] = snapshot
        f = ref_reni.recipe(config)["field"]
        record["flops_per_step"] = reni_counts.step_flops(p, f.latent_dim, f.hidden_features, f.num_attention_heads,
                                                          f.num_attention_layers)
    return record
