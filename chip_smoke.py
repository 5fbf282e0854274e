"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is passed over):

1. the card (``torch.cuda.get_device_name``, ``nvidia-smi`` name and power
   limit); build every kernel from ``neusky_torch/csrc`` with ``nvcc``
   (``sm_90a``), all sources at once;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (K1: all levels of each of the joint
   step's seven differentiated hash-grid encodes, indices from
   ``_all_iw``), with CUDA-event timings of the kernel, the plain version
   and one library call, and the bound;
3. the port's training step on the card against the same step on the CPU
   (plain versions), on a small input: the scene step, then the joint step
   (DDF visibility, DDF fit, level-set loss; the canonical DDF at 5×256);
4. the scene path: the canonical configuration without the DDF half (1024
   rays, proposal (256, 96) → 48 samples, SDF hash 16 × 2 × 2^19, 2×256
   MLPs, RENI latent 100 with 6 attention layers, 492 light directions,
   the converted frozen prior) trained a few steps through ``Trainer``;
5. the main path: the canonical joint configuration
   (``neusky_model_config(8, 2)``, ``neusky_pipeline_config()``: the
   FiLM-SIREN DDF at 5×256 with bf16 FiLM inputs, DDF visibility of 1024
   rays × 254 upper-hemisphere directions in checkpointed chunks of 16,384
   queries, the level-set SDF at 64 of them a ray, 8 × 128 vMF DDF-fit rays
   rendered against the SDF, 256 sky rays) trained 4 steps through
   ``Trainer``.  In phases 4 and 5 each kernel's launch count is zeroed
   just before the path and read just after, and must be its launches per
   step (K1 once per differentiated encode: 4 scene, 7 joint) every step;
   one more step keeps the inputs K1 takes there, and K1 is held against
   its plain version and timed on them; one more step runs under
   ``torch.profiler`` (device time by kind);
6. the eval and checkpoint path at canonical width: the joint
   configuration with 2 eval slots, the train ring and an eval ring of 2
   cameras (π/8, height 0.5; 64×64), ``Trainer`` saving every 2 steps and
   evaluating every 4 (fit of both eval slots, render and scores) over 4
   steps; a fresh ``Trainer`` resumed from the step-4 checkpoint (params,
   Adam state and step bit for bit; the next step's losses to 1e-5); the
   250-step eval-latent fit (1,024 region rays a step; the loss falls) and
   the render of a 64×64 eval image in one chunk of 4,096 rays (DDF
   visibility over 4,096 × 254 queries), with PSNR, SSIM, LPIPS, rays/s,
   fps and the peak device memory; K1's count is zeroed before each part
   and must be 7 a training step and 0 in the fit and the render; 10 fit
   steps and one render run under ``torch.profiler``; then a small fit and
   render on the card against the CPU;
7. the command line, in process (``neusky_torch.cli.main``), on fixtures
   written by the port's own writers into a temporary directory: ``train
   neusky`` on a NeRF-OSR fixture (3 sessions; 3 train, 1 validation and 2
   test views each; 64×48; 9 images × 113 rays and 256 sky rays a step) for
   4 steps saving every 2, ``train neusky-synthetic`` on a Blender fixture
   (4 train and 2 validation views, 64×48) for 2 steps, then ``eval
   neusky`` (the 250-step latent fit cycling the 3 validation slots, the
   renders and scores of the 3 validation views) and ``render neusky``
   from the NeRF-OSR run's checkpoint; K1's count is zeroed before each
   command and read after it (and at each logged step): 7 a training step,
   0 in eval and render;
8. one JSON line listing every kernel (K1 per joint step, on the joint
   path's own inputs), the card line, and the final
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from neusky_torch.configs.neusky_config import neusky_model_config, neusky_pipeline_config
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine import metrics
from neusky_torch.engine.checkpoint import load_illumination_prior, prior_asset_path
from neusky_torch.engine.eval_loop import (
    average_eval_metrics, eval_image_metrics, fit_eval_latents, make_render_chunk_fn, render_camera,
)
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.models.neusky import NeuSkyModel, visibility_query_directions
from neusky_torch.models.pipeline import draw_ddf_fit, train_loss_fn
from neusky_torch.ops import hashgrid, hashgrid_cuda as k1
from neusky_torch.ops.hashgrid import HashGridEncoding
from neusky_torch.sampling.illumination import IcosahedronSampler
from neusky_torch.tree import tree_items, tree_map

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
STEPS = 4  # joint path
SCENE_STEPS = 3
# ~10 ms at the H100's clock: longer than the host takes to queue one
# timing loop's calls
HOLD_CYCLES = 20_000_000


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what) -> None:
    """An assertion that ``python -O`` keeps."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build


KERNEL_BUILDS = {k1.KERNEL_NAME: k1.build}


def build_all():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_BUILDS)) as ex:
        futs = {name: ex.submit(fn, True) for name, fn in KERNEL_BUILDS.items()}
        results = {name: f.result() for name, f in futs.items()}
    secs = time.perf_counter() - t0
    for name, (path, msgs) in results.items():
        log(f"built {name}: {path.name}")
        for line in msgs.strip().splitlines():
            log(f"  ptxas: {line.strip()}")
    log(f"build seconds: {secs:.2f}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def time_ms(fn, iters: int = 20, warmup: int = 3, hold_card: bool = True) -> float:
    """CUDA-event time of one call.  With ``hold_card`` a sleep kernel keeps
    the card busy while the host queues all ``iters`` calls, so the events
    time the card's work alone; without it they time back-to-back calls as
    the host issues them (its dispatch cost included when that is longer)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold_card:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound_ms(levels: int, m: int, t: int):
    """Least time for the function: read idx (4 B) and two fp32 values per
    update, write the L×2T fp32 output once; 2 fp32 adds per update."""
    bytes_ms = (12.0 * levels * m + 8.0 * levels * t) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * levels * m / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _rows_per_point(stochastic: bool) -> int:
    """Rows an encode scatters per point and level: one sampled corner with
    a stochastic table gradient, all eight corners with the exact one."""
    return 1 if stochastic else 8


def k1_sites(model_cfg, pipeline_cfg, n_rays: int):
    """The main path's K1 call sites, one launch per hash-grid encode that
    a loss differentiates: (name, hash config, points, rows per point).
    Scene: each proposal field, the SDF ``field_outputs``, the density-grid
    SDF.  With the DDF fit: the SDF of the ground-truth pass over the vMF
    rays and the DDF-fit SDF query at the predicted termination points
    (exact).  With DDF visibility: the level-set SDF query at the strided
    subset of termination points.  The ground-truth pass's proposal
    encodes feed only the resampling, which no gradient passes, and the
    canonical DDF (NeRF encodings) calls no hash grid."""
    prop = model_cfg.proposal
    sh = model_cfg.sdf_field.hash
    sdf_rows = _rows_per_point(model_cfg.sdf_field.stochastic_table_grads)
    sites = [(f"proposal_field_{i}", pf.hash, n_rays * prop.num_proposal_samples[i],
              _rows_per_point(pf.stochastic_table_grad))
             for i, pf in enumerate(model_cfg.proposal_fields)]
    sites.append(("sdf_field_outputs", sh, n_rays * prop.num_final_samples, sdf_rows))
    if model_cfg.losses.hashgrid_density:
        sites.append(("density_grid_sdf", sh, model_cfg.losses.hashgrid_density_grid_resolution ** 3, sdf_rows))
    if model_cfg.ddf is None:
        return sites
    if model_cfg.use_visibility and model_cfg.losses.sdf_level_set_visibility:
        d = visibility_query_directions(
            model_cfg, IcosahedronSampler(model_cfg.num_illumination_directions).actual_num_directions)
        sub = model_cfg.sdf_level_set_subset
        sites.append(("level_set_sdf", sh, n_rays * (sub if sub and sub < d else d), sdf_rows))
    if model_cfg.fit_visibility_field:
        s = pipeline_cfg.visibility_train_sampler
        n_vmf = s.num_samples_on_sphere * s.num_rays_per_sample
        sites.append(("ddf_gt_sdf_field_outputs", sh, n_vmf * prop.num_final_samples, sdf_rows))
        sites.append(("ddf_fit_sdf", sh, n_vmf, 8))
    return sites


def k1_cases(model_cfg, pipeline_cfg, n_rays: int):
    """(name, hash config, points, rows per point, launches per step): the
    sites, then two L = 1 cases: the SDF's dense level 0 taking heavy
    duplicates, and the row-major layout with M not a multiple of the
    block."""
    sites = [site + (1,) for site in k1_sites(model_cfg, pipeline_cfg, n_rays)]
    sh = model_cfg.sdf_field.hash
    prop = model_cfg.proposal
    extra = [("sdf_dense_level0_heavy_duplicates", sh, n_rays * prop.num_final_samples, 1, 0),
             ("row_major_odd_m", model_cfg.proposal_fields[0].hash, n_rays * prop.num_proposal_samples[0] + 77, 1, 0)]
    return sites + extra


def k1_inputs(name, hash_cfg, n, rows_per_point, g):
    """(rows [L, M], vals [L, 2, M], T) on the card.  A site's rows come
    from ``_all_iw`` on random positions: all eight corners per point for
    an exact encode, one random corner per (level, point) for a stochastic
    one, so the dense levels see their real number of rows (the main
    path's ray order is not reproduced: the captured main-path inputs of
    phase 5 carry it)."""
    t = hash_cfg.table_size
    if name == "sdf_dense_level0_heavy_duplicates":
        r0 = hash_cfg.base_res
        rows = torch.randint(0, (r0 + 1) ** 3, (1, n), generator=g, device="cuda", dtype=torch.int32)
    elif name == "row_major_odd_m":
        rows = torch.randint(0, t, (1, n), generator=g, device="cuda", dtype=torch.int32)
    else:
        x = torch.rand((3, n), generator=g, device="cuda")
        idx, _, _ = HashGridEncoding(hash_cfg)._all_iw(x, need_dw=False)
        if rows_per_point == 8:
            rows = idx.reshape(hash_cfg.num_levels, -1).contiguous()
        else:
            c = torch.randint(0, 8, (hash_cfg.num_levels, 1, n), generator=g, device="cuda")
            rows = torch.gather(idx, 1, c)[:, 0].contiguous()
    vals = torch.randn((rows.shape[0], 2, rows.shape[1]), generator=g, device="cuda")
    return rows, vals, t


def measure_k1(name, rows, vals, t, per_step, row_major=False):
    """K1 on one input against its plain version, then CUDA-event times of
    K1, the plain version and one ``index_add_`` on the flat output."""
    levels = rows.shape[0]
    if row_major:
        idx, upd = rows[0], vals[0].t().contiguous()  # [M], [M, 2]
        kern = lambda: k1.scatter_add_tablegrad(idx, upd, t)
        plain = lambda: k1.scatter_add_plain(idx, upd, t)
        flat = (idx.long()[:, None] * 2 + torch.arange(2, device="cuda")).reshape(-1)
        lib_vals = upd.reshape(-1)
    else:
        kern = lambda: k1.scatter_levels(rows, vals, t)
        plain = lambda: k1.scatter_levels_plain(rows, vals, t)
        flat = ((torch.arange(levels * 2, device="cuda").reshape(levels, 2, 1) * t)
                + rows.long()[:, None, :]).reshape(-1)
        lib_vals = vals.reshape(-1)
    library = lambda: torch.zeros(levels * 2 * t, device="cuda").index_add_(0, flat, lib_vals)
    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    # atomics and the warp's run sums reorder each row's sum: tolerance 1e-4
    # (the Pallas test's) up to 64 updates a row, growing linearly beyond
    m = rows.shape[1]
    max_dup = max(int(torch.bincount(rows[l].long(), minlength=t).max()) for l in range(levels))
    atol = 1e-4 * max(1.0, max_dup / 64.0)
    err = float((out - ref).abs().max())
    if not (math.isfinite(err) and err <= atol):
        raise AssertionError(f"K1 {name}: max |kernel - plain| = {err} > {atol}")
    bound, by = k1_bound_ms(levels, m, t)
    row = dict(case=name, L=levels, M=m, T=t, layout="[M,2]->[T,2]" if row_major else "[L,2,M]->[L,2,T]",
               launches_per_step=per_step, max_dup=max_dup, max_abs_err=err, atol=atol,
               ms=time_ms(kern), plain_ms=time_ms(plain), library_ms=time_ms(library),
               bound_ms=bound, bound_by=by, call_ms=time_ms(kern, hold_card=False))
    log("k1 case " + json.dumps(row))
    return row


def check_k1(model_cfg, pipeline_cfg, n_rays: int):
    g = torch.Generator(device="cuda").manual_seed(0)
    return [measure_k1(name, *k1_inputs(name, hash_cfg, n, rpp, g), per_step, row_major=name == "row_major_odd_m")
            for name, hash_cfg, n, rpp, per_step in k1_cases(model_cfg, pipeline_cfg, n_rays)]


def capture_k1_inputs(trainer):
    """One more training step with the encodes' scatter dispatch wrapped, to
    keep what K1 takes on the main path: [(rows, vals, T)], call order."""
    seen = []
    dispatch = hashgrid.scatter_levels

    def keep(rows, vals, t):
        seen.append((rows.clone(), vals.contiguous().clone(), t))
        return dispatch(rows, vals, t)

    hashgrid.scatter_levels = keep
    try:
        trainer.run(1)
        torch.cuda.synchronize()
    finally:
        hashgrid.scatter_levels = dispatch
    return seen


def check_k1_main_path_inputs(model_cfg, pipeline_cfg, n_rays: int, captured):
    """K1 against its plain version and timed on the inputs one main-path
    step gave it (ray-ordered samples: runs of equal coarse rows).  Sites
    of one shape (the scene's and the ground-truth pass's SDF
    ``field_outputs``, 1,024 rays × 48 samples each) cannot be told apart
    by their inputs and share a name."""
    names = {}
    for name, h, n, rpp in k1_sites(model_cfg, pipeline_cfg, n_rays):
        key = (h.num_levels, n * rpp)
        names[key] = f"{names[key]}|{name}" if key in names else name
    want = sorted((h.num_levels, n * rpp) for _, h, n, rpp in k1_sites(model_cfg, pipeline_cfg, n_rays))
    got = sorted((r.shape[0], r.shape[1]) for r, _, _ in captured)
    check(want == got, f"captured K1 inputs {got} are not the sites {want}")
    return [measure_k1(names[tuple(rows.shape)] + "/main_path", rows, vals, t, 1) for rows, vals, t in captured]


# ---------------------------------------------------------------------------
# the configuration


def scene_config(**kw):
    cfg = neusky_model_config(8, 2, **kw)
    return dataclasses.replace(
        cfg, ddf=None, use_visibility=False, fit_visibility_field=False,
        losses=dataclasses.replace(cfg.losses, sdf_level_set_visibility=False),
    )


def expected_launches_per_step(cfg, pipeline_cfg) -> int:
    """K1 launches once per differentiated hash-grid encode
    (:func:`k1_sites`): 4 a scene step, 7 a joint step."""
    return len(k1_sites(cfg, pipeline_cfg, 1))


# ---------------------------------------------------------------------------
# phase 3: the step on the card against the same step on the CPU


def _to(x, dev):
    """Draws (nested dicts, lists and tuples of tensors) → ``dev``."""
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x.to(dev)


def small_configs(joint: bool):
    """Canonical widths on a small input: 2 images, a 2^16 SDF table so the
    CPU side stays quick; the joint one with a 2 × 16 vMF DDF-fit batch."""
    cfg = neusky_model_config(2, 1) if joint else scene_config()
    sdf_hash = dataclasses.replace(cfg.sdf_field.hash, log2_hashmap_size=16)
    cfg = dataclasses.replace(cfg, sdf_field=dataclasses.replace(cfg.sdf_field, hash=sdf_hash), num_train_data=2)
    pcfg = neusky_pipeline_config(visibility_train_sampler=dataclasses.replace(
        neusky_pipeline_config().visibility_train_sampler, num_samples_on_sphere=2, num_rays_per_sample=16))
    return cfg, pcfg


def check_step_cuda_vs_cpu(joint: bool):
    """The same params, batch and draws through train_loss_fn on the card
    (K1) and on the CPU (plain scatter), 2 images × 16 rays.  Losses must
    agree to 1e-4 relative and every gradient array to 2e-3 of its largest
    entry (fp32 with other reduction orders and atomics); the DDF's to 5e-3
    (its bf16-rounded FiLM inputs may round to the neighbouring bf16 value
    where the card's and the CPU's float32 sums differ in the last bits)."""
    cfg, pcfg = small_configs(joint)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    out = {}
    cpu_model = NeuSkyModel(cfg, device="cpu")
    params0 = cpu_model.init(torch.Generator().manual_seed(3))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    batch = dm.next_train(0)
    gen = torch.Generator().manual_seed(4)
    draws = cpu_model.draw(None, gen, batch["pixel_coords"].shape[0])
    if joint:
        draws["ddf"] = draw_ddf_fit(cpu_model, pcfg, None, gen)
    expected = expected_launches_per_step(cfg, pcfg)
    for dev in ("cpu", "cuda"):
        model = NeuSkyModel(cfg, device=dev)
        params = tree_map(lambda x: x.detach().clone().to(dev), params0)
        for k, v in tree_items(params):
            if k.split("/")[0] not in ("eval_latents", "illumination_decoder"):
                v.requires_grad_(True)
        b = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in batch.items()}
        b["cameras"] = batch["cameras"].to(dev)
        before = k1.launches[k1.KERNEL_NAME]
        total, aux = train_loss_fn(model, pcfg, params, b, 10.0, _to(draws, dev))
        total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            n = k1.launches[k1.KERNEL_NAME] - before
            check(n == expected, f"K1 launches on the card: {n}, expected {expected}")
        out[dev] = (float(total.detach()), {k: float(v.detach()) for k, v in aux["loss_dict"].items()},
                    {k: v.grad.detach().cpu() for k, v in tree_items(params) if v.grad is not None})
    (tc, lc, gc), (tg, lg, gg) = out["cpu"], out["cuda"]
    bad = []
    if not (math.isfinite(tg) and abs(tg - tc) <= 1e-4 * abs(tc)):
        bad.append(("total", tg, tc))
    bad += [(k, lg[k], lc[k]) for k in lc if not abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) + 1e-7]
    worst = {}
    for k in gc:
        scale = float(gc[k].abs().max())
        if scale == 0:
            continue
        rel = float((gg[k] - gc[k]).abs().max()) / scale
        group = k.split("/")[0]
        worst[group] = max(worst.get(group, 0.0), rel)
        if rel > (5e-3 if group == "ddf_field" else 2e-3):
            bad.append((k, rel))
    label = "joint" if joint else "scene"
    log(f"{label} step on the card vs the CPU: total {tg:.6f} vs {tc:.6f}; K1 launches {expected}; "
        f"worst grad rel err by group " + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    check(not bad, f"{label} step on the card differs from the CPU: {bad}")


# ---------------------------------------------------------------------------
# phases 4 and 5: the scene path and the main (joint) path


def run_path(label: str, cfg, pcfg, steps: int, card: str, require_groups=()):
    """``steps`` training steps of ``cfg`` through ``Trainer`` on the
    synthetic scene (8 cameras, 64×64; 8 images × 128 rays, 256 sky rays),
    K1's count zeroed before and read after, then one step keeping K1's
    inputs and one profiled step."""
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=64, height=64))
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128),
                          num_sky_rays=256),
        scene["cameras"], scene["images"], scene["masks"], device="cuda",
    )
    model = NeuSkyModel(cfg, device="cuda")
    trainer = Trainer(TrainerConfig(max_num_iterations=100001, steps_per_log=1, seed=0),
                      model, pcfg, dm, device="cuda")
    prior_file = np.load(prior_asset_path(cfg))
    q = prior_file["illumination_decoder/params/decoder/block_0/MultiHeadDotProductAttention_0/query/kernel"]
    got = trainer.params["illumination_decoder"]["params"]["decoder"]["block_0"]["MultiHeadDotProductAttention_0"]["query"]["kernel"]
    check(np.array_equal(got.cpu().numpy(), q), "the frozen prior was not loaded")
    start = {k: v.detach().clone() for k, v in tree_items(trainer.params)}
    n_rays = 8 * 128
    n_counted = trainer._count_rays(dm.next_train(0))
    expected = expected_launches_per_step(cfg, pcfg)
    log(f"{label} path: {n_rays} scene rays/step ({n_counted} counted by the trainer), "
        f"{model.num_directions} light directions, expecting {expected} K1 launches/step")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches[k1.KERNEL_NAME] = 0
    times, per_step = [], []
    for s in range(steps):
        before = k1.launches[k1.KERNEL_NAME]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = trainer.run(1)[-1]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_step.append(k1.launches[k1.KERNEL_NAME] - before)
        losses = {k: v for k, v in rec.items() if k.endswith("_loss") or k == "ddf_depth_psnr"}
        log(f"{label} step {s}: {dt * 1e3:.1f} ms, {n_rays / dt:.1f} scene rays/s, {n_counted / dt:.1f} "
            f"counted rays/s ({card}); K1 launches {per_step[-1]}; " + json.dumps(losses))
        for k, v in rec.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{label} step {s}: {k} = {v}")
        times.append(dt)
    launches = k1.launches[k1.KERNEL_NAME]
    check(per_step == [expected] * steps, f"{label}: K1 launches per step {per_step}, expected {expected}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = float(np.mean(times[1:]))
    log(f"{label} peak device memory: {peak:.2f} GiB")
    log(f"{label} steady step (mean of steps 1..{steps - 1}): {steady * 1e3:.1f} ms, "
        f"{n_rays / steady:.1f} scene rays/s, {n_counted / steady:.1f} counted rays/s ({card})")

    end = dict(tree_items(trainer.params))
    changed = [g for g in trainer.optimizer.group_names
               if any(not torch.equal(start[k], v.detach()) for k, v in end.items()
                      if k.split("/")[0].startswith(g) and v.requires_grad)]
    check(changed == trainer.optimizer.group_names and set(require_groups) <= set(changed),
          f"{label}: trainable groups changed in {steps} steps: {changed} of {trainer.optimizer.group_names}")
    for k, v in end.items():
        check(not k.startswith("illumination_decoder/") or torch.equal(start[k], v), f"frozen {k} changed")
    log(f"{label} trainable groups changed: " + ", ".join(changed) + "; the decoder stayed frozen")
    captured = capture_k1_inputs(trainer)
    profile_call(lambda: trainer.run(1), steady, card, f"{label} step")
    return launches, captured


# device-op name fragments → kind, first match wins
KERNEL_KINDS = (
    ("K1", ("scatter_levels_kernel",)),
    ("matmul", ("gemm", "gemv", "Kernel2", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("sin/cos (SIREN)", ("sin_kernel", "cos_kernel")),
    ("gather/scatter", ("index", "gather", "scatter")),
    ("reduce/scan/sort", ("reduce", "scan", "cumsum", "cumprod", "sort", "softmax")),
    ("copy/fill", ("copy", "fill", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "Functor")),
)


def profile_call(fn, wall_s: float, card: str, label: str, top: int = 15):
    """``fn()`` once more under ``torch.profiler``: device time by kernel
    name, its sum against ``wall_s`` (the unprofiled wall time of the same
    work), and K1's share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, longest = {}, {}
    for e in prof.events():
        # device-side user annotations (the optimizer's range) are spans
        # over kernels, not work of their own
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
            longest[e.name] = max(longest.get(e.name, 0.0), e.time_range.elapsed_us())
    if not by_name:
        log(f"{label} profile: the profiler saw no device events; device time not measured")
        return
    device_ms = sum(us for _, us in by_name.values()) / 1e3
    n_kernels = sum(n for n, _ in by_name.values())
    k1_ms = sum(us for name, (_, us) in by_name.items() if "scatter_levels_kernel" in name) / 1e3
    # autograd's stack of per-level table gradients was a 64 MiB
    # CatArrayBatchedCopy (~40 us) at each SDF encode
    cat = [name for name in by_name if "CatArrayBatchedCopy" in name]
    cat_n, cat_us = sum(by_name[k][0] for k in cat), sum(by_name[k][1] for k in cat)
    cat_max = max((longest[k] for k in cat), default=0.0)
    log(f"{label} profile ({card}): device busy {device_ms:.3f} ms of the {wall_s * 1e3:.3f} ms unprofiled wall time "
        f"({device_ms / (wall_s * 1e3):.3f}); {n_kernels} device ops under {len(by_name)} names; "
        f"K1 {k1_ms:.3f} ms; CatArrayBatchedCopy {cat_us / 1e3:.3f} ms ({cat_n}x, longest {cat_max:.1f} us)")
    by_kind = {}
    for name, (n, us) in by_name.items():
        kind = next((k for k, keys in KERNEL_KINDS if any(s in name for s in keys)), "other")
        c, t = by_kind.get(kind, (0, 0.0))
        by_kind[kind] = (c + n, t + us)
    log("  by kind: " + "; ".join(f"{k} {us / 1e3:.3f} ms ({n}x)"
                                  for k, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1])))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {us / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")


# ---------------------------------------------------------------------------
# phase 6: the eval and checkpoint path


EVAL_RING = dict(angle_offset=math.pi / 8.0, camera_height=0.5)  # tools/train_sanity.py's eval split
EVAL_FIT_STEPS = 250


def eval_datamanager(device, train_cams=8, eval_cams=2, px=64, rays=(8, 128), sky=256):
    """The synthetic train ring and the eval ring, ``rays`` = (images per
    batch, rays per image): a fit step takes their product in region rays."""
    ts = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=train_cams, width=px, height=px))
    es = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=eval_cams, width=px, height=px, **EVAL_RING))
    return DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(*rays), num_sky_rays=sky),
                       ts["cameras"], ts["images"], ts["masks"], eval_cameras=es["cameras"],
                       eval_images=es["images"], eval_masks=es["masks"], device=device)


def k1_launches() -> int:
    return k1.launches[k1.KERNEL_NAME]


def measured(fn):
    """(fn(), seconds, peak device GiB) with the card idle before and after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _equal_state(a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_state(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    return a == b


def train_save_resume(cfg, pcfg, out_dir: str, card: str, expected: int) -> Trainer:
    """4 steps saving every 2 and evaluating at 4, then a resumed trainer
    against the original on one more step."""
    make = lambda d: Trainer(TrainerConfig(max_num_iterations=100001, steps_per_log=1, steps_per_save=2,
                                           steps_per_eval_image=4, output_dir=d, seed=0),
                             NeuSkyModel(cfg, device="cuda"), pcfg, eval_datamanager("cuda"), device="cuda")
    trainer = make(out_dir)
    k1.launches[k1.KERNEL_NAME] = 0
    per_step = []
    for s in range(4):
        before = k1_launches()
        hist, dt, _ = measured(lambda: trainer.run(1))
        rec = next(r for r in reversed(hist) if "total_loss" in r)
        per_step.append(k1_launches() - before)
        log(f"eval path train step {s + 1}: {dt * 1e3:.1f} ms ({card}); K1 launches {per_step[-1]}; "
            f"total loss {rec['total_loss']:.6f}" + ("; with the eval pass" if s == 3 else ""))
    check(per_step == [expected] * 4, f"eval path: K1 launches per step {per_step}, expected {expected}")
    saved = sorted(p.name for p in (Path(out_dir) / "checkpoints").iterdir())
    check(saved == ["step-000000002", "step-000000004"], f"checkpoints written: {saved}")
    evals = [r for r in trainer.history if "eval_psnr" in r]
    check(len(evals) == 1 and evals[0]["step"] == 4 and all(math.isfinite(v) for v in evals[0].values()),
          f"eval records: {evals}")
    log(f"eval pass at step 4 ({card}): " + json.dumps(evals[0]))

    resumed = make(str(Path(out_dir) / "resumed"))
    resumed.load(out_dir, 4)
    orig, back = dict(tree_items(trainer.params)), dict(tree_items(resumed.params))
    check(resumed.step == 4 and all(torch.equal(back[k], v) for k, v in orig.items()),
          "resumed params differ from the saved ones")
    check(_equal_state(resumed.optimizer.state_dict(), trainer.optimizer.state_dict()),
          "resumed Adam state differs from the saved one")
    trainer.datamanager.reseed(4)
    resumed.generator.set_state(trainer.generator.get_state())
    k1.launches[k1.KERNEL_NAME] = 0
    a = trainer.run(1)[-1]
    n_a = k1_launches()
    b = resumed.run(1)[-1]
    n_b = k1_launches() - n_a
    check(n_a == n_b == expected, f"K1 launches on the step after the resume: {n_a}, {n_b}")
    losses = [k for k in a if k.endswith("_loss")]
    worst = max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-12) for k in losses)
    check(worst <= 1e-5, f"resumed step's losses differ by {worst:.3g} relative")
    with torch.no_grad():
        drift = max(float((back[k] - v).abs().max()) for k, v in tree_items(trainer.params))
    log(f"checkpoint round trip: params ({len(orig)} leaves), Adam state and step bit for bit; step 5: "
        f"total loss {a['total_loss']:.6f} vs resumed {b['total_loss']:.6f}, worst loss rel diff {worst:.3g}, "
        f"worst param diff after the update {drift:.3g}; K1 launches {n_a} and {n_b}")
    return trainer


def run_eval_path(card: str):
    """Phase 6: see the module docstring."""
    cfg, pcfg = neusky_model_config(8, 2), neusky_pipeline_config()
    expected = expected_launches_per_step(cfg, pcfg)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = train_save_resume(cfg, pcfg, out_dir, card, expected)
    model, params, dm = trainer.model, trainer.params, trainer.datamanager
    rays = dm.config.pixel_sampler.images_per_batch * dm.config.pixel_sampler.rays_per_image
    resident = torch.cuda.memory_allocated() / 2**30

    k1.launches[k1.KERNEL_NAME] = 0
    (fit_params, losses), fit_s, fit_peak = measured(lambda: fit_eval_latents(model, params, dm, steps=EVAL_FIT_STEPS))
    (_, short), short_s, _ = measured(lambda: fit_eval_latents(model, params, dm, steps=50))
    fit_launches = k1_launches()
    check(fit_launches == 0, f"K1 launched {fit_launches} times in the eval-latent fit")
    # each step draws a new batch: compare the means of the first and last 25
    check(all(math.isfinite(x) for x in losses) and np.mean(losses[-25:]) < np.mean(losses[:25]),
          f"the fit loss does not fall: {losses[:3]} … {losses[-3:]}")
    steady_ms = (fit_s - short_s) / (EVAL_FIT_STEPS - 50) * 1e3
    log(f"eval fit ({card}): {EVAL_FIT_STEPS} steps of {rays} region rays in {fit_s:.3f} s, steady "
        f"{steady_ms:.3f} ms/step (from the 50-step fit's {short_s:.3f} s); loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (mean of the first/last 25: {np.mean(losses[:25]):.6f} / {np.mean(losses[-25:]):.6f}); "
        f"peak device memory {fit_peak:.3f} GiB ({resident:.3f} GiB resident before); K1 launches {fit_launches}")

    chunk_fn, chunk = make_render_chunk_fn(model, 4096)
    k1.launches[k1.KERNEL_NAME] = 0
    m, _, render_peak = measured(lambda: eval_image_metrics(model, fit_params, dm, 0, chunk_fn, chunk))
    avg = average_eval_metrics(model, fit_params, dm, chunk_size=4096, fit_latents_first=False)
    render_launches = k1_launches()
    check(render_launches == 0, f"K1 launched {render_launches} times in the render")
    out = m.pop("outputs")
    h = dm.eval_cameras.height * dm.eval_cameras.width
    for k, c in (("rgb", 3), ("depth", 1), ("accumulation", 1), ("normal", 3), ("albedo", 3)):
        check(out[k].shape == (h, c) and np.isfinite(out[k]).all(), f"render {k}: {out[k].shape}")
    check(out["rgb"].min() >= 0 and out["rgb"].max() <= 1 and out["accumulation"].min() >= 0
          and out["accumulation"].max() <= 1 + 1e-5, "render rgb or accumulation out of [0, 1]")
    check(all(math.isfinite(v) for v in list(m.values()) + list(avg.values())), f"eval metrics {m} {avg}")
    d = visibility_query_directions(cfg, model.num_directions)
    log(f"eval render ({card}): {h} rays in one chunk of {chunk}, DDF visibility over {h} × {d} = {h * d:,} "
        f"queries; image 0: PSNR {m['psnr']:.4f}, SSIM {m['ssim']:.4f}, LPIPS {m['lpips']:.4f} "
        f"({metrics.lpips_flavour()}), MSE {m['mse']:.6f}, {m['num_rays_per_sec']:.1f} rays/s, {m['fps']:.3f} fps; "
        f"peak device memory {render_peak:.3f} GiB; K1 launches {render_launches}")
    log(f"average_eval_metrics over {dm.num_eval} eval images ({card}): " + json.dumps(avg))

    # where the time goes: 10 fit steps and one render, unprofiled then profiled
    fit10 = lambda: fit_eval_latents(model, params, dm, steps=10)
    _, fit10_s, _ = measured(fit10)
    profile_call(fit10, fit10_s, card, "eval fit (10 steps)", top=8)
    rb = dm.eval_image_bundle(0)[0]
    render = lambda: render_camera(model, fit_params, rb, 0, chunk_fn, chunk)
    _, render_s, _ = measured(render)
    profile_call(render, render_s, card, "eval render (4,096 rays)", top=8)
    del trainer, model, params, fit_params


def check_eval_cuda_vs_cpu(card: str):
    """5 fit steps and the render of a 16×16 eval image from the same
    params and batches on the card and on the CPU (plain versions): the
    eval latents to 1e-4 of scale, ``rgb``, ``depth`` and ``accumulation``
    to 1e-4, the metrics to 1e-4 relative.  The card half runs with
    cuDNN's TF32 on (PyTorch's default), which LPIPS must ignore."""
    cfg, _ = small_configs(joint=True)
    cfg = dataclasses.replace(cfg, num_eval_data=2)
    params0 = load_illumination_prior(NeuSkyModel(cfg, device="cpu").init(torch.Generator().manual_seed(3)), cfg)
    got = {}
    for dev in ("cpu", "cuda"):
        model = NeuSkyModel(cfg, device=dev)
        params = tree_map(lambda x: x.detach().clone().to(dev), params0)
        dm = eval_datamanager(dev, train_cams=2, px=16, rays=(2, 16), sky=8)
        torch.backends.cudnn.allow_tf32 = dev == "cuda"
        try:
            fit, losses = fit_eval_latents(model, params, dm, steps=5)
            m = eval_image_metrics(model, fit, dm, 0)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        got[dev] = ({k: v.detach().cpu() for k, v in fit["eval_latents"].items()}, losses, m)
    (lat_c, loss_c, m_c), (lat_g, loss_g, m_g) = got["cpu"], got["cuda"]
    lat_err = max(float((lat_g[k] - lat_c[k]).abs().max() / lat_c[k].abs().max()) for k in ("eval_latents", "eval_scale"))
    map_err = {k: float(np.abs(m_g["outputs"][k] - m_c["outputs"][k]).max()) for k in ("rgb", "depth", "accumulation")}
    met_err = {k: abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-12) for k in ("psnr", "ssim", "mse", "lpips")}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c))
    log(f"small eval on the card vs the CPU ({card}): eval latents {lat_err:.3g} of scale, fit losses {loss_err:.3g} "
        f"relative, maps " + json.dumps({k: float(f"{v:.3g}") for k, v in map_err.items()})
        + ", metrics " + json.dumps({k: float(f"{v:.3g}") for k, v in met_err.items()}))
    check(lat_err <= 1e-4 and loss_err <= 1e-4 and max(map_err.values()) <= 1e-4 and max(met_err.values()) <= 1e-4,
          "the eval path on the card differs from the CPU")


# ---------------------------------------------------------------------------
# phase 7: the command line


CLI_NERFOSR = dict(num_sessions=3, train_per_session=3, test_per_session=2, width=64, height=48)
CLI_BLENDER = dict(num_train=4, num_val=2, width=64, height=48)
CLI_STEPS = 4


def cli_train(argv, expected: int, steps: int, card: str):
    """``cli.main(argv)`` (a ``train``, every step logged): K1's count
    zeroed before and read at each logged step and after; → (host time
    of each log line, the log records, peak device GiB)."""
    from neusky_torch import cli

    stamps, records = [], []
    printer = cli.print_record

    def keep(record):  # the log line reads the loss, which waits for the card
        stamps.append((time.perf_counter(), k1_launches()))
        records.append(record)
        printer(record)

    cli.print_record = keep
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches[k1.KERNEL_NAME] = 0
        t0 = time.perf_counter()
        cli.main(argv + ["--trainer.steps_per_log", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cli.print_record = printer
    per_step = [n - (stamps[i - 1][1] if i else 0) for i, (_, n) in enumerate(stamps)]
    check(per_step == [expected] * steps and k1_launches() == expected * steps,
          f"cli {argv[1]}: K1 launches per step {per_step} ({k1_launches()} in all), expected {expected}")
    bad = [(r["step"], k, v) for r in records for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)]
    check(len(records) == steps and not bad, f"cli {argv[1]}: {len(records)} log lines, non-finite {bad}")
    log(f"cli train {argv[1]} ({card}): {steps} steps in {wall:.3f} s (model, data and prior set-up included); "
        f"K1 launches per step {per_step}")
    return [t for t, _ in stamps], records, torch.cuda.max_memory_allocated() / 2**30


def run_cli_path(card: str):
    """Phase 7: see the module docstring."""
    from neusky_torch import cli
    from neusky_torch.data.fixtures import make_blender_fixture, make_nerfosr_fixture

    cfg, pcfg = neusky_model_config(9, 3), neusky_pipeline_config()
    expected = expected_launches_per_step(cfg, pcfg)
    n_train = CLI_NERFOSR["num_sessions"] * CLI_NERFOSR["train_per_session"]
    u = min(16, n_train)
    n_scene = u * (1024 // u)  # cli train's default --rays-per-batch
    s = pcfg.visibility_train_sampler
    n_counted = n_scene + s.num_samples_on_sphere * s.num_rays_per_sample + DataManagerConfig().num_sky_rays
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        osr = make_nerfosr_fixture(tmp / "nerfosr", **CLI_NERFOSR)
        blender = make_blender_fixture(tmp / "blender", **CLI_BLENDER)
        log(f"cli fixtures written in {time.perf_counter() - t0:.3f} s: NeRF-OSR {CLI_NERFOSR}, Blender {CLI_BLENDER}")
        run = tmp / "run"
        common = ["--data", str(osr), "--session-holdout-indices", "0,0,0"]

        stamps, records, train_peak = cli_train(
            ["train", "neusky", *common, "--max-iterations", str(CLI_STEPS), "--output-dir", str(run),
             "--trainer.steps_per_save", "2", "--trainer.steps_per_eval_image", "1000000000"], expected, CLI_STEPS, card)
        saved = sorted(p.name for p in (run / "checkpoints").iterdir())
        check(saved == ["step-000000002", "step-000000004"], f"cli train checkpoints: {saved}")
        gaps = np.diff(stamps)  # steps 2..4; a save at step 2 falls in step 3's gap
        steady = float(np.mean([gaps[0], gaps[2]]))
        log(f"cli train neusky ({card}): {n_scene} scene rays a step ({u} images x {1024 // u}), {n_counted} counted; "
            f"log-to-log ms of steps 2, 3 (after the step-2 save), 4: {', '.join(f'{g * 1e3:.1f}' for g in gaps)}; "
            f"steady step (steps 2 and 4) {steady * 1e3:.1f} ms, {n_scene / steady:.1f} scene rays/s, "
            f"{n_counted / steady:.1f} counted rays/s; peak device memory {train_peak:.3f} GiB; losses at step 4: "
            + json.dumps({k: v for k, v in records[-1].items() if k.endswith("_loss")}))

        _, syn_records, syn_peak = cli_train(
            ["train", "neusky-synthetic", "--data", str(blender), "--max-iterations", "2",
             "--output-dir", str(tmp / "run_synthetic")], expected, 2, card)
        check((tmp / "run_synthetic" / "latest.json").exists(), "cli train neusky-synthetic wrote no checkpoint")
        log(f"cli train neusky-synthetic ({card}): total loss {syn_records[0]['total_loss']} -> "
            f"{syn_records[-1]['total_loss']}; peak device memory {syn_peak:.3f} GiB")

        out = io.StringIO()
        k1.launches[k1.KERNEL_NAME] = 0
        with contextlib.redirect_stdout(out):
            _, eval_s, eval_peak = measured(lambda: cli.main(["eval", "neusky", *common, "--load-dir", str(run)]))
        eval_launches = k1_launches()
        metrics_line = out.getvalue().strip().splitlines()[-1]
        m = json.loads(metrics_line)
        check(eval_launches == 0, f"K1 launched {eval_launches} times in cli eval")
        check(sorted(m) == ["fps", "lpips", "mse", "num_rays_per_sec", "psnr", "ssim"]
              and all(math.isfinite(v) for v in m.values()), f"cli eval printed {metrics_line}")
        log(f"cli eval neusky ({card}): {eval_s:.3f} s wall (set-up, the {EVAL_FIT_STEPS}-step fit of 3 slots at "
            f"{n_scene} region rays, 3 renders of {CLI_NERFOSR['width']}x{CLI_NERFOSR['height']}); peak device memory "
            f"{eval_peak:.3f} GiB; K1 launches {eval_launches}; printed: {metrics_line}")

        image = tmp / "render.npy"
        k1.launches[k1.KERNEL_NAME] = 0
        with contextlib.redirect_stdout(io.StringIO()):
            _, render_s, render_peak = measured(lambda: cli.main(
                ["render", "neusky", *common, "--load-dir", str(run), "--image-idx", "0", "--output", str(image)]))
        render_launches = k1_launches()
        img = np.load(image)
        check(render_launches == 0, f"K1 launched {render_launches} times in cli render")
        check(img.shape == (CLI_NERFOSR["height"], CLI_NERFOSR["width"], 3) and np.isfinite(img).all(),
              f"cli render wrote {img.shape}, finite {np.isfinite(img).all()}")
        log(f"cli render neusky ({card}): {img.shape} in {render_s:.3f} s wall (set-up included), rgb in "
            f"[{img.min():.4f}, {img.max():.4f}]; peak device memory {render_peak:.3f} GiB; K1 launches {render_launches}")


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all()

    joint_cfg, joint_pcfg = neusky_model_config(8, 2), neusky_pipeline_config()
    check_k1(joint_cfg, joint_pcfg, 8 * 128)
    check_step_cuda_vs_cpu(joint=False)
    check_step_cuda_vs_cpu(joint=True)
    run_path("scene", scene_config(), neusky_pipeline_config(), SCENE_STEPS, card)
    main_launches, captured = run_path("joint", joint_cfg, joint_pcfg, STEPS, card,
                                       require_groups=("ddf_field", "visibility_sigmoid"))
    # the kernels line: K1 per joint step, on the inputs the main path gave it
    sites = check_k1_main_path_inputs(joint_cfg, joint_pcfg, 8 * 128, captured)
    del captured
    run_eval_path(card)
    check_eval_cuda_vs_cpu(card)
    run_cli_path(card)
    per_step = lambda key: sum(r[key] * r["launches_per_step"] for r in sites)
    kernels = [{
        "name": k1.KERNEL_NAME,
        "route": "cuda",
        "source": "neusky_torch/csrc/hashgrid_scatter.cu",
        "replaces": "neusky_tpu/ops/hashgrid_pallas.py:47",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in sites),
        # times are per joint training step: the sum over its launches, on
        # the inputs one main-path step gave them
        "ms": per_step("ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": max(sites, key=lambda r: r["bound_ms"] * r["launches_per_step"])["bound_by"],
        "library_ms": per_step("library_ms"),
    }]
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
