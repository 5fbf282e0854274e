"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is passed over).
Every single-process training step, eval-latent fit, DDF and RENI
trainer step, envmap and rotation fit, render chunk and LPIPS on the card
runs captured as a CUDA graph (``neusky_torch/parallel/graphs.py``: the
first call eager, the second captured, then replays), as the entry
points run them; K1's launches are counted through the replays,
and where a phase keeps K1's inputs it takes them from one eager step on
the same params.  Phase 13, the mesh, runs both ways: gloo ranks eagerly
(gloo's collectives cannot be captured), NCCL ranks eagerly and
captured with their collectives:

1. the card (``torch.cuda.get_device_name``, ``nvidia-smi`` name and power
   limit); build every kernel from ``neusky_torch/csrc`` with ``nvcc``
   (``sm_90a``), all sources at once;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (K1: all levels of each of the joint
   step's seven differentiated hash-grid encodes, indices from
   ``_all_iw``), with CUDA-event timings of the kernel, the plain version
   and one library call, and the bound; the fused DDF forward
   (``ddf_film_forward``) through the model's dispatch at a joint step's
   260,096 query rows in 16,384-row launches and a 96 × 96 viewer frame's
   2,340,864 in one, its launches and ``ddf.fused_rows`` counted, each
   path's worst and median gap to a float64 answer (the fused at most
   twice the plain float32 query's), timed beside the plain query in the
   same chunks and in one call;
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
   step (K1 once per differentiated encode: 4 scene, 7 joint; the fused
   DDF forward 0 scene, 16 launches over 260,096 rows joint) every step;
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
   0 in eval and render; ``train neusky`` runs its eval pass at step 4 (the
   peak allocated and reserved memory of a run with eval on);
8. in phase 7's directory, from its ``train neusky`` run: ``train ddf``
   (the DDF alone against the frozen scene: 5×256 FiLM-SIREN, 8 × 128 vMF
   rays at κ = 20 and 256 sky rays a step, 20 steps; every non-DDF leaf of
   the checkpoint it writes bit-equal to the run's, the DDF moved, the
   depth PSNR finite), then ``eval neusky --protocol nerfosr`` per image and
   with ``nerf_osr_envmap`` (the fits cut from 250 to 60 steps; JAX's
   keys in the JSON, finite metrics, rotations in [0, 2π)); K1's count is
   zeroed before each command and must read 0 after it; one more DDF
   step runs under ``torch.profiler``;
9. the RENI++ prior at the canonical decoder (latent 100, 6 attention
   layers of 8 heads) through ``neusky_torch/tools/train_reni_prior.py``:
   64 skies at 128 px, 2,048 pixels a step for 200 steps, the gates
   (4 held-out skies fitted for 250 steps), the prior file written and
   read back through ``illumination_prior_dir``, K1 0, one more trainer
   step timed and profiled; then a 5-step
   trainer chunk and a 5-step envmap fit on the card against the CPU on
   the same draws;
10. the configuration the JAX package's bench measures (``bench.py:85-118``),
   built by the port's bench (``neusky_torch.bench.build``), at full
   width: first a small step of (b) on the card against the CPU (the
   canonical widths on 2 images × 16 rays, the level-set query in chunks
   of 512 points), then (a) ``NEUSKY_BF16_MAPPING=1`` through
   ``apply_env_knobs(neusky_model_config(8, 2))``, bench's pipeline (8 ×
   128 vMF rays at κ = 20, 256 sky rays), the synthetic scene with 8 × 128
   rays a step from the C++ sampler, the converted prior and the five Adam
   groups for 100,001 steps; and (b) the same with every knob this slice
   ports (``NEUSKY_FUSED_GT=1``, ``NEUSKY_VIS_REMAT=dots``,
   ``NEUSKY_FILM_HEADS=1``, ``NEUSKY_BENCH_BF16=1``) and the level-set query
   in chunks of 16,384 points.  Each run sets its knobs and restores them
   after; 3 warm-up steps and 4 timed steps, K1's count zeroed before and
   read after every step (7 a step in (a), 9 in (b)), the peak memory,
   K1 against its plain version and timed on one step's own inputs, one
   profiled step;
11. the tools around a trained scene, in one temporary directory, with
   the methods without ``-tiny`` and the default device:
   ``neusky_torch/tools/train_sanity.py`` at canonical width with
   ``NEUSKY_BF16_MAPPING=1`` (24 steps logged every 8, the boundary eval of
   2 eval images after a 30-step fit, the checkpoint, the sun shadow map)
   and with ``--gt-illumination`` (4 steps; the probe's table moves), K1's
   count read after every step's update (7 a step) and around the eval and
   the shadow map (0); ``eval_from_ckpt`` (30-step fit) and
   ``render_from_ckpt`` on that checkpoint; the illumination-rotation
   animation (4 frames of the recipe's 64×64 camera 0), then
   ``render_animation``'s three commands on a 2-step ``cli train neusky
   --synthetic-demo`` run; ``render_shadow_probe`` at 64; the viewer
   (``make_handler(ViewerState(...))`` on 127.0.0.1, port 0): a GET of
   each render mode and one probe, each PNG decoded; the init-latent fit on
   the bundled prior; ``trace_context`` around 2 steps.  K1 launches 0
   times in every one but the training steps.  Then a GT-probe joint step,
   a Blinn-Phong joint step and a shadow map on the card against the CPU
   at small size, with phase 3's bounds;
12. the split step, the model variants and the diagnostic tools: (a)
   bench's configuration (a) of phase 10 through ``Trainer`` with
   ``use_split_step=True`` (3 warm-up + 4 steps, K1 7 a step as the fused
   step's, its steady ms, busy share and peak memory beside phase 10's
   fused (a)), then one small step split against fused on the card from
   the same draws (loss 1e-4, parameters 1e-5); (b) the DDF trainer with
   the ``Attention`` / ``sh`` DDF (hidden 256, 8 heads, 6 layers) at 8 ×
   128 vMF rays for 10 steps, a small step of it against the CPU, and
   ``ddf_predicted_normals`` on 1,024 rays against the CPU; (c) the RENI
   trainer with the FiLM and the Concat decoders at the
   ``RENIFieldConfig`` widths; (d) the SH, SG and envmap sky fields and
   the icosphere encoding against the CPU at 492 directions × 8 latents;
   (e) ``analyze_run``, ``prepare_nerfosr``, ``probe_sky_fit``,
   ``diagnose_ckpt`` and ``ab_ddf_encoding --encodings nerf,hash`` (on (a)'s
   checkpoint) and ``prior_fit_sanity``, K1 counted around each (3 a hash
   DDF step, 7 a ``prior_fit_sanity`` step, 0 elsewhere);
13. the multi-device path in bench's configuration (a) of phase 10: the
   one-process step on one global batch and one set of draws, then (a) one
   rank over NCCL, (b) two ranks on the one card over gloo, (c) four ranks,
   ``data`` × ``dirs`` = 2 × 2, over gloo (127 of the 254 queried
   directions a rank), (d) (c) over NCCL with a card a rank where there
   are four cards (logged as not run otherwise), each rank its own process
   (``neusky_torch.parallel.launch``): each run's check step against the
   one-process step, both with the visibility queried in chunks of one
   ray's 127 directions so that every run cuts its DDF calls where one
   process does (loss 1e-4 relative, rank 0's averaged gradient within
   phase 3's bounds, its params within 1e-6 but where a gradient within
   its bound of zero flips the update, every rank's params bitwise
   equal), then ``Trainer(mesh=, graphed=False)`` for 3 warm-up + 4
   steps a rank with K1 (7 a step), the DDF's visibility queries (the
   rank's rays × its share of the directions), steady ms a step, the
   gradient all-reduce's ms and peak memory logged per rank; then the
   captured NCCL rank step (one CUDA graph replay a step, its all-reduces
   inside), a card a rank: (e) one rank on this card, in (a)'s rank
   process after its eager steps, and (f) the 2 × 2 mesh and ``data`` = 4
   where there are four cards (logged as not run otherwise): in (f) the
   check step as a replay against the one-process step (the bounds
   above); ``Trainer(mesh=)`` with its default (captured) step for 3 + 4
   steps (K1 7 a replay), then 3 steps of it each against
   ``Trainer(mesh=, graphed=False)`` from one state (losses 1e-4,
   params at phase 16's bounds), K1 against its plain version and timed on
   the rank's own inputs, one profiled replay (busy share, host calls, the
   NCCL kernels' ms and share); every rank's params bitwise equal;
14. the port's bench, ``python -m neusky_torch.bench`` (what ``bench.py``
   builds, phase 10's (a) and its fused step), in a child process with
   ``NEUSKY_BENCH_STEPS=4 NEUSKY_BENCH_REPEATS=1``: its last line parses,
   with a finite positive ``value``, 2,304 rays a step, no ``vs_baseline``
   and this card's ``nvidia-smi`` line;
15. ``neusky_torch.entry.entry()``: its eval-mode forward of the tiny model
   on the card against the CPU from the same params and rays (rgb, depth,
   normal, accumulation within 1e-4 of each output's scale), K1 0;
16. the captured step against the eager step, on bench's (a) fused and
   split, each built by ``bench.build`` from seed-0 params and seed-1
   draws: 3 warm-up + 8 steps each, the losses of every step within 1e-4
   relative, K1 7 a step counted through the replays, then one more step
   of both from the captured run's params and Adam state, its updates at
   phase 3's bounds but where a gradient within its bound of zero flips
   Adam's update (:func:`same_state_step`); steady ms a step, device busy
   share and ops and the host's launch calls (a profiled step on a pass
   of its own), capture seconds and peak memory of each; then the 250-step
   eval-latent fit captured against ``host_loop=True``: the fitted eval
   latents within 1e-4 of their scale, ms a fit step;
17. the other captured paths against their eager selves, on bench (a)'s
   model (seed-0 params, the prior) and phase 6's eval ring: 20 DDF
   trainer steps (losses within 1e-4 at each, ``ddf_field`` within 1e-4 of
   scale after), 20 RENI trainer steps at the canonical decoder (losses
   within 1e-4), the envmap fit (4 skies, 30 steps: latents within 1e-4
   of scale, PSNRs within 0.01 dB), the rotation fit (30 steps: angles
   within 1e-4 rad, scales within 1e-4), the render of a 64×48 image (one
   padded chunk) and a 64×64 one with and without a rotation (every map
   within 1e-6 of scale) and LPIPS on it (1e-6); each path's ms a step
   (rays/s for the render), busy share, host calls, ``capture_s``, peak
   allocated and reserved memory (the allocator's cache emptied first) and
   K1 launches (0);
18. one JSON line listing every kernel (K1 per step of phase 12's split
   step, on its own inputs, with their shapes; the fused DDF forward per
   joint step of phase 5 and a viewer frame, from phase 2), the card line, and the
   final ``{"ok": true, "device": ...}`` line.

``split_ab()`` is a separate command: the split and the fused step in
turns, more steps each (see its docstring); ``mesh_path()`` runs phase 13
alone, ``graph_path()`` phase 16, ``graph_paths()`` phase 17;
``graph_spread()`` measures how far two
runs of a step part (the ground of phase 16's bound on the params) and
``bench_ab()`` runs the port's bench at a parent tree and at this one in
turns.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from neusky_torch import bench
from neusky_torch.configs import env_overrides
from neusky_torch.configs.neusky_config import neusky_model_config, neusky_pipeline_config
from neusky_torch.core.rays import RayBundle
from neusky_torch.core.spherical import ray_sphere_intersection
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine import metrics
from neusky_torch.engine.checkpoint import load_illumination_prior, prior_asset_path, save_checkpoint
from neusky_torch.engine.optimizers import GroupedAdam, default_neusky_optimizer_groups
from neusky_torch.engine.eval_loop import (
    average_eval_metrics, eval_image_metrics, fit_eval_latents, make_render_chunk_fn, render_camera,
)
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.models.neusky import NeuSkyModel, visibility_query_directions
from neusky_torch.models.losses import ddf_sky_ray_loss
from neusky_torch.models.pipeline import batch_sky_bundle, draw_ddf_fit, draw_step, train_loss_fn
from neusky_torch.ops import ddf_film_cuda, hashgrid, hashgrid_cuda as k1
from neusky_torch.ops.hashgrid import HashGridEncoding
from neusky_torch.parallel import mesh as mesh_mod
from neusky_torch.parallel.launch import run_ranks
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig
from neusky_torch.sampling.illumination import IcosahedronSampler
from neusky_torch.tree import tree_digest, tree_items, tree_map
from neusky_torch.utils.profiling import count_visibility_queries

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
STEPS = 4  # joint path
SCENE_STEPS = 4
# ~10 ms at the H100's clock: longer than the host takes to queue one
# timing loop's calls
HOLD_CYCLES = 20_000_000


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what) -> None:
    """An assertion that ``python -O`` keeps."""
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 1: build


KERNEL_BUILDS = {k1.KERNEL_NAME: k1.build, ddf_film_cuda.KERNEL_NAME: ddf_film_cuda.build}


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
    subset of termination points, one launch per chunk of
    ``sdf_query_chunk`` points when that is set.  The ground-truth pass's
    proposal encodes feed only the resampling, which no gradient passes,
    and the canonical DDF (NeRF encodings) calls no hash grid.  With the
    fused pass (``fused_ddf_gt_pass``) the scene and vMF rays share one
    proposal and field pass: its three encodes take both ray sets' points
    in one launch each, and the ground-truth pass has none of its own."""
    prop = model_cfg.proposal
    sh = model_cfg.sdf_field.hash
    sdf_rows = _rows_per_point(model_cfg.sdf_field.stochastic_table_grads)
    fit = model_cfg.ddf is not None and model_cfg.fit_visibility_field
    s = pipeline_cfg.visibility_train_sampler
    n_vmf = s.num_samples_on_sphere * s.num_rays_per_sample if fit else 0
    fused = fit and model_cfg.fused_ddf_gt_pass and not pipeline_cfg.stop_sdf_gradients
    n_pass = n_rays + n_vmf if fused else n_rays
    sites = [(f"proposal_field_{i}", pf.hash, n_pass * prop.num_proposal_samples[i],
              _rows_per_point(pf.stochastic_table_grad))
             for i, pf in enumerate(model_cfg.proposal_fields)]
    sites.append(("sdf_field_outputs", sh, n_pass * prop.num_final_samples, sdf_rows))
    if model_cfg.losses.hashgrid_density:
        sites.append(("density_grid_sdf", sh, model_cfg.losses.hashgrid_density_grid_resolution ** 3, sdf_rows))
    if model_cfg.ddf is None:
        return sites
    if model_cfg.use_visibility and model_cfg.losses.sdf_level_set_visibility:
        d = visibility_query_directions(
            model_cfg, IcosahedronSampler(model_cfg.num_illumination_directions).actual_num_directions)
        sub = model_cfg.sdf_level_set_subset
        m = n_rays * (sub if sub and sub < d else d)
        chunk = model_cfg.sdf_query_chunk or m
        sites += [("level_set_sdf", sh, min(chunk, m - start), sdf_rows) for start in range(0, m, chunk)]
    if fit:
        if not fused:
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


def capture_k1_inputs(one_step):
    """``one_step()`` (one more training step) with the encodes' scatter
    dispatch wrapped, to keep what K1 takes on the main path: [(rows, vals,
    T)], call order."""
    seen = []
    dispatch = hashgrid.scatter_levels

    def keep(rows, vals, t):
        seen.append((rows.clone(), vals.contiguous().clone(), t))
        return dispatch(rows, vals, t)

    hashgrid.scatter_levels = keep
    try:
        one_step()
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
        names[key] = f"{names[key]}|{name}" if key in names and name not in names[key].split("|") else name
    want = sorted((h.num_levels, n * rpp) for _, h, n, rpp in k1_sites(model_cfg, pipeline_cfg, n_rays))
    got = sorted((r.shape[0], r.shape[1]) for r, _, _ in captured)
    check(want == got, f"captured K1 inputs {got} are not the sites {want}")
    return [measure_k1(names[tuple(rows.shape)] + "/main_path", rows, vals, t, 1) for rows, vals, t in captured]


def ddf_query_rows(cfg, n_rays: int) -> int:
    """The DDF visibility query's rows a step of ``n_rays`` rays: every
    ray at each queried light direction (0 without DDF visibility)."""
    if cfg.ddf is None or not cfg.use_visibility:
        return 0
    return n_rays * visibility_query_directions(
        cfg, IcosahedronSampler(cfg.num_illumination_directions).actual_num_directions)


def ddf_film_bound_ms(rows: int, packed) -> float:
    """Least time of the fused DDF forward over ``rows``: per row the fp32
    FMAs of the mapping network, its heads and the output layer on the CUDA
    cores, and the FiLM layers' bf16 MACs on the tensor cores."""
    w, e = ddf_film_cuda.WIDTH, ddf_film_cuda.ENC_DIM
    nm, nf = packed.mapping_layers, packed.film_layers
    fp32 = e * w + (nm - 1) * w * w + w * 2 * nf * w + w
    bf16 = e * w + (nf - 1) * w * w
    return rows * (2.0 * fp32 / FP32_OPS_PER_S + 2.0 * bf16 / BF16_OPS_PER_S) * 1e3


def ddf_film_f64(net, origins, local, scale: float, chunk: int = 131072) -> torch.Tensor:
    """The canonical FiLM-SIREN DDF in float64, the FiLM layers' inputs
    rounded to bf16 as the recipe rounds them: the answer both float32
    paths are held to."""
    from neusky_torch.ops.encodings import nerf_encoding

    enc = lambda v: torch.cat([v, nerf_encoding(v, 2, 0.0, 2.0)], dim=-1)  # noqa: E731
    mp = {k: v.double() for k, v in net["MappingNetwork_0"].items()}
    nm, nf = ddf_film_cuda.layer_counts(net)
    w = ddf_film_cuda.WIDTH
    outs = []
    for s in range(0, origins.shape[0], chunk):
        x = enc(origins[s:s + chunk].double())
        for i in range(nm):
            x = torch.nn.functional.leaky_relu(x @ mp[f"kernel_{i}"] + mp[f"bias_{i}"], 0.2)
        heads = x @ mp["kernel_out"] + mp["bias_out"]
        h = enc(local[s:s + chunk].double())
        for i in range(nf):
            lin = h.bfloat16().double() @ net[f"film_kernel_{i}"].bfloat16().double() + net[f"film_bias_{i}"].double()
            f, ph = heads[:, i * w:(i + 1) * w], heads[:, (nf + i) * w:(nf + i + 1) * w]
            h = torch.sin((15.0 * f + 30.0) * lin + ph)
        outs.append(torch.sigmoid((h @ net["out_kernel"].double() + net["out_bias"].double())[:, 0]) * scale)
    return torch.cat(outs)


def check_ddf_film(cfg, n_rays: int, frame_rays: int = 96 * 96):
    """The fused DDF forward (``ddf_film_forward``) through the model's own
    dispatch (``NeuSkyModel._ddf_query``) on seeded weights of ``cfg``'s
    DDF, at a training step's rows (``n_rays`` rays, one launch a chunk, as
    the training chunks' forward runs it) and a 96 × 96 viewer frame's (one
    launch): launches and ``ddf.fused_rows`` counted, each path's worst and
    median gap to the float64 answer (the fused path's at most twice the
    plain float32 path's), then CUDA-event times of the kernel, the plain
    query in the same chunks (no autograd: the checkpoint's first pass and
    the viewer's path before the kernel), the plain query in one call, and
    the bound."""
    model = NeuSkyModel(cfg, device="cuda")
    check(model._fuses_ddf(torch.empty(0, 3, device="cuda"), True),
          "the recipe's DDF does not take the fused kernel")
    params = model.ddf.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    net = params["params"]["field"]["net"]
    packed = ddf_film_cuda.pack(net)
    chunk = cfg.visibility_query_chunk
    g = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    for label, rows in (("step", ddf_query_rows(cfg, n_rays)), ("frame", ddf_query_rows(cfg, frame_rays))):
        # origins on the DDF sphere, world directions into it
        o = torch.nn.functional.normalize(torch.randn((rows, 3), generator=g, device="cuda"), dim=-1)
        o = o * cfg.ddf_radius
        d = torch.nn.functional.normalize(torch.randn((rows, 3), generator=g, device="cuda"), dim=-1)
        d = torch.where((d * o).sum(-1, keepdim=True) > 0, -d, d)
        fused_call = model.ddf.fused_query(params)
        plain_call = lambda oo, dd: model.ddf.apply(params, oo, dd)["expected_termination_dist"]  # noqa: E731
        in_chunks = lambda fn: torch.cat([fn(o[s:s + chunk], d[s:s + chunk])  # noqa: E731
                                          for s in range(0, rows, chunk)])
        with torch.no_grad():
            ddf_film_cuda.launches[ddf_film_cuda.KERNEL_NAME] = 0
            ddf_film_cuda.launches[ddf_film_cuda.FUSED_ROWS] = 0
            fused = in_chunks(fused_call) if label == "step" else model._ddf_query(params, o, d)
            torch.cuda.synchronize()
            launches = ddf_film_cuda.launches[ddf_film_cuda.KERNEL_NAME]
            counted = ddf_film_cuda.launches[ddf_film_cuda.FUSED_ROWS]
            want = -(-rows // chunk) if label == "step" else 1
            check(launches == want and counted == rows,
                  f"ddf_film_forward {label}: {launches} launches and {counted} rows, expected {want} and {rows}")
            plain = in_chunks(plain_call)
            exact = ddf_film_f64(net, o, model.ddf.local_directions(o, d), model.ddf.field.distance_scale)
            gaps = {k: (v.double() - exact).abs() for k, v in (("plain", plain), ("fused", fused))}
            worst = {k: float(v.max()) for k, v in gaps.items()}
            median = {k: float(v.median()) for k, v in gaps.items()}
            check(0 < worst["plain"] and worst["fused"] <= 2.0 * worst["plain"]
                  and median["fused"] <= 2.0 * median["plain"],
                  f"ddf_film_forward {label}: gaps to float64 worst {worst}, median {median}")
            del gaps, exact, plain, fused
            iters = 20 if label == "step" else 5
            row = dict(case=label, rows=rows, launches=want, counted_rows=counted, worst_gap=worst,
                       median_gap=median, max_abs_err=worst["fused"],
                       ms=time_ms(lambda: in_chunks(fused_call) if label == "step" else fused_call(o, d),
                                  iters=iters, warmup=1),
                       plain_ms=time_ms(lambda: in_chunks(plain_call), iters=iters, warmup=1),
                       bound_ms=ddf_film_bound_ms(rows, packed))
            if label == "step":
                row["library_ms"] = time_ms(lambda: plain_call(o, d), iters=iters, warmup=1)
        log("ddf_film_forward case " + json.dumps(row))
        res[label] = row
        del o, d
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the configuration


def scene_config(**kw):
    cfg = neusky_model_config(8, 2, **kw)
    return dataclasses.replace(
        cfg, ddf=None, use_visibility=False, fit_visibility_field=False,
        losses=dataclasses.replace(cfg.losses, sdf_level_set_visibility=False),
    )


def expected_launches_per_step(cfg, pipeline_cfg, n_rays: int = 8 * 128) -> int:
    """K1 launches once per differentiated hash-grid encode
    (:func:`k1_sites`): 4 a scene step, 7 a joint step, 9 a fused joint
    step with the level-set query in 4 chunks."""
    return len(k1_sites(cfg, pipeline_cfg, n_rays))


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


def rounds_cotangent(cfg, key: str) -> bool:
    """Whether the parameter ``key`` is the kernel of a bf16 product, whose
    cotangent both sides round to bfloat16 (as JAX does at the cast) at
    each use: the DDF's FiLM kernels, its mapping kernels with the bf16
    mapping, the SDF field's geometry and colour kernels with bf16 MLPs."""
    f = cfg.ddf.field if cfg.ddf is not None else None
    if key.startswith("ddf_field/") and f is not None:
        return bool((f.use_bf16_compute and "/film_kernel_" in key)
                    or (f.use_bf16_mapping and "/MappingNetwork_0/kernel_" in key))
    if key.startswith("fields/"):
        leaf = key.split("/")
        return bool(cfg.sdf_field.use_bf16_compute and leaf[-1] == "kernel"
                    and leaf[-2].split("_")[0] in ("geo", "col"))
    return False


def grad_allowance(want: torch.Tensor, rel: float, bf16_cotangent: bool) -> torch.Tensor:
    """Each element's allowed error: ``rel`` of the array's largest.  A
    gradient whose cotangent both sides round to bfloat16
    (:func:`rounds_cotangent`) may besides round to the neighbouring
    bfloat16 value where the card's and the CPU's float32 sums straddle a
    rounding boundary: 2⁻⁷ of the element at most (of the term of one use,
    where several uses add up)."""
    allow = rel * want.abs().max()
    if bf16_cotangent:
        allow = allow + 2.0**-7 * want.abs()
    return allow


def grad_close(got: torch.Tensor, want: torch.Tensor, rel: float, bf16_cotangent: bool) -> bool:
    """Every element within its :func:`grad_allowance`."""
    return bool(((got - want).abs() <= grad_allowance(want, rel, bf16_cotangent)).all())


def check_step_cuda_vs_cpu(joint: bool, knobs=None, sdf_query_chunk: int = 0, variant=None):
    """The same params, batch and draws through train_loss_fn on the card
    (K1) and on the CPU (plain scatter), 2 images × 16 rays.  Losses must
    agree to 1e-4 relative and every gradient array to 2e-3 of its largest
    entry (fp32 with other reduction orders and atomics); the DDF's to 5e-3
    (its bf16-rounded FiLM inputs may round to the neighbouring bf16 value
    where the card's and the CPU's float32 sums differ in the last bits);
    a kernel of a bf16 product, whose cotangent both sides round to
    bfloat16, may besides differ by one bf16 step of each element
    (:func:`rounds_cotangent`, :func:`grad_close`).
    With ``knobs`` (phase 10's (b): the fused pass, the bf16 mapping with
    per-layer heads, ``dots``, bf16 SDF MLPs) and the level-set query in
    chunks, more values are rounded to bfloat16 where the two sums may
    differ in the last bit (the mapping outputs, the SDF and colour MLPs'
    products and cotangents; a flip moves an element by up to 2⁻⁷ of it):
    losses to 1e-3 relative, the SDF field's and the DDF's gradients to
    5e-2 of scale, as the CPU tests against JAX hold the same step
    (``tests/test_torch_fused.py``).  ``variant`` (a name in
    :data:`VARIANTS`, phase 11) turns on the GT-illumination probe or
    Blinn-Phong shading, with phase 3's bounds."""
    cfg, pcfg = small_configs(joint)
    if variant is not None:
        cfg = VARIANTS[variant](cfg)
    if knobs is not None:
        with knobs_set(knobs):
            cfg = dataclasses.replace(env_overrides.apply_env_knobs(cfg), sdf_query_chunk=sdf_query_chunk)
    loss_rtol, grad_rel = (1e-4, {"ddf_field": 5e-3}) if knobs is None else (1e-3, {"ddf_field": 5e-2, "fields": 5e-2})
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    out = {}
    cpu_model = NeuSkyModel(cfg, device="cpu")
    params0 = cpu_model.init(torch.Generator().manual_seed(3))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    batch = dm.next_train(0)
    gen = torch.Generator().manual_seed(4)
    n_rays = batch["pixel_coords"].shape[0]
    s = pcfg.visibility_train_sampler
    fused = joint and cfg.fused_ddf_gt_pass
    draws = cpu_model.draw(None, gen, n_rays + (s.num_samples_on_sphere * s.num_rays_per_sample if fused else 0))
    if joint:
        draws["ddf"] = draw_ddf_fit(cpu_model, pcfg, None, gen, with_gt=not fused)
    expected = expected_launches_per_step(cfg, pcfg, n_rays)
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
    if not (math.isfinite(tg) and abs(tg - tc) <= loss_rtol * abs(tc)):
        bad.append(("total", tg, tc))
    bad += [(k, lg[k], lc[k]) for k in lc if not abs(lg[k] - lc[k]) <= loss_rtol * abs(lc[k]) + 1e-7]
    worst = {}
    for k in gc:
        scale = float(gc[k].abs().max())
        if scale == 0:
            continue
        rel = float((gg[k] - gc[k]).abs().max()) / scale
        group = k.split("/")[0]
        worst[group] = max(worst.get(group, 0.0), rel)
        if not grad_close(gg[k], gc[k], grad_rel.get(group, 2e-3), rounds_cotangent(cfg, k)):
            bad.append((k, rel))
    label = ("joint" if joint else "scene") + ("" if knobs is None else " (b) " + json.dumps(knobs)
                                               + f" sdf_query_chunk {sdf_query_chunk}") + (
        "" if variant is None else f" ({variant})")
    log(f"{label} step on the card vs the CPU: total {tg:.6f} vs {tc:.6f}; K1 launches {expected}; "
        f"worst grad rel err by group " + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    check(not bad, f"{label} step on the card differs from the CPU: {bad}")


# ---------------------------------------------------------------------------
# phases 4 and 5: the scene path and the main (joint) path


def run_path(label: str, cfg, pcfg, steps: int, card: str, require_groups=(), fused_ddf: bool = False):
    """``steps`` training steps of ``cfg`` through ``Trainer`` on the
    synthetic scene (8 cameras, 64×64; 8 images × 128 rays, 256 sky rays),
    K1's count and the fused DDF forward's launches and rows zeroed before
    and read after (with ``fused_ddf`` each step's visibility rows in one
    launch a chunk, else none), then one step keeping K1's inputs and one
    profiled step.  Returns K1's launches, its inputs and the DDF kernel's
    (launches, rows)."""
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
    ddf_rows = ddf_query_rows(cfg, n_rays) if fused_ddf else 0
    ddf_expected = (-(-ddf_rows // cfg.visibility_query_chunk), ddf_rows)
    log(f"{label} path: {n_rays} scene rays/step ({n_counted} counted by the trainer), "
        f"{model.num_directions} light directions, expecting {expected} K1 launches/step and "
        f"{ddf_expected[0]} {ddf_film_cuda.KERNEL_NAME} launches over {ddf_rows} rows a step")

    ddf_counts = lambda: (ddf_film_cuda.launches[ddf_film_cuda.KERNEL_NAME],  # noqa: E731
                          ddf_film_cuda.launches[ddf_film_cuda.FUSED_ROWS])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches[k1.KERNEL_NAME] = 0
    ddf_film_cuda.launches[ddf_film_cuda.KERNEL_NAME] = 0
    ddf_film_cuda.launches[ddf_film_cuda.FUSED_ROWS] = 0
    times, per_step, ddf_per_step = [], [], []
    for s in range(steps):
        before, ddf_before = k1.launches[k1.KERNEL_NAME], ddf_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = trainer.run(1)[-1]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_step.append(k1.launches[k1.KERNEL_NAME] - before)
        ddf_per_step.append(tuple(a - b for a, b in zip(ddf_counts(), ddf_before)))
        losses = {k: v for k, v in rec.items() if k.endswith("_loss") or k == "ddf_depth_psnr"}
        log(f"{label} step {s}: {dt * 1e3:.1f} ms, {n_rays / dt:.1f} scene rays/s, {n_counted / dt:.1f} "
            f"counted rays/s ({card}); K1 launches {per_step[-1]}; {ddf_film_cuda.KERNEL_NAME} launches, rows "
            f"{ddf_per_step[-1]}; " + json.dumps(losses))
        for k, v in rec.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{label} step {s}: {k} = {v}")
        times.append(dt)
    launches = k1.launches[k1.KERNEL_NAME]
    ddf_total = ddf_counts()
    check(per_step == [expected] * steps, f"{label}: K1 launches per step {per_step}, expected {expected}")
    check(ddf_per_step == [ddf_expected] * steps,
          f"{label}: {ddf_film_cuda.KERNEL_NAME} (launches, rows) per step {ddf_per_step}, expected {ddf_expected}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # step 0 runs eagerly and step 1 captures the step: the replays are steady
    steady = float(np.mean(times[2:]))
    log(f"{label} peak device memory: {peak:.2f} GiB")
    log(f"{label} steady step (mean of steps 2..{steps - 1}, replays): {steady * 1e3:.1f} ms, "
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
    log(f"{label} step captured as a CUDA graph in {trainer.train_step.captured.capture_s:.3f} s; "
        f"{trainer.train_step.captured.replays} replays")
    with eager_steps(trainer):
        captured = capture_k1_inputs(lambda: trainer.run(1))
    profile_call(lambda: trainer.run(1), steady, card, f"{label} step")
    return launches, captured, ddf_total


@contextlib.contextmanager
def eager_steps(trainer):
    """``trainer``'s step run eagerly inside the block, on the same params
    and Adam state (and mesh) as its captured step (a replay calls no
    Python, so K1's inputs are kept from an eager step)."""
    graphed = trainer.train_step
    make = mesh_mod.make_train_step_split if trainer.config.use_split_step else mesh_mod.make_train_step
    trainer.train_step = make(trainer.model, trainer.pipeline_config, trainer.optimizer, trainer.mesh, graphed=False)
    try:
        yield trainer
    finally:
        trainer.train_step = graphed


# device-op name fragments → kind, first match wins
KERNEL_KINDS = (
    ("K1", ("scatter_levels_kernel",)),
    ("NCCL", ("nccl",)),
    ("matmul", ("gemm", "gemv", "Kernel2", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("sin/cos (SIREN)", ("sin_kernel", "cos_kernel")),
    ("gather/scatter", ("index", "gather", "scatter")),
    ("reduce/scan/sort", ("reduce", "scan", "cumsum", "cumprod", "sort", "softmax")),
    ("copy/fill", ("copy", "fill", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "Functor")),
)


# the CUDA runtime and driver calls by which the host issues device work
# (kernel launches, copies and fills, graph launches)
HOST_LAUNCH_CALLS = ("LaunchKernel", "Memcpy", "Memset", "GraphLaunch")


def profile_call(fn, wall_s: float, card: str, label: str, top: int = 15):
    """``fn()`` once more under ``torch.profiler``: device time by kernel
    name, its sum against ``wall_s`` (the unprofiled wall time of the same
    work), K1's share, and the calls by which the host issued the work
    (:data:`HOST_LAUNCH_CALLS`: one per kernel eagerly, one graph launch
    and the input copies for a captured step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, longest = {}, {}
    host_calls = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                     and e.name.startswith("cu") and any(w in e.name for w in HOST_LAUNCH_CALLS))
    for e in prof.events():
        # device-side user annotations (the optimizer's range) are spans
        # over kernels, not work of their own
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
            longest[e.name] = max(longest.get(e.name, 0.0), e.time_range.elapsed_us())
    if not by_name:
        log(f"{label} profile: the profiler saw no device events; device time not measured")
        return None
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
        f"K1 {k1_ms:.3f} ms; CatArrayBatchedCopy {cat_us / 1e3:.3f} ms ({cat_n}x, longest {cat_max:.1f} us); "
        f"{host_calls} launch, copy and graph calls from the host")
    by_kind = {}
    for name, (n, us) in by_name.items():
        kind = next((k for k, keys in KERNEL_KINDS if any(s in name for s in keys)), "other")
        c, t = by_kind.get(kind, (0, 0.0))
        by_kind[kind] = (c + n, t + us)
    log("  by kind: " + "; ".join(f"{k} {us / 1e3:.3f} ms ({n}x)"
                                  for k, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1])))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  {us / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")
    return {"device_ms": device_ms, "busy_share": device_ms / (wall_s * 1e3), "ops": n_kernels,
            "host_calls": host_calls, "by_kind_ms": {k: us / 1e3 for k, (_, us) in by_kind.items()}}


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
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
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
        f"K1 launches per step {per_step}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"allocated / {torch.cuda.max_memory_reserved() / 2**30:.3f} GiB reserved")
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
             "--trainer.steps_per_save", "2", "--trainer.steps_per_eval_image", str(CLI_STEPS)], expected, CLI_STEPS,
            card)
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
        run_ddf_and_protocol(card, tmp, common, run)


# ---------------------------------------------------------------------------
# phase 8: cli train ddf and cli eval --protocol nerfosr


DDF_STEPS = 20
PROTOCOL_FIT_STEPS = 60  # the CLI's fits take 250; depth cut, not width
PROTOCOL_KEYS = {"per_image", "mean", "fit_loss_first", "fit_loss_last", "num_sessions", "lpips_flavour"}


def _checkpoint_leaves(base: Path):
    from neusky_torch.engine.checkpoint import STATE_FILE, latest_step

    step = latest_step(base)
    state = torch.load(base / "checkpoints" / f"step-{step:09d}" / STATE_FILE, weights_only=True, map_location="cpu")
    return dict(tree_items(state["params"]))


def run_cli_ddf(card: str, tmp: Path, common, run: Path):
    """``train ddf`` from ``run``: K1 zeroed before and read after; each
    step synchronised and stamped (its draws, made before the step's
    replay) for its time."""
    from neusky_torch import cli
    from neusky_torch.engine import ddf_trainer

    stamps, records, trainers = [], [], []
    draw_step, printer = ddf_trainer.DDFTrainer.draw_step, cli.print_record

    def stamped_draws(self, *a, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        trainers[:] = [self]
        return draw_step(self, *a, **kw)

    ddf_trainer.DDFTrainer.draw_step = stamped_draws
    cli.print_record = lambda record: records.append(record) or printer(record)
    out = tmp / "ddf"
    try:
        k1.launches[k1.KERNEL_NAME] = 0
        _, wall, peak = measured(lambda: cli.main(["train", "ddf", *common, "--load-dir", str(run), "--output-dir",
                                                   str(out), "--max-iterations", str(DDF_STEPS)]))
    finally:
        ddf_trainer.DDFTrainer.draw_step, cli.print_record = draw_step, printer
    launches = k1_launches()
    check(launches == 0, f"K1 launched {launches} times in cli train ddf")
    check(len(records) == 1 and records[0]["step"] == DDF_STEPS and all(math.isfinite(v) for v in records[0].values()),
          f"cli train ddf records {records}")
    before, after = _checkpoint_leaves(run), _checkpoint_leaves(out)
    check(sorted(before) == sorted(after), "the DDF checkpoint's leaves differ from the run's")
    moved = sorted({k.split("/")[0] for k in after if not torch.equal(after[k], before[k])})
    check(moved == ["ddf_field"], f"cli train ddf moved {moved}")
    gaps = np.diff(stamps)
    steady = float(np.mean(gaps[2:]))
    log(f"cli train ddf ({card}): {DDF_STEPS} steps of 8 x 128 vMF + 256 sky rays in {wall:.3f} s wall (set-up and "
        f"the save included); steady {steady * 1e3:.3f} ms a step (steps 3..{DDF_STEPS - 1}, each synchronised); peak "
        f"device memory {peak:.3f} GiB; K1 launches {launches}; only ddf_field moved; step {DDF_STEPS}: "
        + json.dumps(records[0]))
    log("cli train ddf ms of steps 1.." + str(DDF_STEPS - 1) + ": " + ", ".join(f"{g * 1e3:.1f}" for g in gaps))
    trainer = trainers[0]
    lone = [measured(lambda: trainer.run(1))[1] for _ in range(3)]
    log(f"ddf steps after the command ({card}): " + ", ".join(f"{t * 1e3:.3f}" for t in lone) + " ms, each alone")
    profile_call(lambda: trainer.run(1), lone[-1], card, "ddf step", top=8)


def run_cli_protocol(card: str, tmp: Path, common, run: Path, method: str):
    """``eval neusky --protocol nerfosr`` with ``method`` (fits cut to
    PROTOCOL_FIT_STEPS): K1 zeroed before and read after."""
    from neusky_torch import cli
    from neusky_torch.engine import eval_loop

    protocol = eval_loop.run_nerfosr_protocol
    eval_loop.run_nerfosr_protocol = lambda *a, **kw: protocol(*a, fit_steps=PROTOCOL_FIT_STEPS, **kw)
    path = tmp / f"nerfosr_{method}.json"
    try:
        k1.launches[k1.KERNEL_NAME] = 0
        with contextlib.redirect_stdout(io.StringIO()):
            _, wall, peak = measured(lambda: cli.main(["eval", "neusky", *common, "--load-dir", str(run), "--protocol",
                                                       "nerfosr", "--output", str(path),
                                                       "--model.eval_latent_optimise_method", method]))
    finally:
        eval_loop.run_nerfosr_protocol = protocol
    launches = k1_launches()
    check(launches == 0, f"K1 launched {launches} times in cli eval --protocol nerfosr ({method})")
    result = json.loads(path.read_text())
    keys = PROTOCOL_KEYS | ({"envmap_fit_psnr", "session_rotation_rad"} if method == "nerf_osr_envmap" else set())
    check(set(result) == keys, f"protocol JSON keys {sorted(result)}, expected {sorted(keys)}")
    finite = list(result["mean"].values()) + [result["fit_loss_first"], result["fit_loss_last"]]
    finite += [v for p in result["per_image"] for k, v in p.items() if k not in ("image_idx", "session")]
    finite += result.get("envmap_fit_psnr", [])
    check(all(math.isfinite(v) for v in finite), f"protocol ({method}) metrics not finite: {result}")
    check(all(0.0 <= g < 2.0 * math.pi for g in result.get("session_rotation_rad", [])),
          f"session rotations {result.get('session_rotation_rad')}")
    extra = "" if method == "per_image" else (
        f"; envmap fit PSNR {result['envmap_fit_psnr']}, session rotations {result['session_rotation_rad']} rad")
    log(f"cli eval neusky --protocol nerfosr ({method}, {card}): {wall:.3f} s wall ({PROTOCOL_FIT_STEPS}-step fits of "
        f"{result['num_sessions']} sessions, {len(result['per_image'])} building-masked compare renders); peak device "
        f"memory {peak:.3f} GiB; K1 launches {launches}; fit loss {result['fit_loss_first']:.6f} -> "
        f"{result['fit_loss_last']:.6f}; mean " + json.dumps(result["mean"]) + extra)


def run_ddf_and_protocol(card: str, tmp: Path, common, run: Path):
    """Phase 8: see the module docstring."""
    t0 = time.perf_counter()
    run_cli_ddf(card, tmp, common, run)
    for method in ("per_image", "nerf_osr_envmap"):
        run_cli_protocol(card, tmp, common, run, method)
    log(f"phase 8 took {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 9: the RENI++ prior


PRIOR_ARGS = ["--num-skies", "64", "--holdout", "4", "--width", "128", "--steps", "200"]


def run_reni_prior(card: str):
    """Phase 9 (first half): the prior script at the canonical decoder into
    a temporary directory, then the prior read back from it."""
    from types import SimpleNamespace

    from neusky_torch.engine.checkpoint import PRIOR_FILE
    from neusky_torch.fields.reni import RENIField
    from neusky_torch.tools import train_reni_prior

    from neusky_torch.engine.reni_trainer import RENITrainer

    cfg = neusky_model_config(1, 1)
    trainers = []
    init = RENITrainer.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "prior"
        k1.launches[k1.KERNEL_NAME] = 0
        RENITrainer.__init__ = keep
        try:
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rc, wall, peak = measured(lambda: train_reni_prior.main(PRIOR_ARGS + ["--output", str(out)]))
        finally:
            RENITrainer.__init__ = init
        launches = k1_launches()
        check(rc in (0, 1), f"train_reni_prior exited {rc}: {text.getvalue()[-2000:]}")
        check(launches == 0, f"K1 launched {launches} times in the RENI trainer")
        q = json.loads((out / "quality.json").read_text())
        check(all(math.isfinite(q[k]) for k in ("train_recon_psnr", "heldout_fit_psnr", "equivariance_max_err",
                                                "clip_fit_loss_first", "clip_fit_loss_last"))
              and q["equivariance_gate"], f"prior gates {q}")
        prior_cfg = SimpleNamespace(illumination_prior_dir=str(out))
        check(prior_asset_path(prior_cfg) == out / PRIOR_FILE, f"the prior resolves to {prior_asset_path(prior_cfg)}")
        field = RENIField(dataclasses.replace(cfg.illumination, fixed_decoder=False))
        loaded = load_illumination_prior({"illumination_decoder": field.init(torch.Generator(device="cuda"), "cuda")},
                                         prior_cfg)
        with np.load(out / PRIOR_FILE) as z:
            same = all(np.array_equal(v.cpu().numpy(), z[k]) for k, v in tree_items(loaded))
        check(same, "the prior read back differs from the file written")
    log(f"RENI++ prior ({card}): {q['num_skies']} skies at {q['width']} px, {q['steps']} steps of 2048 pixels in "
        f"{q['train_seconds']:.3f} s ({q['train_seconds'] / q['steps'] * 1e3:.3f} ms a step, the first chunk's set-up "
        f"included); script {wall:.3f} s wall with the corpus and the gates; peak device memory {peak:.3f} GiB; K1 "
        f"launches {launches}; train recon PSNR {q['train_recon_psnr']:.4f}, held-out fit PSNR "
        f"{q['heldout_fit_psnr']:.4f} (4 skies, 250 steps), equivariance err {q['equivariance_max_err']:.3g}, z=0 "
        f"saturated {q['z0_srgb_saturated_frac']:.4f}, clip fit {q['clip_fit_loss_first']:.4f} -> "
        f"{q['clip_fit_loss_last']:.4f}, all gates {q['all_pass']} (exit {rc}); read back through "
        "illumination_prior_dir")
    trainer = trainers[0]
    step = lambda: trainer.train_step(trainer.draw())
    _, one_s, _ = measured(step)
    log(f"RENI++ trainer step ({card}): {one_s * 1e3:.3f} ms (one more step, synchronised)")
    profile_call(step, one_s, card, "RENI++ trainer step", top=8)


def check_reni_cuda_vs_cpu(card: str):
    """Phase 9 (second half): a 5-step chunk of the RENI trainer (4 skies
    at 16 px, 256 pixels a step, the canonical decoder) and a 5-step fit of
    3 skies at 32 px in chunks of 2 (the last padded) with the converted
    prior, on the card and on the CPU from the same params and draws.
    Tolerances (a float32 against float64 rehearsal on the CPU gave 3.3e-3,
    3.0e-4 and 1.1e-4 for the three trainer groups, 1.1e-7 for the fit):
    the losses and PSNRs to 1e-4 relative; the decoder to 1e-3 of each
    leaf's largest entry, the latents and log-variances to 1e-2, the fitted
    latents to 1e-4; the attention key biases, which take no gradient
    (softmax is shift invariant) and move by Adam-normalised rounding noise,
    by at most lr a step."""
    from neusky_torch.data.sky_generator import generate_sky_corpus
    from neusky_torch.engine.reni_trainer import RENITrainer, RENITrainerConfig, fit_latents_to_envmaps
    from neusky_torch.fields.reni import RENIField

    cfg = neusky_model_config(1, 1)
    tcfg = RENITrainerConfig(field=dataclasses.replace(cfg.illumination, fixed_decoder=False), pixels_per_step=256,
                             steps_per_call=5)
    corpus = generate_sky_corpus(4, width=16, seed=2)
    trainers = {dev: RENITrainer(tcfg, corpus, device=dev) for dev in ("cpu", "cuda")}
    draws = [trainers["cpu"].draw() for _ in range(5)]
    start = {k: v.detach().clone() for k, v in tree_items(trainers["cpu"].params)}
    with torch.no_grad():
        for k, v in tree_items(trainers["cuda"].params):
            v.copy_(start[k])
    hist = {dev: t.run(5, draws=[{k: v.to(dev) for k, v in d.items()} for d in draws])[-1]
            for dev, t in trainers.items()}
    got, want = dict(tree_items(trainers["cuda"].params)), dict(tree_items(trainers["cpu"].params))
    worst, bad = {}, []
    for k, w in want.items():
        g = got[k].detach().cpu()
        if k.endswith("/key/bias"):
            if not float((g - start[k]).abs().max()) <= 5 * tcfg.lr * 1.001:
                bad.append(k)
            continue
        group = "decoder" if k.startswith("decoder/") else k
        rel = float((g - w.detach()).abs().max() / w.detach().abs().max())
        worst[group] = max(worst.get(group, 0.0), rel)
        if rel > (1e-3 if group == "decoder" else 1e-2):
            bad.append((k, rel))
    loss_err = max(abs(hist["cuda"][k] - hist["cpu"][k]) / abs(hist["cpu"][k]) for k in ("recon", "kl", "total"))

    field = RENIField(cfg.illumination)
    decoder = load_illumination_prior({"illumination_decoder": field.init(torch.Generator(), "cpu")}, cfg,
                                      init_latent=False)["illumination_decoder"]
    skies = generate_sky_corpus(3, width=32, seed=5)
    pix = [np.random.default_rng(i).integers(0, 512, (5, 256)) for i in range(2)]
    fits = {dev: fit_latents_to_envmaps(field, tree_map(lambda t: t.to(dev), decoder), skies, steps=5,
                                        pixels_per_step=256, sky_chunk=2, pixel_draws=pix) for dev in ("cpu", "cuda")}
    (z_c, p_c), (z_g, p_g) = fits["cpu"], fits["cuda"]
    z_err = float(np.abs(z_g - z_c).max() / np.abs(z_c).max())
    p_err = float(np.abs(p_g - p_c).max() / np.abs(p_c).max())
    log(f"small RENI trainer chunk and envmap fit on the card vs the CPU ({card}): losses {loss_err:.3g} relative, "
        f"params by group " + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
        + f"; fitted latents {z_err:.3g} of scale, PSNRs {p_err:.3g} relative")
    check(not bad and loss_err <= 1e-4 and z_err <= 1e-4 and p_err <= 1e-4,
          f"the RENI trainer or the envmap fit on the card differs from the CPU: {bad}")


# ---------------------------------------------------------------------------
# phase 10: the configuration JAX's bench measures


BENCH_KNOBS = {"NEUSKY_BF16_MAPPING": "1"}  # bench.py:85
# (b): every knob this slice ports turned on, with the level-set query chunked
ALL_SLICE_KNOBS = {**BENCH_KNOBS, "NEUSKY_FUSED_GT": "1", "NEUSKY_VIS_REMAT": "dots", "NEUSKY_FILM_HEADS": "1",
                   "NEUSKY_BENCH_BF16": "1"}
SDF_QUERY_CHUNK = 16384  # the level-set query's 1,024 × 64 points in 4 launches
BENCH_WARMUP, BENCH_STEPS = 3, 4
SPLIT_AB_STEPS = 12  # timed steps of each run of split_ab
# the variables knobs_set controls: the model knobs and the bench's own
BENCH_ENV = (*env_overrides.KNOBS, "NEUSKY_BENCH_NATIVE", "NEUSKY_BENCH_SPLIT")


@contextlib.contextmanager
def knobs_set(knobs):
    """Exactly ``knobs`` among the :data:`BENCH_ENV` variables inside the
    block; the environment as it was after it."""
    saved = {k: os.environ.pop(k, None) for k in BENCH_ENV}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k in BENCH_ENV:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def run_bench_config(label: str, knobs, sdf_query_chunk: int, card: str, split: bool = False, save_to=None,
                     steps: int = BENCH_STEPS):
    """The port's bench (``neusky_torch.bench.build``, what ``bench.py:85-118``
    builds) with ``knobs`` set (and restored after), the level-set query in
    chunks of ``sdf_query_chunk`` points, and with ``split`` the split step
    (``NEUSKY_BENCH_SPLIT``).  BENCH_WARMUP steps, then ``steps`` timed
    steps (each synchronised, on a fresh batch); K1's count zeroed before
    and read after every step; then one step keeping K1's inputs and one
    profiled step; with ``save_to`` the checkpoint is written there."""
    with knobs_set({**knobs, **({"NEUSKY_BENCH_SPLIT": "1"} if split else {})}):
        cfg = dataclasses.replace(bench.model_config(), sdf_query_chunk=sdf_query_chunk)
        log(f"{label}: knobs " + json.dumps(env_overrides.knob_summary()) + f", sdf_query_chunk {sdf_query_chunk}; "
            "effective " + json.dumps(env_overrides.effective_summary(cfg)))
        b = bench.build("cuda", cfg)
        n_rays, n_counted = 8 * 128, b.rays_per_step
        expected = expected_launches_per_step(cfg, b.pipeline, n_rays)
        history = []

        def train_step(step_fn=b.step):
            s = len(history)
            aux = step_fn(b.params, b.datamanager.next_train(s), float(s), generator=b.generator)
            history.append({"step": s + 1, "total_loss": float(aux["total_loss"]),
                            **{k: float(v) for k, v in aux["metrics"].items()},
                            **{k: float(v) for k, v in aux["loss_dict"].items()}})
            return history[-1]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches[k1.KERNEL_NAME] = 0
        per_step, times = [], []
        for s in range(BENCH_WARMUP + steps):
            before = k1_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = train_step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step.append(k1_launches() - before)
            bad = {k: v for k, v in rec.items() if isinstance(v, float) and not math.isfinite(v)}
            check(not bad, f"{label} step {s}: non-finite {bad}")
            log(f"{label} step {s}{' (warm-up)' if s < BENCH_WARMUP else ''}: {times[-1] * 1e3:.1f} ms; K1 launches "
                f"{per_step[-1]}; total loss {rec['total_loss']:.6f}")
        launches = k1_launches()
        check(per_step == [expected] * len(per_step), f"{label}: K1 launches per step {per_step}, expected {expected}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = float(np.mean(times[BENCH_WARMUP:]))
        log(f"{label} steady step (mean of {steps} after {BENCH_WARMUP} warm-up): {steady * 1e3:.3f} ms, "
            f"{n_rays / steady:.1f} scene rays/s, {n_counted / steady:.1f} counted rays/s; peak device memory "
            f"{peak:.3f} GiB ({card})")
        capture_s = b.step.captured.capture_s
        log(f"{label} step captured as a CUDA graph in {capture_s:.3f} s ({card})")
        eager = (mesh_mod.make_train_step_split if split else mesh_mod.make_train_step)(
            b.model, b.pipeline, b.optimizer, graphed=False)
        captured = capture_k1_inputs(lambda: train_step(eager))
        prof = profile_call(train_step, steady, card, f"{label} step")
        sites = check_k1_main_path_inputs(cfg, b.pipeline, n_rays, captured)
        if save_to is not None:
            save_checkpoint(Path(save_to), len(history), b.params, b.optimizer.state_dict())
        del captured, b
    return {"label": label, "steady_ms": steady * 1e3, "capture_s": capture_s, "scene_rays_per_s": n_rays / steady,
            "counted_rays_per_s": n_counted / steady, "peak_gib": peak, "k1_per_step": expected,
            "k1_launches": launches, "busy_share": prof and prof["busy_share"],
            "device_ms": prof and prof["device_ms"], "matmul_ms": prof and prof["by_kind_ms"].get("matmul", 0.0),
            "k1_ms_per_step": sum(r["ms"] for r in sites), "k1_bound_ms_per_step": sum(r["bound_ms"] for r in sites),
            "k1_index_add_ms_per_step": sum(r["library_ms"] for r in sites), "sites": sites, "history": history}


def run_bench_path(card: str):
    """Phase 10: a small card-against-CPU step of (b), then (a) JAX's bench
    configuration and (b) the same with every knob this slice ports."""
    t0 = time.perf_counter()
    check_step_cuda_vs_cpu(joint=True, knobs=ALL_SLICE_KNOBS, sdf_query_chunk=512)
    runs = [run_bench_config("bench (a)", BENCH_KNOBS, 0, card),
            run_bench_config("bench (b)", ALL_SLICE_KNOBS, SDF_QUERY_CHUNK, card)]
    log("bench configurations " + json.dumps([{k: v for k, v in r.items() if k not in ("sites", "history")}
                                              for r in runs]))
    log(f"phase 10 took {time.perf_counter() - t0:.3f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 11: the tools around a trained scene


SANITY_STEPS, SANITY_LOG_EVERY = 24, 8
SANITY_ARGS = [str(SANITY_STEPS), str(SANITY_LOG_EVERY), "--eval-images", "2", "--eval-fit-steps", "30"]
GT_STEPS = 4
VARIANTS = {
    "gt_probe": lambda c: dataclasses.replace(c, gt_illumination_probe=True),
    "blinn_phong": lambda c: dataclasses.replace(c, sdf_field=dataclasses.replace(c.sdf_field, predict_shininess=True)),
}
PRIOR_INIT_ARGS = ["--num-skies", "8", "--width", "64", "--steps", "100"]


def counted(fn):
    """(fn(), seconds, K1 launches) with K1's count zeroed before and the
    card idle before and after."""
    torch.cuda.synchronize()
    k1.launches[k1.KERNEL_NAME] = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, k1_launches()


def run_sanity_counted(argv, label: str):
    """``train_sanity`` (its ``build_run`` and ``run_sanity``, stdout kept)
    with K1's count and the host clock read after every step's update and
    around the boundary eval and the shadow map → (the run, the JSON lines
    it printed, per-step launches, per-step seconds, launches in the eval
    and the shadow map, peak device GiB, wall seconds)."""
    from neusky_torch.tools import train_sanity

    steps, stamps, phases = [], [], {}
    wrapped = {name: getattr(train_sanity, name) for name in ("boundary_eval", "shadow_map")}

    def on_step(i, aux):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        steps.append(k1_launches())

    def around(name):
        def run(*a, **kw):
            before = k1_launches()
            out = wrapped[name](*a, **kw)
            torch.cuda.synchronize()
            phases[name] = phases.get(name, 0) + k1_launches() - before
            return out
        return run

    for name in wrapped:
        setattr(train_sanity, name, around(name))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            run = train_sanity.build_run(train_sanity.parse_args(argv))
            k1.launches[k1.KERNEL_NAME] = 0
            t_train = time.perf_counter()
            rc = train_sanity.run_sanity(run, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in wrapped.items():
            setattr(train_sanity, name, fn)
    check(rc == 0, f"{label}: exit code {rc}")
    per_step = [n - (steps[i - 1] if i else 0) for i, n in enumerate(steps)]
    gaps = np.diff([t_train] + stamps)
    lines = [json.loads(x) for x in text.getvalue().strip().splitlines() if x.startswith("{")]
    return run, lines, per_step, gaps, phases, torch.cuda.max_memory_allocated() / 2**30, wall


def check_shadow_map_cuda_vs_cpu(card: str):
    """The shadow map of a 16×16 view (sun at azimuth 30°, elevation 50°;
    threshold 0 and sigmoid scale 5, so the untrained DDF's visibility is
    not saturated) of the small joint configuration of phase 3 from the same
    params on the card and on the CPU: within the DDF's bound of phase 3,
    5e-3 (its bf16-rounded FiLM inputs)."""
    from neusky_torch.engine.render_features import render_shadow_map

    cfg, _ = small_configs(joint=True)
    params0 = NeuSkyModel(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    cams = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=16, height=16))["cameras"]
    got = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda x: x.detach().clone().to(dev), params0)
        got[dev] = render_shadow_map(NeuSkyModel(cfg, device=dev), params, cams.to(dev).generate_rays(1),
                                     azimuth_deg=30.0, elevation_deg=50.0, threshold=0.0, sigmoid_scale=5.0)
    want, card_out = got["cpu"], got["cuda"]
    err = {k: float(np.abs(card_out[k] - want[k]).max()) for k in want}
    log(f"small shadow map on the card vs the CPU ({card}): max abs diff " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in err.items()}) + f"; shadow mean {card_out['shadow_map'].mean():.4f}")
    check(max(err.values()) <= 5e-3, "the shadow map on the card differs from the CPU")


def run_tools_path(card: str):
    """Phase 11: see the module docstring."""
    from neusky_torch import cli
    from neusky_torch.core.colour import sRGB_to_linear
    from neusky_torch.core.spherical import look_at_target
    from neusky_torch.engine.render_features import AnimationConfig, render_illumination_animation, render_shadow_probe
    from neusky_torch.tools import eval_from_ckpt, fit_prior_init_latent, render_animation, render_from_ckpt
    from neusky_torch.utils.profiling import trace_context
    from neusky_torch.utils.viz import load_png
    from neusky_torch.viewer import MODES, ViewerState, make_handler

    t_phase = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 1. the canonical recipe at full width, with bench's knob
        ckpt = tmp / "sanity"
        with knobs_set(BENCH_KNOBS):
            run, lines, per_step, gaps, phases, peak, walls["train_sanity"] = run_sanity_counted(
                SANITY_ARGS + ["--ckpt-dir", str(ckpt), "--shadow-out", str(tmp / "shadow.png"),
                               "--out", str(tmp / "sanity.jsonl")], "train_sanity")
        expected = expected_launches_per_step(run.cfg, run.pipeline)
        check(expected == 7 and per_step == [expected] * SANITY_STEPS,
              f"train_sanity: K1 launches per step {per_step}, expected {expected}")
        check(phases == {"boundary_eval": 0, "shadow_map": 0}, f"train_sanity: K1 launches outside the steps {phases}")
        records = [r for r in lines if "total_loss" in r]
        evals = [r for r in lines if "eval_at" in r]
        check([r["step"] for r in records] == [1, 8, 16, 24] and all(
            math.isfinite(v) for r in records for v in r.values() if isinstance(v, float)), f"records {records}")
        check(len(evals) == 1 and evals[0]["eval_at"] == SANITY_STEPS and all(
            math.isfinite(p) for p in evals[0]["eval_psnr"]), f"eval records {evals}")
        check((ckpt / "latest.json").exists() and json.loads((ckpt / "latest.json").read_text())["step"] == SANITY_STEPS,
              "train_sanity wrote no checkpoint")
        check(load_png(str(tmp / "shadow.png")).shape == (64, 64, 3), "the shadow PNG does not decode")
        steady = float(np.mean(gaps[2:]))
        log(f"train_sanity ({card}): {SANITY_STEPS} steps of the canonical recipe (NEUSKY_BF16_MAPPING=1) in "
            f"{walls['train_sanity']:.3f} s wall (set-up, the boundary eval of 2 images with a 30-step fit and the "
            f"shadow map included); steady {steady * 1e3:.3f} ms a step (steps 3..{SANITY_STEPS}, each synchronised, "
            f"min {gaps[2:].min() * 1e3:.3f}, max {gaps[2:].max() * 1e3:.3f}); peak device memory {peak:.3f} GiB; K1 "
            f"launches per step {per_step[0]} x {len(per_step)}, boundary eval {phases['boundary_eval']}, shadow map "
            f"{phases['shadow_map']}; first / last record " + json.dumps(records[0]) + " / " + json.dumps(records[-1])
            + "; eval " + json.dumps(evals[0]))

        # 2. the GT-illumination probe
        with knobs_set(BENCH_KNOBS):
            gt_run, gt_lines, gt_steps, _, _, _, walls["train_sanity --gt-illumination"] = run_sanity_counted(
                [str(GT_STEPS), "1", "--gt-illumination"], "train_sanity --gt-illumination")
        table = gt_run.params["gt_probe_illumination"]["log_light"].detach()
        start = torch.log(torch.clamp(sRGB_to_linear(torch.tensor(gt_run.cfg.gt_probe_background, device=table.device)),
                                      min=1e-4))
        gt_records = [r for r in gt_lines if "total_loss" in r]
        check(gt_steps == [expected] * GT_STEPS, f"train_sanity --gt-illumination: K1 launches per step {gt_steps}")
        check(len(gt_records) == GT_STEPS and all(math.isfinite(r["total_loss"]) for r in gt_records),
              f"gt records {gt_records}")
        moved = float((table - start).abs().max())
        check(moved > 0, "the GT-probe table did not move")
        log(f"train_sanity --gt-illumination ({card}): {GT_STEPS} steps in {walls['train_sanity --gt-illumination']:.3f}"
            f" s wall; K1 launches per step {gt_steps}; table moved by up to {moved:.3g}; total loss "
            + " -> ".join(f"{r['total_loss']}" for r in gt_records) + f"; psnr {gt_records[-1]['psnr']}")
        del gt_run

        # 3. evaluation and renders from the checkpoint
        with knobs_set(BENCH_KNOBS), contextlib.redirect_stdout(io.StringIO()):
            res, walls["eval_from_ckpt"], n_eval = counted(lambda: eval_from_ckpt.main(
                ["--ckpt-dir", str(ckpt), "--fit-steps", "30", "--out", str(tmp / "eval.json")]))
        with contextlib.redirect_stdout(io.StringIO()):
            rec, walls["render_from_ckpt"], n_render = counted(lambda: render_from_ckpt.main(
                [str(ckpt), "--out-prefix", str(tmp / "render")]))
        check(n_eval == 0 and n_render == 0, f"K1 launched {n_eval} / {n_render} times in eval / render_from_ckpt")
        check(res["ckpt_step"] == SANITY_STEPS and all(math.isfinite(v) for v in res["mean"].values()),
              f"eval_from_ckpt {res['mean']}")
        check(all(math.isfinite(v) for v in rec.values()) and load_png(str(tmp / "render_shadow.png")).shape
              == (64, 64, 3), f"render_from_ckpt {rec}")
        log(f"eval_from_ckpt ({card}): {walls['eval_from_ckpt']:.3f} s wall (30-step fit, 2 renders of 64x64 with "
            f"GT-layer metrics); K1 launches {n_eval}; mean " + json.dumps({k: round(v, 4) for k, v in res["mean"].items()}))
        log(f"render_from_ckpt ({card}): {walls['render_from_ckpt']:.3f} s wall; K1 launches {n_render}; "
            + json.dumps(rec))

        # 4. animations: the library call on the recipe's camera 0 (64x64),
        # then the tool's three commands on a cli run of the synthetic demo
        rb0 = run.dm.train_cameras.generate_rays(0)
        seq, walls["render_illumination_animation"], n_anim = counted(lambda: render_illumination_animation(
            run.model, run.params, rb0, 0, AnimationConfig(num_frames=4, output_dir=str(tmp / "rot"))))
        check(n_anim == 0 and seq.shape == (4, 64 * 64, 3) and np.isfinite(seq).all()
              and np.abs(seq[1] - seq[0]).max() > 0, f"illumination animation {seq.shape}, K1 {n_anim}")
        log(f"render_illumination_animation ({card}): 4 frames of 64x64 in {walls['render_illumination_animation']:.3f}"
            f" s; K1 launches {n_anim}; frame 0 vs 1 max diff {np.abs(seq[1] - seq[0]).max():.4f}")
        cli_run = tmp / "cli_run"
        with contextlib.redirect_stdout(io.StringIO()):
            _, walls["cli train neusky --synthetic-demo (2 steps)"], n_cli = counted(lambda: cli.main(
                ["train", "neusky", "--synthetic-demo", "--max-iterations", "2", "--output-dir", str(cli_run)]))
        check(n_cli == 2 * expected, f"cli train: K1 launches {n_cli}")
        frames = [{"camera_to_world": c2w.reshape(-1).tolist(), "fov": 50.0}
                  for c2w in look_at_target(np.asarray([[1.2, 0.2, 0.4], [-0.3, 1.1, 0.5]], np.float32),
                                            np.zeros((2, 3)))]
        (tmp / "path.json").write_text(json.dumps({"render_height": 64, "render_width": 64, "camera_path": frames}))
        common = ["--load-dir", str(cli_run), "--method", "neusky", "--out", str(tmp / "anim")]
        for name, argv, want in (
                ("illumination-rotation", ["--frames", "4"], {"frames": 4}),
                ("camera-path", [str(tmp / "path.json"), "--height", "64", "--width", "64"], {"frames": 2}),
                ("envmaps", [], {"envmaps": 8})):
            with contextlib.redirect_stdout(io.StringIO()):
                out, walls[f"render_animation {name}"], n = counted(lambda: render_animation.main([name, *argv, *common]))
            check(n == 0 and {k: out[k] for k in want} == want, f"render_animation {name}: {out}, K1 {n}")
            log(f"render_animation {name} ({card}): {walls[f'render_animation {name}']:.3f} s wall (the run's load "
                f"included); K1 launches {n}; " + json.dumps(out))
        with np.load(tmp / "anim" / "render_sequence.npz") as z:
            check(z["rgb"].shape == (4, 48 * 48, 3) and np.isfinite(z["rgb"]).all(), "rotation sequence")
        with np.load(tmp / "anim" / "sequence.npz") as z:
            check(z["rgb"].shape == (2, 64, 64, 3) and np.isfinite(z["rgb"]).all(), "camera-path sequence")
        check(np.isfinite(np.load(tmp / "anim" / "envmap_007_hdr.npy")).all(), "envmap")

        # 5. the sky-visibility probe at a point on the sphere
        probe, walls["render_shadow_probe"], n_probe = counted(lambda: render_shadow_probe(
            run.model, run.params, np.array([0.41, 0.0, 0.05], np.float32), side_length=64))
        check(n_probe == 0 and probe.shape == (32, 64) and np.isfinite(probe).all()
              and 0.0 <= probe.min() and probe.max() <= 1.0, f"probe {probe.shape}")
        log(f"render_shadow_probe ({card}): 32x64 in {walls['render_shadow_probe']:.3f} s; K1 launches {n_probe}; "
            f"visible share {float((probe > 0.5).mean()):.4f}")

        # 6. the viewer: every mode and one probe over HTTP, on the recipe's model
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(ViewerState(run.model, run.params)))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        gets = {}
        try:
            k1.launches[k1.KERNEL_NAME] = 0
            for name in (*MODES, "probe"):
                path = "/probe?px=0.5&py=0.5" if name == "probe" else f"/render?mode={name}"
                t0 = time.perf_counter()
                body = urllib.request.urlopen(f"{url}{path}&az=30&el=20&dist=1.2", timeout=300).read()
                gets[name] = time.perf_counter() - t0
                (tmp / "view.png").write_bytes(body)
                shape = load_png(str(tmp / "view.png")).shape
                check(shape == ((64, 128, 3) if name == "probe" else (512, 512, 3)), f"viewer {name}: {shape}")
            n_view = k1_launches()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive() and n_view == 0, f"viewer: K1 launches {n_view}")
        walls["viewer (9 GETs)"] = sum(gets.values())
        log(f"viewer ({card}): 8 modes and a probe at 96x96 over HTTP, ms a GET " + json.dumps(
            {k: round(t * 1e3, 1) for k, t in gets.items()}) + f"; K1 launches {n_view}")

        # 7. the prior's init latent, on the bundled prior
        prior = tmp / "reni_prior_variational"
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc, walls["fit_prior_init_latent"], n_prior = counted(lambda: fit_prior_init_latent.main(
                ["--prior", str(prior), *PRIOR_INIT_ARGS]))
        stats = json.loads([x for x in text.getvalue().splitlines() if x.startswith("{")][-1])
        with np.load(prior / "reni_prior.npz") as z:
            init = z["init_latent"] if rc == 0 else None
        check(rc == 0 and n_prior == 0 and init.shape == (100, 3) and np.isfinite(init).all(),
              f"fit_prior_init_latent: exit {rc}, K1 {n_prior}, {stats}")
        log(f"fit_prior_init_latent ({card}): {' '.join(PRIOR_INIT_ARGS)} on the bundled prior in "
            f"{walls['fit_prior_init_latent']:.3f} s wall; K1 launches {n_prior}; " + json.dumps(stats))

        # 8. a trace of two recipe steps
        def two_steps():
            with trace_context(str(tmp / "trace")):
                for i in range(2):
                    run.step_fn(run.params, run.dm.next_train(i), float(SANITY_STEPS + i), None, run.generator)
        _, walls["trace_context (2 steps)"], n_trace = counted(two_steps)
        traces = list((tmp / "trace").glob("trace_*.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(n_trace == 2 * expected and kernels, f"trace: {len(traces)} files, {len(kernels)} kernel events, "
              f"K1 {n_trace}")
        log(f"trace_context ({card}): 2 steps traced in {walls['trace_context (2 steps)']:.3f} s (export included), "
            f"{traces[0].stat().st_size / 2**20:.1f} MiB, {len(kernels)} kernel events; K1 launches {n_trace}")
        del run

    check_step_cuda_vs_cpu(joint=True, variant="gt_probe")
    check_step_cuda_vs_cpu(joint=True, variant="blinn_phong")
    check_shadow_map_cuda_vs_cpu(card)
    log("phase 11 wall seconds " + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    log(f"phase 11 took {time.perf_counter() - t_phase:.3f} s")


# ---------------------------------------------------------------------------
# phase 12: the split step, the model variants and the diagnostic tools


SPLIT_GROUPS = ("proposal_networks", "fields", "illumination_field", "visibility_sigmoid", "ddf_field")
DDF_VARIANT_STEPS = 10
RENI_VARIANT_STEPS = 5
SKY_DIRECTIONS, SKY_LATENTS = 492, 8
TOOL_STEPS = 4


def check_split_vs_fused_on_card(card: str):
    """Phase 12 (a): one step of the small joint configuration of phase 3,
    fused and split, on the card from the same params, batch and draws:
    the same K1 launches, the total loss to 1e-4 relative and the
    parameters after the update to 1e-5 absolute (JAX's bounds,
    ``tests/test_train_e2e.py:343-345``).  Adam's first update is
    ±lr·sign(g), so an entry whose gradient is within 1e-3 of its array's
    scale of zero may take the other sign (2·lr): the CPU tests' rule
    (``tests/test_torch_split_step.py``)."""
    from neusky_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig
    from neusky_torch.parallel.mesh import make_train_step, make_train_step_split

    cfg, pcfg = small_configs(joint=True)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device="cuda")
    batch = dm.next_train(0)
    model = NeuSkyModel(cfg, device="cuda")
    params0 = model.init(torch.Generator(device="cuda").manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(4)
    draws = model.draw(None, gen, batch["pixel_coords"].shape[0])
    draws["ddf"] = draw_ddf_fit(model, pcfg, None, gen)
    lr = 1e-3
    out = {}
    for name, make in (("fused", make_train_step), ("split", make_train_step_split)):
        params = tree_map(lambda x: x.detach().clone(), params0)
        opt = GroupedAdam(params, {g: OptimizerGroupConfig(lr=lr, schedule="constant", max_steps=10)
                                   for g in SPLIT_GROUPS})
        before = k1_launches()
        aux = make(model, pcfg, opt)(params, batch, 10.0, _to(draws, "cuda"))
        torch.cuda.synchronize()
        out[name] = (float(aux["total_loss"]), dict(tree_items(params)), k1_launches() - before)
    (tf, pf, kf), (ts, ps, ks) = out["fused"], out["split"]
    worst, bad = 0.0, []
    for k, v in pf.items():
        diff = (ps[k].detach() - v.detach()).abs()
        if v.grad is None:
            if float(diff.max()) != 0.0:
                bad.append(k)
            continue
        g = v.grad.abs()
        flip_ok = g <= 1e-3 * g.max()
        worst = max(worst, float(diff[~flip_ok].max()) if bool((~flip_ok).any()) else 0.0)
        if bool(((diff > 1e-5) & ~flip_ok).any()) or float(diff.max()) > 2 * lr + 1e-5:
            bad.append((k, float(diff.max())))
    log(f"split vs fused step on the card ({card}): total {ts:.6f} vs {tf:.6f}; K1 launches {ks} vs {kf}; "
        f"worst parameter difference after the update {worst:.3g} (outside sign flips of near-zero gradients)")
    check(kf == ks == expected_launches_per_step(cfg, pcfg, batch["pixel_coords"].shape[0]),
          f"K1 launches fused {kf}, split {ks}")
    check(math.isfinite(ts) and abs(ts - tf) <= 1e-4 * abs(tf) and not bad,
          f"the split step differs from the fused step on the card: {ts} vs {tf}; {bad}")


def ddf_variant(cfg):
    """The DDF with ``Attention`` conditioning and the ``sh`` position
    encoding, at the ``DDFFieldConfig`` widths of the attention decoder."""
    field = dataclasses.replace(cfg.ddf.field, conditioning="Attention", position_encoding_type="sh")
    return dataclasses.replace(cfg, ddf=dataclasses.replace(cfg.ddf, field=field))


def check_ddf_variant_cuda_vs_cpu(card: str):
    """Phase 12 (b): one DDF trainer step of the Attention / ``sh`` DDF on
    the small configuration of phase 3 (2 × 16 vMF rays, 8 sky rays) on the
    card and on the CPU from the same params and draws: the loss to 1e-4
    relative and every DDF gradient to phase 3's DDF bound, 5e-3 of its
    array's scale."""
    from neusky_torch.engine.ddf_trainer import DDFTrainer, DDFTrainerConfig

    cfg, _ = small_configs(joint=True)
    cfg = ddf_variant(cfg)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    params0 = NeuSkyModel(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    tcfg = DDFTrainerConfig(max_num_iterations=10, sampler=DDFSamplerConfig(
        num_samples_on_sphere=2, num_rays_per_sample=16, only_sample_upper_hemisphere=True, concentration=20.0),
        num_sky_rays=8)
    out, draws = {}, None
    for dev in ("cpu", "cuda"):
        dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                         scene["cameras"], scene["images"], scene["masks"], device=dev)
        trainer = DDFTrainer(tcfg, NeuSkyModel(cfg, device=dev), tree_map(lambda x: x.to(dev), params0),
                             datamanager=dm)
        draws = trainer.draw() if draws is None else draws
        for _, v in tree_items(trainer.ddf_params):
            v.requires_grad_(True)
        before = k1_launches()
        d = trainer.draw_step(_to(draws, dev))
        total, _ = trainer.loss(d, trainer.sky_rays(d))
        total.backward()
        out[dev] = (float(total.detach()), {k: v.grad.detach().cpu() for k, v in tree_items(trainer.ddf_params)},
                    k1_launches() - before)
    (lc, gc, _), (lg, gg, kg) = out["cpu"], out["cuda"]
    worst = max(float((gg[k] - gc[k]).abs().max() / gc[k].abs().max()) for k in gc if gc[k].abs().max() > 0)
    log(f"Attention/sh DDF trainer step on the card vs the CPU ({card}): loss {lg:.6f} vs {lc:.6f}; worst DDF "
        f"gradient {worst:.3g} of scale; K1 launches {kg}")
    check(kg == 0 and abs(lg - lc) <= 1e-4 * abs(lc) and worst <= 5e-3,
          f"the Attention/sh DDF step on the card differs from the CPU: {lg} vs {lc}, {worst}")


def run_ddf_variant(card: str):
    """Phase 12 (b): the DDF trainer with the Attention / ``sh`` DDF of the
    canonical configuration (hidden 256, 8 heads, 6 layers) against a
    frozen scene (seed-0 weights, the converted prior): 8 × 128 vMF rays at
    κ = 20 and 256 sky rays a step for DDF_VARIANT_STEPS steps, K1 0; then
    ``ddf_predicted_normals`` of the trained DDF on 1,024 vMF rays on the
    card against the CPU (5e-3, phase 3's DDF bound: the normal is a
    normalised gradient of the DDF)."""
    from neusky_torch.engine.ddf_trainer import DDFTrainer, DDFTrainerConfig
    from neusky_torch.models.ddf_model import ddf_predicted_normals
    from neusky_torch.sampling.ddf_sampler import vmf_ddf_samples

    cfg = ddf_variant(neusky_model_config(8, 2))
    f = cfg.ddf.field
    model = NeuSkyModel(cfg, device="cuda")
    params = load_illumination_prior(model.init(torch.Generator(device="cuda").manual_seed(0)), cfg)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=64, height=64))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128),
                                       num_sky_rays=256), scene["cameras"], scene["images"], scene["masks"],
                     device="cuda")
    trainer = DDFTrainer(DDFTrainerConfig(max_num_iterations=DDF_VARIANT_STEPS, steps_per_log=1), model, params,
                         datamanager=dm)
    start = {k: v.detach().clone() for k, v in tree_items(trainer.ddf_params)}
    times = []
    k1.launches[k1.KERNEL_NAME] = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(DDF_VARIANT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, peak = k1_launches(), torch.cuda.max_memory_allocated() / 2**30
    hist = trainer.history
    check(all(math.isfinite(v) for r in hist for v in r.values()), f"Attention/sh DDF: non-finite {hist[-1]}")
    moved = any(not torch.equal(start[k], v.detach()) for k, v in tree_items(trainer.ddf_params))
    check(launches == 0 and moved, f"Attention/sh DDF: K1 launches {launches}, DDF moved {moved}")
    log(f"Attention/sh DDF trainer ({card}): conditioning {f.conditioning}, {f.hidden_features} hidden, "
        f"{f.num_attention_heads} heads, {f.num_attention_layers} layers; {DDF_VARIANT_STEPS} steps, median "
        f"{float(np.median(times)) * 1e3:.3f} ms a step (first {times[0] * 1e3:.3f} ms), peak {peak:.3f} GiB; K1 "
        f"launches {launches}; depth PSNR {hist[0]['depth_psnr']:.4f} -> {hist[-1]['depth_psnr']:.4f}")

    bundle = vmf_ddf_samples(trainer.config.sampler, trainer.draw()["vmf"], ddf_sphere_radius=cfg.ddf_radius)
    o, d = bundle.origins, bundle.directions
    n_card, secs, _ = measured(lambda: ddf_predicted_normals(model.ddf, trainer.ddf_params, o, d))
    cpu_model = NeuSkyModel(cfg, device="cpu")
    n_cpu = ddf_predicted_normals(cpu_model.ddf, tree_map(lambda t: t.detach().cpu(), trainer.ddf_params),
                                  o.cpu(), d.cpu())
    err = float((n_card.cpu() - n_cpu).abs().max())
    unit = float((torch.linalg.norm(n_card, dim=-1) - 1.0).abs().max())
    log(f"ddf_predicted_normals on {o.shape[0]} rays ({card}): {secs * 1e3:.3f} ms; card vs CPU max |diff| {err:.3g}, "
        f"unit norm to {unit:.3g}")
    check(o.shape[0] == 1024 and err <= 5e-3 and unit <= 1e-4, f"normals on the card differ from the CPU: {err}")


def run_reni_variants(card: str):
    """Phase 12 (c): the RENI trainer with the FiLM and the Concat decoder
    at the ``RENIFieldConfig`` widths (latent 100; FiLM-SIREN 9 × 128 with
    a 5 × 128 mapping network; SIREN 9 × 128), only ``conditioning``
    changed, on 16 skies at 64 px, 2,048 pixels a step: a first chunk of
    RENI_VARIANT_STEPS steps, then RENI_VARIANT_STEPS timed; K1 0, finite
    losses, the decoder moves."""
    from neusky_torch.data.sky_generator import generate_sky_corpus
    from neusky_torch.engine.reni_trainer import RENITrainer, RENITrainerConfig

    corpus = generate_sky_corpus(16, width=64, seed=3)
    for cond in ("FiLM", "Concat"):
        tcfg = RENITrainerConfig(field=dataclasses.replace(RENITrainerConfig().field, conditioning=cond),
                                 steps_per_call=RENI_VARIANT_STEPS)
        trainer = RENITrainer(tcfg, corpus, device="cuda")
        start = {k: v.detach().clone() for k, v in tree_items(trainer.params["decoder"])}
        trainer.run(RENI_VARIANT_STEPS)
        torch.cuda.reset_peak_memory_stats()
        hist, secs, launches = counted(lambda: trainer.run(RENI_VARIANT_STEPS))
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = hist[-1]
        moved = any(not torch.equal(start[k], v.detach()) for k, v in tree_items(trainer.params["decoder"]))
        n_params = sum(v.numel() for _, v in tree_items(trainer.params["decoder"]))
        log(f"RENI {cond} decoder ({card}): {n_params} decoder parameters; {RENI_VARIANT_STEPS} steps of 2048 pixels "
            f"in {secs * 1e3:.3f} ms ({secs / RENI_VARIANT_STEPS * 1e3:.3f} ms a step, after a first chunk), peak "
            f"{peak:.3f} GiB; K1 launches {launches}; recon {rec['recon']:.5f}, kl {rec['kl']:.5f}")
        check(launches == 0 and moved and all(math.isfinite(rec[k]) for k in ("recon", "kl", "total")),
              f"RENI {cond}: K1 {launches}, decoder moved {moved}, {rec}")


def run_alternative_fields(card: str):
    """Phase 12 (d): the SH (4 levels), SG (42 lobes: the order-2
    icosphere; the default 24 has no field, in JAX as here) and envmap
    (64 × 128) sky fields and the icosphere encoding (4 levels of 2
    features, orders 1–4, 3 neighbours) on the card against the CPU, at the
    492 light directions × 8 latents: each latent shared by all directions,
    and per direction with per-direction rotations and scales; to 1e-5 of
    scale (1e-4 for the envmap, whose bilinear weights come from arccos and
    arctan2)."""
    from neusky_torch.core.spherical import icosphere_vertices
    from neusky_torch.fields import illumination_alternatives as alt
    from neusky_torch.ops.icosphere_encoding import IcosphereEncoding, IcosphereEncodingConfig
    from neusky_torch.sampling.illumination import icosphere_order_for

    g = torch.Generator().manual_seed(7)
    dirs = torch.from_numpy(icosphere_vertices(icosphere_order_for(SKY_DIRECTIONS)))
    check(dirs.shape[0] == SKY_DIRECTIONS, f"{dirs.shape[0]} light directions")
    m = SKY_DIRECTIONS * SKY_LATENTS
    rot = torch.linalg.qr(torch.randn((m, 3, 3), generator=g))[0]
    scale = 1.0 + 0.1 * torch.randn((m,), generator=g)
    fields = {"sh": (alt.SphericalHarmonicIlluminationField(), (16, 3)),
              "sg": (alt.SphericalGaussianField(sg_num=42), (42, 3)),
              "envmap": (alt.EnvironmentMapField(), (3, 64, 128))}
    report, walls = {}, {}
    for name, (field, shape) in fields.items():
        lat = 0.3 * torch.randn((SKY_LATENTS, *shape), generator=g)
        per_dir = lat.repeat_interleave(SKY_DIRECTIONS, dim=0)
        all_dirs = dirs.repeat(SKY_LATENTS, 1)

        def run(dev):
            shared = torch.cat([field.unnormalise(field(dirs.to(dev), lat[i].to(dev))["rgb"])
                                for i in range(SKY_LATENTS)])
            batched = field.unnormalise(field(all_dirs.to(dev), per_dir.to(dev), scale.to(dev), rot.to(dev))["rgb"])
            return torch.cat([shared, batched]).cpu()

        (got, walls[name], launches), want = counted(lambda: run("cuda")), run("cpu")
        report[name] = float((got - want).abs().max() / want.abs().max())
        check(launches == 0 and report[name] <= (1e-4 if name == "envmap" else 1e-5) and bool(torch.isfinite(got).all()),
              f"{name} sky field on the card differs from the CPU: {report[name]}")
    enc = IcosphereEncoding(IcosphereEncodingConfig())
    tables = enc.init(g, "cpu")
    d = torch.randn((m, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    got = enc([t.cuda() for t in tables], d.cuda()).cpu()
    want = enc(tables, d)
    report["icosphere_encoding"] = float((got - want).abs().max() / want.abs().max())
    log(f"alternative sky fields and the icosphere encoding on the card vs the CPU ({card}; {SKY_DIRECTIONS} "
        f"directions x {SKY_LATENTS} latents, {got.shape[1]} encoding features): max error of scale "
        + json.dumps({k: float(f"{v:.3g}") for k, v in report.items()}) + "; card seconds a field "
        + json.dumps({k: round(v, 4) for k, v in walls.items()}))
    check(report["icosphere_encoding"] <= 1e-5, f"icosphere encoding: {report['icosphere_encoding']}")


def run_diag_tools(card: str, ckpt: Path, tmp: Path, history):
    """Phase 12 (e): the six diagnostic tools on small inputs, K1's count
    zeroed before each and read after: ``analyze_run`` on the split run's
    records, ``prepare_nerfosr`` (``copy-masks`` and ``validate``) on a
    fixture, ``probe_sky_fit`` (100 steps), ``diagnose_ckpt`` and
    ``ab_ddf_encoding --encodings nerf,hash`` (TOOL_STEPS steps an arm) on
    the split run's checkpoint, ``prior_fit_sanity`` (TOOL_STEPS steps).
    K1 launches once per differentiated encode: 3 a hash DDF step (the
    vMF, multi-view and sky-ray queries), 7 a ``prior_fit_sanity`` step,
    0 elsewhere."""
    from neusky_torch.data.fixtures import make_nerfosr_fixture
    from neusky_torch.tools import (
        ab_ddf_encoding, analyze_run, diagnose_ckpt, prepare_nerfosr, prior_fit_sanity, probe_sky_fit,
    )

    walls, k1s = {}, {}

    def tool(name, fn):
        with contextlib.redirect_stdout(io.StringIO()) as text:
            out, walls[name], k1s[name] = counted(fn)
        return out, text.getvalue()

    runlog = tmp / "split_run.jsonl"
    runlog.write_text("".join(json.dumps({k: r[k] for k in ("step", "psnr", "ddf_depth_psnr", "s_val", "total_loss")})
                              + "\n" for r in history))
    _, text = tool("analyze_run", lambda: analyze_run.main([str(runlog), str(runlog)]))
    check(f"final: step {history[-1]['step']}," in text, f"analyze_run printed {text[-300:]}")

    data = tmp / "osr"
    make_nerfosr_fixture(data, num_sessions=2, train_per_session=2, width=16, height=12)
    masks = tmp / "masks" / "lk2"
    for split in ("train", "val", "test"):
        (masks / split / "cityscapes_mask").mkdir(parents=True)
        (masks / split / "cityscapes_mask" / "extra.png").write_bytes(b"")
    copied, _ = tool("prepare_nerfosr copy-masks",
                     lambda: prepare_nerfosr.main(["copy-masks", "lk2", str(tmp / "masks"), str(data)]))
    report, _ = tool("prepare_nerfosr validate", lambda: prepare_nerfosr.main(["validate", "lk2", str(data)]))
    check(copied == {"train": 1, "validation": 1, "test": 1} and report["ok"], f"prepare_nerfosr: {copied} {report}")

    probe, _ = tool("probe_sky_fit", lambda: probe_sky_fit.main(["--steps", "100"]))
    check(probe[-1]["step"] == 100 and probe[-1]["loss"] < probe[0]["loss_init"], f"probe_sky_fit: {probe}")

    diag, _ = tool("diagnose_ckpt", lambda: diagnose_ckpt.main([str(ckpt)]))
    check(len(diag) == 4 and math.isfinite(diag[3]["psnr"]) and math.isfinite(diag[0]["radius_est_mean"]),
          f"diagnose_ckpt: {diag}")

    fit, _ = tool("prior_fit_sanity", lambda: prior_fit_sanity.main([str(TOOL_STEPS), "2"]))
    check(math.isfinite(fit[-1]["final_image_psnr"]) and k1s["prior_fit_sanity"] == 7 * TOOL_STEPS,
          f"prior_fit_sanity: K1 {k1s['prior_fit_sanity']}, {fit[-1]}")

    arm_k1 = {}

    def count_arm(enc, trainer):
        run = trainer.run

        def counted_run(*a, **kw):
            before = k1_launches()
            out = run(*a, **kw)
            torch.cuda.synchronize()
            arm_k1[enc] = k1_launches() - before
            return out

        trainer.run = counted_run

    ab, _ = tool("ab_ddf_encoding", lambda: ab_ddf_encoding.main(
        ["--ckpt", str(ckpt), "--steps", str(TOOL_STEPS), "--log-every", "2", "--out", str(tmp / "ab.jsonl"),
         "--encodings", "nerf,hash"], on_trainer=count_arm))
    done = {r["arm"]: r for r in ab if r.get("event") == "done"}
    check(arm_k1 == {"nerf": 0, "hash": 3 * TOOL_STEPS}
          and all(math.isfinite(r["final_depth_psnr"]) for r in done.values()),
          f"ab_ddf_encoding: K1 launches by arm {arm_k1}, {done}")
    others = {k: v for k, v in k1s.items() if k not in ("prior_fit_sanity", "ab_ddf_encoding")}
    check(all(v == 0 for v in others.values()), f"K1 launched in a tool that trains nothing: {others}")
    log(f"diagnostic tools ({card}): wall seconds " + json.dumps({k: round(v, 3) for k, v in walls.items()})
        + "; K1 launches " + json.dumps(k1s) + " (ab_ddf_encoding by arm " + json.dumps(arm_k1) + ")")
    log("diagnose_ckpt records " + json.dumps(diag))
    log("ab_ddf_encoding ends " + json.dumps(list(done.values())) + "; prior_fit_sanity end " + json.dumps(fit[-1])
        + "; probe_sky_fit end " + json.dumps(probe[-1]))


def run_variants_path(card: str, fused_a):
    """Phase 12: (a) the split step at full width in bench's configuration
    (a), beside phase 10's fused (a) from this call, then a split-vs-fused
    step on the card; (b) the Attention / ``sh`` DDF; (c) the RENI FiLM and
    Concat decoders; (d) the alternative sky fields and the icosphere
    encoding; (e) the six diagnostic tools."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        split = run_bench_config("split (a)", BENCH_KNOBS, 0, card, split=True, save_to=tmp / "split_ckpt")
        check(split["k1_per_step"] == fused_a["k1_per_step"] == 7,
              f"K1 a step: split {split['k1_per_step']}, fused {fused_a['k1_per_step']}")
        keys = ("steady_ms", "busy_share", "device_ms", "peak_gib", "k1_per_step", "k1_ms_per_step")
        log("split step vs fused step, bench (a) " + json.dumps(
            {r["label"]: {k: r[k] for k in keys} for r in (fused_a, split)}) + f" ({card})")
        check_split_vs_fused_on_card(card)
        run_ddf_variant(card)
        check_ddf_variant_cuda_vs_cpu(card)
        run_reni_variants(card)
        run_alternative_fields(card)
        run_diag_tools(card, tmp / "split_ckpt", tmp, split["history"])
    log(f"phase 12 took {time.perf_counter() - t0:.3f} s")
    return split


def split_ab() -> int:
    """The split step against the fused step in turns in one process:
    bench's configuration (a) trained fused, split, split, fused, each
    BENCH_WARMUP + SPLIT_AB_STEPS steps with K1 counted every step, then a
    profiled step.  Prints each run's steady ms a step, device busy time
    and share, peak memory and K1 launches a step as one JSON line, then
    the card's ``nvidia-smi`` name and power limit.

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.split_ab())'
    """
    if not torch.cuda.is_available():
        print("split_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = bench.card_line()
    build_all()
    keys = ("label", "steady_ms", "busy_share", "device_ms", "peak_gib", "k1_per_step")
    runs = []
    for i, (label, split) in enumerate((("fused", False), ("split", True), ("split", True), ("fused", False))):
        r = run_bench_config(f"{label} (a) #{i}", BENCH_KNOBS, 0, card, split=split, steps=SPLIT_AB_STEPS)
        runs.append({k: r[k] for k in keys})
    print(json.dumps(runs))
    print(card)
    return 0


# ---------------------------------------------------------------------------
# phase 13: the multi-device path


MESH_WARMUP, MESH_STEPS = 3, 4
# label → (ranks, dirs, backend, check step, trainers).  The check step runs
# eagerly ("eager") or as a replay of the captured rank step ("replay");
# then ``Trainer(mesh=)`` trains with each of ``trainers``: "eager"
# (``graphed=False``) or "captured" (its default over NCCL).  (a)/(e) one
# NCCL rank on the one card, eager and captured in one process; (b) two
# gloo ranks sharing the card; (c) four, data × dirs = 2 × 2; (d) (c) over
# NCCL, a card a rank; (f) the 2 × 2 and data = 4 meshes captured.  (d) and
# (f) run where there are four cards.  (a)/(e)'s check step stays eager:
# capturing its 2,048 visibility chunks takes ~2 min on one rank
MESH_RUNS = {
    "(a)/(e)": (1, 1, "nccl", "eager", ("eager", "captured")),
    "(b)": (2, 1, "gloo", "eager", ("eager",)),
    "(c)": (4, 2, "gloo", "eager", ("eager",)),
    "(d)": (4, 2, "nccl", "eager", ("eager",)),
    "(f) 2x2": (4, 2, "nccl", "replay", ("captured",)),
    "(f) data4": (4, 1, "nccl", "replay", ("captured",)),
}
MESH_SAME_STATE_STEPS = 3  # captured: replay against eager step from one state
# phase 3's bounds: losses 1e-4, gradients 2e-3 of scale, the DDF's 5e-3
MESH_GRAD_REL = {"ddf_field": 5e-3}


def mesh_setup(device):
    """(config, pipeline, datamanager) of phase 13: the port's bench
    (``neusky_torch.bench``) under phase 10's (a) knobs: its model config,
    pipeline and data (the synthetic scene, 8 cameras at 64×64, 8 × 128
    rays and 256 sky rays a step from the native sampler)."""
    with knobs_set(BENCH_KNOBS):
        return bench.model_config(), bench.pipeline(), bench.datamanager(device)


def mesh_check_config(cfg):
    """The check step's config: ``cfg`` with the visibility queried in
    chunks of the directions one rank of the widest ``dirs`` axis takes for
    one ray (127 of 254).  Every run then cuts its DDF calls where the
    one-process step does, on the same points in the same order, so the
    kernel gradient of each call, which a bf16 product rounds to bfloat16
    once a call (:func:`rounds_cotangent`), is the same in every run, up
    to the power-of-two scale of a rank's mean."""
    d = visibility_query_directions(cfg, IcosahedronSampler(cfg.num_illumination_directions).actual_num_directions)
    dirs = max(r[1] for r in MESH_RUNS.values())
    check(d % dirs == 0, f"{d} queried directions do not split evenly over {dirs} 'dirs' ranks")
    return dataclasses.replace(cfg, visibility_query_chunk=d // dirs)


def _batch_to(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def mesh_init(cfg, dev, mesh):
    """(model, params) of the check step: seed 0 with the converted prior,
    broadcast from rank 0 on a mesh."""
    model = NeuSkyModel(cfg, device=dev).set_mesh(mesh)
    return model, mesh_mod.replicate(load_illumination_prior(model.init(torch.Generator(dev).manual_seed(0)), cfg), mesh)


def mesh_sky_rounding(cfg, batch, data: int) -> dict:
    """For each kernel of a bf16 product of the DDF, u·(|P| + Σ_r |P_r|)
    with u = 2⁻⁸, bfloat16's unit roundoff: the most by which rounding the
    sky-ray loss's DDF call moves the check step's gradient on a mesh of
    ``data`` shards.  One process calls the DDF once on the batch's sky rays
    and rounds that call's kernel gradient P to bfloat16 once; each rank
    calls it on its shard and rounds its own P_r (scaled as the ranks'
    average scales it).  Zero where the calls are the same: ``data`` = 1,
    or sky rays that do not split evenly and stay whole."""
    dev = "cuda"
    model, params = mesh_init(cfg, dev, None)
    srb = batch_sky_bundle(_batch_to(batch, dev))
    keys = [k for k, _ in tree_items(params) if k.startswith("ddf_field/") and rounds_cotangent(cfg, k)]
    leaves = [dict(tree_items(params))[k].requires_grad_() for k in keys]
    out = {k: torch.zeros_like(t) for k, t in zip(keys, leaves)}
    s = srb.origins.shape[0]
    if data == 1 or s % data:
        return {k: v.cpu() for k, v in out.items()}
    coef = dict(cfg.ddf.loss_coefficients)["sky_ray_loss"]
    n = s // data
    for rows, weight in [(slice(None), 1.0)] + [(slice(r * n, (r + 1) * n), 1.0 / data) for r in range(data)]:
        o, d = srb.origins[rows], srb.directions[rows]
        pts = ray_sphere_intersection(o, d, cfg.ddf_radius)
        sky = model.ddf.apply(params["ddf_field"], pts, -d)["expected_termination_dist"]
        loss = weight * coef * ddf_sky_ray_loss(sky, torch.linalg.norm(o - pts, dim=-1))
        for k, g in zip(keys, torch.autograd.grad(loss, leaves)):
            out[k] += g.abs()
    return {k: (2.0**-8 * v).cpu() for k, v in out.items()}


def mesh_check_step(cfg, pcfg, dev, mesh, batch, draws):
    """One step of ``make_train_step`` with :func:`mesh_check_config`'s
    chunks (with ``mesh``: this rank's shard of ``batch``, the global
    ``draws``) from :func:`mesh_init`'s params → (total loss, params, K1
    launches, DDF visibility queries)."""
    model, params = mesh_init(mesh_check_config(cfg), dev, mesh)
    opt = GroupedAdam(params, default_neusky_optimizer_groups(100001))
    step_fn = mesh_mod.make_train_step(model, pcfg, opt, mesh, graphed=False)
    local = mesh_mod.shard_batch(_batch_to(batch, dev), mesh)
    before = k1_launches()
    with count_visibility_queries(model) as queries:
        aux = step_fn(params, local, 0.0, _to(draws, dev))
    torch.cuda.synchronize(dev)
    return float(aux["total_loss"]), params, k1_launches() - before, queries[0]


def mesh_compare(cfg, params, ref, data: int) -> dict:
    """Rank 0's averaged gradient and updated params after the check step
    against the one-process step's (``ref``).  Gradients: every element
    within phase 3's bound of its array's largest (:func:`grad_allowance`),
    a bf16 kernel of the DDF besides within the rounding that the mesh
    moves (``ref["sky_rounding"][data]``, :func:`mesh_sky_rounding`); the
    reading is the largest error over its allowance.  Params: within 1e-6
    (and two float32 steps of the value), except where the reference
    gradient lies within its allowance of zero: Adam's first update is
    ±lr·sign(g), so such an element may move the other way, as in
    ``tests/test_torch_slice.py``."""
    grads = {k: t.grad.detach().cpu() for k, t in tree_items(params) if t.grad is not None}
    sky = ref["sky_rounding"][data]
    grad_bad, param_bad, worst, moved = [], [], {}, {}
    for k, t in tree_items(params):
        group = k.split("/")[0]
        got_p, want_p = t.detach().cpu(), ref["params"][k]
        diff = (got_p - want_p).abs()
        moved[group] = max(moved.get(group, 0.0), float(diff.max()))
        ok = diff <= 1e-6 + 2.0**-22 * want_p.abs()
        want = ref["grads"].get(k)
        if want is not None and float(want.abs().max()) > 0:
            bf16_kernel = rounds_cotangent(cfg, k)
            label = group + (" (bf16 kernels)" if bf16_kernel else "")
            allow = grad_allowance(want, MESH_GRAD_REL.get(group, 2e-3), bf16_kernel) + sky.get(k, 0.0)
            ratio = float(((grads[k] - want).abs() / allow).max())
            worst[label] = max(worst.get(label, 0.0), ratio)
            if ratio > 1.0:
                grad_bad.append((k, ratio))
            ok |= want.abs() <= allow
        if not bool(ok.all()):
            param_bad.append((k, float(diff.max())))
    return dict(grad_bad=grad_bad, grad_worst=worst, param_bad=param_bad, param_worst=moved)


def mesh_train(trainer, dev) -> dict:
    """MESH_WARMUP + MESH_STEPS steps of ``trainer`` (a ``Trainer(mesh=)``),
    each timed alone → K1's launches a step (counted through the
    replays), the DDF's visibility queries a step (Python calls: none in a
    replay), the losses, the wall ms of each step and their steady mean,
    the params' digest after, and eagerly the gradient all-reduce's ms a
    step (host-synchronised, which a capture cannot hold)."""
    captured = getattr(trainer.train_step, "captured", None)
    reduce_s = [0.0]
    average = mesh_mod.average_grads

    def timed(*a, **k):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = average(*a, **k)
        torch.cuda.synchronize(dev)
        reduce_s[0] += time.perf_counter() - t0
        return r

    if captured is None:
        mesh_mod.average_grads = timed
    times, launches, queries, reduce_ms, losses = [], [], [], [], []
    try:
        with count_visibility_queries(trainer.model) as q:
            for _ in range(MESH_WARMUP + MESH_STEPS):
                before, q[0], reduce_s[0] = k1_launches(), 0, 0.0
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                rec = trainer.run(1)[-1]
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
                launches.append(k1_launches() - before)
                queries.append(q[0])
                reduce_ms.append(reduce_s[0] * 1e3)
                losses.append(rec["total_loss"])
    finally:
        mesh_mod.average_grads = average
    out = dict(launches=launches, queries=queries, losses=losses, step_ms=[t * 1e3 for t in times],
               steady_ms=float(np.mean(times[MESH_WARMUP:])) * 1e3, digest=tree_digest(trainer.params))
    if captured is None:
        out["allreduce_ms"] = float(np.mean(reduce_ms[MESH_WARMUP:]))
    else:
        out.update(capture_s=captured.capture_s, replays=captured.replays)
    return out


def mesh_rank(rank, world_size, init_method, dirs, backend, work, label, card, check_step, trainers):
    """One rank of a phase 13 run (run by ``run_ranks``; NCCL rank r on
    ``cuda:r``, gloo ranks sharing the card):

    1. the check step on the reference's batch and draws, eagerly
       (:func:`mesh_check_step`) or as a replay of the captured rank step
       (:func:`mesh_graph_check_step`); rank 0 holds its gradient and
       params to the one-process step's (:func:`mesh_compare`);
    2. for each of ``trainers``, ``Trainer(mesh=)`` (``graphed=False`` for
       "eager", its default for "captured") trains (:func:`mesh_train`),
       its peak allocated and reserved memory read from its build on, the
       allocator's cache emptied first (``base_gib``: what was allocated
       before it);
    3. captured: MESH_SAME_STATE_STEPS more steps, each a replay and an
       eager step from the replaying trainer's state
       (:func:`same_state_step`; the eager trainer of 2 or a new one); one
       eager step on that state keeping K1's inputs (the rank's own,
       ``M/data`` points a site) and counting the DDF's visibility
       queries, K1 held to its plain version and timed on each input; one
       profiled replay: busy share, host calls, and the device time of the
       NCCL kernels (the all-reduces; with other ranks a rank's NCCL kernel
       also waits there for the slowest).

    → this rank's numbers: its rays, "check", one entry a trainer, and the
    seconds each part took."""
    seconds, t0 = {}, time.perf_counter()
    t_start = t0

    def lap(name):
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = f"cuda:{rank}" if backend == "nccl" else "cuda"
    mesh = mesh_mod.make_mesh(world_size, dirs, backend=backend, rank=rank, init_method=init_method, device=dev)
    cfg, pcfg, dm = mesh_setup(dev)
    ref = torch.load(Path(work) / "reference.pt", weights_only=False)
    out = {"rank": rank, "rays": int(mesh_mod.shard_batch(ref["batch"], mesh)["pixel_coords"].shape[0])}
    lap("setup")
    if check_step == "replay":
        total, params, launches, captured = mesh_graph_check_step(cfg, pcfg, dev, mesh, ref["batch"], ref["draws"])
        out["check"] = dict(loss=total, launches=launches, replays=captured.replays)
        del captured
    else:
        total, params, launches, queries = mesh_check_step(cfg, pcfg, dev, mesh, ref["batch"], ref["draws"])
        out["check"] = dict(loss=total, launches=launches, queries=queries)
    out["check"]["digest"] = tree_digest(params)
    if rank == 0:
        out["check"].update(mesh_compare(cfg, params, ref, world_size // dirs))
    del params
    lap("check_step")

    def trainer(graphed):
        return Trainer(TrainerConfig(max_num_iterations=100001, steps_per_log=1, seed=0),
                       NeuSkyModel(cfg, device=dev), pcfg, dm, optimizer_groups=default_neusky_optimizer_groups(100001),
                       device=dev, mesh=mesh, graphed=graphed)

    built = {}
    for kind in trainers:
        release()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        built[kind] = trainer(None if kind == "captured" else False)
        check(hasattr(built[kind].train_step, "captured") == (kind == "captured"),
              f"{label}: the {kind} trainer's step is {'not ' * (kind == 'captured')}captured")
        lap(f"{kind} trainer")
        out[kind] = mesh_train(built[kind], dev)
        out[kind].update(base_gib=base / 2**30, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                         peak_reserved_gib=torch.cuda.max_memory_reserved(dev) / 2**30)
        lap(f"{kind} steps")
    if "captured" in built:
        graphed, got = built["captured"], out["captured"]
        eager = built.get("eager") or trainer(False)
        n = MESH_WARMUP + MESH_STEPS
        got["same_state"] = [same_state_step(trainer_as_bench(eager), trainer_as_bench(graphed), False, n + i,
                                             mesh=mesh) for i in range(MESH_SAME_STATE_STEPS)]
        del eager
        lap("same state")
        with eager_steps(graphed), count_visibility_queries(graphed.model) as queries:
            inputs = capture_k1_inputs(lambda: graphed.run(1))
        got["eager_queries"] = queries[0]
        sites = [measure_k1(f"{label} rank {rank} site {i}", rows, vals, t, 1)
                 for i, (rows, vals, t) in enumerate(inputs)]
        got["k1"] = {"launches": len(sites), "shapes": [[r["L"], r["M"]] for r in sites],
                     "max_abs_err": max(r["max_abs_err"] for r in sites),
                     **{k: sum(r[k] for r in sites) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}
        del inputs
        lap("k1")
        prof = profile_call(lambda: graphed.run(1), got["steady_ms"] / 1e3, card,
                            f"phase 13 {label} rank {rank} replay", top=5)
        lap("profile")
        nccl_ms = prof and prof["by_kind_ms"].get("NCCL", 0.0)
        got.update(busy_share=prof and prof["busy_share"], device_ms=prof and prof["device_ms"],
                   host_calls=prof and prof["host_calls"], allreduce_ms=nccl_ms,
                   allreduce_share=prof and nccl_ms / prof["device_ms"], digest=tree_digest(graphed.params))
    seconds["total"] = time.perf_counter() - t_start
    out["seconds"] = seconds
    return out


def reset_in_place(params, start: dict, optimizer) -> None:
    """``params`` back to ``start`` and ``optimizer`` (a capturable
    ``GroupedAdam``) back to before its first update, in the same tensors,
    which a captured step keeps: Adam's zero moments and step count are
    those it starts from."""
    with torch.no_grad():
        for k, v in tree_items(params):
            v.copy_(start[k])
        for state in optimizer.optimizer.state.values():
            for t in state.values():
                t.zero_()
    optimizer.count = 0


def mesh_graph_check_step(cfg, pcfg, dev, mesh, batch, draws):
    """:func:`mesh_check_step` as a replay of the captured rank step: its
    eager first call and its capture (and first replay) on the check step's
    inputs, the params and Adam state put back, then the check step →
    (total loss, params, K1 launches of that replay, the step's
    ``CapturedStep``)."""
    model, params = mesh_init(mesh_check_config(cfg), dev, mesh)
    opt = GroupedAdam(params, default_neusky_optimizer_groups(100001))
    step_fn = mesh_mod.make_train_step(model, pcfg, opt, mesh, graphed=True)
    local = mesh_mod.shard_batch(_batch_to(batch, dev), mesh)
    draws = _to(draws, dev)
    start = {k: v.detach().clone() for k, v in tree_items(params)}
    for _ in range(2):
        step_fn(params, local, 0.0, draws)
    reset_in_place(params, start, opt)
    before = k1_launches()
    aux = step_fn(params, local, 0.0, draws)
    torch.cuda.synchronize(dev)
    return float(aux["total_loss"]), params, k1_launches() - before, step_fn.captured


def run_mesh_path(card: str):
    """Phase 13: bench's configuration (a) over a mesh.  The one-process
    step on one global batch (the native sampler's first) and one set of
    draws is the reference.  Each run of MESH_RUNS (:func:`mesh_rank`)
    takes a check step (:func:`mesh_check_config`'s chunks) that must match
    the reference (loss 1e-4 relative, rank 0's gradient and params by
    :func:`mesh_compare`, every rank's params bitwise equal), then trains
    bench's (a) through ``Trainer(mesh=)``, eagerly or captured: K1 7
    times a step on every rank, the DDF's visibility queries the rank's
    rays × its share of the directions, the params bitwise equal on every
    rank at the end (:func:`check_mesh_run`)."""
    t_phase = time.perf_counter()
    cfg, pcfg, dm = mesh_setup("cuda")
    expected = expected_launches_per_step(cfg, pcfg)
    d_query = visibility_query_directions(cfg, IcosahedronSampler(cfg.num_illumination_directions).actual_num_directions)
    torch.cuda.empty_cache()
    results = {}
    with tempfile.TemporaryDirectory() as work:
        batch = dm.next_train(0)
        n_rays = int(batch["pixel_coords"].shape[0])
        del dm
        model = NeuSkyModel(cfg, device="cuda")
        gen = torch.Generator("cuda").manual_seed(4)
        draws = model.draw(None, gen, n_rays)
        draws["ddf"] = draw_ddf_fit(model, pcfg, None, gen)
        sky_rounding = {data: mesh_sky_rounding(cfg, batch, data)
                        for data in sorted({w // d for w, d, *_ in MESH_RUNS.values()})}
        total, params, launches, queries = mesh_check_step(cfg, pcfg, "cuda", None, batch, draws)
        check(launches == expected and queries == n_rays * d_query,
              f"reference step: K1 {launches} (expected {expected}), DDF queries {queries}")
        torch.save({"batch": _batch_to(batch, "cpu"), "draws": _to(draws, "cpu"), "sky_rounding": sky_rounding,
                    "grads": {k: t.grad.detach().cpu() for k, t in tree_items(params) if t.grad is not None},
                    "params": {k: t.detach().cpu() for k, t in tree_items(params)}}, Path(work) / "reference.pt")
        del params, model
        torch.cuda.empty_cache()
        log(f"phase 13 reference (one process, {n_rays} rays, {d_query} queried directions in chunks of "
            f"{mesh_check_config(cfg).visibility_query_chunk}): total loss {total:.6f}")
        for label, (world, dirs, backend, check_step, trainers) in MESH_RUNS.items():
            if backend == "nccl" and torch.cuda.device_count() < world:
                log(f"phase 13 {label} not run: {torch.cuda.device_count()} card(s) for {world} NCCL ranks")
                continue
            t0 = time.perf_counter()
            ranks = run_ranks("chip_smoke:mesh_rank", world, dict(dirs=dirs, backend=backend, work=work, label=label,
                                                                  card=card, check_step=check_step, trainers=trainers))
            results[label] = check_mesh_run(label, backend, dirs, ranks, total, expected, n_rays, d_query, card,
                                            time.perf_counter() - t0)
    log(f"phase 13 took {time.perf_counter() - t_phase:.3f} s")
    return results


def check_mesh_run(label, backend, dirs, ranks, total, expected, n_rays, d_query, card, wall) -> dict:
    """Phase 13's checks of one run's ranks (:func:`mesh_rank`), then its
    log lines → its summary.  Every rank: its shard of the rays; its check
    step K1 ``expected`` times (as a replay, the second after its capture),
    eagerly the DDF queries its rays × its share of the directions, its
    loss the one-process step's ``total`` within 1e-4 relative; each
    trainer K1 ``expected`` times a step (through the replays) and finite
    losses; eagerly those DDF queries every step; captured, a replay every
    step after the first, every same-state step within GRAPH_LOSS_RTOL and
    phase 16's bounds, K1 ``expected`` times and those DDF queries in an
    eager step on its own inputs.  Every rank's params bitwise equal after
    the check step and after each trainer's steps; rank 0's gradient and
    params after the check step within :func:`mesh_compare`'s bounds."""
    world = len(ranks)
    data = world // dirs
    shares = [d_query // dirs + (1 if j < d_query % dirs else 0) for j in range(dirs)]
    kinds = [kind for kind in ("eager", "captured") if kind in ranks[0]]
    for r in ranks:
        who = f"{label} rank {r['rank']}"
        want_q = (n_rays // data) * shares[r["rank"] % dirs]
        c = r["check"]
        check(r["rays"] == n_rays // data, f"{who}: {r['rays']} rays")
        check(c["launches"] == expected and c.get("replays", 2) == 2 and c.get("queries", want_q) == want_q,
              f"{who}: the check step's K1 {c['launches']} (expected {expected}), replays {c.get('replays')}, "
              f"DDF queries {c.get('queries')} (expected {want_q})")
        check(abs(c["loss"] - total) <= 1e-4 * abs(total), f"{who}: check loss {c['loss']:.7f} vs one process {total:.7f}")
        for kind in kinds:
            t = r[kind]
            steps = len(t["launches"])
            check(t["launches"] == [expected] * steps, f"{who} {kind}: K1 launches {t['launches']} (expected {expected})")
            check(all(math.isfinite(x) for x in t["losses"]), f"{who} {kind}: losses {t['losses']}")
            if kind == "eager":
                check(t["queries"] == [want_q] * steps, f"{who} eager: DDF queries {t['queries']} (expected {want_q})")
                continue
            check(t["replays"] == steps - 1, f"{who} captured: {t['replays']} replays in {steps} steps")
            check(all(s["ok"] and s["loss_rel"] <= GRAPH_LOSS_RTOL for s in t["same_state"]),
                  f"{who}: the replayed step from the eager step's state differs: {t['same_state']}")
            check(t["k1"]["launches"] == expected and t["eager_queries"] == want_q,
                  f"{who}: K1 {t['k1']['launches']}, DDF queries {t['eager_queries']} in an eager step "
                  f"(expected {expected}, {want_q})")
    r0 = ranks[0]
    check(len({r["check"]["digest"] for r in ranks}) == 1, f"{label}: params after the check step differ by rank")
    check(not r0["check"]["grad_bad"],
          f"{label}: rank 0's gradient differs from the one-process step: {r0['check']['grad_bad']}")
    check(not r0["check"]["param_bad"],
          f"{label}: rank 0's params after the check step differ from one process's: {r0['check']['param_bad']}")
    for kind in kinds:
        check(len({r[kind]["digest"] for r in ranks}) == 1, f"{label}: params after the {kind} steps differ by rank")
    for r in ranks:
        for kind in kinds:
            t = r[kind]
            line = (f"phase 13 {label} rank {r['rank']} {kind} ({backend}): steady {t['steady_ms']:.3f} ms a step "
                    f"(steps " + json.dumps([round(x, 1) for x in t["step_ms"]]) + f"), peak {t['peak_gib']:.3f} GiB "
                    f"allocated / {t['peak_reserved_gib']:.3f} GiB reserved (from {t['base_gib']:.3f} allocated), "
                    f"K1 {t['launches'][-1]} a step, ")
            if kind == "eager":
                line += f"all-reduce {t['allreduce_ms']:.3f} ms a step, DDF queries {t['queries'][-1]} a step"
            else:
                k = t["k1"]
                line += (f"capture {t['capture_s']:.3f} s; a profiled replay: busy {t['busy_share']}, "
                         f"{t['host_calls']} host calls, NCCL {t['allreduce_ms']} ms ({t['allreduce_share']} of "
                         f"device time); K1 on its own inputs {k['ms']:.4f} ms a step (bound {k['bound_ms']:.4f}, "
                         f"plain {k['plain_ms']:.4f}, index_add_ {k['library_ms']:.4f}, shapes {k['shapes']}); "
                         f"DDF queries {t['eager_queries']} a step")
            log(line + f", {r['rays']} rays ({card})")
        log(f"phase 13 {label} rank {r['rank']} seconds by part "
            + json.dumps({part: round(v, 2) for part, v in r["seconds"].items()}))
    summary = {"run": label, "ranks": world, "data": data, "dirs": dirs, "backend": backend,
               "check": "replay" if "replays" in r0["check"] else "eager", "check_loss": r0["check"]["loss"],
               "one_process_loss": total, "loss_rel_err": abs(r0["check"]["loss"] - total) / abs(total),
               "grad_worst_over_allowance_by_group": r0["check"]["grad_worst"],
               "param_worst_abs_by_group": r0["check"]["param_worst"], "k1_per_step": expected, "wall_s": wall}
    keys = {"eager": ("steady_ms", "allreduce_ms", "peak_gib", "peak_reserved_gib"),
            "captured": ("steady_ms", "capture_s", "busy_share", "host_calls", "allreduce_ms", "allreduce_share",
                         "device_ms", "peak_gib", "peak_reserved_gib", "eager_queries", "k1")}
    for kind in kinds:
        summary[kind] = {key: [r[kind][key] for r in ranks] for key in keys[kind]}
        if kind == "captured":
            summary[kind].update(same_state_loss_rel=[[s["loss_rel"] for s in r[kind]["same_state"]] for r in ranks],
                                 same_state_worst=[[s["worst"] for s in r[kind]["same_state"]] for r in ranks])
    log("phase 13 " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# phase 14: the port's bench; phase 15: entry()


BENCH_CHILD_ENV = {"NEUSKY_BENCH_STEPS": "4", "NEUSKY_BENCH_REPEATS": "1"}
BENCH_RAYS_PER_STEP = 8 * 128 + 8 * 128 + 256  # scene + DDF-fit + sky
ENTRY_REL = 1e-4  # phase 3's loss bound, of each output's largest magnitude


def run_bench_module(card: str) -> dict:
    """Phase 14: ``python -m neusky_torch.bench`` in a child process with
    BENCH_CHILD_ENV: its last line is one JSON object with JAX's bench
    fields, a finite positive ``value``, 2,304 rays a step and this card's
    ``nvidia-smi`` line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "neusky_torch.bench"], cwd=Path(__file__).resolve().parent,
                          env={**os.environ, **BENCH_CHILD_ENV}, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"neusky_torch.bench exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    keys = {"metric", "value", "unit", "absolute_rays_per_sec", "chip", "loop_rates", "stddev", "loadavg_before",
            "loadavg_after", "steps_per_loop", "effective", "rays_per_step", "peak_gib"}
    check(keys <= set(out) and "vs_baseline" not in out, f"bench line keys {sorted(out)}")
    check(out["metric"] == bench.METRIC and math.isfinite(out["value"]) and out["value"] > 0,
          f"bench value {out['value']}")
    check(out["rays_per_step"] == BENCH_RAYS_PER_STEP, f"bench rays a step {out['rays_per_step']}")
    check(out["chip"] == card and out["steps_per_loop"] == 4 and len(out["loop_rates"]) == 1,
          f"bench chip {out['chip']!r}, steps {out['steps_per_loop']}, loops {out['loop_rates']}")
    log(f"phase 14 bench ({json.dumps(BENCH_CHILD_ENV)}; {time.perf_counter() - t0:.3f} s): {line}")
    return out


def check_entry_cuda_vs_cpu(card: str) -> dict:
    """Phase 15: ``entry()``'s forward (the tiny model's eval-mode forward)
    on the card and on the CPU from the same params, rays and draws (the
    eval forward's: none): rgb, depth, normal and accumulation within
    ENTRY_REL of each output's largest magnitude on the CPU; K1 0 (no
    backward)."""
    from neusky_torch.entry import entry

    fn_cpu, (params, _, rb, image_indices, ray_image_idx) = entry("cpu")
    fn_card, _ = entry("cuda")
    want = [o.detach() for o in fn_cpu(params, {}, rb, image_indices, ray_image_idx)]
    k1.launches[k1.KERNEL_NAME] = 0
    rb_card = RayBundle(**{f.name: getattr(rb, f.name).cuda() for f in dataclasses.fields(RayBundle)})
    got = [o.detach().cpu() for o in fn_card(_to(params, "cuda"), {}, rb_card, image_indices.cuda(),
                                             ray_image_idx.cuda())]
    torch.cuda.synchronize()
    errs = {name: float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
            for name, g, w in zip(("rgb", "depth", "normal", "accumulation"), got, want)}
    log(f"phase 15 entry(): card vs CPU, largest error over each output's largest magnitude {json.dumps(errs)} "
        f"(bound {ENTRY_REL}); K1 launches {k1_launches()}; rgb {tuple(got[0].shape)} ({card})")
    check(all(g.shape == w.shape and bool(torch.isfinite(g).all()) for g, w in zip(got, want)), "entry(): outputs")
    check(all(e <= ENTRY_REL for e in errs.values()), f"entry(): card vs CPU {errs}")
    check(k1_launches() == 0, f"entry(): K1 launched {k1_launches()} times")
    return errs


# ---------------------------------------------------------------------------
# phase 16: the captured step against the eager step


GRAPH_WARMUP, GRAPH_STEPS = 3, 8
GRAPH_LOSS_RTOL = 1e-4  # K1's and the gathers' atomics sum in another order each run
GRAPH_FIT_REL = 1e-4  # the fitted eval latents and scales, of their scale
# Adam (eps 1e-15) moves an entry by about lr whatever its gradient's size,
# and a sample's gradient lands on hash rows by its position and its
# stochastic corner: two runs of the same steps, eager against eager as
# captured against eager, part on tens of thousands of the SDF table's
# 16.8M entries within 11 steps, K1's atomic order the seed
# (:func:`graph_spread`).  So the params are held after one step that both
# take from the same state, where only that step's atomics differ.
FLIP_LR_FACTOR = 7.0  # a step moves an entry by at most ~3.3 lr: twice that


def trainer_as_bench(trainer):
    """A ``Trainer`` under ``bench.Bench``'s names, for :func:`same_state_step`."""
    return types.SimpleNamespace(model=trainer.model, pipeline=trainer.pipeline_config,
                                 datamanager=trainer.datamanager, params=trainer.params,
                                 optimizer=trainer.optimizer, step=trainer.train_step)


def _clone_tree(tree):
    """A copy of an optimizer state dict (dicts of tensors and values)."""
    return tree_map(lambda x: x.clone() if torch.is_tensor(x) else copy.deepcopy(x), tree)


def same_state_step(eager, graphed, split: bool, s: int, grad_rel=None, mesh=None) -> dict:
    """One more step of ``graphed`` (its captured step: a replay) and of
    ``eager`` (its eager step) from the same state: the captured run's
    params and Adam state, copied into the eager run's, one batch, one set
    of draws and the step count ``s + 1`` as a device scalar.  Both are
    ``bench.Bench``-like (``model``, ``pipeline``, ``datamanager``,
    ``params``, ``optimizer``, ``step``).  The params after it are held as
    phase 3 holds gradients: each trained array's update within 2e-3 (the
    DDF's 5e-3, or ``grad_rel`` by top-level key) of its largest entry,
    but where either run's gradient is within that bound of zero, where
    Adam may take the other sign (at most FLIP_LR_FACTOR × the group's lr
    apart); frozen leaves bit for bit → {"loss_rel", "ok", "worst",
    "flips", "bad"}.  With ``mesh`` both are a rank's steps: the batch is
    this rank's shard, the draws the global step's."""
    grad_rel = grad_rel or {"ddf_field": 5e-3}
    batch = mesh_mod.shard_batch(graphed.datamanager.next_train(s), mesh)
    draws = draw_step(graphed.model, graphed.pipeline, batch, torch.Generator("cuda").manual_seed(2), split)
    step = torch.full((), float(s + 1), device="cuda")
    count = graphed.optimizer.count
    lr = {id(p): float(schedule(count)) for group, schedule in
          zip(graphed.optimizer.optimizer.param_groups, graphed.optimizer.schedules) for p in group["params"]}
    start = {k: v.detach().clone() for k, v in tree_items(graphed.params)}
    state = _clone_tree(graphed.optimizer.state_dict())
    total_g = float(graphed.step(graphed.params, batch, step, draws)["total_loss"])
    with torch.no_grad():
        for k, v in tree_items(eager.params):
            v.copy_(start[k])
    eager.optimizer.load_state_dict(state)
    total_e = float(eager.step(eager.params, batch, step, draws)["total_loss"])
    got, want = dict(tree_items(graphed.params)), dict(tree_items(eager.params))
    worst, flips, bad = 0.0, 0, []
    for k, w in want.items():
        if id(got[k]) not in lr:
            if not torch.equal(got[k], w):
                bad.append((k, "frozen leaf moved"))
            continue
        rel = grad_rel.get(k.split("/")[0], 2e-3)
        du_g, du_e = got[k].detach() - start[k], w.detach() - start[k]
        diff = (du_g - du_e).abs()
        near_zero = torch.zeros_like(diff, dtype=torch.bool)
        for g in (got[k].grad, w.grad):
            if g is not None:
                near_zero |= g.abs() <= rel * g.abs().max()
        beyond = diff > rel * du_e.abs().max()
        worst = max(worst, float(diff[~near_zero].max()) / max(float(du_e.abs().max()), 1e-30)
                    if bool((~near_zero).any()) else 0.0)
        flips += int((beyond & near_zero).sum())
        if not bool(torch.isfinite(du_g).all()) or bool((beyond & ~near_zero).any()) or (
                bool(near_zero.any()) and float(diff[near_zero].max()) > FLIP_LR_FACTOR * lr[id(got[k])]):
            bad.append((k, float(diff.max())))
    return {"loss_rel": abs(total_g - total_e) / abs(total_e), "ok": not bad, "worst": worst, "flips": flips,
            "bad": bad}


def graphed_run(graphed: bool, split: bool) -> dict:
    """Bench's (a) from ``bench.build`` (seed-0 params, seed-1 draws, the C++
    sampler's stream) with the fused or split step, eager or captured:
    GRAPH_WARMUP steps, then GRAPH_STEPS timed as one loop ended by a
    synchronise; the losses of every step read after it.  Both take the
    step count as a device scalar, as the captured step reads it: a float
    step anneals the proposal weights by the host's float64 arithmetic,
    which moves the samples by a few ulps and with them the hash rows that
    take gradients (:func:`graph_spread`)."""
    with knobs_set({**BENCH_KNOBS, **({"NEUSKY_BENCH_SPLIT": "1"} if split else {})}):
        b = bench.build("cuda", graphed=graphed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches[k1.KERNEL_NAME] = 0
    auxes = []
    for s in range(GRAPH_WARMUP + GRAPH_STEPS):
        if s == GRAPH_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        step = torch.full((), float(s + 1), device="cuda")
        auxes.append(b.step(b.params, b.datamanager.next_train(s), step, generator=b.generator))
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / GRAPH_STEPS
    return {"bench": b, "steady_ms": steady * 1e3, "k1_launches": k1_launches(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            "capture_s": b.step.captured.capture_s if graphed else None,
            "losses": [{"total_loss": float(a["total_loss"]), **{k: float(v) for k, v in a["loss_dict"].items()}}
                       for a in auxes]}


def graphed_vs_eager_train(split: bool, card: str) -> dict:
    """Phase 16, one training step kind: the eager and the captured step
    from the same params, draws and batches: the losses of every step
    within GRAPH_LOSS_RTOL, K1 7 a step in both (counted through replays),
    then one more step of both from the captured run's state
    (:func:`same_state_step`), then one profiled step of each on a pass of
    its own."""
    eager, graphed = graphed_run(False, split), graphed_run(True, split)
    n = GRAPH_WARMUP + GRAPH_STEPS
    label = "split" if split else "fused"
    for r in (eager, graphed):
        log(f"phase 16 {label} (a) {'graphed' if r is graphed else 'eager'}: steady {r['steady_ms']:.3f} ms a step "
            f"(loop of {GRAPH_STEPS} after {GRAPH_WARMUP}), K1 {r['k1_launches']} launches in {n} steps, peak "
            f"{r['peak_gib']:.3f} GiB allocated / {r['peak_reserved_gib']:.3f} GiB reserved, capture {r['capture_s']} s "
            f"({card})")
    worst_loss = max(abs(g[k] - e[k]) / max(abs(e[k]), 1e-12)
                     for e, g in zip(eager["losses"], graphed["losses"]) for k in e)
    check(worst_loss <= GRAPH_LOSS_RTOL and all(math.isfinite(v) for r in graphed["losses"] for v in r.values()),
          f"{label}: graphed losses differ from eager by {worst_loss:.3g}")
    check(eager["k1_launches"] == graphed["k1_launches"] == 7 * n,
          f"{label}: K1 launches eager {eager['k1_launches']}, graphed {graphed['k1_launches']}, expected {7 * n}")
    close = same_state_step(eager["bench"], graphed["bench"], split, n)
    log(f"phase 16 {label} (a) graphed vs eager ({card}): worst loss rel diff over {n} steps {worst_loss:.3g} "
        f"(bound {GRAPH_LOSS_RTOL}); step {n + 1} from one state: loss rel diff {close['loss_rel']:.3g}, params' "
        f"updates worst {close['worst']:.3g} of scale outside {close['flips']} near-zero-gradient entries; K1 "
        f"{eager['k1_launches']} / {graphed['k1_launches']} launches")
    check(close["ok"] and close["loss_rel"] <= GRAPH_LOSS_RTOL,
          f"{label}: the captured step from the eager step's state differs: {close}")
    for r in (eager, graphed):
        b, s = r["bench"], n + 1
        prof = profile_call(lambda: b.step(b.params, b.datamanager.next_train(s), float(s + 1), generator=b.generator),
                            r["steady_ms"] / 1e3, card, f"phase 16 {label} (a) {'graphed' if r is graphed else 'eager'} "
                            "step", top=5)
        r.update(busy_share=prof and prof["busy_share"], device_ms=prof and prof["device_ms"],
                 host_calls=prof and prof["host_calls"], device_ops=prof and prof["ops"])
        del r["bench"], b
    keys = ("steady_ms", "busy_share", "device_ms", "device_ops", "host_calls", "capture_s", "peak_gib",
            "peak_reserved_gib", "k1_launches")
    return {"step": label, "worst_loss_rel": worst_loss, "same_state": {k: close[k] for k in ("loss_rel", "worst",
                                                                                                "flips")},
            **{f"{kind}_{k}": r[k] for kind, r in (("eager", eager), ("graphed", graphed)) for k in keys}}


def graphed_vs_eager_fit(card: str) -> dict:
    """Phase 16, the eval-latent fit: 250 steps of the default (captured)
    fit against ``host_loop=True`` (eager, step by step) on bench (a)'s
    model with seed-0 params and the eval ring of phase 6 (two
    datamanagers of one seed: the same batches): the fitted eval latents
    and scales within GRAPH_FIT_REL of their scale, K1 0."""
    with knobs_set(BENCH_KNOBS):
        cfg = bench.model_config()
    model = NeuSkyModel(cfg, device="cuda")
    params = load_illumination_prior(model.init(torch.Generator("cuda").manual_seed(0)), cfg)
    out, fits = {}, {}
    k1.launches[k1.KERNEL_NAME] = 0
    for kind, host_loop in (("host_loop", True), ("graphed", False)):
        dm = eval_datamanager("cuda")
        (fit, losses), secs, peak = measured(lambda: fit_eval_latents(model, params, dm, steps=EVAL_FIT_STEPS,
                                                                      host_loop=host_loop))
        fits[kind] = {k: v.detach() for k, v in fit["eval_latents"].items()}
        out[f"{kind}_ms_per_step"] = secs / EVAL_FIT_STEPS * 1e3
        out[f"{kind}_peak_gib"] = peak
        out[f"{kind}_loss_last"] = losses[-1]
    errs = {k: float((fits["graphed"][k] - fits["host_loop"][k]).abs().max() / fits["host_loop"][k].abs().max())
            for k in ("eval_latents", "eval_scale")}
    out.update(latent_err=errs, k1_launches=k1_launches())
    log(f"phase 16 eval fit, graphed vs host_loop over {EVAL_FIT_STEPS} steps ({card}): " + json.dumps(out))
    check(max(errs.values()) <= GRAPH_FIT_REL, f"graphed fit differs from the host loop's: {errs}")
    check(out["k1_launches"] == 0, f"K1 launched {out['k1_launches']} times in the fits")
    return out


def run_graph_path(card: str) -> list:
    """Phase 16: the captured step against the eager step on bench's (a)
    fused and split, and the captured eval fit against the host loop."""
    t0 = time.perf_counter()
    rows = [graphed_vs_eager_train(False, card), graphed_vs_eager_train(True, card), graphed_vs_eager_fit(card)]
    log("phase 16 " + json.dumps(rows))
    log(f"phase 16 took {time.perf_counter() - t0:.3f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 17: the other captured paths against their eager selves


PATH_STEPS = 20  # DDF and RENI steps compared, captured against eager
PATH_REL = 1e-4  # their losses; the DDF, the envmap latents (of scale); the rotation angles (rad) and scales
PATH_FIT_STEPS = 30  # the envmap and rotation fits compared
PATH_FIT_TIMED = 5  # the steps of the eager fit timed and profiled
RENDER_REL = 1e-6  # every RENDER_KEYS map, of its scale
LPIPS_ABS = 1e-6
PSNR_DB = 0.01
PATH_TIMED = 10  # timed calls of a step, a render or LPIPS after the compared ones


@contextlib.contextmanager
def recorded_graphs(*modules):
    """The ``CapturedStep`` objects that ``modules`` build inside the block
    (each module's name ``CapturedStep`` swapped for a subclass that keeps
    them): a fit's graph, built inside the fit, reports its ``capture_s``."""
    from neusky_torch.parallel import graphs

    made = []

    class Kept(graphs.CapturedStep):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    saved = [(m, m.CapturedStep) for m in modules]
    for m, _ in saved:
        m.CapturedStep = Kept
    try:
        yield made
    finally:
        for m, c in saved:
            m.CapturedStep = c


def path_side(label: str, run, again, card: str, calls: int = PATH_TIMED, per_call: int = 1) -> tuple:
    """One side (eager or captured) of a phase-17 path: ``run()`` the
    compared work with the allocator's cache emptied first (its peak
    allocated and reserved memory and K1's launches read around it), then
    ``again()`` timed ``calls`` times ending in one synchronise and once
    profiled → (run's result, {"ms" a unit of work (a call over
    ``per_call``), "busy_share", "device_ms", "host_calls", "peak_gib",
    "peak_reserved_gib", "k1_launches"})."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches[k1.KERNEL_NAME] = 0
    out = run()
    torch.cuda.synchronize()
    rec = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    t0 = time.perf_counter()
    for _ in range(calls):
        again()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls
    rec["k1_launches"] = k1_launches()
    prof = profile_call(again, wall, card, label, top=5)
    rec.update(ms=wall / per_call * 1e3, busy_share=prof and prof["busy_share"], device_ms=prof and prof["device_ms"],
               host_calls=prof and prof["host_calls"])
    return out, rec


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale > 0 else diff


def _loss_rel(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want)


def graph_ddf(model, params, make_dm, card: str, steps: int = PATH_STEPS, sampler=None, num_sky_rays: int = 256):
    """The DDF trainer's step, eager then captured, from ``params`` over
    ``make_dm()``'s sky rays and one list of draws: each of ``steps``
    records' losses within PATH_REL, ``ddf_field`` within PATH_REL of its
    scale after them → the path's record."""
    from neusky_torch.engine import ddf_trainer

    cfg = ddf_trainer.DDFTrainerConfig(max_num_iterations=100001, steps_per_log=1, num_sky_rays=num_sky_rays,
                                       **({"sampler": sampler} if sampler is not None else {}))
    sides, draws = {}, None
    for graphed in (False, True):
        with recorded_graphs(ddf_trainer) as made:
            t = ddf_trainer.DDFTrainer(cfg, model, params, datamanager=make_dm(), graphed=graphed)
        draws = draws or [t.draw() for _ in range(steps)]
        run = lambda: (t.run(steps, draws=draws),  # noqa: E731,B023
                       {k: v.detach().clone() for k, v in tree_items(t.ddf_params)})
        again = lambda: t.train_step(t.ddf_params, None, t.draw_step())  # noqa: E731,B023
        out, rec = path_side(f"phase 17 ddf step {'captured' if graphed else 'eager'}", run, again, card)
        sides[graphed] = (out, rec, made[0].capture_s if made else None)
    ((he, pe), re_, _), ((hg, pg), rg, cap) = sides[False], sides[True]
    errs = {"loss_rel": max(_loss_rel(g, e) for e, g in zip(he, hg)), "ddf_rel": max(_rel(pg[k], pe[k]) for k in pe)}
    return _path_record("ddf_step", re_, rg, cap, errs, errs["loss_rel"] <= PATH_REL and errs["ddf_rel"] <= PATH_REL)


def graph_reni(envmaps, field_cfg, card: str, steps: int = PATH_STEPS, pixels: int = 2048):
    """The RENI trainer's step, eager then captured, on ``envmaps`` from one
    seed and one list of draws: each of ``steps`` steps' losses within
    PATH_REL → the path's record."""
    from neusky_torch.engine import reni_trainer

    cfg = reni_trainer.RENITrainerConfig(field=field_cfg, pixels_per_step=pixels)
    sides, draws = {}, None
    for graphed in (False, True):
        with recorded_graphs(reni_trainer) as made:
            t = reni_trainer.RENITrainer(cfg, envmaps, device="cuda", graphed=graphed)
        draws = draws or [t.draw() for _ in range(steps)]
        run = lambda: [{k: float(v) for k, v in t.train_step(d).items()} for d in draws]  # noqa: E731,B023
        again = lambda: t.train_step(t.draw())  # noqa: E731,B023
        out, rec = path_side(f"phase 17 RENI step {'captured' if graphed else 'eager'}", run, again, card)
        sides[graphed] = (out, rec, made[0].capture_s if made else None)
    (le, re_, _), (lg, rg, cap) = sides[False], sides[True]
    errs = {"loss_rel": max(_loss_rel(g, e) for e, g in zip(le, lg))}
    return _path_record("reni_step", re_, rg, cap, errs, errs["loss_rel"] <= PATH_REL)


def replay(graph):
    """One more call of a captured step on its static inputs as they
    stand (its last call's)."""
    return graph(graph._static_params, graph._step, *graph._static_inputs)


def fit_sides(label: str, fit, card: str, steps: int) -> dict:
    """Both sides of a fit path: ``fit(graphed, n)`` runs a fit of ``n``
    steps → its result, copied.  Each side runs the compared fit of
    ``steps``.  The captured side's ms a step is PATH_TIMED replays of the
    fit's graph (the step on its last inputs), one of them profiled; the
    eager side's is the compared fit's wall time less a fit of
    PATH_FIT_TIMED steps over the steps between them (the set-up and the
    PSNR decode cancel), and its busy share that of the short fit, which
    is profiled → {graphed: (result, record, capture_s)}."""
    from neusky_torch.engine import eval_loop, reni_trainer

    walls = {}

    def timed(graphed, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(graphed, n)
        torch.cuda.synchronize()
        walls.setdefault((graphed, n), time.perf_counter() - t0)
        return out

    sides = {}
    for graphed in (False, True):
        with recorded_graphs(eval_loop, reni_trainer) as made:
            if graphed:
                out, rec = path_side(f"phase 17 {label} captured", lambda: timed(True, steps),
                                     lambda: replay(made[-1]), card)  # noqa: B023
            else:
                out, rec = path_side(f"phase 17 {label} eager", lambda: timed(False, steps),
                                     lambda: timed(False, PATH_FIT_TIMED), card, calls=1, per_call=PATH_FIT_TIMED)
                rec["ms"] = (walls[(False, steps)] - walls[(False, PATH_FIT_TIMED)]) / (steps - PATH_FIT_TIMED) * 1e3
        sides[graphed] = (out, rec, made[0].capture_s if made else None)
    return sides


def graph_envmap_fit(field, decoder, envmaps, card: str, steps: int = PATH_FIT_STEPS, pixels: int = 2048):
    """``fit_latents_to_envmaps`` eager then captured on the same pixel
    draws: the latents within PATH_REL of their scale, the PSNRs within
    PSNR_DB → the path's record (:func:`fit_sides`)."""
    from neusky_torch.engine import reni_trainer

    sides = fit_sides("envmap fit", lambda graphed, n: reni_trainer.fit_latents_to_envmaps(
        field, decoder, envmaps, steps=n, pixels_per_step=pixels, graphed=graphed), card, steps)
    ((ze, pe), re_, _), ((zg, pg), rg, cap) = sides[False], sides[True]
    errs = {"latent_rel": _rel(torch.from_numpy(zg), torch.from_numpy(ze)),
            "psnr_db": float(np.abs(pg - pe).max()), "psnr": [float(x) for x in pg]}
    return _path_record("envmap_fit", re_, rg, cap, errs,
                        errs["latent_rel"] <= PATH_REL and errs["psnr_db"] <= PSNR_DB and np.isfinite(pg).all())


class EvalPool:
    """A stand-in for the protocol's compare pool over an eval
    datamanager: ``lighting_eval_batch`` cycles its eval slots."""

    def __init__(self, dm):
        self.dm, self.i = dm, 0

    def lighting_eval_batch(self, pool: str):
        self.i += 1
        return self.dm.eval_latent_batch((self.i - 1) % self.dm.num_eval)


def graph_rotation_fit(model, params, make_dm, gt_latents, card: str, steps: int = PATH_FIT_STEPS):
    """``fit_eval_rotation`` eager then captured on the same batches
    (:class:`EvalPool` over ``make_dm()``): the angles within PATH_REL rad,
    the scales within PATH_REL → the path's record (:func:`fit_sides`)."""
    from neusky_torch.engine import eval_loop

    def fit(graphed, n):
        out, gamma, losses = eval_loop.fit_eval_rotation(model, params, EvalPool(make_dm()), gt_latents, steps=n,
                                                         graphed=graphed)
        return out["eval_latents"]["eval_scale"].clone(), gamma, losses

    sides = fit_sides("rotation fit", fit, card, steps)
    ((se, ge, le), re_, _), ((sg, gg, lg), rg, cap) = sides[False], sides[True]
    errs = {"angle_rad": float(np.abs(gg - ge).max()), "scale": float((sg - se).abs().max()),
            "loss_last": [le[-1], lg[-1]]}
    return _path_record("rotation_fit", re_, rg, cap, errs, errs["angle_rad"] <= PATH_REL and errs["scale"] <= PATH_REL)


def graph_render(model, params, bundles, card: str, rotation=None, chunk_size: int = 4096):
    """``render_camera`` eager then captured (the model's shared chunk
    function) over each of ``bundles`` (the first with a short last chunk)
    with the sky of slot 0, ``rotation`` or not: every RENDER_KEYS map
    within RENDER_REL of its scale → (the path's record, the captured
    renders).  ms: a render of the last bundle; rays/s from it."""
    from neusky_torch.engine import eval_loop

    sides = {}
    for graphed in (False, True):
        with recorded_graphs(eval_loop) as made:
            run = lambda: [render_camera(model, params, rb, 0, chunk_size=chunk_size, rotation=rotation,  # noqa: E731,B023
                                         graphed=graphed) for rb in bundles]
            again = lambda: render_camera(model, params, bundles[-1], 0, chunk_size=chunk_size,  # noqa: E731,B023
                                          rotation=rotation, graphed=graphed)
            out, rec = path_side(f"phase 17 {'rotating ' if rotation is not None else ''}render "
                                 f"{'captured' if graphed else 'eager'}", run, again, card, calls=3)
        rec["rays_per_s"] = bundles[-1].num_rays / (rec["ms"] / 1e3)
        sides[graphed] = (out, rec, made[0].capture_s if made else None)
    (oe, re_, _), (og, rg, cap) = sides[False], sides[True]
    errs = {"map_rel": max(_rel(torch.from_numpy(g[k]), torch.from_numpy(e[k])) for e, g in zip(oe, og) for k in e),
            "rays": [rb.num_rays for rb in bundles]}
    ok = errs["map_rel"] <= RENDER_REL and all(np.isfinite(v).all() for o in og for v in o.values())
    return _path_record("rotating_chunk" if rotation is not None else "render_chunk", re_, rg, cap, errs, ok), og


def graph_lpips(pred: np.ndarray, target: np.ndarray, card: str):
    """LPIPS eager then captured on one pair of images: within LPIPS_ABS →
    the path's record."""
    from neusky_torch.engine import lpips as lp

    sides = {}
    for graphed in (False, True):
        call = lambda: lp.lpips(pred, target, "cuda", graphed)[0]  # noqa: E731,B023
        sides[graphed] = path_side(f"phase 17 LPIPS {'captured' if graphed else 'eager'}",
                                   lambda: [call() for _ in range(3)], call, card)  # noqa: B023
    (ve, re_), (vg, rg) = sides[False], sides[True]
    # the graph of this image shape is kept for the process: it may date from an earlier phase
    cap = lp.distance_fn(torch.device("cuda"), (1, 3, *pred.shape[:2])).captured.capture_s
    errs = {"abs": max(abs(g - e) for e, g in zip(ve, vg)), "value": vg[-1]}
    return _path_record("lpips", re_, rg, cap, errs, errs["abs"] <= LPIPS_ABS and math.isfinite(vg[-1]))


def _path_record(path: str, eager: dict, graphed: dict, capture_s, errs: dict, ok: bool) -> dict:
    return {"path": path, "ok": bool(ok), **errs, "capture_s": capture_s,
            **{f"{kind}_{k}": v for kind, r in (("eager", eager), ("graphed", graphed)) for k, v in r.items()}}


def run_graph_paths(card: str) -> list:
    """Phase 17: each captured path against its eager self on bench (a)'s
    model (seed-0 params, the converted prior) and phase 6's eval ring: the
    DDF trainer (8 × 128 vMF rays and 256 sky rays a step), the RENI
    trainer at the canonical decoder (16 skies at 64 px, 2,048 pixels a
    step), the envmap fit (4 skies at 128 px), the rotation fit, the
    render of a 64×48 image (one chunk, padded) and a 64×64 one, with and
    without a rotation, and LPIPS on the render; K1 0 on each."""
    from neusky_torch.data.sky_generator import generate_sky_corpus
    from neusky_torch.engine.checkpoint import prior_init_latent
    from neusky_torch.core.spherical import rot_z

    t0 = time.perf_counter()
    with knobs_set(BENCH_KNOBS):
        cfg = bench.model_config()
    model = NeuSkyModel(cfg, device="cuda")
    params = load_illumination_prior(model.init(torch.Generator("cuda").manual_seed(0)), cfg)
    make_dm = lambda: eval_datamanager("cuda")  # noqa: E731
    dm = make_dm()
    short = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=64, height=48, **EVAL_RING))
    bundles = [short["cameras"].to("cuda").generate_rays(0), dm.eval_image_bundle(0)[0]]
    rows = [graph_ddf(model, params, make_dm, card)]
    rows.append(graph_reni(generate_sky_corpus(16, width=64, seed=3),
                           dataclasses.replace(cfg.illumination, fixed_decoder=False), card))
    rows.append(graph_envmap_fit(model.illumination, params["illumination_decoder"],
                                 generate_sky_corpus(4, width=128, seed=4), card))
    z = torch.as_tensor(prior_init_latent(cfg), device="cuda")
    gt = z[None] + 0.1 * torch.randn((2, *z.shape), generator=torch.Generator("cuda").manual_seed(5), device="cuda")
    rows.append(graph_rotation_fit(model, params, make_dm, gt, card))
    row, renders = graph_render(model, params, bundles, card)
    rows.append(row)
    rows.append(graph_render(model, params, bundles, card, rotation=rot_z(torch.tensor(0.7, device="cuda")))[0])
    _, image = dm.eval_image_bundle(0)
    h, w = dm.eval_cameras.height, dm.eval_cameras.width
    rows.append(graph_lpips(np.clip(renders[-1]["rgb"].reshape(h, w, 3), 0, 1),
                            np.asarray(image["image"]).reshape(h, w, 3), card))
    for r in rows:
        log(f"phase 17 {r['path']} ({card}): " + json.dumps(r))
    bad = [r["path"] for r in rows if not r["ok"] or r["eager_k1_launches"] or r["graphed_k1_launches"]]
    check(not bad, f"phase 17: captured paths differ from their eager selves or launched K1: {bad}")
    log(f"phase 17 took {time.perf_counter() - t0:.3f} s")
    return rows


def graph_spread() -> int:
    """How far two runs of bench (a)'s fused step part in GRAPH_WARMUP +
    GRAPH_STEPS steps from the same params, draws and batches: eager
    against eager (K1's atomic order alone), eager given the step as a
    device scalar against eager given a float, and captured against eager
    with either (the ground of phase 16's same-state step).  Prints one
    JSON line a pair (the losses' worst relative difference; per trained
    array the entries beyond 2e-3 of its largest, their count and the
    largest difference), then the card line:

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.graph_spread())'
    """
    if not torch.cuda.is_available():
        print("graph_spread: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = bench.card_line()
    build_all()
    n = GRAPH_WARMUP + GRAPH_STEPS

    def run(graphed: bool, tensor_step: bool):
        with knobs_set(BENCH_KNOBS):
            b = bench.build("cuda", graphed=graphed)
        losses = []
        for s in range(n):
            step = torch.full((), float(s + 1), device="cuda") if tensor_step else float(s + 1)
            losses.append(float(b.step(b.params, b.datamanager.next_train(s), step, generator=b.generator)
                                ["total_loss"]))
        return losses, {k: v.detach().clone() for k, v in tree_items(b.params)}, {
            k for k, v in tree_items(b.params) if v.requires_grad}

    runs = {"eager": run(False, False), "eager again": run(False, False), "eager, step on the card": run(False, True),
            "captured": run(True, True)}
    for a, ref in (("eager again", "eager"), ("eager, step on the card", "eager"), ("captured", "eager"),
                   ("captured", "eager, step on the card")):
        (la, pa, _), (lb, pb, trained) = runs[a], runs[ref]
        apart = {}
        for k, w in pb.items():
            d = (pa[k] - w).abs()
            beyond = int((d > 2e-3 * w.abs().max()).sum()) if k in trained else 0
            if beyond:
                apart[k] = [beyond, w.numel(), float(d.max())]
        print(json.dumps({"run": a, "against": ref, "steps": n,
                          "loss_rel": max(abs(x - y) / abs(y) for x, y in zip(la, lb)), "beyond_bound": apart}))
    print(card)
    return 0


def bench_ab(parent: str = "_parent") -> int:
    """The port's bench (``python -m neusky_torch.bench``, its default
    loops) at the tree unpacked in ``parent`` and at this one, in turns:
    parent, change, change, parent, parent, change, each a fresh process;
    prints each run's JSON line after its name, then the card line.
    Unpack the parent first, into a directory ``.gitignore`` lists:
    ``mkdir _parent && git archive <commit> | tar -x -C _parent``.

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.bench_ab())'
    """
    if not torch.cuda.is_available():
        print("bench_ab: CUDA is not available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    for who in ("parent", "change", "change", "parent", "parent", "change"):
        proc = subprocess.run([sys.executable, "-m", "neusky_torch.bench"], capture_output=True, text=True,
                              cwd=here / parent if who == "parent" else here, timeout=900)
        check(proc.returncode == 0, f"bench at the {who} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        print(who, proc.stdout.strip().splitlines()[-1], flush=True)
    print(bench.card_line())
    return 0


def graph_path() -> int:
    """Phase 16 alone (the kernels built first):

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.graph_path())'
    """
    if not torch.cuda.is_available():
        print("graph_path: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = bench.card_line()
    build_all()
    run_graph_path(card)
    print(card)
    return 0


def graph_paths() -> int:
    """Phase 17 alone (the kernels built first):

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.graph_paths())'
    """
    if not torch.cuda.is_available():
        print("graph_paths: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_line()
    build_all()
    run_graph_paths(card)
    print(card)
    return 0


def mesh_path() -> int:
    """Phase 13 alone (the kernels built first):

        python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.mesh_path())'
    """
    if not torch.cuda.is_available():
        print("mesh_path: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = bench.card_line()
    build_all()
    run_mesh_path(card)
    print(card)
    return 0


# ---------------------------------------------------------------------------


def release() -> None:
    """Free what the last phase dropped: collect what is held in reference
    cycles (a graph's private pool goes back to the card only once the graph
    is freed) and empty the allocator's cache, so the next phase's reserved
    peak is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_line()
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_all()

    joint_cfg, joint_pcfg = neusky_model_config(8, 2), neusky_pipeline_config()
    check_k1(joint_cfg, joint_pcfg, 8 * 128)
    ddf_cases = check_ddf_film(joint_cfg, 8 * 128)
    release()
    check_step_cuda_vs_cpu(joint=False)
    check_step_cuda_vs_cpu(joint=True)
    run_path("scene", scene_config(), neusky_pipeline_config(), SCENE_STEPS, card)
    main_launches, captured, ddf_main = run_path("joint", joint_cfg, joint_pcfg, STEPS, card,
                                                 require_groups=("ddf_field", "visibility_sigmoid"), fused_ddf=True)
    # the kernels line: K1 per joint step, on the inputs the main path gave it
    sites = check_k1_main_path_inputs(joint_cfg, joint_pcfg, 8 * 128, captured)
    del captured
    run_eval_path(card)
    release()
    check_eval_cuda_vs_cpu(card)
    run_cli_path(card)
    release()
    t9 = time.perf_counter()
    run_reni_prior(card)
    check_reni_cuda_vs_cpu(card)
    release()
    log(f"phase 9 took {time.perf_counter() - t9:.3f} s; the script so far {time.perf_counter() - t_start:.3f} s")
    bench_runs = run_bench_path(card)
    run_tools_path(card)
    release()
    split = run_variants_path(card, bench_runs[0])
    release()
    run_mesh_path(card)
    run_bench_module(card)
    release()
    check_entry_cuda_vs_cpu(card)
    run_graph_path(card)
    release()
    run_graph_paths(card)
    log(f"the script took {time.perf_counter() - t_start:.3f} s before its last lines")
    joint_k1 = {k: sum(r[k] for r in sites) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"phase 5's joint step K1 (unfused, float32 mapping): {main_launches} launches in {STEPS} steps, "
        + json.dumps(joint_k1) + " ms a step")
    log(f"phase 10's (b) K1: {bench_runs[1]['k1_launches']} launches in {BENCH_WARMUP + BENCH_STEPS} steps, "
        + json.dumps({k: bench_runs[1][k]
                      for k in ("k1_ms_per_step", "k1_bound_ms_per_step", "k1_index_add_ms_per_step")})
        + " a step, shapes " + json.dumps([[r["L"], r["M"]] for r in bench_runs[1]["sites"]]))
    # the kernels line: K1 per step of the main path, the split
    # step in bench's configuration (a), on the inputs one of its steps gave K1
    main_path = split
    sites = main_path["sites"]
    per_step = lambda key: sum(r[key] * r["launches_per_step"] for r in sites)  # noqa: E731
    kernels = [{
        "name": k1.KERNEL_NAME,
        "route": "cuda",
        "source": "neusky_torch/csrc/hashgrid_scatter.cu",
        "replaces": "neusky_tpu/ops/hashgrid_pallas.py:47",
        "launches": main_path["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in sites),
        # times are per split training step: the sum over its launches, on
        # the inputs one step gave them
        "ms": per_step("ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": max(sites, key=lambda r: r["bound_ms"] * r["launches_per_step"])["bound_by"],
        "library_ms": per_step("library_ms"),
        "shapes": [[r["L"], r["M"]] for r in sites],
    }, {
        "name": ddf_film_cuda.KERNEL_NAME,
        "route": "cuda",
        "source": "neusky_torch/csrc/ddf_film_forward.cu",
        "replaces": "none: neusky_tpu/nets/siren.py::FiLMSiren under XLA",
        # phase 5's joint step (the neusky recipe's DDF): its launches and
        # rows in STEPS steps; times per step, over one step's chunks
        "launches": ddf_main[0],
        "rows": ddf_main[1],
        "max_abs_err": max(r["max_abs_err"] for r in ddf_cases.values()),
        "ms": ddf_cases["step"]["ms"],
        "plain_ms": ddf_cases["step"]["plain_ms"],
        "bound_ms": ddf_cases["step"]["bound_ms"],
        "bound_by": "fp32 FMA",
        "library_ms": ddf_cases["step"]["library_ms"],
        "shapes": [[ddf_cases["step"]["rows"], 3]],
        "frame": {k: ddf_cases["frame"][k] for k in ("rows", "launches", "ms", "plain_ms", "bound_ms")},
    }]
    log(json.dumps({"kernels": kernels}))
    log(bench.card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
