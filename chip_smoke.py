"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is passed over):

1. the card (``torch.cuda.get_device_name``, ``nvidia-smi`` name and power
   limit); build every kernel from ``neusky_torch/csrc`` with ``nvcc``
   (``sm_90a``), all sources at once;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with CUDA-event timings of the kernel,
   the plain version and one library call, and the bound;
3. the port's scene training step on the card against the same step on
   the CPU (plain versions), on a small input;
4. the main path: the canonical scene configuration (1024 rays, proposal
   (256, 96) → 48 samples, SDF hash 16 × 2 × 2^19, 2×256 MLPs, RENI latent
   100 with 6 attention layers, 492 light directions, the converted frozen
   prior) trained a few steps through the port's ``Trainer``; each
   kernel's launch count is zeroed just before and read just after; then
   one more step under ``torch.profiler`` (device time by kernel);
5. one JSON line listing every kernel, the card line, and the final
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from neusky_torch.configs.neusky_config import neusky_model_config
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine.checkpoint import prior_asset_path
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig, train_loss_fn
from neusky_torch.ops import hashgrid_cuda as k1
from neusky_torch.tree import tree_items, tree_map

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
STEPS = 4
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


KERNEL_BUILDS = {"hashgrid_scatter_add": k1.build}


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


def k1_bound_ms(m: int, t: int):
    """Least time for the function: read idx (4 B) and two fp32 values per
    update, write the 2T fp32 table once; 2 fp32 adds per update."""
    bytes_ms = (12.0 * m + 8.0 * t) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def k1_cases(model_cfg, n_rays: int):
    """The main path's K1 call sites: (name, M, T, launches per step, index
    range, layout).  Plus a heavy-duplicate case (every index in the dense
    17^3-row level 0) and a row-major case with M not a multiple of the
    256-thread block."""
    sites = []
    prop = model_cfg.proposal
    for i, pf in enumerate(model_cfg.proposal_fields):
        m = n_rays * prop.num_proposal_samples[i]
        sites.append((f"proposal_field_{i}", m, pf.hash.table_size, pf.hash.num_levels, None, True))
    sh = model_cfg.sdf_field.hash
    sites.append(("sdf_field_outputs", n_rays * prop.num_final_samples, sh.table_size, sh.num_levels, None, True))
    if model_cfg.losses.hashgrid_density:
        r3 = model_cfg.losses.hashgrid_density_grid_resolution ** 3
        sites.append(("density_grid_sdf", r3, sh.table_size, sh.num_levels, None, True))
    extra = [
        ("sdf_dense_level0_heavy_duplicates", n_rays * prop.num_final_samples, sh.table_size, 0, 17**3, True),
        ("row_major_odd_m", n_rays * prop.num_proposal_samples[0] + 77, model_cfg.proposal_fields[0].hash.table_size,
         0, None, False),
    ]
    return sites, extra


def check_k1(model_cfg, n_rays: int):
    sites, extra = k1_cases(model_cfg, n_rays)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, m, t, per_step, rng_hi, transposed in sites + extra:
        hi = t if rng_hi is None else rng_hi
        idx = torch.randint(0, hi, (m,), generator=g, device="cuda", dtype=torch.int32)
        shape = (2, m) if transposed else (m, 2)
        upd = torch.randn(shape, generator=g, device="cuda")
        if transposed:
            kern = lambda: k1.scatter_add_tablegrad_t(idx, upd, t)
            plain = lambda: k1.scatter_add_plain_t(idx, upd, t)
            library = lambda: torch.zeros((2, t), device="cuda").index_add_(1, idx, upd)
        else:
            kern = lambda: k1.scatter_add_tablegrad(idx, upd, t)
            plain = lambda: k1.scatter_add_plain(idx, upd, t)
            library = lambda: torch.zeros((t, 2), device="cuda").index_add_(0, idx, upd)
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        # atomics reorder each row's sum: tolerance 1e-4 (the Pallas test's)
        # up to 64 updates a row, growing linearly with the updates a row takes
        max_dup = int(torch.bincount(idx.long(), minlength=t).max())
        atol = 1e-4 * max(1.0, max_dup / 64.0)
        err = float((out - ref).abs().max())
        if not (math.isfinite(err) and err <= atol):
            raise AssertionError(f"K1 {name}: max |kernel - plain| = {err} > {atol}")
        bound, by = k1_bound_ms(m, t)
        row = dict(case=name, M=m, T=t, layout="[2,M]->[2,T]" if transposed else "[M,2]->[T,2]",
                   launches_per_step=per_step, max_dup=max_dup, max_abs_err=err, atol=atol,
                   ms=time_ms(kern), plain_ms=time_ms(plain), library_ms=time_ms(library),
                   bound_ms=bound, bound_by=by, call_ms=time_ms(kern, hold_card=False))
        log("k1 case " + json.dumps(row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the configuration


def scene_config(**kw):
    cfg = neusky_model_config(8, 2, **kw)
    return dataclasses.replace(
        cfg, ddf=None, use_visibility=False, fit_visibility_field=False,
        losses=dataclasses.replace(cfg.losses, sdf_level_set_visibility=False),
    )


def expected_launches_per_step(cfg) -> int:
    n = sum(pf.hash.num_levels for pf in cfg.proposal_fields if pf.stochastic_table_grad)
    n += cfg.sdf_field.hash.num_levels  # field_outputs
    if cfg.losses.hashgrid_density:
        n += cfg.sdf_field.hash.num_levels  # density-grid SDF query
    return n


# ---------------------------------------------------------------------------
# phase 3: the step on the card against the same step on the CPU


def check_step_cuda_vs_cpu():
    """A small input (canonical widths, 2 images × 16 rays, a 2^16 SDF
    table so the CPU side stays quick): the same params, batch and draws
    through train_loss_fn on the card (K1) and on the CPU (plain scatter).
    Losses must agree to 1e-4 relative and every gradient array to 2e-3 of
    its largest entry (fp32 with other reduction orders and atomics)."""
    cfg = scene_config()
    cfg = dataclasses.replace(
        cfg, sdf_field=dataclasses.replace(cfg.sdf_field, hash=dataclasses.replace(cfg.sdf_field.hash, log2_hashmap_size=16)),
        num_train_data=2,
    )
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    out = {}
    cpu_model = NeuSkyModel(cfg, device="cpu")
    params0 = cpu_model.init(torch.Generator().manual_seed(3))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    batch = dm.next_train(0)
    draws = cpu_model.draw(None, torch.Generator().manual_seed(4), batch["pixel_coords"].shape[0])
    for dev in ("cpu", "cuda"):
        model = NeuSkyModel(cfg, device=dev)
        params = tree_map(lambda x: x.detach().clone().to(dev), params0)
        for k, v in tree_items(params):
            if k.split("/")[0] not in ("eval_latents", "illumination_decoder"):
                v.requires_grad_(True)
        b = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in batch.items()}
        b["cameras"] = batch["cameras"].to(dev)
        d = {k: ([x.to(dev) for x in v] if isinstance(v, list) else v.to(dev)) for k, v in draws.items()}
        before = k1.launches[k1.KERNEL_NAME]
        total, aux = train_loss_fn(model, PipelineConfig(), params, b, 10.0, d)
        total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            check(k1.launches[k1.KERNEL_NAME] - before == expected_launches_per_step(cfg), "K1 launches on the card")
        out[dev] = (float(total.detach()), {k: float(v) for k, v in aux["loss_dict"].items()},
                    {k: v.grad.detach().cpu() for k, v in tree_items(params) if v.grad is not None})
    (tc, lc, gc), (tg, lg, gg) = out["cpu"], out["cuda"]
    check(math.isfinite(tg) and abs(tg - tc) <= 1e-4 * abs(tc), (tg, tc))
    for k in lc:
        check(abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) + 1e-7, (k, lg[k], lc[k]))
    worst = 0.0
    for k in gc:
        scale = float(gc[k].abs().max())
        if scale == 0:
            continue
        rel = float((gg[k] - gc[k]).abs().max()) / scale
        worst = max(worst, rel)
        check(rel <= 2e-3, (k, rel))
    log(f"step on the card vs the CPU: total {tg:.6f} vs {tc:.6f}, worst grad rel err {worst:.2e}")


# ---------------------------------------------------------------------------
# phase 4: the main path


def run_main_path(card: str):
    cfg = scene_config()
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=64, height=64))
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128),
                          num_sky_rays=256),
        scene["cameras"], scene["images"], scene["masks"], device="cuda",
    )
    model = NeuSkyModel(cfg, device="cuda")
    trainer = Trainer(TrainerConfig(max_num_iterations=100001, steps_per_log=1, seed=0),
                      model, PipelineConfig(), dm, device="cuda")
    prior_file = np.load(prior_asset_path(cfg))
    q = prior_file["illumination_decoder/params/decoder/block_0/MultiHeadDotProductAttention_0/query/kernel"]
    got = trainer.params["illumination_decoder"]["params"]["decoder"]["block_0"]["MultiHeadDotProductAttention_0"]["query"]["kernel"]
    check(np.array_equal(got.cpu().numpy(), q), "the frozen prior was not loaded")
    start = {k: v.detach().clone() for k, v in tree_items(trainer.params)}
    n_rays = 8 * 128
    expected = expected_launches_per_step(cfg)
    log(f"main path: {n_rays} rays/step, {model.num_directions} light directions, "
        f"expecting {expected} K1 launches/step")

    k1.launches[k1.KERNEL_NAME] = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(STEPS):
        before = k1.launches[k1.KERNEL_NAME]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = trainer.run(1)[-1]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = k1.launches[k1.KERNEL_NAME] - before
        losses = {k: v for k, v in rec.items() if k.endswith("_loss")}
        log(f"step {s}: {dt * 1e3:.1f} ms, {n_rays / dt:.1f} rays/s ({card}); K1 launches {n}; "
            + json.dumps(losses))
        for k, v in rec.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"step {s}: {k} = {v}")
        if n != expected:
            raise AssertionError(f"step {s}: {n} K1 launches, expected {expected}")
        steps.append(dt)
    main_launches = k1.launches[k1.KERNEL_NAME]
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"steady step (mean of steps 1..{STEPS - 1}): {np.mean(steps[1:]) * 1e3:.1f} ms, "
        f"{n_rays / np.mean(steps[1:]):.1f} rays/s ({card})")

    end = dict(tree_items(trainer.params))
    for group in trainer.optimizer.group_names:
        changed = any(not torch.equal(start[k], v.detach()) for k, v in end.items()
                      if k.split("/")[0].startswith(group) and v.requires_grad)
        if not changed:
            raise AssertionError(f"trainable group {group} did not change in {STEPS} steps")
    for k, v in end.items():
        if k.startswith("illumination_decoder/") and not torch.equal(start[k], v):
            raise AssertionError(f"frozen {k} changed")
    log("trainable groups changed: " + ", ".join(trainer.optimizer.group_names))
    profile_step(trainer, float(np.mean(steps[1:])), card)
    return main_launches


# device-op name fragments → kind, first match wins
KERNEL_KINDS = (
    ("K1", ("scatter_add_f2_kernel",)),
    ("matmul", ("gemm", "gemv", "Kernel2", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("gather/scatter", ("index", "gather", "scatter")),
    ("reduce/scan/sort", ("reduce", "scan", "cumsum", "cumprod", "sort", "softmax")),
    ("copy/fill", ("copy", "fill", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "Functor")),
)


def profile_step(trainer: Trainer, steady_s: float, card: str, top: int = 15):
    """One more step under ``torch.profiler``: device time by kernel name,
    its sum against the steady (unprofiled) step time, and K1's share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run(1)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        # device-side user annotations (the optimizer's range) are spans
        # over kernels, not work of their own
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        log("step profile: the profiler saw no device events; device time not measured")
        return
    device_ms = sum(us for _, us in by_name.values()) / 1e3
    n_kernels = sum(n for n, _ in by_name.values())
    k1_ms = sum(us for name, (_, us) in by_name.items() if "scatter_add_f2_kernel" in name) / 1e3
    log(f"step profile ({card}): device busy {device_ms:.3f} ms of the {steady_s * 1e3:.3f} ms steady step "
        f"({device_ms / (steady_s * 1e3):.3f}); {n_kernels} device ops under {len(by_name)} names; "
        f"K1 {k1_ms:.3f} ms")
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

    rows = check_k1(scene_config(), 8 * 128)
    check_step_cuda_vs_cpu()
    main_launches = run_main_path(card)

    sites = [r for r in rows if r["launches_per_step"] > 0]
    per_step = lambda key: sum(r[key] * r["launches_per_step"] for r in sites)
    kernels = [{
        "name": k1.KERNEL_NAME,
        "route": "cuda",
        "source": "neusky_torch/csrc/hashgrid_scatter.cu",
        "replaces": "neusky_tpu/ops/hashgrid_pallas.py:47",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times are per training step: the sum over the step's launches at
        # each call site's shape
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
