"""The reference's first training steps, and the numbers that judge the
program's against them.

The reference starts from the same weights (:func:`model.make_params`),
draws its batches with its own pixel sampler from the same images, masks
and sampler seed, and its step's draws from a generator seeded as the
program's, in the order the program's step makes them; it runs in float32
with TF32 off, eagerly, with every scatter a plain ``index_add_``."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import torch

from benchmark.reference import model as ref
from benchmark.reference.plain.data.pixel_sampler import PixelSampler, PixelSamplerConfig
from benchmark.reference.plain.engine.optimizers import GroupedAdam
from benchmark.reference.plain.models import neusky, pipeline
from benchmark.reference.plain.tree import tree_items

BETA1 = 0.9  # the first moment's decay of the program's Adam (``GroupedAdam``'s betas)


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products in full precision (the configuration's), or in TF32
    for the control."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def batches(split: Dict, traffic: Dict, sampler_seed: int, n: int, device) -> List[Dict]:
    """The first ``n`` training batches of the pixel sampler (U = min(U,
    images) images × R rays and the sky rays), on ``device``."""
    u = min(traffic["images_per_batch"], split["images"].shape[0])
    sampler = PixelSampler(PixelSamplerConfig(images_per_batch=u, rays_per_image=traffic["rays_per_batch"] // u),
                           split["images"], split["masks"], seed=sampler_seed)
    cams = ref.split_cameras(split, device)
    out = []
    for _ in range(n):
        b = sampler.sample_batch()
        sky = sampler.sample_sky_rays(traffic["sky_rays"])
        if sky is not None:
            b["sky_cam_idx"], b["sky_pixel_coords"] = sky
        out.append(ref.batch_to_device(b, cams, device))
    return out


def half_batch(batch: Dict) -> Dict:
    """A fault: the first half of the batch's scene rays alone (the loss
    then the mean over them)."""
    n = batch["pixel_coords"].shape[0] // 2
    return {k: (v[:n] if k in ("cam_idx", "pixel_coords", "image", "mask", "ray_image_idx") else v)
            for k, v in batch.items()}


def is_proposal_table(path: str) -> bool:
    """The proposal density fields' hash tables (2 of K1's 7 sites a step)."""
    return path.startswith("proposal_networks_") and path.endswith("/hash_table")


def zero_proposal_tables(named: Dict[str, torch.Tensor]) -> None:
    """A fault: the proposal hash tables' gradients zeroed before the
    update."""
    for path, t in named.items():
        if is_proposal_table(path) and t.grad is not None:
            t.grad.zero_()


def run_steps(config: Dict, split: Dict, traffic: Dict, seeds, n_steps: int, device, tf32: bool = False,
              fault_batch=None, fault_grads=None) -> Dict:
    """``n_steps`` reference steps → ``losses`` (each step's total),
    ``grads`` (each step's gradient of each trainable leaf as the optimizer
    gets it, host) and ``params`` (the leaves before step 1 and after the
    last, host).  ``fault_batch`` (batch → batch) and ``fault_grads``
    (called with the named leaves after the backward) plant a fault in
    each step."""
    with precision(tf32):
        recipe = ref.recipe(config)
        model = ref.make_model(config, device)
        params = ref.make_params(config, seeds.weights, device)
        start = {k: t.detach().cpu().clone() for k, t in tree_items(params)}
        opt = GroupedAdam(params, recipe["optimizer_groups"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seeds.draws)
        losses, grads = [], []
        for step, batch in enumerate(batches(split, traffic, seeds.sampler, n_steps, device)):
            batch = fault_batch(batch) if fault_batch else batch
            draws = pipeline.draw_step(model, recipe["pipeline_config"], batch, gen)
            opt.zero_grad()
            total, _ = pipeline.train_loss_fn(model, recipe["pipeline_config"], params, batch, float(step), draws)
            total.backward()
            if fault_grads:
                fault_grads(dict(tree_items(params)))
            grads.append({k: (t.grad.detach().cpu().clone() if t.grad is not None else torch.zeros(t.shape))
                          for k, t in tree_items(params) if t.requires_grad})
            opt.step()
            losses.append(float(total.detach()))
        end = {k: t.detach().cpu().clone() for k, t in tree_items(params)}
    return {"losses": losses, "grads": grads, "params": (start, end)}


def count_step_flops(config: Dict, split: Dict, traffic: Dict, seeds, device) -> float:
    """FLOPs of the matrix products of one training step (forward and
    backward), counted by torch's flop counter on the reference step at the
    configuration's shapes, without the visibility chunks' recompute."""
    from torch.utils.flop_counter import FlopCounterMode

    recipe = ref.recipe(config)
    model = ref.make_model(config, device)
    params = ref.make_params(config, seeds.weights, device)
    GroupedAdam(params, recipe["optimizer_groups"])  # marks the trainable leaves, as the step sees them
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.draws)
    batch = batches(split, traffic, seeds.sampler, 1, device)[0]
    draws = pipeline.draw_step(model, recipe["pipeline_config"], batch, gen)
    saved = neusky.checkpoint
    neusky.checkpoint = lambda fn, *a, **_: fn(*a)
    try:
        with FlopCounterMode(display=False) as counter:
            total, _ = pipeline.train_loss_fn(model, recipe["pipeline_config"], params, batch, 0.0, draws)
            total.backward()
    finally:
        neusky.checkpoint = saved
    return float(counter.get_total_flops())


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tree.items()}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / scale if p == p else float("inf")


def leaf_norms(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Each trainable leaf's norms on both sides: ``g_ref``, ``g_prog``
    (its gradient at each step) and ``d_ref``, ``d_prog`` (its change over
    the steps)."""
    if len(program["grads"]) != len(reference["grads"]):
        raise ValueError(f"{len(program['grads'])} program steps against {len(reference['grads'])} reference steps")
    gp = [_norms(g) for g in program["grads"]]
    gr = [_norms(g) for g in reference["grads"]]
    for a, b in zip(gp, gr):
        if set(a) != set(b):
            raise ValueError(f"trainable leaves differ: {sorted(set(a) ^ set(b))}")
    (p0, p1), (r0, r1) = program["params"], reference["params"]
    leaves = sorted(gr[0])
    dp = _norms({k: p1[k].double() - p0[k].double() for k in leaves})
    dr = _norms({k: r1[k].double() - r0[k].double() for k in leaves})
    return {k: {"g_ref": [g[k] for g in gr], "g_prog": [g[k] for g in gp], "d_ref": dr[k], "d_prog": dp[k]}
            for k in leaves}


def compare(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers compared: ``loss_gap``, each step's total loss,
    |program − reference| over |reference|, and the leaf numbers of
    :func:`leaf_numbers`."""
    pl, rl = program["losses"], reference["losses"]
    if len(pl) != len(rl):
        raise ValueError(f"{len(pl)} program steps against {len(rl)} reference steps")
    out = leaf_numbers(leaf_norms(program, reference))
    out["loss_gap"] = max(_gap(p, r, max(abs(r), 1e-12)) for p, r in zip(pl, rl))
    return out


def leaf_numbers(norms: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The numbers of the leaves' norms (:func:`leaf_norms`), each the worst
    over its parts:

    - ``grad_gap``: each trainable leaf's gradient norm at step 1, the gap
      between the two norms over the larger of the reference's norm of
      that leaf and of the median leaf; ``grad_gap_later``: the same at
      the later steps (the SDF's hash table gets its first gradient at
      step 2: the geometric initialisation zeroes it at step 1);
    - ``change_gap``: each leaf's change over the steps, measured alike;
    - ``leaf_grad_gap``, ``leaf_change_gap``: the same gaps over the
      reference's norm of that leaf alone, so that a leaf whose gradient
      is small beside the median leaf's (the proposal networks' at the
      start) is held to its own scale.  A leaf whose reference gradient
      (or change) is exactly zero at a step has no scale of its own there
      and is held by the median numbers alone.

    ``worst`` names the leaf (and step) behind each number."""
    out: Dict[str, Any] = {"worst": {}}

    def worst(key: str, gaps) -> None:
        gap, where = max(gaps, default=(0.0, "none"))
        out[key], out["worst"][key] = gap, where

    steps = range(len(next(iter(norms.values()))["g_ref"]))
    g_med = [_median(n["g_ref"][s] for n in norms.values()) for s in steps]
    for key, chosen in (("grad_gap", steps[:1]), ("grad_gap_later", steps[1:])):
        worst(key, ((_gap(n["g_prog"][s], n["g_ref"][s], max(n["g_ref"][s], g_med[s], 1e-30)), f"{k} (step {s + 1})")
                    for k, n in norms.items() for s in chosen))
    worst("leaf_grad_gap", ((_gap(n["g_prog"][s], n["g_ref"][s], n["g_ref"][s]), f"{k} (step {s + 1})")
                            for k, n in norms.items() for s in steps if n["g_ref"][s] > 0))
    d_med = _median(n["d_ref"] for n in norms.values())
    worst("change_gap", ((_gap(n["d_prog"], n["d_ref"], max(n["d_ref"], d_med, 1e-30)), k) for k, n in norms.items()))
    worst("leaf_change_gap", ((_gap(n["d_prog"], n["d_ref"], n["d_ref"]), k)
                              for k, n in norms.items() if n["d_ref"] > 0))
    return out
