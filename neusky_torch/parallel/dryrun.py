"""The multi-device dry run (counterpart of ``__graft_entry__.py::
dryrun_multichip``): the full joint training step (scene, RENI, DDF
visibility, DDF fit) of a tiny model over an n-rank mesh, held against a
one-process run of the same batch and draws that runs as the ranks do: one
eager step over gloo, the captured step over NCCL (three calls: eager,
captured, replayed).

    python -m neusky_torch.parallel.dryrun 4 --device cpu --backend gloo
    python -m neusky_torch.parallel.dryrun 4 --backend nccl   # four cards

The configuration and batch are JAX's ``_tiny_configs`` and
``_tiny_batch`` (:func:`neusky_torch.entry.tiny_configs`,
:func:`neusky_torch.entry.tiny_batch`), the batch drawn from a seed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import torch

from neusky_torch.device import resolve_device
from neusky_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig
from neusky_torch.entry import tiny_batch, tiny_configs
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.parallel.launch import run_ranks
from neusky_torch.parallel.mesh import check_backend, make_mesh, make_train_step, replicate, shard_batch
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

LOSS_RTOL = 1e-3  # JAX's bound


def _pipeline() -> PipelineConfig:
    return PipelineConfig(
        visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=8,
                                                  only_sample_upper_hemisphere=True, concentration=20.0),
        num_sky_rays=16)


def _mesh_dirs(n_devices: int) -> int:
    """2-D ``data`` × ``dirs`` mesh of shape (n/2, 2) when n ≥ 4 is even."""
    return 2 if n_devices >= 4 and n_devices % 2 == 0 else 1


def _one_step(device, mesh, n_devices: int, graphed=None) -> dict:
    """The joint step of the tiny model on the batch of 16 · ``n_devices``
    rays (this rank's shard with ``mesh``) → the (global) total loss of
    its last call and its graph replays.  ``graphed`` as
    :func:`make_train_step` takes it.  A captured step (on the card, alone
    or over NCCL) is called three times from one generator stream:
    eagerly, then captured, then replayed; an eager one once."""
    model = NeuSkyModel(tiny_configs(), device=device)
    model.set_mesh(mesh)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = replicate(model.init(gen), mesh)
    groups = {name: OptimizerGroupConfig(lr=1e-3, schedule="constant", max_steps=10)
              for name in ("proposal_networks", "fields", "illumination_field", "visibility_sigmoid", "ddf_field")}
    optimizer = GroupedAdam(params, groups)
    batch = shard_batch(tiny_batch(1, model.device, n_rays=16 * n_devices), mesh)
    step_fn = make_train_step(model, _pipeline(), optimizer, mesh=mesh, graphed=graphed)
    captured = getattr(step_fn, "captured", None)
    gen.manual_seed(3)
    for s in range(3 if captured else 1):
        total = float(step_fn(params, batch, float(s), generator=gen)["total_loss"])
    return {"total_loss": total, "replays": captured.replays if captured else 0}


def _rank(rank: int, world_size: int, init_method: str, device: str, backend: str) -> dict:
    dev = f"cuda:{rank}" if backend == "nccl" else device
    if dev == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(1)
    mesh = make_mesh(world_size, _mesh_dirs(world_size), backend=backend, rank=rank, init_method=init_method,
                     device=dev)
    return _one_step(dev, mesh, world_size)


def dryrun_multichip(n_devices: int, device="cuda", backend: str = "nccl") -> dict:
    """Run the tiny joint step on ``n_devices`` ranks (a ``data`` mesh, or
    ``data`` × ``dirs`` = (n/2, 2) when n ≥ 4 is even), each its own
    process on ``device`` (with NCCL rank r on ``cuda:r``), and in this
    process on the whole batch with the same draws; raise unless the
    losses agree to 1e-3 relative.  Over NCCL each rank's step is its
    captured step, replayed (as the one-process step on the card); over
    gloo both run eagerly.  Entry point: runs on the card unless
    ``device="cpu"``; the ``backend`` is the caller's (``nccl``: a card a
    rank; ``gloo``: the CPU, or ranks sharing a card).  → the losses, the
    relative difference, the mesh shape and the ranks' graph replays."""
    dev = resolve_device(device)
    check_backend(backend, n_devices)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl needs CUDA devices; the CPU takes gloo")
    results = run_ranks("neusky_torch.parallel.dryrun:_rank", n_devices, dict(device=str(dev), backend=backend))
    totals = [r["total_loss"] for r in results]
    if not all(math.isfinite(t) for t in totals) or len(set(totals)) != 1:
        raise AssertionError(f"dryrun_multichip({n_devices}): rank losses {totals}")
    total = totals[0]
    # gloo ranks run eagerly, also when they share a card: so does this side
    one = _one_step(dev, None, n_devices, graphed=None if backend == "nccl" else False)
    total1 = one["total_loss"]
    rel = abs(total - total1) / max(abs(total1), 1e-8)
    dirs = _mesh_dirs(n_devices)
    shape = {"data": n_devices // dirs, **({"dirs": dirs} if dirs > 1 else {})}
    replays = [r["replays"] for r in results]
    if replays != [one["replays"]] * n_devices:
        raise AssertionError(f"rank replays {replays}, one process {one['replays']}: one side ran eagerly")
    if not rel < LOSS_RTOL:
        raise AssertionError(f"{n_devices}-rank loss {total:.6f} != one-process loss {total1:.6f} (rel {rel:.2e})")
    print(f"dryrun_multichip({n_devices}) mesh {shape} loss matches the one-process run: {total:.6f} vs "
          f"{total1:.6f} (rel err {rel:.2e}; {replays[0]} graph replays a rank)")
    return {"mesh": shape, "total_loss": total, "total_loss_one_process": total1, "rel_err": rel,
            "replays": replays[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n_devices, args.device, args.backend)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
