"""Fixtures of the benchmark's CPU tests: a tiny cell (the ``neusky-tiny``
recipe on a 4-image scene) written as data files into a temporary folder,
as a later change would add one."""

from __future__ import annotations

import json

import pytest

TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 0.3, "leaf_grad_gap": 1e-3,
                "leaf_change_gap": 1e-3}
VIEW_LIMITS = {"rgb_rmse": 1e-4}


@pytest.fixture
def tiny_cells(tmp_path):
    """(base folder, manifest) of the cells ``tiny.train`` and ``tiny.view``."""
    from benchmark import cfgjson, run
    from neusky_torch.configs import METHOD_REGISTRY

    for d in ("configs", "workloads", "traffic"):
        (tmp_path / d).mkdir()
    bundle = METHOD_REGISTRY["neusky-tiny"].build(num_train_data=4, num_eval_data=2)
    cfg = {"name": "tiny", "method": "neusky-tiny", "prior_file": None, "bundle": cfgjson.encode(bundle),
           "assumed": {"train_images": 4, "eval_images": 2, "width": 16, "height": 16}}
    files = {
        "configs/tiny.json": cfg,
        "traffic/tiny_batch.json": {"images_per_batch": 16, "rays_per_batch": 64, "sky_rays": 16},
        "traffic/tiny_orbit.json": {"resolution": 8, "warmup_frames": 2, "poses": 16, "check_frames": 3},
        "workloads/tiny.train.json": {"name": "tiny.train", "config": "tiny", "traffic": "tiny_batch",
                                      "loop": "train", "chips": 1, "limits": TRAIN_LIMITS},
        "workloads/tiny.view.json": {"name": "tiny.view", "config": "tiny", "traffic": "tiny_orbit",
                                     "loop": "view", "chips": 1, "limits": VIEW_LIMITS},
    }
    for rel, obj in files.items():
        (tmp_path / rel).write_text(json.dumps(obj))
    bench = run.manifest()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kinds = {w.rsplit(".", 1)[1] for w in m["workloads"]}
            m["workloads"] = [f"tiny.{k}" for k in sorted(kinds)]
    return tmp_path, bench
