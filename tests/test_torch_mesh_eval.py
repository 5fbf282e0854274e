"""The eval pass of ``Trainer(mesh=)`` against the one-process pass, on the
CPU: four gloo ranks (``data`` × ``dirs`` = 2 × 2, started by
``neusky_torch.parallel.launch.run_ranks``; rank code in
``tests/torch_mesh_ranks.py``) train one step of the tiny joint config of
``test_torch_joint_slice`` on a 16×16 synthetic scene with an eval ring of
2 cameras, then run the eval pass of the cadence: the 250-step latent fit
of both eval slots, the render of eval image 0 and its scores.

JAX's ``Trainer(mesh=)`` runs this pass as its one-process pass
(``neusky_tpu/engine/trainer.py:163-204``), so every rank's eval record
(PSNR, SSIM, LPIPS, MSE; not the render's timings) must be the record of a
one-process trainer given rank 0's params, within 1e-6 relative, and the
fitted eval latents bitwise equal on every rank."""

from pathlib import Path

import numpy as np
import pytest
import torch

from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine import trainer as trainer_module
from neusky_torch.parallel.launch import run_ranks
from neusky_torch.tree import tree_items
from test_torch_joint_slice import PIPE, tiny_joint_config
from torch_mesh_ranks import capture_eval_fit, eval_trainer
from torch_parity import to_torch_config

TESTS = Path(__file__).resolve().parent
EVAL_KEYS = ("eval_psnr", "eval_ssim", "eval_lpips", "eval_mse")
REL = 1e-6


@pytest.fixture(scope="module")
def setup():
    cfg, pipe = to_torch_config(tiny_joint_config(False)), to_torch_config(PIPE)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=6, width=16, height=16))
    eval_scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=16, height=16,
                                                               angle_offset=float(np.pi / 8.0), camera_height=0.5))
    ranks = run_ranks("torch_mesh_ranks:eval_rank", 4, dict(dirs=2, cfg=cfg, pipe=pipe, scene=scene,
                                                            eval_scene=eval_scene), paths=(TESTS,))
    return cfg, pipe, scene, eval_scene, ranks


@pytest.fixture(scope="module")
def one_process(setup):
    """The eval pass of a one-process trainer given rank 0's params at the
    eval: (its eval record, its fitted eval group)."""
    cfg, pipe, scene, eval_scene, ranks = setup
    saved = torch.get_num_threads()
    fits: list = []
    fit = trainer_module.fit_eval_latents
    torch.set_num_threads(1)
    try:
        capture_eval_fit(trainer_module, fits)
        trainer = eval_trainer(cfg, pipe, scene, eval_scene)
        with torch.no_grad():
            for k, t in tree_items(trainer.params):
                t.copy_(torch.from_numpy(ranks[0]["params_in"][k]))
        trainer.step = 1
        trainer._eval_image_pass()
    finally:
        trainer_module.fit_eval_latents = fit
        torch.set_num_threads(saved)
    return trainer.history[-1], fits[0][1]


def _eval_record(history):
    (rec,) = [h for h in history if "eval_psnr" in h]
    return rec


def test_mesh_eval_record_is_the_one_process_record(setup, one_process):
    """Each rank's eval record is the one-process record within 1e-6."""
    want, _ = one_process
    for r, rank in enumerate(setup[4]):
        got = _eval_record(rank["history"])
        assert got["step"] == want["step"] == 1
        for k in EVAL_KEYS:
            assert np.isfinite(want[k]), k
            assert abs(got[k] - want[k]) <= REL * abs(want[k]), (r, k, got[k], want[k])


def test_mesh_eval_latents_are_bitwise_equal_on_every_rank(setup, one_process):
    """Every rank fits the same eval group, bit for bit, and it is the
    one-process fit's within 1e-6."""
    ranks = setup[4]
    first = ranks[0]["eval_latents"]
    assert sorted(first) == sorted(one_process[1])
    for rank in ranks[1:]:
        for k, v in first.items():
            assert np.array_equal(rank["eval_latents"][k], v), k
    for k, v in first.items():
        np.testing.assert_allclose(v, one_process[1][k], rtol=REL, atol=REL * np.abs(one_process[1][k]).max(),
                                   err_msg=k)



def test_eval_pass_runs_off_the_mesh_and_restores_it_when_it_raises(setup, monkeypatch):
    """The pass sees the model without its mesh, and the model is back on
    it after a pass that raises (a stand-in mesh: nothing here meets in a
    collective)."""
    cfg, pipe, scene, eval_scene, _ = setup
    trainer = eval_trainer(cfg, pipe, scene, eval_scene)
    mesh = object()
    trainer.mesh = mesh
    trainer.model.set_mesh(mesh)
    seen = []

    def failing_fit(model, *a, **k):
        seen.append(model.mesh)
        raise RuntimeError("planted eval failure")

    monkeypatch.setattr(trainer_module, "fit_eval_latents", failing_fit)
    trainer.step = 1
    with pytest.raises(RuntimeError, match="planted"):
        trainer._eval_image_pass()
    assert seen == [None] and trainer.model.mesh is mesh
