"""The port's command line against the JAX package's, on the CPU: the
registered methods' configs, the dotted overrides, the datamanager that
``cli train`` builds from a NeRF-OSR and a Blender fixture, and the
train → eval → render round trip on the fixture.  One ``neusky-tiny``
joint step on a fixture batch is ``test_torch_cli_step.py``."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neusky_torch import cli as t_cli
from neusky_torch.configs import METHOD_REGISTRY as T_REGISTRY
from neusky_torch.data.fixtures import make_blender_fixture, make_nerfosr_fixture
from neusky_torch.tree import tree_items
from neusky_tpu import cli as j_cli
from neusky_tpu.configs import METHOD_REGISTRY as J_REGISTRY
from torch_parity import one_torch_thread, to_torch_config  # noqa: F401 (one_torch_thread: the fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
HOLDOUT = "0,0"


def _args(data, rays=64, **kw):
    """The arguments ``_build_datamanager`` and ``_load_run`` read."""
    return argparse.Namespace(**{"synthetic_demo": False, "data": data and str(data), "scene": "site1", "downscale": 1,
                                 "rays_per_batch": rays, "session_holdout_indices": HOLDOUT, "device": "cpu", **kw})


def small_nerfosr_fixture(root):
    """The port's NeRF-OSR fixture: 2 sessions, 2 train, 1 validation and
    2 test views each, 24 × 16."""
    return make_nerfosr_fixture(root, num_sessions=2, train_per_session=2, test_per_session=2, width=24, height=16)


@pytest.fixture(scope="module")
def osr_root(tmp_path_factory):
    return small_nerfosr_fixture(tmp_path_factory.mktemp("osr"))


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender"), width=24, height=16)


# ---------------------------------------------------------------------------
# the registry and the overrides


def test_registries_name_the_same_methods():
    assert sorted(T_REGISTRY) == sorted(J_REGISTRY) == [
        "ddf", "neusky", "neusky-synthetic", "neusky-synthetic-tiny", "neusky-tiny"]


@pytest.mark.parametrize("name", sorted(J_REGISTRY))
def test_method_bundle_matches_jax(name):
    """Every key of the bundle, every config field for field (JAX's
    ``TrainerConfig.mixed_precision``, which nothing reads, left out)."""
    want, got = J_REGISTRY[name].build(), T_REGISTRY[name].build()
    assert sorted(got) == sorted(want)
    for k in want:
        assert to_torch_config(want[k]) == got[k], k
    assert T_REGISTRY[name].description == J_REGISTRY[name].description


def test_tiny_recipe_leaves_the_decoder_unnamed():
    """``fixed_decoder=False`` in the tiny recipes, and no optimizer group
    trains ``illumination_decoder`` (the optimizer labels it frozen)."""
    for name in ("neusky-tiny", "neusky-synthetic-tiny"):
        b = T_REGISTRY[name].build()
        assert not b["model_config"].illumination.fixed_decoder
        assert "illumination_decoder" not in b["optimizer_groups"] and "frozen" not in b["optimizer_groups"]


OVERRIDES = [
    [("model.num_illumination_directions", "24")],
    [("model.illumination.fixed_decoder", "true"), ("model.use_visibility", "0")],
    [("model.sdf_field.bias", "0.5"), ("model.collider_shape", "aabb")],
    [("pipeline.visibility_train_sampler.concentration", "10")],
    [("trainer.steps_per_log", "1"), ("trainer.output_dir", "elsewhere")],
    [("model.proposal.num_proposal_samples", "[16, 8]")],
    [("dataparser", '"nerfosr"')],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: o[0][0])
def test_apply_overrides_matches_jax(overrides):
    want = j_cli._apply_overrides(J_REGISTRY["neusky-synthetic-tiny"].build(), overrides)
    got = t_cli._apply_overrides(T_REGISTRY["neusky-synthetic-tiny"].build(), overrides)
    assert to_torch_config(want) == got


def test_set_dotted_casts_to_the_fields_type():
    cfg = T_REGISTRY["neusky-tiny"].build()["model_config"]
    out = t_cli._set_dotted(cfg, "illumination.latent_dim", "12")
    assert out.illumination.latent_dim == 12 and cfg.illumination.latent_dim == 8
    assert t_cli._set_dotted(cfg, "use_visibility", "No").use_visibility is False
    assert t_cli._set_dotted(cfg, "ddf_radius", "2").ddf_radius == 2.0
    assert t_cli._set_dotted(cfg, "loss_coefficients", "[[\"a\", 1.0]]").loss_coefficients == [["a", 1.0]]


@pytest.mark.parametrize("dotted,exc", [
    ("nope.x", KeyError), ("model.num_train_data.x", ValueError), ("model.no_such_field", AttributeError),
    ("model.num_train_data", ValueError),
])
def test_apply_overrides_errors_match_jax(dotted, exc):
    value = "x" if dotted == "model.num_train_data" else "1"
    with pytest.raises(exc) as want:
        j_cli._apply_overrides(J_REGISTRY["neusky-tiny"].build(), [(dotted, value)])
    with pytest.raises(exc) as got:
        t_cli._apply_overrides(T_REGISTRY["neusky-tiny"].build(), [(dotted, value)])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the datamanager of ``cli train``


def dm_pair(root, method: str, rays: int = 64):
    """(JAX's, the port's) ``_build_datamanager`` of ``method`` on ``root``."""
    j_bundle, t_bundle = J_REGISTRY[method].build(), T_REGISTRY[method].build()
    parser = j_bundle.get("dataparser", "nerfosr")
    assert parser == t_bundle.get("dataparser", "nerfosr")
    args = _args(root, rays)
    return (j_cli._build_datamanager(args, j_bundle["model_config"], parser),
            t_cli._build_datamanager(args, t_bundle["model_config"], parser))


def _assert_batches_equal(jb, tb):
    host = {k: v for k, v in jb.items() if k != "cameras"}
    assert sorted(host) == sorted(k for k in tb if k != "cameras")
    for k, v in host.items():
        assert np.array_equal(tb[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("fixture,method", [("osr_root", "neusky-tiny"), ("blender_root", "neusky-synthetic-tiny")])
def test_build_datamanager_matches_jax(request, fixture, method):
    """Splits, cameras and the first three training batches with their sky
    rays (the Blender fixture has no sky mask, so none)."""
    jdm, tdm = dm_pair(request.getfixturevalue(fixture), method)
    assert (tdm.num_train, tdm.num_eval) == (jdm.num_train, jdm.num_eval)
    for split in ("train", "eval"):
        for k in ("images", "masks"):
            assert np.array_equal(getattr(tdm, f"{split}_{k}"), getattr(jdm, f"{split}_{k}")), (split, k)
        tc, jc = getattr(tdm, f"{split}_cameras"), getattr(jdm, f"{split}_cameras")
        for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
            assert np.array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k))), (split, k)
    ps_j, ps_t = jdm.config.pixel_sampler, tdm.config.pixel_sampler
    assert (ps_t.images_per_batch, ps_t.rays_per_image) == (ps_j.images_per_batch, ps_j.rays_per_image)
    for step in range(3):
        jb, tb = jdm.next_train(step), tdm.next_train(step)
        _assert_batches_equal(jb, tb)
        assert ("sky_cam_idx" in tb) == (fixture == "osr_root")


def test_build_datamanager_synthetic_demo_matches_jax():
    args = _args(None, 64, synthetic_demo=True)
    jdm = j_cli._build_datamanager(args, J_REGISTRY["neusky-tiny"].build()["model_config"])
    tdm = t_cli._build_datamanager(args, T_REGISTRY["neusky-tiny"].build()["model_config"])
    assert np.array_equal(tdm.train_images, jdm.train_images)
    _assert_batches_equal(jdm.next_train(0), tdm.next_train(0))


# ---------------------------------------------------------------------------
# the command line end to end


def _common(root):
    return ["--data", str(root), "--session-holdout-indices", HOLDOUT, "--device", "cpu"]


def test_cli_train_eval_render_on_the_fixture(osr_root, tmp_path, capsys):
    """2 training steps (a save at each, every step logged), then ``eval``
    (the 250-step latent fit, the renders and scores of both validation
    views) and ``render`` from the checkpoint."""
    run = tmp_path / "run"
    t_cli.main(["train", "neusky-tiny", *_common(osr_root), "--max-iterations", "2", "--rays-per-batch", "32",
                "--output-dir", str(run), "--trainer.steps_per_log", "1", "--trainer.steps_per_save", "1"])
    logs = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(v) for r in logs for v in r.values())
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step-000000001", "step-000000002"]
    assert json.loads((run / "latest.json").read_text()) == {"step": 2}
    # fixed_decoder=False, yet the optimizer leaves the decoder where it was
    from neusky_torch.engine.checkpoint import STATE_FILE

    steps = [dict(tree_items(torch.load(run / "checkpoints" / f"step-00000000{i}" / STATE_FILE,
                                        weights_only=True)["params"])) for i in (1, 2)]
    decoder = [k for k in steps[0] if k.startswith("illumination_decoder/")]
    assert decoder and all(torch.equal(steps[0][k], steps[1][k]) for k in decoder)
    assert not torch.equal(steps[0]["illumination_field/train_latents"], steps[1]["illumination_field/train_latents"])

    t_cli.main(["eval", "neusky-tiny", *_common(osr_root), "--rays-per-batch", "32", "--load-dir", str(run)])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(metrics) == ["fps", "lpips", "mse", "num_rays_per_sec", "psnr", "ssim"]
    assert all(np.isfinite(v) for v in metrics.values())

    out = tmp_path / "render.npy"
    t_cli.main(["render", "neusky-tiny", *_common(osr_root), "--load-dir", str(run), "--image-idx", "1",
                "--output", str(out)])
    img = np.load(out)
    assert img.shape == (16, 24, 3) and img.dtype == np.float32 and np.isfinite(img).all()
    assert 0 <= img.min() and img.max() <= 1


def test_load_run_restores_the_checkpoint(osr_root, tmp_path):
    """``_load_run`` gives the params that training saved, leaf for leaf;
    without ``--load-dir`` it keeps the initial params (no prior)."""
    from neusky_torch.engine.checkpoint import STATE_FILE
    from neusky_torch.engine.eval_loop import _load_run

    run = tmp_path / "run"
    t_cli.main(["train", "neusky-tiny", *_common(osr_root), "--max-iterations", "1", "--rays-per-batch", "16",
                "--output-dir", str(run)])
    saved = torch.load(run / "checkpoints" / "step-000000001" / STATE_FILE, weights_only=True)["params"]
    args = _args(osr_root, 16, load_dir=str(run), method="neusky-tiny")
    model, params, dm = _load_run(args, [])
    assert (model.config.num_train_data, model.config.num_eval_data) == (dm.num_train, dm.num_eval) == (4, 2)
    saved_flat = dict(tree_items(saved))
    for k, v in tree_items(params):
        assert torch.equal(v.detach(), saved_flat[k]), k
    fresh = dict(tree_items(_load_run(_args(osr_root, 16, load_dir=None, method="neusky-tiny"), [])[1]))
    assert not torch.equal(fresh["illumination_field/train_latents"], saved_flat["illumination_field/train_latents"])


def test_cli_module_runs_as_a_program(tmp_path):
    """``python -m neusky_torch.cli train neusky-tiny --synthetic-demo
    --device cpu``: one step, its log line, a checkpoint."""
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "neusky_torch.cli", "train", "neusky-tiny", "--synthetic-demo", "--device", "cpu",
         "--max-iterations", "1", "--rays-per-batch", "64", "--output-dir", str(out)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    logs = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(logs) == 1 and logs[0]["step"] == 1 and np.isfinite(logs[0]["total_loss"])
    assert json.loads((out / "latest.json").read_text()) == {"step": 1}


@pytest.mark.parametrize("argv,item", [
    (["train", "ddf", "--synthetic-demo"], "item 11"),
    (["eval", "neusky-tiny", "--synthetic-demo", "--protocol", "nerfosr"], "item 10"),
])
def test_unported_commands_raise(argv, item):
    """The two commands that raised ``NotImplementedError``, naming a
    roadmap item, are ported: without ``--load-dir`` they exit as JAX's do,
    naming the flag and no roadmap item."""
    with pytest.raises(SystemExit, match="--load-dir") as e:
        t_cli.main(argv + ["--device", "cpu"])
    assert item not in str(e.value)


def test_unparsed_argument_exits():
    with pytest.raises(SystemExit, match="unparsed argument: --dangling"):
        t_cli.main(["train", "neusky-tiny", "--synthetic-demo", "--device", "cpu", "--dangling"])
