"""Checkpoints and the trainer's save / eval cadences in the PyTorch port,
on the CPU: a bitwise round trip of params and Adam state, the JAX
package's layout (``checkpoints/step-%09d/`` + ``latest.json``) and
sub-tree semantics (``include`` / ``exclude``, the eval-latent reinit on a
shape mismatch, an error on any other), and a tiny ``Trainer`` run that
saves, evaluates, writes events and PNG panels, and resumes."""

import dataclasses
import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.engine import checkpoint as j_ckpt

from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine import checkpoint as t_ckpt
from neusky_torch.engine.optimizers import GroupedAdam, default_neusky_optimizer_groups
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.engine.writer import Writer
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.tree import tree_items, tree_map
from test_torch_eval import EVAL_SCENE
from test_torch_joint_slice import PIPE, tiny_joint_config
from torch_parity import to_torch_config, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def tiny_model(num_eval_data=2):
    cfg = to_torch_config(tiny_joint_config(False))
    return NeuSkyModel(dataclasses.replace(cfg, num_eval_data=num_eval_data), device="cpu")


def trained_state(steps=2):
    """Params and Adam state after ``steps`` updates with seeded gradients."""
    params = tiny_model().init(torch.Generator().manual_seed(0))
    opt = GroupedAdam(params, default_neusky_optimizer_groups(100))
    g = torch.Generator().manual_seed(1)
    for _ in range(steps):
        opt.zero_grad()
        for _, t in tree_items(params):
            if t.requires_grad:
                t.grad = torch.randn(t.shape, generator=g)
        opt.step()
    return params, opt


def _assert_state_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_state_equal(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    else:
        assert a == b


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    params, opt = trained_state()
    path = t_ckpt.save_checkpoint(tmp_path, 2, params, opt.state_dict())
    assert path == tmp_path / "checkpoints" / "step-000000002"
    template = tiny_model().init(torch.Generator().manual_seed(5))
    fresh = GroupedAdam(template, default_neusky_optimizer_groups(100))
    got_params, got_opt, step = t_ckpt.load_checkpoint(tmp_path, None, template, fresh.state_dict())
    assert step == 2
    for k, v in tree_items(params):
        r = dict(tree_items(got_params))[k]
        assert torch.equal(r, v.detach()) and r.requires_grad == v.requires_grad, k
    _assert_state_equal(got_opt, opt.state_dict())
    assert got_opt["count"] == 2 and len(got_opt["adam"]["state"]) > 0


def test_checkpoint_layout_matches_jax(tmp_path):
    """The same directory names and ``latest.json`` as JAX's (whose files
    are orbax's; the formats do not read each other)."""
    for step in (3, 12):
        j_ckpt.save_checkpoint(tmp_path / "jax", step, {"fields": {"w": jnp.ones((3,))}}, {"opt": jnp.zeros(1)})
        t_ckpt.save_checkpoint(tmp_path / "port", step, {"fields": {"w": torch.ones(3)}}, {"count": 0})
    for side in ("jax", "port"):
        assert sorted(p.name for p in (tmp_path / side / "checkpoints").iterdir()) == [
            "step-000000003", "step-000000012"]
    assert json.loads((tmp_path / "port" / "latest.json").read_text()) == json.loads(
        (tmp_path / "jax" / "latest.json").read_text()) == {"step": 12}
    assert t_ckpt.latest_step(tmp_path / "port") == j_ckpt.latest_step(tmp_path / "jax") == 12
    assert t_ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.load_checkpoint(tmp_path / "none", None, {"fields": {"w": torch.ones(3)}}, {})


def _saved(tmp_path):
    params = {"fields": {"w": torch.ones(3)}, "ddf_field": {"w": torch.full((2,), 2.0)},
              "illumination_decoder": {"w": torch.full((2,), 3.0)},
              "eval_latents": {"eval_latents": torch.ones((2, 4, 3)), "eval_scale": torch.ones(2)}}
    t_ckpt.save_checkpoint(tmp_path, 7, params, {"count": 0})
    j_ckpt.save_checkpoint(tmp_path / "jax", 7, tree_map(lambda t: jnp.asarray(t.numpy()), params),
                           {"opt": jnp.zeros(1)})


def _template(fields=3, n_eval=2):
    return {"fields": {"w": torch.zeros(fields)}, "ddf_field": {"w": torch.zeros(2)},
            "illumination_decoder": {"w": torch.zeros(2)},
            "eval_latents": {"eval_latents": torch.zeros((n_eval, 4, 3)), "eval_scale": torch.zeros(n_eval)}}


@pytest.mark.parametrize("include, exclude, n_eval, restored", [
    (("illumination_decoder",), (), 2, {"illumination_decoder"}),
    ((), ("ddf_field",), 2, {"fields", "illumination_decoder", "eval_latents"}),
    ((), (), 5, {"fields", "ddf_field", "illumination_decoder"}),
], ids=["decoder_only", "all_but_ddf", "eval_latents_reinit"])
def test_load_param_subtrees_matches_jax(tmp_path, include, exclude, n_eval, restored):
    """Which groups come from the checkpoint and which keep the template,
    against JAX on the same saved values; a differently sized eval split
    keeps its fresh eval latents."""
    _saved(tmp_path)
    tmpl = _template(n_eval=n_eval)
    got = t_ckpt.load_param_subtrees(tmp_path, 7, tmpl, include=include, exclude=exclude)
    want = j_ckpt.load_param_subtrees(tmp_path / "jax", 7, tree_map(lambda t: jnp.asarray(t.numpy()), tmpl),
                                      include=include, exclude=exclude)
    for k, v in tree_items(got):
        np.testing.assert_array_equal(v.numpy(), np.asarray(dict(tree_items(want))[k]), err_msg=k)
    assert {k.split("/")[0] for k, v in tree_items(got) if float(v.abs().max()) > 0} == restored
    assert got["eval_latents"]["eval_latents"].shape == (n_eval, 4, 3)


def test_load_param_subtrees_refuses_other_mismatches(tmp_path):
    _saved(tmp_path)
    with pytest.raises(ValueError, match="'fields' does not match the model: leaf w shape"):
        t_ckpt.load_param_subtrees(tmp_path, 7, _template(fields=7))
    with pytest.raises(ValueError, match="fields"):
        j_ckpt.load_param_subtrees(tmp_path / "jax", 7, tree_map(lambda t: jnp.asarray(t.numpy()),
                                                                   _template(fields=7)))
    with pytest.raises(ValueError, match="does not match the model"):
        t_ckpt.load_checkpoint(tmp_path, 7, _template(n_eval=5), {})
    assert t_ckpt._subtree_mismatch({"a": torch.zeros(2)}, {"b": torch.zeros(2)}).startswith("tree structure")
    assert t_ckpt._subtree_mismatch({"a": torch.zeros(2)}, {"a": torch.ones(2)}) is None


# ---------------------------------------------------------------------------
# the trainer's cadences


def _png_pixels(path):
    """Decode an 8-bit PNG written with filter 0 → uint8 [H, W, C]."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    channels = {0: 1, 2: 3, 6: 4}[colour]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * channels)
    assert depth == 8 and (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, channels)


def _datamanager():
    ts = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=6, width=16, height=16))
    es = generate_synthetic_scene(SyntheticSceneConfig(**EVAL_SCENE))
    return DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                       ts["cameras"], ts["images"], ts["masks"],
                       eval_cameras=es["cameras"], eval_images=es["images"], eval_masks=es["masks"], device="cpu")


def _trainer(out_dir):
    return Trainer(TrainerConfig(max_num_iterations=100, steps_per_log=1, steps_per_save=2, steps_per_eval_image=2,
                                 output_dir=str(out_dir), seed=0),
                   tiny_model(), to_torch_config(PIPE), _datamanager(), device="cpu")


def test_trainer_saves_evaluates_writes_and_resumes(tmp_path):
    """Two steps with a writer: a checkpoint at step 2, one eval pass (fit
    of both eval slots, render of eval image 0, scores), ``events.jsonl``
    with the train and eval records, PNG panels that decode to what was
    written.  A fresh trainer resumed from the checkpoint holds the same
    params, Adam state and step, and takes the same next step."""
    out = tmp_path / "run"
    trainer = _trainer(out).attach_writer(Writer(str(out)))
    hist = trainer.run(2)
    trainer.writer.close()
    trainer.attach_writer(None)
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["step-000000002"]
    assert t_ckpt.latest_step(out) == 2
    evals = [r for r in hist if "eval_psnr" in r]
    assert len(evals) == 1 and evals[0]["step"] == 2
    for k in ("eval_psnr", "eval_ssim", "eval_lpips", "eval_mse", "eval_num_rays_per_sec", "eval_fps"):
        assert np.isfinite(evals[0][k]), k
    events = [json.loads(line) for line in (out / "events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events] == [1, 2, 2] and "eval_psnr" in events[-1] and "total_loss" in events[0]
    pngs = {p.stem: p for p in (out / "images" / "step-000000002").iterdir()}
    assert {"img", "accumulation", "depth", "normal", "normalised_error", "albedo", "reni_envmap"} <= set(pngs)
    img = _png_pixels(pngs["img"])
    assert img.shape == (16, 32, 3)
    gt = trainer.datamanager.eval_images[0]
    np.testing.assert_array_equal(img[:, :16], np.clip(gt * 255.0, 0, 255).astype(np.uint8))

    resumed = _trainer(tmp_path / "other")
    resumed.load(str(out))
    assert resumed.step == 2
    for k, v in tree_items(trainer.params):
        assert torch.equal(dict(tree_items(resumed.params))[k], v), k
    _assert_state_equal(resumed.optimizer.state_dict(), trainer.optimizer.state_dict())
    trainer.datamanager.reseed(2)
    resumed.generator.set_state(trainer.generator.get_state())
    a, b = trainer.run(1)[-1], resumed.run(1)[-1]
    assert a["step"] == b["step"] == 3
    for k in a:
        if k.endswith("_loss"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)


def test_trainer_refuses_the_split_step():
    with pytest.raises(NotImplementedError, match="use_split_step"):
        Trainer(TrainerConfig(use_split_step=True), tiny_model(), to_torch_config(PIPE), _datamanager(), device="cpu")
