"""The eval metrics, LPIPS, visualisations and eval panels of the PyTorch
port against the JAX package's, on the CPU and the same seed-made images:
PSNR / MSE / SSIM to 1e-10, LPIPS (the seeded random VGG16, and a
torchvision ``state_dict`` written to ``tmp_path``) to 1e-5 relative, the
equirectangular directions, colormaps and panels to 1e-6 (the decoded
envmap to 1e-4), and the PNG writer against a decoder built from
``zlib``."""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_tpu.engine import eval_panels as j_panels
from neusky_tpu.engine import lpips as j_lpips
from neusky_tpu.engine import metrics as j_metrics
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.sampling.illumination import EquirectangularSampler as JEquirect
from neusky_tpu.utils import viz as j_viz

from neusky_torch.engine import eval_panels as t_panels
from neusky_torch.engine import lpips as t_lpips
from neusky_torch.engine import metrics as t_metrics
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.sampling.illumination import EquirectangularSampler as TEquirect
from neusky_torch.utils import viz as t_viz
from test_torch_slice import tiny_scene_config
from torch_parity import jax_to_torch_params, max_rel_err, to_torch_config, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 24, 32


def _images(seed=0):
    g = np.random.default_rng(seed)
    pred = g.uniform(0, 1, (H, W, 3)).astype(np.float32)
    target = np.clip(pred + 0.1 * g.normal(size=pred.shape), 0, 1).astype(np.float32)
    return pred, target


def test_psnr_mse_ssim_match_jax():
    pred, target = _images()
    for fn in ("psnr", "mse", "ssim_image"):
        for a, b in ((pred, target), (pred[..., 0], target[..., 0]), (pred, pred)):
            want = getattr(j_metrics, fn)(a, b)
            np.testing.assert_allclose(getattr(t_metrics, fn)(a, b), want, rtol=1e-10, err_msg=fn)
    assert t_metrics.psnr(pred, pred) == 100.0


def test_lpips_random_vgg_matches_jax():
    """The labelled random-feature VGG16: the same He-normal draws as JAX,
    the same distance."""
    pred, target = _images(1)
    want, flavour = j_lpips.lpips(pred, target)
    got = t_metrics.lpips_image(pred, target, "cpu")
    assert flavour == t_metrics.lpips_flavour() == "vgg16-random"
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert t_metrics.lpips_image(pred, pred, "cpu") == 0.0 and got > 0
    for (wt, bt), (wj, bj) in zip(t_lpips.random_vgg(), j_lpips._random_vgg()):
        np.testing.assert_array_equal(wt, np.transpose(wj, (3, 2, 0, 1)))
        np.testing.assert_array_equal(bt, bj)


def test_lpips_convolutions_ignore_tf32_setting(monkeypatch):
    """LPIPS runs its convolutions with cuDNN's TF32 off even when the
    caller has it on (PyTorch's default), and leaves the caller's setting
    as it was."""
    seen = []
    conv2d = t_lpips.F.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(t_lpips.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    pred, target = _images(1)
    t_lpips.lpips(pred, target, "cpu")
    assert len(seen) == 2 * 13 and not any(seen)  # 13 convs for each image
    assert torch.backends.cudnn.allow_tf32


def test_lpips_torchvision_weights(tmp_path, monkeypatch):
    """A torchvision-layout VGG16 ``state_dict`` (random, written to
    ``tmp_path``) found through ``NEUSKY_VGG_WEIGHTS``: the port's loader
    reads the same 13 convs as JAX's, and LPIPS with them matches."""
    g = torch.Generator().manual_seed(0)
    sd, cin, i = {}, 3, 0
    for spec in t_lpips._VGG16:
        if spec == "M":
            i += 1
            continue
        sd[f"features.{i}.weight"] = torch.randn((spec[0], cin, 3, 3), generator=g) * (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{i}.bias"] = torch.randn((spec[0],), generator=g) * 0.01
        cin, i = spec[0], i + 2  # conv, relu
    sd["classifier.0.weight"] = torch.zeros((4, 4))
    path = tmp_path / "vgg16.pth"
    torch.save(sd, path)
    convs_j = j_lpips._convert_torch_vgg(path)
    convs_t = t_lpips.load_torchvision_vgg(path)
    for (wt, bt), (wj, bj) in zip(convs_t, convs_j):
        np.testing.assert_array_equal(wt, np.transpose(wj, (3, 2, 0, 1)))
        np.testing.assert_array_equal(bt, bj)
    monkeypatch.setenv("NEUSKY_VGG_WEIGHTS", str(path))
    monkeypatch.setattr(t_lpips, "_cache", {})
    pred, target = _images(2)
    got, flavour = t_lpips.lpips(pred, target, "cpu")
    want = float(j_lpips._lpips_fn(convs_j)(jnp.asarray(pred)[None], jnp.asarray(target)[None]))
    assert flavour == "vgg16-pretrained"
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_equirectangular_sampler_matches_jax():
    for width in (16, 128):
        want, got = JEquirect(width)(), TEquirect(width)("cpu")
        assert got.shape == (width * width // 2, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_viz_matches_jax():
    g = np.random.default_rng(3)
    x = g.uniform(-0.2, 1.2, (H, W)).astype(np.float32)
    depth = g.uniform(0.5, 3.0, (H, W, 1)).astype(np.float32)
    acc = g.uniform(0, 1, (H, W, 1)).astype(np.float32)
    pred, target = _images(4)
    pairs = [
        (t_viz.apply_colormap(x), j_viz.apply_colormap(x)),
        (t_viz.apply_colormap(x[..., None]), j_viz.apply_colormap(x[..., None])),
        (t_viz.apply_depth_colormap(depth), j_viz.apply_depth_colormap(depth)),
        (t_viz.apply_depth_colormap(depth, acc, 1.0, 2.0), j_viz.apply_depth_colormap(depth, acc, 1.0, 2.0)),
        (t_viz.normalised_error_map(pred, target), j_viz.normalised_error_map(pred, target)),
        (t_viz.side_by_side(pred, target), j_viz.side_by_side(pred, target)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


def _decode_png(path):
    data = open(path, "rb").read()
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[kind] = chunks.get(kind, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[colour]
    return np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * c)[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_save_png_round_trip(tmp_path, channels):
    g = np.random.default_rng(channels)
    img = g.uniform(-0.1, 1.1, (H, W) if channels == 0 else (H, W, channels))
    path = tmp_path / "x.png"
    t_viz.save_png(str(path), img)
    want = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    got = _decode_png(path)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.fixture(scope="module")
def panel_models():
    cfg_j = tiny_scene_config(True)
    jm = JModel(cfg_j)
    params_j = dict(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    g = np.random.default_rng(0)
    params_j["eval_latents"] = {**params_j["eval_latents"],
                                "eval_latents": jnp.asarray(g.normal(size=(2, 8, 3)), jnp.float32)}
    return jm, TModel(to_torch_config(cfg_j), device="cpu"), params_j, jax_to_torch_params(params_j)


def test_image_metrics_and_panels_match_jax(panel_models):
    """Metrics (GT layers included) and every panel, the envmap decoded
    from eval slot 1, on seeded render maps of the synthetic scene.  The
    envmap panel is the RENI decoder's output through ``exp``, held to
    1e-4 of scale like the model's outputs; every other panel to 1e-6."""
    jm, tm, pj, pt = panel_models
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=1, width=W, height=H))
    g = np.random.default_rng(5)
    n = H * W
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    outputs = {
        "rgb": np.clip(scene["images"][0].reshape(n, 3) + 0.05 * g.normal(size=(n, 3)), 0, 1).astype(np.float32),
        "accumulation": g.uniform(0, 1, (n, 1)).astype(np.float32),
        "depth": (scene["depths"][0].reshape(n, 1) * 1.3 + 0.1).astype(np.float32),
        "normal": nrm / np.linalg.norm(nrm, axis=-1, keepdims=True),
        "albedo": g.uniform(0, 1, (n, 3)).astype(np.float32),
        "prop_depth_0": g.uniform(0.5, 2.0, (n, 1)).astype(np.float32),
    }
    batch = {"image": scene["images"][0].reshape(n, 3), "mask": scene["masks"][0].reshape(n, 4)}
    gt_layers = {"albedo": g.uniform(0, 1, (H, W, 3)), "normal": scene["normals"][0], "depth": scene["depths"][0]}
    want_m, want_p = j_panels.image_metrics_and_panels(jm, pj, outputs, batch, H, W, latent_slot=1,
                                                       gt_layers=gt_layers)
    got_m, got_p = t_panels.image_metrics_and_panels(tm, pt, outputs, batch, H, W, latent_slot=1,
                                                     gt_layers=gt_layers)
    assert sorted(got_m) == sorted(want_m) and {"albedo_psnr", "normal_mae", "depth_mse", "lpips"} <= set(got_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5 if k == "lpips" else 1e-6, err_msg=k)
    assert sorted(got_p) == sorted(want_p) and "reni_envmap" in got_p
    for k in want_p:
        assert got_p[k].shape == want_p[k].shape, k
        if k == "reni_envmap":  # a network's output through exp: held like the model's outputs
            assert max_rel_err(got_p[k], want_p[k]) < 1e-4
        else:
            np.testing.assert_allclose(got_p[k], np.asarray(want_p[k]), atol=1e-6, err_msg=k)
    scale, shift = t_panels.normalized_depth_scale_and_shift(outputs["depth"], scene["depths"][0].reshape(n, 1),
                                                             np.ones((n, 1), bool))
    assert (scale, shift) == j_panels.normalized_depth_scale_and_shift(
        outputs["depth"], scene["depths"][0].reshape(n, 1), np.ones((n, 1), bool))
    assert max_rel_err(outputs["depth"] * scale + shift, scene["depths"][0].reshape(n, 1)) < 1e-5
