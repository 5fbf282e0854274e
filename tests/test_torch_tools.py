"""The tools around a trained scene, against the JAX package on the CPU:
the GT-illumination probe and Blinn-Phong shading in one training step,
``neusky_torch/tools/{eval_from_ckpt,render_from_ckpt,render_animation}.py``
on a checkpoint of converted JAX parameters against the JAX functions
those JAX tools call, and ``utils/profiling.py``.

The JAX tools are scripts of the JAX package and stay unedited: each test
builds what the JAX tool builds (config, scene, data, params) and calls
the same JAX functions on it; the port's tool runs through its ``main``.

Steps (mirror of ``tests/test_train_e2e.py:175``, ``:211``): the tiny
scene config of ``tests/test_torch_slice.py`` with the variant on, JAX's
draws injected; losses to 1e-4 relative, gradients to 1e-3 of each array's
scale (the compositor with visibility is held by
``tests/test_torch_render_features.py``).  Renders of the tiny recipe (its
DDF in bf16, as the tools build it): maps and metrics to 1e-4 (a bf16-rounded FiLM input may flip to
its neighbour where two float32 sums differ in the last bit), fitted
losses to 1e-4 relative (optax forms Adam's 1 − β₂ in float32); the JSON
records the tools round, to their last digit.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.configs.tiny_config import tiny_model_config as j_tiny
from neusky_tpu.core.cameras import Cameras as JCameras, CameraType
from neusky_tpu.core.rays import RayBundle as JRays
from neusky_tpu.data.datamanager import DataManager as JDataManager, DataManagerConfig as JDMConfig
from neusky_tpu.data.pixel_sampler import PixelSamplerConfig as JPSConfig
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JSceneConfig, generate_synthetic_scene as j_scene
from neusky_tpu.engine import eval_loop as j_eval, render_features as j_rf
from neusky_tpu.engine.eval_panels import image_metrics_and_panels as j_panels
from neusky_tpu.fields.reni import freeze_decoder_params as j_freeze
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import train_loss_fn as j_train_loss
from neusky_tpu.sampling.illumination import EquirectangularSampler as JEquirect
from neusky_tpu.utils import profiling as j_prof

from neusky_torch.core.rays import RayBundle as TRays
from neusky_torch.engine.checkpoint import save_checkpoint
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.models.pipeline import train_loss_fn as t_train_loss
from neusky_torch.tools import eval_from_ckpt, render_animation, render_from_ckpt
from neusky_torch.tree import tree_items
from neusky_torch.utils import profiling as t_prof
from neusky_torch.utils.viz import load_png
from test_torch_joint_slice import PIPE
from test_torch_slice import make_batch_pair, tiny_scene_config
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture)
    flat_jax, jax_scene_draws, jitted, jax_to_torch_params, max_rel_err, one_torch_thread, to_torch_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
NOISE = 1e-9
STEP = 100.0
MAP_ATOL = 1e-4
# the HDR envmap is exp of 13 × the decoder's output: its float32 rounding
# (~1e-6) grows to ~1e-5 relative
ENVMAP_RTOL = 1e-4
RNG = np.random.default_rng(11)


# ---------------------------------------------------------------------------
# the GT-illumination probe and Blinn-Phong in a training step


VARIANTS = {
    "gt_probe": lambda c: dataclasses.replace(c, gt_illumination_probe=True),
    "blinn_phong": lambda c: dataclasses.replace(c, sdf_field=dataclasses.replace(c.sdf_field, predict_shininess=True)),
}


@pytest.fixture(scope="module")
def batch_pair():
    return make_batch_pair()


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant_step(request, batch_pair):
    """One scene step of ``tests/test_torch_slice.py``'s tiny config (the
    canonical stochastic SDF table gradient) with the variant on."""
    jb, tb = batch_pair
    cfg_j = VARIANTS[request.param](tiny_scene_config(True))
    jm = JModel(cfg_j)
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(7)
    loss = lambda p: j_train_loss(jm, PIPE, p, rng, jb, jnp.asarray(STEP, jnp.float32))
    (total_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)

    tm = TModel(to_torch_config(cfg_j), device="cpu")
    params_t = jax_to_torch_params(params_j)
    for k, v in tree_items(params_t):
        v.requires_grad_(k.split("/")[0] not in ("eval_latents", "illumination_decoder"))
    draws = jax_scene_draws(cfg_j, rng, tb["pixel_coords"].shape[0])
    total_t, aux_t = t_train_loss(tm, to_torch_config(PIPE), params_t, tb, STEP, draws)
    total_t.backward()
    return dict(variant=request.param, grads_j=grads_j, total_j=total_j, aux_j=aux_j, params_t=params_t,
                total_t=total_t, aux_t=aux_t)


def test_variant_step_losses_match_jax(variant_step):
    s = variant_step
    np.testing.assert_allclose(float(s["total_t"].detach()), float(s["total_j"]), rtol=LOSS_RTOL)
    lj, lt = s["aux_j"]["loss_dict"], s["aux_t"]["loss_dict"]
    assert sorted(lj) == sorted(lt) and "sky_pixel_loss" in lt
    for k in lj:
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for k, v in s["aux_j"]["metrics"].items():
        np.testing.assert_allclose(float(s["aux_t"]["metrics"][k]), float(v), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("group", ["proposal_networks", "fields", "illumination_field", "gt_probe_illumination"])
def test_variant_step_gradients_match_jax(variant_step, group):
    """Every leaf's gradient; in probe mode the table takes one and the sky
    latents none (their sky is not decoded), in JAX as in the port."""
    gj = flat_jax(variant_step["grads_j"])
    pt = dict(tree_items(variant_step["params_t"]))
    keys = [k for k in gj if k.startswith(group)]
    probe = variant_step["variant"] == "gt_probe"
    if not keys:  # the table is the probe's alone
        assert group == "gt_probe_illumination" and not probe and not any(k.startswith(group) for k in pt)
        return
    checked = 0
    for k in keys:
        got = np.zeros_like(gj[k]) if pt[k].grad is None else pt[k].grad.numpy()
        if np.abs(gj[k]).max() <= NOISE:
            assert np.abs(got).max() <= NOISE, k
            continue
        checked += 1
        assert max_rel_err(got, gj[k]) < GRAD_REL, (k, max_rel_err(got, gj[k]))
    if probe and group == "illumination_field":
        assert checked == 0
    else:
        assert checked


def test_gt_probe_init_and_sky_match_jax():
    """The table starts at the background's linear level for every light
    direction; the sky (train and eval mode) is the table and the fixed
    background, the light directions unrotated, as in JAX."""
    cfg_j = VARIANTS["gt_probe"](tiny_scene_config(True))
    jm, tm = JModel(cfg_j), TModel(to_torch_config(cfg_j), device="cpu")
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))
    own = tm.init(torch.Generator().manual_seed(1))["gt_probe_illumination"]["log_light"]
    want = np.asarray(params_j["gt_probe_illumination"]["log_light"])
    assert want.shape == (tm.num_directions, 3)
    np.testing.assert_allclose(own.numpy(), want, rtol=1e-6, atol=0)
    table = RNG.normal(size=want.shape).astype(np.float32)
    params_j["gt_probe_illumination"] = {"log_light": jnp.asarray(table)}
    params_t = jax_to_torch_params(params_j)
    n = 5
    d = RNG.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rb_j, rb_t = JRays.create(jnp.zeros((n, 3)), jnp.asarray(d)), TRays.create(torch.zeros(n, 3), torch.from_numpy(d))
    ray_idx = [0, 1, 1, 0, 1]
    for train in (True, False):
        got = tm.sample_illumination(params_t, rb_t, torch.tensor([0, 1]), torch.tensor(ray_idx), train,
                                     rotation_normals=torch.randn(4))
        want = jm.sample_illumination(params_j, jax.random.PRNGKey(3), rb_j, jnp.asarray([0, 1]),
                                      jnp.asarray(ray_idx), train)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[1][0].numpy(), np.exp(table), rtol=1e-6)


# ---------------------------------------------------------------------------
# the checkpoint tools


def _tiny_pair(num_train, num_eval, random_latents=True):
    """JAX's tiny model and params (sky latents random, else the sky of
    zero latents is symmetric about z) and the port's converted params."""
    cfg_j = j_tiny(num_train, num_eval)
    jm = JModel(cfg_j)
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))
    if random_latents:
        for group, key in (("illumination_field", "train_latents"), ("eval_latents", "eval_latents")):
            lat = params_j[group][key]
            params_j[group][key] = jnp.asarray(0.5 * RNG.normal(size=lat.shape), jnp.float32)
    return cfg_j, jm, params_j, jax_to_torch_params(params_j)


def test_eval_from_ckpt_matches_jax(tmp_path):
    """``--tiny`` (6 train images, JAX's rehearsal config) on a checkpoint of
    converted params: the 3-step eval-latent fit over both eval images of a
    16 × 16 ring and every metric of each image as the JAX tool computes
    them; the JSON it writes."""
    cfg_j, jm, params_j, params_t = _tiny_pair(6, 2)
    save_checkpoint(tmp_path / "ckpt", 4, params_t, {})
    res = eval_from_ckpt.main(["--ckpt-dir", str(tmp_path / "ckpt"), "--tiny", "--device", "cpu", "--fit-steps", "3",
                               "--width", "16", "--out", str(tmp_path / "eval.json"), "--panels", str(tmp_path / "p")])

    train = j_scene(JSceneConfig(num_cameras=6, width=64, height=64))
    ev = j_scene(JSceneConfig(num_cameras=2, width=16, height=16, angle_offset=float(np.pi / 8.0), camera_height=0.5))
    dm = JDataManager(JDMConfig(pixel_sampler=JPSConfig(images_per_batch=6, rays_per_image=128), num_sky_rays=256),
                      train["cameras"], train["images"], train["masks"], eval_cameras=ev["cameras"],
                      eval_images=ev["images"], eval_masks=ev["masks"])
    fit, losses = j_eval.fit_eval_latents(jm, params_j, dm, jax.random.PRNGKey(1), steps=3, sample_region="full_image")
    chunk_fn, chunk = j_eval.make_render_chunk_fn(jm, 4096)
    albedo = np.broadcast_to(np.asarray(JSceneConfig().albedo, np.float32), (16, 16, 3))
    assert res["ckpt_step"] == 4 and res["fit_steps"] == 3 and len(res["per_image"]) == 2
    np.testing.assert_allclose([res["fit_loss_first"], res["fit_loss_last"]], [losses[0], losses[-1]], rtol=LOSS_RTOL)
    for i, got in enumerate(res["per_image"]):
        rb, batch = dm.eval_image_bundle(i)
        out = j_eval.render_camera(jm, fit, rb, i, jax.random.PRNGKey(2), chunk_fn, chunk)
        want, _ = j_panels(jm, fit, out, batch, 16, 16, latent_slot=i,
                           gt_layers={"albedo": albedo, "normal": ev["normals"][i], "depth": ev["depths"][i]})
        assert set(want) | {"num_rays_per_sec"} == set(got) - {"image_idx"}
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=MAP_ATOL, atol=MAP_ATOL, err_msg=k)
    on_disk = json.loads((tmp_path / "eval.json").read_text())
    assert on_disk["mean"] == res["mean"] and on_disk["device"] == "cpu" and on_disk["lpips_flavour"]
    assert (tmp_path / "p" / "eval1_img.png").exists()


def test_render_from_ckpt_matches_jax(tmp_path, capsys):
    """A ``train_sanity --tiny`` checkpoint (8 train images, 2 eval slots):
    the train latents copied into the eval slots, camera 0 rendered at
    64 × 64 and scored against the scene, and the shadow map, as the JAX
    tool computes them; the five PNGs decode."""
    cfg_j, jm, params_j, params_t = _tiny_pair(8, 2)
    save_checkpoint(tmp_path / "ckpt", 3, params_t, {})
    rec = render_from_ckpt.main([str(tmp_path / "ckpt"), "--tiny", "--device", "cpu", "--cam", "1",
                                 "--out-prefix", str(tmp_path / "r")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec

    g = params_j["illumination_field"]
    params = {**params_j, "eval_latents": {"eval_latents": g["train_latents"][:2], "eval_scale": g["train_scale"][:2]}}
    scene = j_scene(JSceneConfig(num_cameras=8, width=64, height=64))
    rb = scene["cameras"].generate_rays(1)
    outs = j_eval.render_camera(jm, params, rb, 1, jax.random.PRNGKey(3), chunk_size=4096)
    pred = np.clip(np.asarray(outs["rgb"]).reshape(64, 64, 3), 0, 1)
    gt = np.asarray(scene["images"][1])
    err = np.mean((pred - gt) ** 2, axis=-1)
    sky = scene["masks"][1][..., 3] > 0.5
    sm = jitted(j_rf.render_shadow_map, jm, params, rb, jax.random.PRNGKey(7), azimuth_deg=45.0, elevation_deg=45.0)
    shadow = np.clip(sm["shadow_map"], 0, 1)
    want = {"image_psnr": -10.0 * np.log10(max(float(err.mean()), 1e-10)), "mse": err.mean(),
            "mse_sky": err[sky].mean(), "mse_fg": err[~sky].mean(),
            "accum_mean": np.asarray(outs["accumulation"]).mean(), "shadow_mean": shadow.mean(),
            "shadow_std": shadow.std()}
    assert rec["step"] == 3 and rec["cam"] == 1
    for k, v in want.items():
        digits = 3 if k == "image_psnr" else (5 if k.startswith("mse") else 4)
        assert abs(rec[k] - v) <= 0.5 * 10.0 ** -digits + MAP_ATOL, (k, rec[k], v)
    for name in ("rgb", "gt", "err", "depth", "shadow"):
        assert load_png(str(tmp_path / f"r_{name}.png")).shape == (64, 64, 3)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A ``neusky-tiny --synthetic-demo`` run's checkpoint (6 train images,
    one eval slot) of converted JAX params."""
    cfg_j, jm, params_j, params_t = _tiny_pair(6, 1)
    run = tmp_path_factory.mktemp("run")
    save_checkpoint(run, 2, params_t, {})
    return jm, params_j, run


def _animation(tiny_run, tmp_path, *argv):
    return render_animation.main([*argv, "--load-dir", str(tiny_run[2]), "--method", "neusky-tiny", "--device", "cpu",
                                  "--out", str(tmp_path)])


def test_render_animation_envmaps_match_jax(tiny_run, tmp_path):
    jm, params_j, _ = tiny_run
    assert _animation(tiny_run, tmp_path, "envmaps", "--envmap-width", "16") == {"envmaps": 6, "out": str(tmp_path)}
    dirs = JEquirect(width=16)()
    decoder = j_freeze(params_j["illumination_decoder"])
    g = params_j["illumination_field"]
    for i in range(6):
        out = jm.illumination.apply(decoder, dirs, g["train_latents"][i], g["train_scale"][i:i + 1])
        want = np.asarray(jm.illumination.unnormalise(out["rgb"])).reshape(8, 16, 3)
        np.testing.assert_allclose(np.load(tmp_path / f"envmap_{i:03d}_hdr.npy"), want, rtol=ENVMAP_RTOL, atol=0)
        assert load_png(str(tmp_path / f"envmap_{i:03d}.png")).shape == (8, 16, 3)


def test_render_animation_camera_path_matches_jax(tiny_run, tmp_path):
    """Two frames of a nerfstudio camera path at 16 × 16 (the second one
    skipped by ``--stride 2`` of three)."""
    jm, params_j, _ = tiny_run
    frames = []
    for pos in ([1.2, 0.0, 0.3], [0.0, -1.2, 0.4], [-1.0, 0.5, 0.2]):
        from neusky_torch.core.spherical import look_at_target

        frames.append({"camera_to_world": look_at_target(np.asarray([pos], np.float32), np.zeros((1, 3)))[0].tolist(),
                       "fov": 45.0})
    spec = tmp_path / "path.json"
    spec.write_text(json.dumps({"render_height": 64, "render_width": 64, "camera_path": frames}))
    out = tmp_path / "frames"
    assert _animation(tiny_run, out, "camera-path", str(spec), "--stride", "2", "--height", "16",
                      "--width", "16") == {"frames": 2, "out": str(out)}
    with np.load(out / "sequence.npz") as z:
        got = z["rgb"]
    assert got.shape == (2, 16, 16, 3)
    fy = 0.5 * 16 / np.tan(0.5 * np.deg2rad(45.0))
    for i, f in enumerate(frames[::2]):
        c2w = np.asarray(f["camera_to_world"], np.float32).reshape(4, 4)[:3]
        cam = JCameras(camera_to_worlds=jnp.asarray(c2w)[None], fx=jnp.asarray([fy]), fy=jnp.asarray([fy]),
                       cx=jnp.asarray([8.0]), cy=jnp.asarray([8.0]), width=16, height=16,
                       camera_type=int(CameraType.PERSPECTIVE))
        outs = j_eval.render_camera(jm, params_j, cam.generate_rays(0), 0, jax.random.PRNGKey(0), chunk_size=256)
        np.testing.assert_allclose(got[i], np.clip(np.asarray(outs["rgb"]).reshape(16, 16, 3), 0, 1), rtol=0,
                                   atol=MAP_ATOL)
        assert load_png(str(out / f"frame_{i:04d}.png")).shape == (16, 16, 3)


def test_render_animation_illumination_rotation_matches_jax(tiny_run, tmp_path):
    """Three frames (0°, 120°, 240°) of the synthetic demo's camera 0 (48 ×
    48), as JAX's ``render_illumination_animation`` renders them."""
    jm, params_j, _ = tiny_run
    assert _animation(tiny_run, tmp_path / "t", "illumination-rotation", "--frames", "3",
                      "--chunk-size", "2304") == {"frames": 3, "out": str(tmp_path / "t")}
    rb = j_scene(JSceneConfig(num_cameras=6))["cameras"].generate_rays(0)
    want = j_rf.render_illumination_animation(jm, params_j, rb, 0, jax.random.PRNGKey(0), j_rf.AnimationConfig(
        num_frames=3, output_dir=str(tmp_path / "j"), chunk_size=2304))
    with np.load(tmp_path / "t" / "render_sequence.npz") as z:
        got = z["rgb"]
    assert got.shape == want.shape == (3, 2304, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_ATOL)
    assert np.abs(got[1] - got[0]).max() > 1e-3
    assert load_png(str(tmp_path / "t" / "frame_0002.png")).shape == (48, 48, 3)


# ---------------------------------------------------------------------------
# profiling


def test_profiling_summary_semantics_match_jax():
    """The same calls through both decorators: the same table (names,
    call counts; total the sum, mean the total over the calls); reset
    empties it."""

    def run(mod):
        mod.reset_profiler()

        @mod.time_function
        def work(n):
            return sum(range(n))

        @mod.time_function
        def other():
            time.sleep(0.002)

        assert [work(1000) for _ in range(3)] == [499500] * 3 and other() is None
        return mod.profiler_summary()

    got, want = run(t_prof), run(j_prof)
    assert sorted(got) == sorted(want) and len(got) == 2
    for name, row in got.items():
        assert row["calls"] == want[name]["calls"] and set(row) == {"calls", "total_s", "mean_s"}
        assert row["mean_s"] == pytest.approx(row["total_s"] / row["calls"])
    assert [r for r in got.values() if r["calls"] == 1][0]["total_s"] >= 0.002
    t_prof.reset_profiler()
    j_prof.reset_profiler()
    assert t_prof.profiler_summary() == {} == j_prof.profiler_summary()


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with t_prof.trace_context(str(tmp_path / "trace")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with t_prof.trace_context(logdir):
        torch.ones(8).sum()
    traces = sorted((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 2
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
