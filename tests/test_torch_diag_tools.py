"""The six diagnostic tools of ``neusky_torch/tools/`` against the JAX
tools of ``tools/`` on the CPU, each on the same input at its smallest
size.

``analyze_run`` and ``prepare_nerfosr`` import no JAX: the JAX tools'
functions run here as they are, and the output is held byte for byte.
The other four are scripts around the JAX package: each test builds what
the JAX tool builds (config, scene, data, params, draws) and calls the
same JAX functions on it, and the port's tool runs through its ``main``
with JAX's parameters (a checkpoint of converted parameters, or copied
into the run) and JAX's draws.  Their JSON records are held to the JAX
values to the digit each record is rounded to, plus 1e-4 relative (the
float32 sums of the two frameworks, through one Adam step and the bf16
FiLM inputs of the tiny recipe's DDF).
"""

import dataclasses
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neusky_tpu.configs.neusky_config import neusky_model_config as j_canonical
from neusky_tpu.configs.tiny_config import tiny_model_config as j_tiny
from neusky_tpu.core.colour import linear_to_sRGB as j_srgb
from neusky_tpu.data.datamanager import DataManager as JDM, DataManagerConfig as JDMConfig
from neusky_tpu.data.pixel_sampler import PixelSamplerConfig as JPS
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JScene, generate_synthetic_scene as j_scene
from neusky_tpu.engine import ddf_trainer as j_ddf
from neusky_tpu.engine.checkpoint import load_illumination_prior as j_load_prior
from neusky_tpu.engine.eval_loop import render_camera as j_render
from neusky_tpu.engine.optimizers import build_optimizer, default_neusky_optimizer_groups
from neusky_tpu.fields.reni import RENIField as JRENI
from neusky_tpu.models import losses as j_losses
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import batch_ray_bundle as j_bundle
from neusky_tpu.parallel.mesh import make_train_step as j_make_step
from neusky_tpu.sampling.ddf_sampler import DDFSamplerConfig as JSampler

from neusky_torch.configs import neusky_config
from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.engine.checkpoint import save_checkpoint
from neusky_torch.ops import hashgrid
from neusky_torch.tools import (
    ab_ddf_encoding, analyze_run, diagnose_ckpt, prepare_nerfosr, prior_fit_sanity, probe_sky_fit,
)
from neusky_torch.tree import tree_items
from test_torch_ddf_trainer import _jax_step_draws
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture)
    flat_jax, jax_ddf_draws, jax_forward_draws, jax_scene_draws, jax_to_torch_params, one_torch_thread,
    to_torch_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4
RNG = np.random.default_rng(23)


def _jax_tool(name: str):
    """A JAX tool of ``tools/`` (a directory of scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, digits: int, key: str):
    """A value rounded to ``digits`` against JAX's unrounded one."""
    if np.ndim(want) > 0:
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _close(g, w, digits, key)
        return
    want = float(want)
    assert abs(got - want) <= 0.5 * 10.0**-digits + RTOL * abs(want) + 1e-7, (key, got, want)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# analyze_run and prepare_nerfosr: byte for byte


def _write_run(path: Path, encoding: str, seed: int):
    rng = np.random.default_rng(seed)
    steps = [1, 100, 500, 1000, 1500, 2500, 5000, 7500, 10000, 20000]
    s_val = 0.3 * np.exp(-np.arange(len(steps)) / 3.0)
    s_val[6] *= 2.0  # one reversal over 25%
    with open(path, "w") as f:
        for i, step in enumerate(steps):
            f.write(json.dumps({"step": step, "ddf_encoding": encoding, "psnr": float(10 + 2 * i + rng.normal()),
                                "ddf_depth_psnr": float(8 + i + rng.normal()), "s_val": float(s_val[i]),
                                "total_loss": float(2.0 / (i + 1))}) + "\n")
            if i == 3:
                f.write("\n")  # blank lines are skipped


def test_analyze_run_prints_what_the_jax_tool_prints(tmp_path, capsys):
    a, b = tmp_path / "nerf.jsonl", tmp_path / "hash.jsonl"
    _write_run(a, "nerf", 0)
    _write_run(b, "hash", 1)
    j_tool = _jax_tool("analyze_run")
    for paths in ([str(a)], [str(a), str(b)]):
        analyze_run.main(paths)
        got = capsys.readouterr().out
        for p in paths:
            j_tool.summarise(p)
        if len(paths) > 1:
            j_tool.compare(paths)
        want = capsys.readouterr().out
        assert got == want and "| 5000 |" in got and "s_val reversals>25%: 1" in got
    assert "A/B comparison" in got


def _nerfosr_tree(root: Path, scene: str, nested: bool, n_img: int = 3, with_env: bool = True):
    base = root / ("Data" if nested else "") / scene / "final"
    for split in prepare_nerfosr.SPLITS:
        d = base / split
        for sub, ext in (("rgb", "jpg"), ("pose", "txt"), ("intrinsics", "txt")):
            (d / sub).mkdir(parents=True)
            for i in range(n_img - (split == "test" and sub == "pose")):
                (d / sub / f"{i:03d}.{ext}").write_text(f"{sub} {i}")
    if with_env:
        (base / "ENV_MAP_CC" / "session_0").mkdir(parents=True)
        (base / "ENV_MAP_CC" / "session_1").mkdir(parents=True)
    return base


def _masks_archive(root: Path, scene: str, n_img: int = 3):
    for split in ("train", "val", "test"):  # the archive names validation "val"
        d = root / scene / split / "cityscapes_mask"
        (d / "sub").mkdir(parents=True)
        (d / "sub" / "nested.png").write_bytes(b"n")
        for i in range(n_img if split != "test" else n_img - 1):
            (d / f"{i:03d}.png").write_bytes(bytes([i]))
    return root


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("nested", [False, True], ids=["scene_at_root", "under_Data"])
def test_prepare_nerfosr_matches_the_jax_tool(tmp_path, capsys, nested):
    """``copy-masks`` (each tool on its own copy of the tree): the same
    report and the same files; ``validate``: the same JSON, byte for byte,
    before the masks (exit 1) and after them, and without ``ENV_MAP_CC``."""
    j_tool = _jax_tool("prepare_nerfosr")
    src = _masks_archive(tmp_path / "masks", "lk2")
    _nerfosr_tree(tmp_path / "t", "lk2", nested)
    shutil.copytree(tmp_path / "t", tmp_path / "j")

    def validate_both(root):
        with pytest.raises(SystemExit) as e:
            prepare_nerfosr.main(["validate", "lk2", str(root)])
        got = (e.value.code, capsys.readouterr().out)
        want = j_tool.validate("lk2", root)
        return got, want

    (code, out), want = validate_both(tmp_path / "t")
    assert code == 1 and out == json.dumps(want, indent=1) + "\n" and not want["ok"]

    got = prepare_nerfosr.main(["copy-masks", "lk2", str(src), str(tmp_path / "t")])
    assert json.loads(capsys.readouterr().out) == got == j_tool.copy_masks("lk2", src, tmp_path / "j")
    assert got == {"train": 4, "validation": 4, "test": 3}
    assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")

    (code, out), want = validate_both(tmp_path / "t")  # the test split lacks a pose and a mask
    assert code == 1 and out == json.dumps(want, indent=1) + "\n"
    base = tmp_path / "t" / ("Data" if nested else "") / "lk2" / "final"
    (base / "test" / "pose" / "002.txt").write_text("pose 2")
    (base / "test" / "cityscapes_mask" / "002.png").write_bytes(b"m")
    rep = prepare_nerfosr.main(["validate", "lk2", str(tmp_path / "t")])
    assert capsys.readouterr().out == json.dumps(j_tool.validate("lk2", tmp_path / "t"), indent=1) + "\n"
    assert rep["ok"] and rep["envmap_sessions"] == 2 and rep["scene_dir"] == str(base)
    shutil.rmtree(base / "ENV_MAP_CC")
    _, want = validate_both(tmp_path / "t")
    assert "missing ENV_MAP_CC/" in want["problems"][0]


# ---------------------------------------------------------------------------
# probe_sky_fit


def test_probe_sky_fit_matches_jax(capsys):
    """Two Adam steps of the canonical prior's fit on JAX's 512 directions
    (``normal(PRNGKey(2))``, z folded up): the start record and step 1."""
    cfg = j_canonical(num_train_data=1, num_eval_data=1)
    rf = JRENI(cfg.illumination)
    tree = {"illumination_decoder": jax.jit(rf.init)(jax.random.PRNGKey(5), jnp.zeros((2, 3)),
                                                     jnp.zeros((2, cfg.illumination.latent_dim, 3))),
            "illumination_field": {"train_latents": jnp.zeros((1, cfg.illumination.latent_dim, 3)),
                                   "train_scale": jnp.ones(1)},
            "eval_latents": {"eval_latents": jnp.zeros((1, cfg.illumination.latent_dim, 3)), "eval_scale": jnp.ones(1),
                             "eval_rotation": jnp.ones(1)}}
    params = j_load_prior(tree, cfg)
    dirs = jax.random.normal(jax.random.PRNGKey(2), (512, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs.at[:, 2].set(jnp.abs(dirs[:, 2]))
    sky = jnp.array(probe_sky_fit.SKY_SRGB)

    def decode(st):
        out = rf.apply(params["illumination_decoder"], dirs, jnp.repeat(st["z"][None], 512, 0),
                       jnp.repeat(st["s"][None], 512, 0), None)
        return rf.unnormalise(out["rgb"])

    def loss_fn(st):
        return j_losses.sky_pixel_loss(j_srgb(decode(st)), jnp.tile(sky[None], (512, 1)), jnp.ones((512, 1)),
                                       cfg.losses.sky_pixel_cosine_weight)

    state = {"z": params["illumination_field"]["train_latents"][0], "s": params["illumination_field"]["train_scale"][0]}
    opt = optax.adam(1e-2)
    loss0, g0 = jax.jit(jax.value_and_grad(loss_fn))(state)
    up, _ = opt.update(g0, opt.init(state))
    state1 = optax.apply_updates(state, up)
    pred = np.asarray(jax.jit(lambda st: j_srgb(decode(st)))(state1))

    recs = probe_sky_fit.main(["--steps", "1", "--device", "cpu"], dirs=_t(dirs))
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == recs and len(recs) == 2
    start, step1 = recs
    _close(start["grad_norm_z"], jnp.linalg.norm(g0["z"]), 6, "grad_norm_z")
    _close(start["grad_s"], g0["s"], 6, "grad_s")
    _close(start["loss_init"], loss0, 5, "loss_init")
    assert step1["step"] == 1
    _close(step1["loss"], loss0, 6, "loss")
    _close(step1["sky_srgb_mse"], np.mean((pred - np.asarray(sky)) ** 2), 6, "sky_srgb_mse")
    _close(step1["pred_mean"], pred.mean(0), 3, "pred_mean")
    _close(step1["scale"], state1["s"], 4, "scale")
    _close(step1["z_norm"], jnp.linalg.norm(state1["z"]), 3, "z_norm")


# ---------------------------------------------------------------------------
# diagnose_ckpt


def _tiny_params(num_train, num_eval):
    """JAX's tiny recipe and params, the sky latents random (zero latents
    make a sky symmetric about z)."""
    cfg = j_tiny(num_train, num_eval)
    jm = JModel(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    for group, key in (("illumination_field", "train_latents"), ("eval_latents", "eval_latents")):
        lat = params[group][key]
        params[group][key] = jnp.asarray(0.5 * RNG.normal(size=lat.shape), jnp.float32)
    return cfg, jm, params


def _tiny_recipe(monkeypatch):
    """The tools build ``neusky_model_config(8, 2)``; here they build the
    tiny recipe instead."""
    monkeypatch.setattr(neusky_config, "neusky_model_config", tiny_model_config)


def test_diagnose_ckpt_matches_jax(tmp_path, capsys, monkeypatch):
    """The tiny recipe's checkpoint: the four records the JAX tool
    computes, on JAX's probe directions and forward draws."""
    _tiny_recipe(monkeypatch)
    cfg, jm, params = _tiny_params(8, 2)
    save_checkpoint(tmp_path / "ckpt", 7, jax_to_torch_params(params), {})
    sc = JScene(num_cameras=8, width=64, height=64)
    scene = j_scene(sc)
    d = jax.random.normal(jax.random.PRNGKey(0), (512, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    sky_dirs = jax.random.normal(jax.random.PRNGKey(1), (2048, 3))
    sky_dirs = sky_dirs / jnp.linalg.norm(sky_dirs, axis=-1, keepdims=True)
    dm = JDM(JDMConfig(pixel_sampler=JPS(images_per_batch=8, rays_per_image=128), num_sky_rays=256),
             scene["cameras"], scene["images"], scene["masks"])
    batch = dm.next_train(0)
    rng = jax.random.PRNGKey(42)

    @jax.jit
    def reference(params, d, sky_dirs, batch_arrays):
        b = {**batch, **batch_arrays}
        surf = jnp.asarray(sc.sphere_center) + sc.sphere_radius * d
        sdf_at = lambda pts: jm.field.apply(params["fields"], pts, method=jm.field.sdf_only).reshape(-1)  # noqa: E731
        lo, hi = jnp.full((512,), 0.05), jnp.full((512,), 0.9)
        for _ in range(24):
            mid = 0.5 * (lo + hi)
            inside = sdf_at(jnp.asarray(sc.sphere_center) + mid[:, None] * d) < 0
            lo, hi = jnp.where(inside, mid, lo), jnp.where(inside, hi, mid)
        g = params["illumination_field"]
        out = jm.illumination.apply(params["illumination_decoder"], sky_dirs, jnp.repeat(g["train_latents"][0:1], 2048, 0),
                                    jnp.repeat(g["train_scale"][0:1], 2048, 0), None)
        rs = surf * (1.0 - 1e-3)
        _, feat = jm.field.apply(params["fields"], rs, method=jm.field.geo)
        alb = jm.field.apply(params["fields"], rs, feat, method=jm.field.colour)[:, :3]
        outs = jm.forward(params, rng, j_bundle(b), b["image_indices"], b["ray_image_idx"], step=jnp.float32(7),
                          train=True)
        return dict(sdf=sdf_at(surf), radius=0.5 * (lo + hi), hdr=jm.illumination.unnormalise(out["rgb"]), alb=alb,
                    losses=jm.loss_dict(params, outs, b), metrics=jm.metrics_dict(params, outs, b), rgb=outs["rgb"],
                    acc=outs["accumulation"])

    arrays = {k: v for k, v in batch.items() if k != "cameras"}
    ref = jax.tree_util.tree_map(np.asarray, reference(params, d, sky_dirs, arrays))
    draws = {"surface_dirs": _t(d), "sky_dirs": _t(sky_dirs),
             "forward": jax_forward_draws(cfg, rng, batch["pixel_coords"].shape[0])}
    recs = diagnose_ckpt.main([str(tmp_path / "ckpt"), "--device", "cpu"], draws=draws)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == [{"loaded_step": 7}, *recs] and len(recs) == 4
    geo, illum, alb, losses = recs

    assert geo["radius_gt"] == sc.sphere_radius
    _close(geo["sdf_surface_rms"], np.sqrt((ref["sdf"] ** 2).mean()), 5, "sdf_surface_rms")
    _close(geo["sdf_surface_mean"], ref["sdf"].mean(), 5, "sdf_surface_mean")
    _close(geo["radius_est_mean"], ref["radius"].mean(), 4, "radius_est_mean")
    _close(geo["radius_est_std"], ref["radius"].std(), 4, "radius_est_std")

    sun = np.asarray(sc.sun_direction, np.float64)
    cos = np.asarray(sky_dirs) @ (sun / np.linalg.norm(sun))
    hdr = ref["hdr"]
    want = {"hdr_min": hdr.min(), "hdr_mean": hdr.mean(), "hdr_max": hdr.max(),
            "hdr_near_sun_mean": hdr[cos > 0.95].mean(), "hdr_away_sun_mean": hdr[cos < 0.5].mean(),
            "hdr_upper_mean": hdr[np.asarray(sky_dirs)[:, 2] > 0].mean(),
            "train_scale_0": params["illumination_field"]["train_scale"][0],
            "latent_norm_0": jnp.linalg.norm(params["illumination_field"]["train_latents"][0])}
    for k, v in want.items():
        _close(illum[k], v, 4, k)
    assert (illum["gt_sun_intensity"], illum["gt_ambient"]) == (sc.sun_intensity, sc.ambient)

    _close(alb["albedo_mean"], ref["alb"].mean(0), 4, "albedo_mean")
    _close(alb["albedo_std"], ref["alb"].std(0), 4, "albedo_std")
    assert alb["albedo_gt"] == list(sc.albedo)

    assert set(losses) == set(ref["losses"]) | {"psnr", "s_val", "batch_mse_sky", "batch_mse_fg", "accum_mean_fg",
                                                "accum_mean_sky"}
    for k, v in ref["losses"].items():
        _close(losses[k], v, 5, k)
    _close(losses["psnr"], ref["metrics"]["psnr"], 3, "psnr")
    _close(losses["s_val"], ref["metrics"]["s_val"], 5, "s_val")
    sky = np.asarray(batch["mask"][..., 3]) > 0.5
    err = ((ref["rgb"] - np.asarray(batch["image"])) ** 2).mean(-1)
    acc = ref["acc"].reshape(-1)
    for k, v in (("batch_mse_sky", err[sky].mean()), ("batch_mse_fg", err[~sky].mean()),
                 ("accum_mean_fg", acc[~sky].mean()), ("accum_mean_sky", acc[sky].mean())):
        _close(losses[k], v, 5 if k.startswith("batch") else 4, k)


# ---------------------------------------------------------------------------
# prior_fit_sanity


def test_prior_fit_sanity_matches_jax(tmp_path, capsys):
    """Two steps (log every step) from JAX's initial params and draws,
    then the final render of camera 0: every record but the seconds."""
    steps = 2
    cfg = _jax_prior_fit_config()
    assert to_torch_config(cfg) == prior_fit_sanity.build_config()
    jm = JModel(cfg)
    params = j_load_prior(jax.jit(jm.init)(jax.random.PRNGKey(0)), cfg)
    run = prior_fit_sanity.build(prior_fit_sanity.parse_args([str(steps), "1", "--device", "cpu",
                                                              "--out", str(tmp_path / "o.jsonl")]))
    got_params = dict(tree_items(run.params))
    for k, v in flat_jax(params).items():
        with torch.no_grad():
            got_params[k].copy_(torch.from_numpy(v))

    pipe = jtool_pipeline()
    scene = j_scene(JScene(num_cameras=8, width=48, height=48))
    dm = JDM(JDMConfig(pixel_sampler=JPS(images_per_batch=8, rays_per_image=32), num_sky_rays=64),
             scene["cameras"], scene["images"], scene["masks"])
    opt = build_optimizer(params, default_neusky_optimizer_groups(steps + 1))
    opt_state = opt.init(params)
    step_fn = j_make_step(jm, pipe, opt, donate=False)
    rng, keys, want = jax.random.PRNGKey(1), [], []
    for i in range(steps):
        rng, k = jax.random.split(rng)
        keys.append(k)
        params, opt_state, aux = step_fn(params, opt_state, dm.next_train(i), k, np.float32(i))
        want.append(aux)
    g = params["illumination_field"]
    n_eval = params["eval_latents"]["eval_latents"].shape[0]
    params = {**params, "eval_latents": {**params["eval_latents"], "eval_latents": g["train_latents"][:n_eval],
                                         "eval_scale": g["train_scale"][:n_eval]}}
    outs = j_render(jm, params, scene["cameras"].generate_rays(0), 0, jax.random.PRNGKey(3), chunk_size=48 * 48)

    def draws_fn(i):
        d = jax_scene_draws(cfg, keys[i], 8 * 32)
        d["ddf"] = jax_ddf_draws(cfg, pipe, keys[i])
        return d

    recs = prior_fit_sanity.run(run, draws_fn)
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == recs
    assert [json.loads(line) for line in (tmp_path / "o.jsonl").read_text().splitlines()] == recs
    assert [r.get("step") for r in recs] == [1, 2, None]
    for rec, aux in zip(recs, want):
        assert rec["prior"] is True
        _close(rec["psnr"], aux["metrics"]["psnr"], 3, "psnr")
        _close(rec["sky_pixel_loss"], aux["loss_dict"]["sky_pixel_loss"], 5, "sky_pixel_loss")
        _close(rec["total_loss"], aux["total_loss"], 4, "total_loss")
    pred = np.clip(np.asarray(outs["rgb"]).reshape(48, 48, 3), 0, 1)
    err = np.mean((pred - np.asarray(scene["images"][0])) ** 2, axis=-1)
    sky = np.asarray(scene["masks"][0])[..., 3] > 0.5
    final = recs[-1]
    _close(final["final_image_psnr"], -10.0 * np.log10(err.mean()), 3, "final_image_psnr")
    _close(final["mse_sky"], err[sky].mean(), 5, "mse_sky")
    _close(final["mse_fg"], err[~sky].mean(), 5, "mse_fg")


def _jax_prior_fit_config():
    """``tools/prior_fit_sanity.py``'s config, as its ``main`` builds it."""
    from neusky_tpu.fields.ddf import DDFFieldConfig
    from neusky_tpu.fields.density_field import DensityFieldConfig
    from neusky_tpu.fields.sdf_albedo import SDFAlbedoFieldConfig
    from neusky_tpu.ops.hashgrid import HashGridConfig
    from neusky_tpu.sampling.proposal import ProposalSamplerConfig

    small_hash = HashGridConfig(num_levels=8, features_per_level=2, log2_hashmap_size=15, base_res=4, max_res=256)
    cfg = j_canonical(
        num_train_data=8, num_eval_data=2,
        sdf_field=SDFAlbedoFieldConfig(num_layers=2, hidden_dim=64, geo_feat_dim=64, num_layers_color=2,
                                       hidden_dim_color=64, bias=0.1, beta_init=0.1, hash=small_hash,
                                       contraction_order="l2", stochastic_table_grads=True),
        proposal=ProposalSamplerConfig(num_proposal_samples=(64, 32), num_final_samples=24),
        proposal_fields=(DensityFieldConfig(hidden_dim=16, num_layers=2, hash=small_hash),
                         DensityFieldConfig(hidden_dim=16, num_layers=2, hash=small_hash)),
        num_illumination_directions=64, visibility_query_chunk=4096,
    )
    return dataclasses.replace(cfg, ddf=dataclasses.replace(cfg.ddf, field=DDFFieldConfig(
        conditioning="FiLM", position_encoding_type="nerf", direction_encoding_type="nerf", hidden_layers=3,
        hidden_features=64, mapping_layers=3, mapping_features=64)))


def jtool_pipeline():
    from neusky_tpu.models.pipeline import PipelineConfig

    return PipelineConfig(visibility_train_sampler=JSampler(num_samples_on_sphere=4, num_rays_per_sample=32,
                                                            only_sample_upper_hemisphere=True, concentration=20.0),
                          num_sky_rays=64)


# ---------------------------------------------------------------------------
# ab_ddf_encoding


def test_ab_ddf_encoding_matches_jax(tmp_path, capsys, monkeypatch):
    """Both arms (``nerf,hash``) of the tiny recipe for 2 steps, from a
    checkpoint of JAX's scene and each encoding's fresh JAX DDF, on JAX's
    draws: every trainer record; the hash arm scatters its table gradient
    through K1 once per differentiated encode (the vMF, multi-view and
    sky-ray queries: 3 a step), the nerf arm never."""
    steps = 2
    _tiny_recipe(monkeypatch)
    cfg, jm, scene_params = _tiny_params(8, 2)
    save_checkpoint(tmp_path / "ckpt", 3, jax_to_torch_params(scene_params), {})
    scene = j_scene(JScene(num_cameras=8, width=64, height=64))
    want, draws, fresh = {}, {}, {}
    for enc in ("nerf", "hash"):
        cfg_e = dataclasses.replace(cfg, ddf=dataclasses.replace(
            cfg.ddf, field=dataclasses.replace(cfg.ddf.field, position_encoding_type=enc)))
        jm_e = JModel(cfg_e)
        fresh[enc] = jax.jit(jm_e.init)(jax.random.PRNGKey(0))["ddf_field"]
        dm = JDM(JDMConfig(pixel_sampler=JPS(images_per_batch=8, rays_per_image=128), num_sky_rays=256),
                 scene["cameras"], scene["images"], scene["masks"])
        sampler = JSampler(num_samples_on_sphere=8, num_rays_per_sample=128, only_sample_upper_hemisphere=True,
                           concentration=20.0)
        jt = j_ddf.DDFTrainer(j_ddf.DDFTrainerConfig(max_num_iterations=steps, steps_per_log=1, sampler=sampler,
                                                     num_sky_rays=256),
                              jm_e, {**scene_params, "ddf_field": fresh[enc]}, datamanager=dm)
        draws[enc] = _jax_step_draws(jt.rng, sampler, steps)
        want[enc] = jt.run(num_steps=steps)

    calls = []
    dispatch = hashgrid.scatter_levels
    monkeypatch.setattr(hashgrid, "scatter_levels", lambda r, v, t: calls.append(r.shape) or dispatch(r, v, t))

    def copy_fresh(enc, trainer):
        for k, v in tree_items(trainer.ddf_params):
            with torch.no_grad():
                v.copy_(torch.from_numpy(flat_jax(fresh[enc])[k]))
        calls.append(enc)

    out = tmp_path / "ab.jsonl"
    recs = ab_ddf_encoding.main(["--ckpt", str(tmp_path / "ckpt"), "--steps", str(steps), "--log-every", "1",
                                 "--out", str(out), "--device", "cpu"], draws=draws, on_trainer=copy_fresh)
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == recs
    assert [json.loads(line) for line in out.read_text().splitlines()] == recs
    assert [(r["arm"], r.get("event", r.get("step"))) for r in recs] == [
        ("nerf", "start"), ("nerf", 1), ("nerf", 2), ("nerf", "done"),
        ("hash", "start"), ("hash", 1), ("hash", 2), ("hash", "done")]
    for enc in ("nerf", "hash"):
        rows = [r for r in recs if r["arm"] == enc and "step" in r]
        for rec, rj in zip(rows, want[enc]):
            assert set(rec) == set(rj) | {"arm", "elapsed_s"}
            for k, v in rj.items():
                _close(rec[k], v, 5, f"{enc} {k}")
        done = [r for r in recs if r["arm"] == enc][-1]
        _close(done["final_depth_psnr"], want[enc][-1]["depth_psnr"], 7, f"{enc} final_depth_psnr")
    hash_calls = calls[calls.index("hash") + 1:]
    assert calls.index("hash") == 1 and len(hash_calls) == 3 * steps
