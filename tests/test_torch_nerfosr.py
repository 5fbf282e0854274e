"""The port's NeRF-OSR relighting protocol against the JAX package, on the
CPU, and ``cli eval --protocol nerfosr`` end to end.

The data is the port's NeRF-OSR fixture (2 sessions; 2 train, 1 validation
and 2 test views each; 24 × 16), parsed and loaded by each package's own
parser and dataset; test image 0 of each session is the optimise
(holdout) image, image 1 the building-masked compare image.  The model is
``test_torch_eval.py``'s: the tiny joint config (DDF in float32) with the
canonical RENI++ decoder and its converted prior, one eval slot a session.
Fits take 4 steps here (6 for the rotation fit alone, 10 through the
command line), the envmap fit 256 pixels a step; JAX's envmap-fit pixel
draws are fed to the port.

Tolerances: batches, envmap resizes and the fixture arrays bit for bit;
the envmaps to 1e-6 relative (float32 ``pow``); fit losses, angles, scales,
PSNR, SSIM and MSE to 1e-4 relative, LPIPS to 1e-3 relative (the
random-VGG distance of two near-equal masked renders).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.data.dataparsers.nerfosr import NeRFOSRDataparserConfig as JParserConfig
from neusky_tpu.data.dataparsers.nerfosr import parse_nerfosr_scene as j_parse
from neusky_tpu.data.dataset import NeuSkyDataset as JDataset
from neusky_tpu.data import nerfosr_eval as j_osr
from neusky_tpu.engine import eval_loop as j_eval
from neusky_tpu.engine import reni_trainer as j_rt

from neusky_torch import cli as t_cli
from neusky_torch.data.dataparsers.nerfosr import NeRFOSRDataparserConfig as TParserConfig
from neusky_torch.data.dataparsers.nerfosr import parse_nerfosr_scene as t_parse
from neusky_torch.data.dataset import NeuSkyDataset as TDataset
from neusky_torch.data import nerfosr_eval as t_osr
from neusky_torch.data.fixtures import make_nerfosr_fixture
from neusky_torch.engine import eval_loop as t_eval
from neusky_torch.engine import reni_trainer as t_rt
from neusky_torch.utils.viz import resize_bilinear_u8
from test_torch_eval import _count_scatters, eval_setup
from test_torch_reni_trainer import _jax_fit_pixels
from torch_parity import one_torch_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HOLDOUT = (0, 0)
W, H = 24, 16
RTOL = 1e-4
FIT_STEPS = 4
ENVMAP_PIXELS = 256
CLI_FIT_STEPS = 10


@pytest.fixture(scope="module")
def osr_root(tmp_path_factory):
    return make_nerfosr_fixture(tmp_path_factory.mktemp("osr"), num_sessions=2, train_per_session=2,
                                test_per_session=2, width=W, height=H)


def _test_split(root, parse, parser_config, dataset):
    po = parse(parser_config(data=str(root), scene="site1", session_holdout_indices=HOLDOUT), "test")
    return po, dataset(po, "test", 1).load()


def protocols(root):
    """A fresh (JAX, port) pair of protocols over the fixture's test split."""
    out = []
    for parse, pcfg, ds, mod in ((j_parse, JParserConfig, JDataset, j_osr), (t_parse, TParserConfig, TDataset, t_osr)):
        po, data = _test_split(root, parse, pcfg, ds)
        out.append(mod.NeRFOSREvalProtocol(
            cameras=data["cameras"], images=data["images"], masks=data["masks"],
            session_to_indices=po["session_to_indices"], indices_to_session=po["indices_to_session"],
            session_holdout_indices=po["session_holdout_indices"],
            test_eval_mask_indices=sorted(po["test_eval_mask_dict"].keys()),
        ))
    return out


@pytest.fixture(scope="module")
def setup():
    return eval_setup()


# ---------------------------------------------------------------------------
# the protocol's batches


def test_lighting_eval_batch_equals_jax_bit_for_bit(osr_root):
    jp, tp = protocols(osr_root)
    assert (tp.optimise_indices, tp.compare_indices, tp.num_sessions) == (jp.optimise_indices, jp.compare_indices,
                                                                        jp.num_sessions) == ([0, 2], [1, 3], 2)
    assert [tp.latent_slot_of_image(i) for i in range(4)] == [0, 0, 1, 1]
    np.testing.assert_array_equal(tp.masks, jp.masks)
    for mode in ("optimise", "compare", "compare", "optimise"):
        want, got = jp.lighting_eval_batch(mode), tp.lighting_eval_batch(mode)
        assert sorted(got) == sorted(want)
        assert got["cameras"] is tp.cameras
        for k in want:
            if k != "cameras":
                assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), (mode, k)
    for i in range(2):
        (ij, sj, rbj, bj), (it, st, rbt, bt) = jp.compare_image(i), tp.compare_image(i)
        assert (it, st) == (ij, sj) and bt["image_idx"] == bj["image_idx"]
        for k in ("image", "mask"):
            np.testing.assert_array_equal(bt[k], np.asarray(bj[k]))
        np.testing.assert_allclose(rbt.directions.numpy(), np.asarray(rbj.directions), atol=1e-6)


def test_protocol_rejects_overlap_and_least_squares_scale_matches(osr_root):
    _, tp = protocols(osr_root)
    with pytest.raises(ValueError, match=r"holdout images \[1\] are also compare images"):
        t_osr.NeRFOSREvalProtocol(tp.cameras, tp.images, tp.masks, tp.session_to_indices, tp.indices_to_session,
                                  [1, 0], [1, 3])
    g = np.random.default_rng(0)
    pred, gt = g.random((4, 5, 3)).astype(np.float32), g.random((4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_osr.global_least_squares_scale(pred, gt), j_osr.global_least_squares_scale(pred, gt))


# ---------------------------------------------------------------------------
# envmaps


@pytest.mark.parametrize("src,dst", [((32, 64), (64, 128)), ((150, 300), (64, 128)), ((33, 65), (7, 12))],
                         ids=["fixture_upsample", "downsample", "odd_sizes"])
def test_resize_bilinear_equals_pillow(src, dst):
    from PIL import Image

    g = np.random.default_rng(sum(src))
    for img in (g.integers(0, 256, src + (3,), dtype=np.uint8),
                (np.linspace(0, 255, src[0] * src[1]).reshape(src)).astype(np.uint8)):
        want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_u8(img, dst[1], dst[0]), want)


def test_load_session_envmaps_matches_jax_pillow(osr_root):
    po_j, _ = _test_split(osr_root, j_parse, JParserConfig, JDataset)
    po_t, _ = _test_split(osr_root, t_parse, TParserConfig, TDataset)
    want = j_eval._load_session_envmaps(po_j, width=128)
    got = t_eval._load_session_envmaps(po_t, width=128)
    assert got.shape == want.shape == (2, 64, 128, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the fits and the protocol


def _gt_latents(setup):
    z = np.asarray(setup["params_j"]["eval_latents"]["eval_latents"])
    return (z + 0.2 * np.random.default_rng(4).normal(size=z.shape)).astype(np.float32)


def test_fit_eval_rotation_matches_jax(setup, osr_root, monkeypatch):
    """6 steps on the same compare batches: the loss trace, the angles and
    the fitted scale; the latents stay the given ones; no hash-table
    gradient is scattered."""
    jm, tm, pj, pt = setup["jm"], setup["tm"], setup["params_j"], setup["params_t"]
    jp, tp = protocols(osr_root)
    gt = _gt_latents(setup)
    out_j, gamma_j, losses_j = j_eval.fit_eval_rotation(jm, pj, jp, jax.random.PRNGKey(3), jnp.asarray(gt), steps=6)
    calls = _count_scatters(monkeypatch)
    out_t, gamma_t, losses_t = t_eval.fit_eval_rotation(tm, pt, tp, torch.from_numpy(gt), steps=6)
    assert calls == []
    np.testing.assert_allclose(losses_t, losses_j, rtol=RTOL)
    assert losses_t[-1] != losses_t[0] and ((0 <= gamma_t) & (gamma_t < 2 * np.pi)).all()
    np.testing.assert_allclose(gamma_t, gamma_j, rtol=RTOL)
    for k in ("eval_scale", "eval_rotation"):
        np.testing.assert_allclose(out_t["eval_latents"][k].numpy(), np.asarray(out_j["eval_latents"][k]), rtol=RTOL)
    np.testing.assert_array_equal(out_t["eval_latents"]["eval_latents"].numpy(), gt)


MODES = {
    "per_image": dict(),
    "compare_scale_least_squares": dict(optimise_compare_eval_scale=True, least_squares_scale=True),
    "envmap": dict(envmap=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_run_nerfosr_protocol_matches_jax(setup, osr_root, mode, monkeypatch):
    jm, tm, pj, pt = setup["jm"], setup["tm"], setup["params_j"], setup["params_t"]
    kw = dict(MODES[mode])
    jp, tp = protocols(osr_root)
    if kw.pop("envmap", False):
        po_j, _ = _test_split(osr_root, j_parse, JParserConfig, JDataset)
        kw["gt_envmaps"] = j_eval._load_session_envmaps(po_j, width=128)
        # both fits take ENVMAP_PIXELS a step, the port JAX's pixel draws
        fit_j, fit_t = j_rt.fit_latents_to_envmaps, t_rt.fit_latents_to_envmaps
        draws = _jax_fit_pixels(2, 2, 1, FIT_STEPS, ENVMAP_PIXELS, 64 * 128)
        monkeypatch.setattr(j_rt, "fit_latents_to_envmaps",
                            lambda *a, **k: fit_j(*a, pixels_per_step=ENVMAP_PIXELS, **k))
        monkeypatch.setattr(t_eval, "fit_latents_to_envmaps",
                            lambda *a, **k: fit_t(*a, pixels_per_step=ENVMAP_PIXELS, pixel_draws=draws, **k))
    want = j_eval.run_nerfosr_protocol(jm, pj, jp, jax.random.PRNGKey(1), fit_steps=FIT_STEPS, chunk_size=W * H,
                                       **kw)
    calls = _count_scatters(monkeypatch)
    got = t_eval.run_nerfosr_protocol(tm, pt, tp, fit_steps=FIT_STEPS, chunk_size=W * H, **kw)
    assert calls == [] and sorted(got) == sorted(want)
    assert got["num_sessions"] == want["num_sessions"] == 2 and got["lpips_flavour"] == want["lpips_flavour"]
    for k in ("fit_loss_first", "fit_loss_last") + (("envmap_fit_psnr", "session_rotation_rad") if "gt_envmaps" in kw
                                                   else ()):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert [(p["image_idx"], p["session"]) for p in got["per_image"]] == [(1, 0), (3, 1)] == [
        (p["image_idx"], p["session"]) for p in want["per_image"]]
    for pg, pw in zip(got["per_image"] + [got["mean"]], want["per_image"] + [want["mean"]]):
        assert sorted(pg) == sorted(pw)
        for k in ("psnr", "ssim", "mse"):
            np.testing.assert_allclose(pg[k], pw[k], rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(pg["lpips"], pw["lpips"], rtol=1e-3)
        assert pg["num_rays_per_sec"] > 0
    np.testing.assert_allclose(got["mean"]["num_rays_per_sec"], got["per_image"][1]["num_rays_per_sec"])


def test_eval_image_metrics_mask_to_building(setup):
    """``mask_to_building`` scores the render and the image inside mask
    channel 0 only."""
    from test_torch_eval import make_datamanagers

    tm, pt = setup["tm"], setup["params_t"]
    _, tdm = make_datamanagers()
    tdm.eval_masks = tdm.eval_masks.copy()
    tdm.eval_masks[1, :, :8, 0] = 0.0  # the synthetic scene's static mask is all ones
    m = t_eval.eval_image_metrics(tm, pt, tdm, 1, chunk_size=256, mask_to_building=True)
    _, batch = tdm.eval_image_bundle(1)
    keep = np.asarray(batch["mask"])[:, 0:1]
    pred, gt = m["outputs"]["rgb"] * keep, np.asarray(batch["image"]) * keep
    assert 0 < keep.mean() < 1
    np.testing.assert_allclose(m["mse"], np.mean((pred - gt) ** 2), rtol=1e-6)
    assert m["mse"] != t_eval.eval_image_metrics(tm, pt, tdm, 1, chunk_size=256)["mse"]


# ---------------------------------------------------------------------------
# the command line


@pytest.mark.parametrize("method", ["per_image", "nerf_osr_envmap"])
def test_cli_eval_protocol_nerfosr(osr_root, tmp_path, capsys, method, monkeypatch):
    """``train neusky-tiny`` one step on the fixture, then ``eval
    neusky-tiny --protocol nerfosr`` from its checkpoint (its fits cut to
    10 steps): the mean metrics printed, the JSON written with JAX's keys,
    the metrics finite."""
    protocol = t_eval.run_nerfosr_protocol
    monkeypatch.setattr(t_eval, "run_nerfosr_protocol", lambda *a, **k: protocol(*a, fit_steps=CLI_FIT_STEPS, **k))
    common = ["--data", str(osr_root), "--session-holdout-indices", "0,0", "--device", "cpu"]
    run = tmp_path / "run"
    t_cli.main(["train", "neusky-tiny", *common, "--max-iterations", "1", "--rays-per-batch", "32",
                "--output-dir", str(run)])
    capsys.readouterr()
    out = tmp_path / "metrics.txt"
    t_cli.main(["eval", "neusky-tiny", *common, "--load-dir", str(run), "--protocol", "nerfosr", "--output", str(out),
                "--model.eval_latent_optimise_method", method])
    printed = capsys.readouterr().out.strip().splitlines()
    result = json.loads((tmp_path / "metrics.json").read_text())
    assert printed[-1] == f"wrote {tmp_path / 'metrics.json'}" and json.loads(printed[-2]) == result["mean"]
    keys = {"per_image", "mean", "fit_loss_first", "fit_loss_last", "num_sessions", "lpips_flavour"}
    if method == "nerf_osr_envmap":
        keys |= {"envmap_fit_psnr", "session_rotation_rad"}
        assert all(0 <= g < 2 * np.pi for g in result["session_rotation_rad"])
        assert all(np.isfinite(result["envmap_fit_psnr"]))
    assert set(result) == keys and result["num_sessions"] == 2 and len(result["per_image"]) == 2
    assert all(np.isfinite(v) for v in result["mean"].values())
    assert np.isfinite(result["fit_loss_last"])
