"""The port's RENI++ prior machinery against the JAX package, on the CPU: the
procedural sky corpus, the RENI trainer (both ``variational`` settings), the
frozen-decoder latent fit, the torch-layout converter and the prior-training
script.

Sizes: a decoder of latent 8, hidden 32, 2 heads and 2 attention layers
(``--quick``'s); skies of 16 px (16 × 8 directions).  JAX's draws are fed
to the port (the trainer's image, pixel and ε draws; the fit's pixels).

Tolerances: the corpus bit for bit; trainer and fit results (params,
latents, losses, PSNRs) to 1e-4 relative of each array's largest entry —
optax forms Adam's 1 − β₂ in float32, so its steps are 1 − 6.7e-6 of
torch's; the converter exact; decodes of converted params to 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.data import sky_generator as j_sky
from neusky_tpu.engine import reni_convert as j_conv
from neusky_tpu.engine import reni_trainer as j_rt
from neusky_tpu.fields.reni import RENIField as JField, RENIFieldConfig as JFieldConfig

from neusky_torch.data import sky_generator as t_sky
from neusky_torch.engine import reni_convert as t_conv
from neusky_torch.engine import reni_trainer as t_rt
from neusky_torch.engine.checkpoint import PRIOR_FILE
from neusky_torch.fields.reni import RENIField as TField
from neusky_torch.tree import tree_items
from torch_parity import flat_jax, jax_to_torch_params, max_rel_err, one_torch_thread, to_torch_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(latent_dim=8, hidden_features=32, num_attention_heads=2, num_attention_layers=2, fixed_decoder=False)
RTOL = 1e-4


def _corpus(n=6, width=16, seed=3):
    return t_sky.generate_sky_corpus(n, width=width, seed=seed)


# ---------------------------------------------------------------------------
# the sky corpus


@pytest.mark.parametrize("num,width,seed", [(5, 16, 0), (3, 32, 7)])
def test_generate_sky_corpus_equals_jax_bit_for_bit(num, width, seed):
    want = j_sky.generate_sky_corpus(num, width=width, seed=seed)
    got = t_sky.generate_sky_corpus(num, width=width, seed=seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == (num, width // 2, width, 3)
    np.testing.assert_array_equal(got, want)
    params = tuple(j_sky.random_sky_params(np.random.default_rng(11)) for _ in range(2))
    np.testing.assert_array_equal(
        t_sky.generate_sky_corpus(2, 16, params=tuple(t_sky.SkyParams(**dataclasses.asdict(p)) for p in params)),
        j_sky.generate_sky_corpus(2, 16, params=params))


# ---------------------------------------------------------------------------
# the trainer


def _jax_trainer_draws(rng, cfg, num_images, n_pix, steps):
    """The draws of ``steps`` steps of ``neusky_tpu`` ``RENITrainer.run``
    from its key ``rng``: per chunk ``rng, k = split(rng)``, ``split(k,
    steps_per_call)``, then per step ``split(key, 3)`` → img, pix, eps."""
    draws = []
    for _ in range(steps // cfg.steps_per_call):
        rng, k = jax.random.split(rng)
        for key in jax.random.split(k, cfg.steps_per_call):
            k_img, k_pix, k_eps = jax.random.split(key, 3)
            d = {"img": jax.random.randint(k_img, (cfg.pixels_per_step,), 0, num_images),
                 "pix": jax.random.randint(k_pix, (cfg.pixels_per_step,), 0, n_pix)}
            if cfg.variational:
                d["eps"] = jax.random.normal(k_eps, (cfg.pixels_per_step, cfg.field.latent_dim, 3))
            draws.append({k2: torch.tensor(np.asarray(v)) for k2, v in d.items()})
    return draws


def _trainer_pair(variational: bool):
    cfg_j = j_rt.RENITrainerConfig(field=JFieldConfig(**TINY), pixels_per_step=64, steps_per_call=3,
                                   variational=variational, kl_weight=3e-3 if variational else 1e-5)
    skies = _corpus()
    jt = j_rt.RENITrainer(cfg_j, skies)
    # latents off zero: at z = 0 every latent token is alike, the attention
    # is uniform and the query path's true gradient is 0
    jt.params["latents"] = jnp.asarray(0.5 * np.random.default_rng(1).normal(size=jt.params["latents"].shape),
                                       jnp.float32)
    cfg_t = t_rt.RENITrainerConfig(**{**{f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)},
                                      "field": to_torch_config(cfg_j.field)})
    tt = t_rt.RENITrainer(cfg_t, skies, device="cpu")
    src = {"decoder": jax_to_torch_params(jt.params["decoder"]), "latents": torch.tensor(np.asarray(jt.params["latents"]))}
    if variational:
        src["logvar"] = torch.tensor(np.asarray(jt.params["logvar"]))
    want = dict(tree_items(src))
    with torch.no_grad():
        for k, v in tree_items(tt.params):
            v.copy_(want[k])
    return cfg_j, jt, tt


@pytest.mark.parametrize("variational", [True, False], ids=["variational", "autodecoder"])
def test_reni_trainer_chunks_match_jax(variational):
    """``run(5)`` in chunks of 3 rounds to 6 steps (a note says so), records
    both chunks, and lands on JAX's params (every leaf moved); the records'
    losses, two reconstruction PSNRs and a decoded envmap agree."""
    cfg_j, jt, tt = _trainer_pair(variational)
    start = {k: v.detach().numpy().copy() for k, v in tree_items(tt.params)}
    draws = _jax_trainer_draws(jt.rng, cfg_j, 6, 128, 6)
    notes_j, notes_t = [], []
    hist_j = jt.run(5, log_every=3, log_fn=notes_j.append)
    hist_t = tt.run(5, log_every=3, log_fn=notes_t.append, draws=draws)
    assert notes_t[0] == notes_j[0] == {"note": "rounded to 6 steps (chunks of 3)"}
    assert [r["step"] for r in hist_t] == [r["step"] for r in hist_j] == [3, 6] and tt.step == jt.step == 6
    for rt, rj in zip(hist_t, hist_j):
        assert sorted(rt) == sorted(rj)
        for k in ("recon", "kl", "total"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, err_msg=k)
    want = flat_jax(jt.params)
    got = dict(tree_items(tt.params))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k.endswith("/key/bias"):
            # adding a bias to every key shifts one query's logits alike, so
            # softmax takes no gradient from it: both packages move it by
            # Adam-normalised rounding noise, at most lr a step
            for p in (v.detach().numpy(), want[k]):
                assert np.abs(p - start[k]).max() <= 6 * cfg_j.lr * 1.001, k
            continue
        err = max_rel_err(v.detach().numpy(), want[k])
        assert err < RTOL, (k, err)
        assert not np.array_equal(v.detach().numpy(), start[k]), k

    for i in (0, 5):
        np.testing.assert_allclose(tt.reconstruction_psnr(i), jt.reconstruction_psnr(i), rtol=RTOL)
    z = np.asarray(jt.params["latents"][2])
    np.testing.assert_allclose(tt.decode_envmap(z, width=16), jt.decode_envmap(jnp.asarray(z), width=16), rtol=1e-3)


def test_reni_trainer_default_draws_are_seeded():
    """Without injected draws, the same seed gives the same run."""
    cfg = t_rt.RENITrainerConfig(field=to_torch_config(JFieldConfig(**TINY)), pixels_per_step=32, steps_per_call=2)
    runs = [t_rt.RENITrainer(cfg, _corpus(), device="cpu").run(2) for _ in range(2)]
    assert runs[0] == runs[1] and np.isfinite(runs[0][-1]["total"])


def _jax_fit_pixels(b, c, seed, steps, p, n_pix):
    """``fit_latents_to_envmaps``'s pixel draws: chunk ``lo`` from
    ``split(PRNGKey(seed + lo), steps)``."""
    return [np.stack([np.asarray(jax.random.randint(k, (p,), 0, n_pix))
                      for k in jax.random.split(jax.random.PRNGKey(seed + lo), steps)])
            for lo in range(0, b, c)]


def test_fit_latents_to_envmaps_matches_jax():
    """5 skies in chunks of 2 (the last padded), 6 steps of 64 pixels."""
    jf = JField(JFieldConfig(**TINY))
    params_j = jf.init(jax.random.PRNGKey(2), jnp.zeros((2, 3)), jnp.zeros((2, 8, 3)))
    skies = _corpus(5, seed=9)
    kw = dict(steps=6, lr=1e-1, pixels_per_step=64, seed=1, sky_chunk=2)
    z_j, psnr_j = j_rt.fit_latents_to_envmaps(jf, params_j, skies, **kw)
    tf = TField(to_torch_config(JFieldConfig(**TINY)))
    params_t = jax_to_torch_params(params_j)
    before = {k: v.clone() for k, v in tree_items(params_t)}
    z_t, psnr_t = t_rt.fit_latents_to_envmaps(tf, params_t, skies, pixel_draws=_jax_fit_pixels(5, 2, 1, 6, 64, 128),
                                              **kw)
    assert z_t.shape == z_j.shape == (5, 8, 3) and psnr_t.shape == (5,)
    assert max_rel_err(z_t, z_j) < RTOL, max_rel_err(z_t, z_j)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=RTOL)
    assert all(torch.equal(before[k], v) for k, v in tree_items(params_t))
    with pytest.raises(ValueError, match="H = W / 2"):
        t_rt.fit_latents_to_envmaps(tf, params_t, np.ones((1, 8, 8, 3), np.float32), steps=1)


def test_normalise_matches_jax():
    cfg = JFieldConfig(**TINY)
    hdr = np.concatenate([_corpus(1).reshape(-1, 3), np.zeros((2, 3), np.float32)])
    want = JField(cfg).normalise(jnp.asarray(hdr))
    got = TField(to_torch_config(cfg)).normalise(torch.from_numpy(hdr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the converter


CONV_CFG = dict(latent_dim=16, hidden_features=32, num_attention_heads=4, num_attention_layers=2, fixed_decoder=False)


@pytest.fixture(scope="module")
def conv_params():
    cfg_j = JFieldConfig(**CONV_CFG)
    params_j = JField(cfg_j).init(jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, 16, 3)))
    return cfg_j, to_torch_config(cfg_j), params_j, jax_to_torch_params(params_j)


def test_reni_convert_round_trip_and_both_ways_match_jax(conv_params):
    cfg_j, cfg_t, params_j, params_t = conv_params
    sd_j = j_conv.params_to_torch_state(params_j, cfg_j)
    sd_t = t_conv.params_to_torch_state(params_t, cfg_t)
    assert sorted(sd_t) == sorted(sd_j)
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], sd_j[k], err_msg=k)
    back = dict(tree_items(t_conv.torch_state_to_params(sd_j, cfg_t)))
    want = flat_jax(j_conv.torch_state_to_params(sd_j, cfg_j))
    orig = dict(tree_items(params_t))
    assert sorted(back) == sorted(want) == sorted(orig)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        assert torch.equal(v, orig[k]), k
    # the converted decoder decodes as JAX's
    g = np.random.default_rng(0)
    d = g.normal(size=(20, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = g.normal(size=(20, 16, 3)).astype(np.float32)
    out_j = JField(cfg_j).apply(params_j, jnp.asarray(d), jnp.asarray(z))["rgb"]
    out_t = TField(cfg_t).apply(t_conv.torch_state_to_params(sd_t, cfg_t), torch.from_numpy(d), torch.from_numpy(z))
    assert max_rel_err(out_t["rgb"].numpy(), out_j) < 1e-5


def test_reni_convert_aliases_checkpoint_file_and_filter(conv_params, tmp_path):
    """Aliased names map as JAX maps them; a nerfstudio-style checkpoint
    file (prefix, latent banks) converts back to the params."""
    cfg_j, cfg_t, params_j, params_t = conv_params
    sd = t_conv.params_to_torch_state(params_t, cfg_t)
    aliased = {k.replace("decoder.blocks.", "decoder.layers.").replace(".norm_q.", ".norm1."): v for k, v in sd.items()}
    got = dict(tree_items(t_conv.torch_state_to_params(aliased, cfg_t)))
    want = flat_jax(j_conv.torch_state_to_params(aliased, cfg_j))
    assert all(np.array_equal(v.numpy(), want[k]) for k, v in got.items())
    pipeline = {f"_model.field.{k}": torch.from_numpy(v) for k, v in sd.items()}
    pipeline.update({"_model.field.train_mu": torch.zeros(3, 16, 3), "_model.field.eval_logvar": torch.zeros(2),
                     "_model.other.weight": torch.ones(2)})
    filtered = t_conv.filter_reni_state_dict(pipeline)
    assert sorted(filtered) == sorted(j_conv.filter_reni_state_dict(pipeline)) == sorted(sd)
    path = tmp_path / "step-000050000.ckpt"
    torch.save({"pipeline": pipeline, "step": 50000}, path)
    loaded = dict(tree_items(t_conv.convert_torch_reni_checkpoint(str(path), cfg_t)))
    assert all(torch.equal(v, dict(tree_items(params_t))[k]) for k, v in loaded.items())


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_reni_convert_incomplete_mapping_raises(conv_params, change):
    _, cfg_t, _, params_t = conv_params
    sd = t_conv.params_to_torch_state(params_t, cfg_t)
    if change == "missing":
        sd.pop("decoder.blocks.1.ff2.bias")
        match = "decoder.block_1.Dense_1.bias"
    else:
        sd["decoder.blocks.0.extra.weight"] = np.zeros((2, 2), np.float32)
        match = "decoder.blocks.0.extra.weight"
    with pytest.raises(KeyError, match=match):
        t_conv.torch_state_to_params(sd, cfg_t)


# ---------------------------------------------------------------------------
# the prior-training script


def test_train_reni_prior_script_writes_a_loadable_prior(tmp_path):
    """``--quick`` for 4 steps on the CPU: the prior file and quality.json
    (JAX's gate keys) land in ``<output>_quick``, and a model whose
    ``illumination_prior_dir`` is that directory loads the decoder it holds."""
    from types import SimpleNamespace

    from neusky_torch.engine.checkpoint import load_illumination_prior, prior_asset_path
    from neusky_torch.tools import train_reni_prior

    rc = train_reni_prior.main(["--quick", "--steps", "4", "--output", str(tmp_path / "prior"), "--device", "cpu"])
    out = tmp_path / "prior_quick"
    assert rc in (0, 1) and (out / PRIOR_FILE).exists()
    quality = json.loads((out / "quality.json").read_text())
    jax_keys = {"train_recon_psnr", "heldout_fit_psnr", "equivariance_max_err", "train_gate", "holdout_gate",
                "equivariance_gate", "variational", "z0_mean_sky_psnr", "z0_decode_max_abs", "z0_srgb_saturated_frac",
                "clip_fit_loss_first", "clip_fit_loss_last", "z0_gate", "clip_fit_gate", "steps", "train_seconds",
                "num_skies", "width", "latent_dim", "all_pass"}
    assert set(quality) == jax_keys | {"device"} and quality["steps"] == 4 and rc == (0 if quality["all_pass"] else 1)
    assert quality["equivariance_gate"] and all(np.isfinite(quality[k]) for k in ("train_recon_psnr", "heldout_fit_psnr"))
    cfg = SimpleNamespace(illumination_prior_dir=str(out))
    assert prior_asset_path(cfg) == out / PRIOR_FILE
    field = TField(to_torch_config(JFieldConfig(**TINY)))
    template = {"illumination_decoder": field.init(torch.Generator().manual_seed(0), "cpu")}
    loaded = dict(tree_items(load_illumination_prior(template, cfg)))
    with np.load(out / PRIOR_FILE) as z:
        assert sorted(z.files) == sorted(loaded)
        for k, v in loaded.items():
            np.testing.assert_array_equal(v.numpy(), z[k])
