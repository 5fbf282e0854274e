"""The prior's init-latent fit (``neusky_torch/tools/fit_prior_init_latent.py``)
against the JAX tool's computation on the CPU, and a prior trained by the
port carried end to end: ``train_reni_prior --quick`` → the init-latent
fit → ``load_illumination_prior`` seeding the latents; and
``train_reni_prior --gates-only``.

The JAX tool is a script of the JAX package and stays unedited: the test
runs the JAX functions it runs (``fit_latents_to_envmaps`` for the log
domain; its LDR loop, Adam through the clipped sRGB path, as the tool
writes it) on a tiny decoder (latent 8, hidden 32, 2 heads, 2 layers: the
``--quick`` decoder) with JAX's draws fed to the port (the fits' pixels,
the 1,024 statistic directions).

Tolerances: fitted latents to 1e-4 of their largest entry and PSNRs to
1e-4 relative (optax forms Adam's 1 − β₂ in float32); the statistics the
tool rounds to 4 digits, to 2e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neusky_tpu.core.colour import linear_to_sRGB as j_srgb
from neusky_tpu.engine import reni_trainer as j_rt
from neusky_tpu.fields.reni import RENIField as JField, RENIFieldConfig as JFieldConfig
from neusky_tpu.sampling.illumination import EquirectangularSampler as JEquirect

from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.data.sky_generator import generate_sky_corpus
from neusky_torch.engine.checkpoint import PRIOR_FILE, load_illumination_prior, prior_init_latent
from neusky_torch.fields.reni import RENIField as TField
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.tools import fit_prior_init_latent as fpil, train_reni_prior
from torch_parity import jax_to_torch_params, max_rel_err, one_torch_thread, to_torch_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUICK = dict(latent_dim=8, hidden_features=32, num_attention_heads=2, num_attention_layers=2, fixed_decoder=True)
RTOL = 1e-4
STEPS = 6


@pytest.fixture(scope="module")
def decoder_pair():
    jf = JField(JFieldConfig(**QUICK))
    params_j = jf.init(jax.random.PRNGKey(2), jnp.zeros((2, 3)), jnp.zeros((2, 8, 3)))
    tf = TField(to_torch_config(JFieldConfig(**QUICK)))
    return jf, params_j, tf, jax_to_torch_params(params_j)


def test_quick_decoder_is_the_prior_scripts():
    """``--quick`` in both scripts is the decoder these tests hold."""
    cfg = train_reni_prior.prior_field_config(True)
    assert all(getattr(cfg, k) == v for k, v in QUICK.items() if k != "fixed_decoder")


def test_log_domain_fit_matches_jax(decoder_pair):
    """3 skies of 16 px: the log-domain mean sky, 6 steps of 2,048 pixels."""
    jf, params_j, tf, params_t = decoder_pair
    corpus = generate_sky_corpus(3, width=16, seed=0)
    mean_sky = np.exp(np.log(np.maximum(corpus, 1e-8)).mean(axis=0))[None].astype(np.float32)
    z_j, psnr_j = j_rt.fit_latents_to_envmaps(jf, params_j, mean_sky, steps=STEPS)
    pix = [np.stack([np.asarray(jax.random.randint(k, (2048,), 0, 128))
                     for k in jax.random.split(jax.random.PRNGKey(1), STEPS)])]
    z_t, psnr_t = fpil.fit_log_domain(tf, params_t, corpus, STEPS, pixel_draws=pix)
    assert z_t.shape == (8, 3)
    assert max_rel_err(z_t, z_j[0]) < RTOL, max_rel_err(z_t, z_j[0])
    np.testing.assert_allclose(psnr_t, float(psnr_j[0]), rtol=RTOL)


def _jax_ldr(jf, decoder, corpus, steps, seed):
    """The JAX tool's ``--ldr`` fit (``tools/fit_prior_init_latent.py``)."""
    nc = corpus.shape[0]
    q = np.quantile(corpus.reshape(nc, -1), 0.98, axis=1)[:, None, None, None]
    target = fpil.srgb_np(corpus / np.maximum(q, 1e-8)).mean(axis=0)
    h, w = target.shape[:2]
    dirs = jnp.asarray(np.asarray(JEquirect(width=w)()).reshape(h * w, 3))
    tgt = jnp.asarray(target.reshape(h * w, 3).astype(np.float32))
    opt = optax.adam(1e-2)

    @jax.jit
    def run(z, rng):
        state = opt.init(z)

        def body(carry, k):
            z, state = carry
            pix = jax.random.randint(k, (2048,), 0, h * w)

            def loss(z):
                pred = j_srgb(jf.unnormalise(jf.apply(decoder, dirs[pix], z)["rgb"]))
                return jnp.mean((pred - tgt[pix]) ** 2)

            updates, state = opt.update(jax.grad(loss)(z), state, z)
            return (z + updates, state), None

        (z, _), _ = jax.lax.scan(body, (z, state), jax.random.split(rng, steps))
        return z

    z = np.asarray(run(jnp.zeros((8, 3)), jax.random.PRNGKey(seed)))
    pred = np.asarray(j_srgb(jf.unnormalise(jf.apply(decoder, dirs, jnp.asarray(z))["rgb"])))
    mse = float(np.mean((pred - np.asarray(tgt)) ** 2))
    return z, 10.0 * float(np.log10(1.0 / max(mse, 1e-12))), float((np.asarray(tgt) < 0.999).mean()), h * w


def test_ldr_fit_matches_jax(decoder_pair):
    jf, params_j, tf, params_t = decoder_pair
    corpus = generate_sky_corpus(3, width=16, seed=4)
    z_j, psnr_j, frac_j, n_pix = _jax_ldr(jf, params_j, corpus, STEPS, seed=4)
    pix = np.stack([np.asarray(jax.random.randint(k, (2048,), 0, n_pix))
                    for k in jax.random.split(jax.random.PRNGKey(4), STEPS)])
    z_t, psnr_t, frac_t = fpil.fit_ldr(tf, params_t, corpus, STEPS, seed=4, pixel_draws=pix)
    assert max_rel_err(z_t, z_j) < RTOL, max_rel_err(z_t, z_j)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=RTOL)
    assert frac_t == frac_j


def test_decode_stats_match_jax(decoder_pair):
    """The statistics of a latent's decode over JAX's 1,024 directions
    (``normal(PRNGKey(3))``), as the JAX tool computes them."""
    jf, params_j, tf, params_t = decoder_pair
    z = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    d = jax.random.normal(jax.random.PRNGKey(3), (1024, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    out = jf.apply(params_j, d, jnp.asarray(z))["rgb"]
    raw, hdr = np.asarray(out), np.asarray(jf.unnormalise(out))
    view = fpil.srgb_np(hdr)
    want = {"raw_out_min": raw.min(), "raw_out_max": raw.max(), "raw_out_frac_in_domain": (np.abs(raw) <= 1.0).mean(),
            "hdr_mean": hdr.mean(), "hdr_max": hdr.max(), "srgb_frac_unsaturated": (view < 0.999).mean(),
            "srgb_mean": view.mean()}
    got = fpil.decode_stats(tf, params_t, z, dirs=torch.from_numpy(np.array(d)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= 2e-4 * max(1.0, abs(float(v))), (k, got[k], v)


@pytest.fixture(scope="module")
def quick_prior(tmp_path_factory):
    """A prior from ``train_reni_prior --quick`` (4 steps): no init latent."""
    out = tmp_path_factory.mktemp("prior")
    rc = train_reni_prior.main(["--quick", "--steps", "4", "--output", str(out / "prior"), "--device", "cpu"])
    prior = out / "prior_quick"
    assert rc in (0, 1)
    with np.load(prior / PRIOR_FILE) as z:
        assert "init_latent" not in z.files
    return prior


def test_init_latent_round_trip(quick_prior):
    """The init-latent fit adds ``init_latent`` to the port's prior file and
    keeps its decoder; a model configured with that prior seeds its train
    and eval latents with it."""
    with np.load(quick_prior / PRIOR_FILE) as z:
        decoder = {k: z[k] for k in z.files}
    rc = fpil.main(["--prior", str(quick_prior), "--quick", "--num-skies", "3", "--width", "16", "--steps", "30",
                    "--device", "cpu"])
    assert rc == 0
    with np.load(quick_prior / PRIOR_FILE) as z:
        assert sorted(z.files) == sorted([*decoder, "init_latent"])
        init = z["init_latent"]
        for k, v in decoder.items():
            np.testing.assert_array_equal(z[k], v)
    stats = json.loads((quick_prior / "init_latent.json").read_text())
    assert init.shape == (8, 3) and stats["mode"] == "log_domain" and stats["raw_out_frac_in_domain"] > 0.95

    import dataclasses

    field = dataclasses.replace(train_reni_prior.prior_field_config(True), fixed_decoder=True)
    cfg = dataclasses.replace(tiny_model_config(3, 2), illumination=field, illumination_prior_dir=str(quick_prior))
    np.testing.assert_array_equal(prior_init_latent(cfg), init)
    params = load_illumination_prior(NeuSkyModel(cfg, device="cpu").init(torch.Generator().manual_seed(0)), cfg)
    for group, key, n in (("illumination_field", "train_latents", 3), ("eval_latents", "eval_latents", 2)):
        np.testing.assert_array_equal(params[group][key].numpy(), np.broadcast_to(init, (n, 8, 3)))


def test_gates_only_regates_the_written_prior(quick_prior, monkeypatch):
    """``--gates-only``: no training and no new prior file (the init latent
    stays); quality.json rewritten with the recorded step count, no
    training time and the gates sampled over the refitted latents.  The
    latent fits are cut from 250 steps to 5: the flow is under test here,
    the fit is held above and in ``tests/test_torch_reni_trainer.py``."""
    from neusky_torch.engine.reni_trainer import RENITrainer

    fit = RENITrainer.fit_heldout_latents
    monkeypatch.setattr(RENITrainer, "fit_heldout_latents", lambda self, skies, steps=400, **kw: fit(
        self, skies, steps=5, **kw))
    before = (quick_prior / PRIOR_FILE).read_bytes()
    rc = train_reni_prior.main(["--quick", "--steps", "4", "--output", str(quick_prior.parent / "prior"),
                                "--gates-only", "--device", "cpu"])
    q = json.loads((quick_prior / "quality.json").read_text())
    assert rc == (0 if q["all_pass"] else 1) and (quick_prior / PRIOR_FILE).read_bytes() == before
    assert q["steps"] == 4 and q["train_seconds"] == 0.0 and q["num_skies"] == 24
    assert np.isfinite(q["train_recon_psnr"]) and q["equivariance_gate"]
