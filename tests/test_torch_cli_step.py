"""One ``neusky-tiny`` joint step on the first batch that ``cli train``
draws from a NeRF-OSR fixture, in the port and in the JAX package, from
the same converted params and with JAX's draws injected; then one update
of the recipe's optimizer (its own file, so it runs beside
``test_torch_cli.py`` on another worker).

The DDF's FiLM inputs run in float32 here (``model.ddf.field.
use_bf16_compute false``, through the CLI's override path): with the
recipe's bf16 rounding, inputs an ulp apart round to neighbouring bf16
values and the FiLM kernels' gradients differ by up to 2.4e-3 of scale;
the bf16 path is held by ``test_torch_joint_slice.py``.  Losses are held
to 1e-4 relative, gradients to 1e-3 of each array's scale
(``test_torch_joint_slice.py``'s float32 tolerances)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neusky_torch import cli as t_cli
from neusky_torch.configs import METHOD_REGISTRY as T_REGISTRY
from neusky_torch.engine.optimizers import GroupedAdam
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.models.pipeline import train_loss_fn as t_train_loss
from neusky_torch.tree import tree_items
from neusky_tpu import cli as j_cli
from neusky_tpu.configs import METHOD_REGISTRY as J_REGISTRY
from neusky_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import train_loss_fn as j_train_loss
from test_torch_cli import dm_pair, small_nerfosr_fixture
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture)
    flat_jax, jax_ddf_draws, jax_scene_draws, jax_to_torch_params, max_rel_err, one_torch_thread, to_torch_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
# a gradient that is zero in exact arithmetic (the attention's query and
# key of a single-token key set) comes out as float32 rounding noise
NOISE = 1e-9
STEP = 100.0
FP32_DDF = [("model.ddf.field.use_bf16_compute", "false")]


@pytest.fixture(scope="module")
def tiny_step(tmp_path_factory):
    """The recipe (latent counts from the fixture, the DDF in float32) on
    the fixture's first batch; every leaf but the eval group takes a
    gradient (``fixed_decoder=False``: the decoder's too)."""
    jdm, tdm = dm_pair(small_nerfosr_fixture(tmp_path_factory.mktemp("osr")), "neusky-tiny")
    j_bundle = j_cli._apply_overrides(J_REGISTRY["neusky-tiny"].build(), FP32_DDF)
    t_bundle = t_cli._apply_overrides(T_REGISTRY["neusky-tiny"].build(), FP32_DDF)
    assert to_torch_config(j_bundle) == t_bundle
    cfg_j = dataclasses.replace(j_bundle["model_config"], num_train_data=jdm.num_train,
                                num_eval_data=max(jdm.num_eval, 1))
    pipe_j = j_bundle["pipeline_config"]
    jb, tb = jdm.next_train(0), tdm.next_train(0)
    jm = JModel(cfg_j)
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))  # jitted: run eagerly, the init goes op by op
    rng = jax.random.PRNGKey(11)
    loss = lambda p: j_train_loss(jm, pipe_j, p, rng, jb, jnp.asarray(STEP, jnp.float32))
    (total_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)

    tm = TModel(to_torch_config(cfg_j), device="cpu")
    params_t = jax_to_torch_params(params_j)
    for k, v in tree_items(params_t):
        v.requires_grad_(not k.startswith("eval_latents/"))
    draws = jax_scene_draws(cfg_j, rng, tb["pixel_coords"].shape[0])
    draws["ddf"] = jax_ddf_draws(cfg_j, pipe_j, rng)
    total_t, aux_t = t_train_loss(tm, to_torch_config(pipe_j), params_t, tb, STEP, draws)
    total_t.backward()
    return dict(j_bundle=j_bundle, params_j=params_j, grads_j=grads_j, total_j=total_j, aux_j=aux_j,
                params_t=params_t, total_t=total_t, aux_t=aux_t, n_rays=tb["pixel_coords"].shape[0],
                n_sky=tb["sky_cam_idx"].shape[0])


def test_tiny_step_losses_match_jax(tiny_step):
    s = tiny_step
    assert (s["n_rays"], s["n_sky"]) == (64, 256)  # 4 images × 16 rays
    np.testing.assert_allclose(float(s["total_t"].detach()), float(s["total_j"]), rtol=LOSS_RTOL)
    lj, lt = s["aux_j"]["loss_dict"], s["aux_t"]["loss_dict"]
    assert sorted(lj) == sorted(lt) and "sky_ray_loss" in lt and "sky_pixel_loss" in lt
    for k in lj:
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for k, v in s["aux_j"]["metrics"].items():
        np.testing.assert_allclose(float(s["aux_t"]["metrics"][k]), float(v), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("group", ["proposal_networks", "fields", "illumination_field", "illumination_decoder",
                                   "visibility_sigmoid", "ddf_field"])
def test_tiny_step_gradients_match_jax(tiny_step, group):
    gj = flat_jax(tiny_step["grads_j"])
    pt = dict(tree_items(tiny_step["params_t"]))
    keys = [k for k in gj if k.startswith(group)]
    assert keys
    checked = 0
    for k in keys:
        got = np.zeros_like(gj[k]) if pt[k].grad is None else pt[k].grad.numpy()
        if np.abs(gj[k]).max() <= NOISE:
            assert np.abs(got).max() <= NOISE, k
            continue
        checked += 1
        assert max_rel_err(got, gj[k]) < GRAD_REL, (k, max_rel_err(got, gj[k]))
    assert checked


def test_tiny_update_keeps_the_decoder_and_moves_latents_as_jax(tiny_step):
    """One update of the tiny recipe's optimizer from JAX's gradients: the
    port's ``GroupedAdam`` and JAX's ``build_optimizer`` give the same
    params, to 2e-5 of the largest step (1e-2: optax's Adam forms 1 − β₂
    in float32, its steps are 1 − 6.7e-6 of torch's); the decoder, which
    has a gradient, moves in neither."""
    s = tiny_step
    groups_j = s["j_bundle"]["optimizer_groups"]
    opt_j = j_build_optimizer(s["params_j"], groups_j)
    update = jax.jit(lambda g, p: optax.apply_updates(p, opt_j.update(g, opt_j.init(p), p)[0]))
    want = flat_jax(update(s["grads_j"], s["params_j"]))
    before = flat_jax(s["params_j"])

    params_t = jax_to_torch_params(s["params_j"])
    opt_t = GroupedAdam(params_t, to_torch_config(groups_j))
    grads = flat_jax(s["grads_j"])
    for k, v in tree_items(params_t):
        if v.requires_grad:
            v.grad = torch.from_numpy(grads[k].copy())
    opt_t.step()
    got = {k: v.detach().numpy() for k, v in tree_items(params_t)}
    assert sorted(got) == sorted(want)
    decoder = [k for k in got if k.startswith("illumination_decoder/")]
    assert decoder and any(np.abs(grads[k]).max() > 1.0 for k in decoder)
    for k in decoder:
        assert np.array_equal(got[k], before[k]) and np.array_equal(want[k], before[k]), k
    latents = "illumination_field/train_latents"
    assert np.abs(got[latents] - before[latents]).max() > 1e-3
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-7, err_msg=k)
