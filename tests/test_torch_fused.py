"""The fused scene + DDF-ground-truth pass (``fused_ddf_gt_pass``,
``NeuSkyModel.forward_with_ddf_gt``) of the port against the JAX package's
fused joint step, and against the port's own unfused pass, on the CPU.

Two JAX joint steps are compiled, once each for the module, both on the
tiny joint configuration of ``test_torch_joint_slice`` with the fused pass
and its SDF encodings made to matter (random hash tables, the first SDF
layer's encoding weights off zero):

- ``fused``: float32 everywhere (the DDF's FiLM products too), to hold the
  fused pass's semantics tightly: losses to 1e-4 relative, gradients to
  1e-3 of each array's scale, as ``test_torch_joint_slice``;
- ``bench_knobs``: what ``chip_smoke.py`` runs at full width as (b), at
  tiny width: the fused pass, bf16 FiLM products, the bf16 mapping network
  with per-layer heads, ``dots`` recompute, bf16 SDF MLPs and the level-set
  query in chunks of 100 points (the last one short).  bf16 roundings a
  float32 ulp apart may flip to the neighbouring bfloat16 value (2⁻⁸
  relative): a flip in a kernel's bf16-rounded cotangent moves an element
  by up to 2⁻⁷ of it, and the weight-normalised colour layers' gradients
  (through the norm's projection) cancel down to a few times that.  Losses
  are held to 1e-3 relative, gradients to 5e-2 of each array's scale.

Reached on the CPU: ``fused`` total 1.1e-6 relative, worst term 7.8e-6
(``multi_view_loss``), gradients ≤ 5.5e-4 of scale (``ddf_field``; the SDF
field 6.0e-5); ``bench_knobs`` total 8.1e-6, worst term 1.1e-4
(``multi_view_loss``), gradients 2.2e-2 (``fields`` ``col_1/kernel``),
1.2e-2 (``ddf_field``), ≤ 4.8e-4 in every other group.

The port gets JAX's draws (``torch_parity.jax_fused_draws``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import train_loss_fn as j_train_loss

from neusky_torch.models import neusky as t_neusky
from neusky_torch.models.pipeline import batch_ray_bundle, train_loss_fn as t_train_loss
from neusky_torch.ops import hashgrid
from neusky_torch.sampling.ddf_sampler import vmf_ddf_samples as t_vmf
from neusky_torch.tree import tree_items
from test_torch_joint_slice import GROUPS, PIPE, STEP, _trainable, tiny_joint_config
from test_torch_slice import make_batch_pair
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture)
    flat_jax, jax_fused_draws, jax_to_torch_params, jax_vmf_draws, max_rel_err, one_torch_thread, to_torch_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = {"fused": 1e-4, "bench_knobs": 1e-3}
GRAD_REL = {"fused": 1e-3, "bench_knobs": 5e-2}
N_SCENE, N_GT = 128, 32
SDF_QUERY_CHUNK = 100


def fused_config(variant: str):
    cfg = dataclasses.replace(tiny_joint_config(variant == "bench_knobs"), fused_ddf_gt_pass=True)
    if variant == "fused":
        return cfg
    field = dataclasses.replace(cfg.ddf.field, use_bf16_mapping=True, film_per_layer_heads=True)
    return dataclasses.replace(
        cfg, ddf=dataclasses.replace(cfg.ddf, field=field), visibility_remat_policy="dots",
        sdf_query_chunk=SDF_QUERY_CHUNK,
        sdf_field=dataclasses.replace(cfg.sdf_field, use_bf16_compute=True),
    )


def _perturbed_params(jm):
    """Init params with random hash tables and the first SDF layer's
    encoding weights off zero, so every encode's table gradient counts."""
    p = jm.init(jax.random.PRNGKey(0))
    f = p["fields"]["params"]
    k0 = f["geo_0"]["kernel"]
    f["geo_0"]["kernel"] = k0 + 0.01 * jax.random.normal(jax.random.PRNGKey(1), k0.shape)
    f["hash_table"] = 0.1 * jax.random.normal(jax.random.PRNGKey(2), f["hash_table"].shape)
    return p


@pytest.fixture(scope="module")
def batch_pair():
    return make_batch_pair()


@pytest.fixture(scope="module", params=["fused", "bench_knobs"])
def fused(request, batch_pair):
    variant = request.param
    jb, tb = batch_pair
    cfg_j = fused_config(variant)
    jm = JModel(cfg_j)
    params_j = _perturbed_params(jm)
    rng = jax.random.PRNGKey(7)
    loss = lambda p: j_train_loss(jm, PIPE, p, rng, jb, jnp.asarray(STEP, jnp.float32))  # noqa: E731
    (total_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)

    tm = t_neusky.NeuSkyModel(to_torch_config(cfg_j), device="cpu")
    params_t = _trainable(jax_to_torch_params(params_j))
    calls = []
    dispatch = hashgrid.scatter_levels
    hashgrid.scatter_levels = lambda r, v, t: calls.append(tuple(r.shape)) or dispatch(r, v, t)
    try:
        total_t, aux_t = t_train_loss(tm, to_torch_config(PIPE), params_t, tb, STEP,
                                      jax_fused_draws(cfg_j, PIPE, rng, N_SCENE))
        total_t.backward()
    finally:
        hashgrid.scatter_levels = dispatch
    return dict(variant=variant, cfg=to_torch_config(cfg_j), grads_j=grads_j, total_j=total_j, aux_j=aux_j,
                params_t=params_t, total_t=total_t, aux_t=aux_t, calls=calls)


def test_fused_total_loss_matches_jax(fused):
    np.testing.assert_allclose(float(fused["total_t"].detach()), float(fused["total_j"]),
                               rtol=LOSS_RTOL[fused["variant"]])


def test_fused_every_loss_term_and_metric_matches_jax(fused):
    lj, lt = fused["aux_j"]["loss_dict"], fused["aux_t"]["loss_dict"]
    assert sorted(lj) == sorted(lt) and "sdf_level_set_visibility_loss" in lt and "interlevel_loss" in lt
    for k in lj:
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]), rtol=LOSS_RTOL[fused["variant"]], atol=1e-7,
                                   err_msg=k)
    mj, mt = fused["aux_j"]["metrics"], fused["aux_t"]["metrics"]
    assert sorted(mj) == sorted(mt)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=LOSS_RTOL[fused["variant"]], err_msg=k)


@pytest.mark.parametrize("group", GROUPS)
def test_fused_group_gradients_match_jax(fused, group):
    gj = flat_jax(fused["grads_j"])
    pt = dict(tree_items(fused["params_t"]))
    keys = [k for k in gj if k.split("/")[0].startswith(group)]
    assert keys
    for k in keys:
        g_t = pt[k].grad
        g_t = np.zeros_like(gj[k]) if g_t is None else g_t.numpy()
        if np.abs(gj[k]).max() == 0:
            assert np.abs(g_t).max() == 0, k
            continue
        err = max_rel_err(g_t, gj[k])
        assert err < GRAD_REL[fused["variant"]], (k, err)


def test_fused_step_scatters_once_per_differentiated_encode(fused):
    """K1's count per fused joint step, from the code: the one proposal and
    field pass over the 128 scene and 32 vMF rays encodes three times (two
    proposal fields, the SDF ``field_outputs``), each once for both ray
    sets; then the density-grid SDF, the level-set SDF query (in chunks of
    100 of its 128 × 8 points under ``bench_knobs``: 11 launches, the last
    of 24) and the DDF-fit SDF query (exact: 8 rows a point).  6 launches
    unchunked where the unfused step takes 7."""
    cfg = fused["cfg"]
    sdf_l = cfg.sdf_field.hash.num_levels
    n = N_SCENE + N_GT
    level_set = [(sdf_l, N_SCENE * 8)]
    if fused["variant"] == "bench_knobs":
        level_set = [(sdf_l, SDF_QUERY_CHUNK)] * 10 + [(sdf_l, N_SCENE * 8 - 10 * SDF_QUERY_CHUNK)]
    want = [(3, n * 32), (3, n * 16), (sdf_l, n * 12), (sdf_l, 6**3), *level_set, (sdf_l, N_GT * 8)]
    assert sorted(fused["calls"]) == sorted(want)
    assert len(want) == (6 if fused["variant"] == "fused" else 16)


# ---------------------------------------------------------------------------
# the port's fused pass against its own unfused one


def test_fused_pass_equals_separate_passes_in_eval_mode(batch_pair):
    """Mirror of ``tests/test_train_e2e.py::test_fused_ddf_gt_matches_separate``:
    in eval mode (no jitter, no stochastic estimators) the scene slice of
    the fused pass equals ``forward`` and its ground-truth slice equals
    ``generate_ddf_ground_truth`` (stopped, annealed at the same step): the
    fusion changes the op structure, not the math (1e-5)."""
    _, tb = batch_pair
    cfg = to_torch_config(fused_config("fused"))
    model = t_neusky.NeuSkyModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rb = batch_ray_bundle(tb)
    image_indices = tb["image_indices"] % cfg.num_eval_data  # eval mode decodes the eval latents
    vis = t_vmf(to_torch_config(PIPE.visibility_train_sampler),
                jax_vmf_draws(jax.random.PRNGKey(5), PIPE.visibility_train_sampler), ddf_sphere_radius=1.0)
    with torch.no_grad():
        out_f, gt_f = model.forward_with_ddf_gt(params, rb, image_indices, tb["ray_image_idx"], vis,
                                                step=STEP, train=False, gt_mask_threshold=0.5)
        out_s = model.forward(params, rb, image_indices, tb["ray_image_idx"], step=STEP, train=False)
        gt_s = model.generate_ddf_ground_truth(params, vis, mask_threshold=0.5, stop_gradients=True, step=STEP)
    for k in ("rgb", "albedo", "accumulation", "depth", "normal", "visibility", "bg_transmittance"):
        torch.testing.assert_close(out_f[k], out_s[k], rtol=1e-5, atol=1e-5, msg=k)
    assert sorted(gt_f) == sorted(gt_s)
    for k in gt_s:
        torch.testing.assert_close(gt_f[k], gt_s[k], rtol=1e-5, atol=1e-5, msg=k)
