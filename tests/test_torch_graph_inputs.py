"""The captured step's device inputs on the CPU: the step count as a 0-d
tensor (the proposal anneal, the visibility threshold and the learning-rate
schedules computed from it on its device) against JAX, which traces the
step, and :func:`~neusky_torch.models.pipeline.draw_step`, which makes a
step's draws ahead of it so that the captured step draws nothing.

Tolerances: the anneal and the threshold to 1e-7 relative (JAX's float32
expression on a float32 step, ``neusky_tpu/sampling/proposal.py:199-200``
and ``neusky_tpu/models/neusky.py:616-618``); the schedules to 1e-6 of the
learning rate against JAX's float32 schedules and the port's float64
ones (a few float32 roundings of ``cos``, ``sin``, ``exp`` and ``log``);
a step given ``draw_step``'s draws against the step that draws for itself:
bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.engine import optimizers as j_opt
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.sampling.proposal import ProposalSamplerConfig as JProposal, anneal_bias as j_anneal_bias

from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine import optimizers as t_opt
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig, draw_step
from neusky_torch.parallel.mesh import make_eval_latent_step, make_train_step, make_train_step_split
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig
from neusky_torch.sampling.proposal import ProposalSamplerConfig, proposal_anneal
from neusky_torch.tree import tree_items, tree_map
from test_train_e2e import tiny_model_config as j_tiny_model_config
from torch_parity import one_torch_thread, to_torch_config  # noqa: F401 (one_torch_thread: the fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VIS_STEPS = 50000  # LossInclusions.vis_steps_until_min_bias
STEPS = (0, 1, 999, 1000, 1001, VIS_STEPS - 1, VIS_STEPS, VIS_STEPS + 1, 20000)
SCHEDULE_STEPS = STEPS + (499, 500, 501, 3999, 4000, 4001, 100000, 100001, 100002)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("step", STEPS)
def test_tensor_step_anneal_matches_jax(step):
    """The proposal weights' exponent from a 0-d float32 step tensor against
    JAX's ``anneal_bias(jnp.clip(step / N, 0, 1), slope)`` on a float32
    step; a float step keeps the host computation, within float32 of it."""
    cfg = ProposalSamplerConfig()
    want = j_anneal_bias(jnp.clip(jnp.float32(step) / JProposal().anneal_max_num_iters, 0.0, 1.0),
                         JProposal().anneal_slope)
    got = proposal_anneal(torch.tensor(step, dtype=torch.float32), cfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _rel(got, want) <= 1e-7, (step, float(got), float(want))
    assert _rel(proposal_anneal(float(step), cfg), want) <= 1e-6
    assert proposal_anneal(None, cfg) == 1.0


@pytest.mark.parametrize("step", STEPS)
def test_tensor_step_visibility_threshold_matches_jax(step):
    """The exponentially decayed occlusion threshold (and its fixed scale)
    from a 0-d float32 step tensor against JAX's ``_visibility_threshold``
    on a float32 step, before, at and after ``vis_steps_until_min_bias``."""
    cfg_j = j_tiny_model_config(use_visibility=True, fit_visibility=True)
    cfg_j = dataclasses.replace(cfg_j, losses=dataclasses.replace(cfg_j.losses, vis_sigmoid_method="exponential_decay"))
    assert cfg_j.losses.vis_steps_until_min_bias == VIS_STEPS
    model = NeuSkyModel(to_torch_config(cfg_j), device="cpu")
    want_thr, want_scale = JModel(cfg_j)._visibility_threshold({}, jnp.float32(step))
    got_thr, got_scale = model._visibility_threshold({}, torch.tensor(step, dtype=torch.float32))
    assert _rel(got_thr, want_thr) <= 1e-7, (step, float(got_thr), float(want_thr))
    assert float(got_scale) == float(want_scale)
    float_thr, _ = model._visibility_threshold({}, float(step))
    assert _rel(float_thr, want_thr) <= 1e-7


GROUP_CONFIGS = {
    **t_opt.default_neusky_optimizer_groups(100001),
    "eval_fit": t_opt.OptimizerGroupConfig(lr=1e-1, schedule="exponential", lr_final=1e-7, max_steps=250),
    "constant": t_opt.OptimizerGroupConfig(lr=3e-3, schedule="constant"),
}


@pytest.mark.parametrize("group", sorted(GROUP_CONFIGS))
def test_device_schedules_match_python_and_jax(group):
    """``GroupedAdam``'s schedules evaluated at a count tensor (what the
    card's capturable update reads) equal the port's float64 schedules and
    JAX's float32 ones (``neusky_tpu/engine/optimizers.py``) at every
    step of :data:`SCHEDULE_STEPS`."""
    g = GROUP_CONFIGS[group]
    params = {"w": torch.zeros(3)}
    opt = t_opt.GroupedAdam(params, {"only": g}, label_fn=lambda _: "only")
    schedule = opt.schedules[0]
    want_j = j_opt._group_schedule(j_opt.OptimizerGroupConfig(**dataclasses.asdict(g)))
    for step in SCHEDULE_STEPS:
        got = schedule(torch.tensor(step, dtype=torch.int64))
        assert got.dtype == torch.float32 and got.dim() == 0
        for want in (schedule(step), want_j(jnp.int32(step))):
            assert abs(float(got) - float(want)) <= 1e-6 * g.lr, (group, step, float(got), float(want))


# -- draw_step ---------------------------------------------------------------

PIPE = PipelineConfig(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16),
                      num_sky_rays=8)
VARIANTS = {
    "fused": (False, False),  # (split, fused ground-truth pass)
    "fused_gt_pass": (False, True),
    "split": (True, False),
}


@pytest.fixture(scope="module")
def scene():
    s = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     s["cameras"], s["images"], s["masks"], device="cpu")
    return dm.next_train(0)


def _model_and_params(fused_gt: bool):
    cfg = dataclasses.replace(tiny_model_config(2, 2), fused_ddf_gt_pass=fused_gt)
    model = NeuSkyModel(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _step(model, params, split: bool):
    opt = t_opt.GroupedAdam(params, t_opt.default_neusky_optimizer_groups(100))
    return (make_train_step_split if split else make_train_step)(model, PIPE, opt)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_draw_step_leaves_the_step_nothing_to_draw(scene, variant):
    """Two copies of the same params: one step draws for itself from a
    generator, the other is given ``draw_step``'s draws from a generator of
    the same seed.  The second step leaves its generator as ``draw_step``
    left it, both generators end in the same state, and the two steps'
    losses and updated params are bit for bit equal: ``draw_step`` made
    every draw, in the step's order."""
    split, fused_gt = VARIANTS[variant]
    model, params0 = _model_and_params(fused_gt)
    params_a = tree_map(lambda t: t.detach().clone(), params0)
    params_b = tree_map(lambda t: t.detach().clone(), params0)
    gen_a, gen_b = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    aux_a = _step(model, params_a, split)(params_a, scene, 3.0, generator=gen_a)
    draws = draw_step(model, PIPE, scene, gen_b, split=split)
    drawn = gen_b.get_state()
    aux_b = _step(model, params_b, split)(params_b, scene, 3.0, draws, gen_b)
    assert torch.equal(gen_b.get_state(), drawn), "the step drew from the generator"
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert torch.equal(aux_a["total_loss"], aux_b["total_loss"])
    assert aux_a["loss_dict"].keys() == aux_b["loss_dict"].keys()
    for k in aux_a["loss_dict"]:
        assert torch.equal(aux_a["loss_dict"][k], aux_b["loss_dict"][k]), k
    b = dict(tree_items(params_b))
    for k, v in tree_items(params_a):
        assert torch.equal(v, b[k]), k
    if fused_gt and not split:
        assert "gt" not in draws["ddf"], "the fused pass's ground truth takes the scene forward's draws"
    else:
        assert {"vmf", "gt", "multi_view_u"} <= set(draws["ddf"])


def test_train_step_takes_a_tensor_step(scene):
    """The eager step given the step as a 0-d float32 tensor (as the
    captured step gives it) computes what it computes from the float."""
    model, params0 = _model_and_params(False)
    out = {}
    for kind, step in (("float", 700.0), ("tensor", torch.tensor(700.0))):
        params = tree_map(lambda t: t.detach().clone(), params0)
        draws = draw_step(model, PIPE, scene, torch.Generator().manual_seed(5))
        out[kind] = _step(model, params, False)(params, scene, step, draws)["total_loss"]
    np.testing.assert_allclose(float(out["tensor"]), float(out["float"]), rtol=1e-6)


def test_eval_step_draws_nothing(scene):
    """The eval-latent step takes no generator and draws from none: the
    default generator's state is unchanged by it (``draw_step`` has nothing
    to make for it)."""
    model, params = _model_and_params(False)
    params = tree_map(lambda t: t.detach().clone(), params)
    opt = t_opt.build_eval_latent_optimizer(params, max_steps=10)
    step_fn = make_eval_latent_step(model, opt)
    before = torch.get_rng_state()
    loss = step_fn(params, scene, torch.tensor(2.0))
    assert torch.isfinite(loss) and torch.equal(torch.get_rng_state(), before)


def test_graphed_true_raises_on_the_cpu(scene):
    """``graphed=True`` asks for a CUDA graph: on the CPU every step factory
    raises rather than run eagerly; the default runs eagerly here."""
    model, params = _model_and_params(False)
    opt = t_opt.GroupedAdam(params, t_opt.default_neusky_optimizer_groups(100))
    for make in (make_train_step, make_train_step_split):
        with pytest.raises(ValueError, match="CUDA"):
            make(model, PIPE, opt, graphed=True)
        assert not hasattr(make(model, PIPE, opt), "captured")
    with pytest.raises(ValueError, match="CUDA"):
        make_eval_latent_step(model, opt, graphed=True)
