"""The paths the port captures as CUDA graphs besides the training step
(the DDF and RENI trainers' steps, the envmap and rotation fits, the render
chunk with and without a rotation, LPIPS), on the CPU, where they run
eagerly:

- each path's step function builds no tensor from host data (after a
  first call that fills the per-device caches) and its loss, backward or
  forward reads nothing on the host, as ``test_torch_guards.py`` checks
  the training step: a CUDA graph could not capture either;
- ``graphed=True`` raises on the CPU for each factory;
- ``render_camera`` pads the last chunk as JAX does: 1,061 rays in chunks
  of 256 against JAX's ``render_camera`` within 1e-5 of each map's scale;
- the DDF trainer driven through ``draw_step`` and its step equals, bit for
  bit, the step-by-step loop on injected draws that
  ``test_torch_ddf_trainer.py`` holds against JAX;
- a forward capture (the render chunk's kind) takes its params as current
  only when they are its last call's tensors and nothing wrote them since.

The sizes are the tiny recipe's (``configs/tiny_config.py``), a RENI
decoder of two attention layers and 16 × 32 skies.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.engine import eval_loop as j_eval
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JScene, generate_synthetic_scene as j_scene

from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine import ddf_trainer, eval_loop, lpips, reni_trainer
from neusky_torch.parallel import graphs
from neusky_torch.fields.reni import RENIField, RENIFieldConfig
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig
from neusky_torch.sampling.illumination import EquirectangularSampler
from neusky_torch.tree import tree_items
from test_torch_ddf_trainer import SAMPLER, _jax_step_draws
from test_torch_joint_slice import tiny_joint_config
from torch_parity import jax_to_torch_params, max_rel_err, one_torch_thread, to_torch_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PATHS = ("ddf_step", "render_chunk", "rotating_chunk", "rotation_fit", "envmap_fit", "reni_step", "lpips")
RENI_FIELD = RENIFieldConfig(latent_dim=8, hidden_features=16, hidden_layers=2, mapping_layers=2,
                             mapping_features=16, num_attention_heads=2, num_attention_layers=2, fixed_decoder=False)
SKY_WIDTH = 32


class _HostTensors(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts ``aten.lift_fresh``: a tensor built from host data (see
    ``test_torch_guards.py``)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _scene_model():
    cfg = tiny_model_config(2, 2)
    model = NeuSkyModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=16, height=16))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    return model, params, dm


def _skies(n: int) -> np.ndarray:
    g = np.random.default_rng(0)
    return np.exp(g.normal(size=(n, SKY_WIDTH // 2, SKY_WIDTH, 3))).astype(np.float32)


def _path(name: str, graphed=None):
    """(step, loss): ``step()`` one call of the path's step function (the
    update included), ``loss()`` its loss and backward (or its forward)
    alone, on fresh CPU objects; ``graphed`` goes to the path's factory."""
    if name == "ddf_step":
        model, params, dm = _scene_model()
        cfg = ddf_trainer.DDFTrainerConfig(sampler=DDFSamplerConfig(**SAMPLER), num_sky_rays=8)
        t = ddf_trainer.DDFTrainer(cfg, model, params, datamanager=dm, graphed=graphed)
        d = t.draw_step()
        return (lambda: t.train_step(t.ddf_params, None, d),
                lambda: t.loss(d, t.sky_rays(d))[0].backward())
    if name in ("render_chunk", "rotating_chunk"):
        model, params, dm = _scene_model()
        chunk_fn, _ = eval_loop.make_render_chunk_fn(model, 64, graphed)
        rb = dm.train_cameras.generate_rays(0).slice(0, 64)
        idx = torch.tensor([1])
        rot = torch.linalg.matrix_exp(torch.tensor([[0.0, -0.3, 0.0], [0.3, 0.0, 0.0], [0.0, 0.0, 0.0]]))
        rot = rot if name == "rotating_chunk" else None
        run = lambda: chunk_fn(params, rb, idx, rot)  # noqa: E731
        return run, run
    if name == "rotation_fit":
        model, params, dm = _scene_model()
        gt = torch.randn((2, model.config.illumination.latent_dim, 3), generator=torch.Generator().manual_seed(1))
        step_fn, q = eval_loop.make_rotation_fit_step(model, params, gt, steps=10, graphed=graphed)
        batch = dm.next_train(0)
        fixed = eval_loop._rotation_fit_params(params, gt)
        return (lambda: step_fn(q, 1.0, batch),
                lambda: eval_loop.rotation_fit_loss(model, fixed, q, batch, torch.tensor(1.0)).backward())
    if name == "envmap_fit":
        field = RENIField(RENI_FIELD)
        decoder = field.init(torch.Generator().manual_seed(0), "cpu")
        dirs = EquirectangularSampler(width=SKY_WIDTH)("cpu")
        z = torch.zeros((2, RENI_FIELD.latent_dim, 3), requires_grad=True)
        targets = field.normalise(torch.from_numpy(_skies(2).reshape(2, -1, 3)))
        step_fn, _ = reni_trainer.make_envmap_fit_step(field, decoder, dirs, z, targets, 0.1, graphed)
        pix = torch.randint(0, dirs.shape[0], (64,), generator=torch.Generator().manual_seed(2))
        return (lambda: step_fn({"z": z}, None, pix),
                lambda: reni_trainer.envmap_fit_loss(field, decoder, dirs, z, targets, pix).backward())
    if name == "reni_step":
        t = reni_trainer.RENITrainer(reni_trainer.RENITrainerConfig(field=RENI_FIELD, pixels_per_step=64,
                                                                    steps_per_call=2),
                                     _skies(4), device="cpu", graphed=graphed)
        d = t.draw()
        return lambda: t.train_step(d), lambda: t.loss(d)[0].backward()
    if name == "lpips":
        fn = lpips.distance_fn(torch.device("cpu"), (1, 3, 16, 16), graphed)
        g = torch.Generator().manual_seed(3)
        a, b = torch.rand((1, 3, 16, 16), generator=g), torch.rand((1, 3, 16, 16), generator=g)
        return (lambda: fn(a, b)), (lambda: fn(a, b))
    raise ValueError(name)


@pytest.mark.parametrize("name", PATHS)
def test_step_builds_no_tensor_from_host_data(name):
    """A second call of each path's step function builds no tensor from
    host data (the first fills the per-device caches and Adam's state)."""
    step, _ = _path(name)
    step()
    mode = _HostTensors()
    with mode:
        step()
    assert mode.count == 0, f"{mode.count} tensors built from host data in one {name} call"


@pytest.mark.parametrize("name", PATHS)
def test_step_reads_nothing_on_the_host(name):
    """Each path's loss and backward, or its forward, reads no value on the
    host (no ``aten::_local_scalar_dense`` in the CPU profiler's events;
    the optimizer aside, which is Adam's capturable update on the card)."""
    _, loss = _path(name)
    loss()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss()
    reads = [e.name for e in prof.events() if e.name == "aten::_local_scalar_dense"]
    assert not reads, f"{len(reads)} host reads in one {name} call"


@pytest.mark.parametrize("name", [p for p in PATHS if p != "rotating_chunk"])
def test_graphed_true_raises_on_the_cpu(name):
    """Each factory refuses ``graphed=True`` on the CPU: nothing is
    captured there, and nothing falls back to the eager path unasked."""
    with pytest.raises(ValueError, match="CUDA"):
        _path(name, graphed=True)


def test_padded_render_matches_jax():
    """1,061 rays (a 33 × 33 eval image's first rays) in chunks of 256:
    the port pads the last chunk of 37 with copies of the last ray, as JAX
    does, and cuts the outputs back; every map within 1e-5 of its scale of
    JAX's ``render_camera`` on the same params."""
    cfg_j = dataclasses.replace(tiny_joint_config(False), num_train_data=2, num_eval_data=2)
    jm, tm = JModel(cfg_j), NeuSkyModel(to_torch_config(cfg_j), device="cpu")
    params_j = dict(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    g = np.random.default_rng(0)
    latents = params_j["eval_latents"]["eval_latents"]
    params_j["eval_latents"] = {**params_j["eval_latents"],
                                "eval_latents": (0.3 * g.normal(size=latents.shape)).astype(np.float32)}
    params_t = jax_to_torch_params(params_j)
    scene = dict(num_cameras=2, width=33, height=33)
    rb_j = j_scene(JScene(**scene))["cameras"].generate_rays(1).slice(0, 1061)
    rb_t = generate_synthetic_scene(SyntheticSceneConfig(**scene))["cameras"].generate_rays(1).slice(0, 1061)
    out_j = j_eval.render_camera(jm, params_j, rb_j, 1, jax.random.PRNGKey(2), chunk_size=256)
    out_t = eval_loop.render_camera(tm, params_t, rb_t, 1, chunk_size=256)
    assert sorted(out_t) == sorted(out_j) == sorted(eval_loop.RENDER_KEYS)
    for k in out_j:
        assert out_t[k].shape == out_j[k].shape == (1061, out_j[k].shape[1]), k
        assert max_rel_err(out_t[k], out_j[k]) < 1e-5, (k, max_rel_err(out_t[k], out_j[k]))


def test_ddf_draw_step_equals_the_injected_draws_loop():
    """Five DDF steps driven by ``run`` (``draw_step`` then the step) on
    JAX's draws equal, bit for bit, the step-by-step loop on the same
    injected draws with the sky rays drawn from the sampler and generated
    beside the loss (the loop ``test_torch_ddf_trainer.py`` holds against
    JAX): every record and the trained DDF."""
    steps = 5
    draws = _jax_step_draws(jax.random.PRNGKey(0), DDFSamplerConfig(**SAMPLER), steps)
    runs = []
    for loop in ("run", "reference"):
        model, params, dm = _scene_model()
        cfg = ddf_trainer.DDFTrainerConfig(sampler=DDFSamplerConfig(**SAMPLER), num_sky_rays=8, steps_per_log=1,
                                           max_num_iterations=steps)
        t = ddf_trainer.DDFTrainer(cfg, model, params, datamanager=dm)
        if loop == "run":
            history = t.run(draws=draws)
        else:
            history = []
            for i, d in enumerate(draws):
                rows, coords = dm.train_sampler.sample_sky_rays(cfg.num_sky_rays)
                sky = dm.train_cameras.generate_rays_at(torch.from_numpy(rows), torch.from_numpy(coords))
                t.optimizer.zero_grad()
                total, aux = t.loss(d, sky)
                total.backward()
                t.optimizer.step()
                history.append({"step": i + 1, "total_loss": float(total), "depth_psnr": float(aux["depth_psnr"]),
                                **{k: float(v) for k, v in aux["losses"].items()}})
        runs.append((history, dict(tree_items(t.ddf_params))))
    (h_run, p_run), (h_ref, p_ref) = runs
    assert h_run == h_ref
    assert all(torch.equal(p_run[k], p_ref[k]) for k in p_ref)


@pytest.mark.parametrize("change", ["none", "eager write", "step replay", "other tensor", "inference tensor"])
def test_forward_takes_its_params_as_current_only_when_unwritten(change):
    """``CapturedStep._params_seen``, which lets a forward capture skip
    copying its params: the last call's tensors with no write since are
    current; an in-place write (its version counter), a call of a step that
    updates its params in place (``graphs.writes``: a replay moves no
    version counter), other tensors, or inference tensors (no version
    counter) are not."""
    forward = graphs.CapturedStep(lambda p, _, x: p["w"] * x)
    leaves = [torch.ones(3), torch.zeros(2)]
    if change == "inference tensor":
        with torch.inference_mode():
            leaves = [torch.ones(3), torch.zeros(2)]
    assert not forward._params_seen(leaves)
    if change == "eager write":
        leaves[1].add_(1.0)
    elif change == "step replay":
        graphs.writes += 1
    elif change == "other tensor":
        leaves = [leaves[0], leaves[1].clone()]
    assert forward._params_seen(leaves) == (change == "none")
