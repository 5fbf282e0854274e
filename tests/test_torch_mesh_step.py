"""The mesh step's capture rule and the mesh trainer's batch stream, on the
CPU (no JAX):

- ``neusky_torch.parallel.mesh._graphed`` as a function of ``graphed``,
  the device and the mesh's backend: over NCCL a rank's step captures on
  the card, over gloo it runs eagerly and ``graphed=True`` raises naming
  gloo, on the CPU ``graphed=True`` raises; the step factories follow it on
  a one-rank gloo mesh;
- ``Trainer(mesh=)`` takes each rank's own sampler's batch, with no
  broadcast: on 2 gloo ranks, with the numpy and the C++ sampler, every
  rank's global batch is rank 0's at every step, and the records and params
  are those of a run that broadcasts rank 0's batch every step.

The captured NCCL rank step itself runs on the card only
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 13).
"""

from pathlib import Path

import pytest
import torch

from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.data import native_sampler
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine.optimizers import GroupedAdam, build_eval_latent_optimizer, default_neusky_optimizer_groups
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.parallel import mesh as t_mesh
from neusky_torch.parallel.launch import run_ranks
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

TESTS = Path(__file__).resolve().parent
CUDA, CPU = torch.device("cuda"), torch.device("cpu")
PIPE = PipelineConfig(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=8),
                      num_sky_rays=8)


# ---------------------------------------------------------------------------
# the capture rule


@pytest.mark.parametrize("graphed, device, backend, want", [
    (None, CUDA, None, True),
    (None, CUDA, "nccl", True),
    (None, CUDA, "gloo", False),
    (None, CPU, None, False),
    (None, CPU, "gloo", False),
    (False, CUDA, "nccl", False),
    (False, CUDA, None, False),
    (True, CUDA, "nccl", True),
    (True, CUDA, None, True),
])
def test_capture_rule(graphed, device, backend, want):
    """None captures on the card alone or over NCCL and runs eagerly over
    gloo or on the CPU; False never captures; True always does."""
    assert t_mesh._graphed(graphed, device, backend) is want


@pytest.mark.parametrize("device", [CUDA, CPU], ids=["cuda", "cpu"])
def test_graphed_true_with_a_gloo_mesh_raises_naming_gloo(device):
    """A gloo mesh step cannot be captured, on the card or off it: asked for
    a graph, the rule raises and says why rather than run eagerly."""
    with pytest.raises(ValueError, match="gloo mesh: gloo's collectives .* cannot be captured"):
        t_mesh._graphed(True, device, "gloo")


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_graphed_true_on_the_cpu_raises(backend):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        t_mesh._graphed(True, CPU, backend)


def factories_rank(rank, world_size, init_method):
    """On a one-rank gloo mesh: what each step factory makes with
    ``graphed`` None, and what it raises with True → {factory: (captured?,
    error or None)}."""
    mesh = t_mesh.make_mesh(world_size, 1, backend="gloo", rank=rank, init_method=init_method)
    model = NeuSkyModel(tiny_model_config(2, 2), device="cpu").set_mesh(mesh)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for name, make in (("train", lambda g: t_mesh.make_train_step(model, PIPE, opt, mesh, graphed=g)),
                       ("split", lambda g: t_mesh.make_train_step_split(model, PIPE, opt, mesh, graphed=g)),
                       ("eval_latent", lambda g: t_mesh.make_eval_latent_step(model, eval_opt, mesh, graphed=g))):
        opt = GroupedAdam(params, default_neusky_optimizer_groups(100))
        eval_opt = build_eval_latent_optimizer(params)
        try:
            make(True)
            error = None
        except ValueError as e:
            error = str(e)
        out[name] = (hasattr(make(None), "captured"), error)
    return out


def test_step_factories_follow_the_rule_on_a_gloo_mesh():
    """Each factory on a gloo mesh: the default step is eager, and
    ``graphed=True`` raises naming gloo."""
    (got,) = run_ranks("test_torch_mesh_step:factories_rank", 1, paths=(TESTS,))
    for name, (captured, error) in got.items():
        assert not captured, name
        assert error is not None and "gloo mesh" in error, (name, error)


# ---------------------------------------------------------------------------
# the trainer's batch stream (no per-step broadcast)


@pytest.mark.parametrize("native", [False, True], ids=["numpy_sampler", "native_sampler"])
def test_mesh_trainer_ranks_draw_rank_0s_batch_without_a_broadcast(native):
    """2 gloo ranks, 4 steps, the tiny joint config: every rank's global
    batch is bitwise rank 0's at every step, and the records (losses and
    metrics) and the params after the steps are bitwise those of a run that
    broadcasts rank 0's batch every step."""
    if native:
        native_sampler.build()  # once, before the ranks load it
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=4, width=16, height=16))
    runs = {}
    for broadcast in (False, True):
        runs[broadcast] = run_ranks(
            "torch_mesh_ranks:batch_stream_rank", 2,
            dict(cfg=tiny_model_config(4, 1), pipe=PIPE, scene=scene, native=native, broadcast=broadcast, steps=4),
            paths=(TESTS,))
    own, broadcast = runs[False], runs[True]
    assert len(own[0]["batches"]) == 4 and len(set(own[0]["batches"])) == 4
    for r in own + broadcast:
        assert r["batches"] == own[0]["batches"]
    for a, b in zip(own, broadcast):
        assert a["history"] == b["history"] and a["digest"] == b["digest"]
    assert own[0]["digest"] == own[1]["digest"]
