"""Guards of the PyTorch port: it imports nothing of the JAX side (and
neither Pillow nor plyfile when a module is imported), its
entry points refuse to silently run on the CPU, its config dataclasses
mirror the JAX ones field for field, its converted RENI++ prior equals
the orbax checkpoint the JAX package restores, and its steps build no
tensor from host data per call (so a CUDA graph can capture them)."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import neusky_torch
from torch_parity import TORCH_CONFIGS, one_torch_thread  # noqa: F401 (one_torch_thread: a fixture)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "neusky_tpu")
PRIOR = "reni_prior_variational"


def _port_files():
    # the card-only tests run where no JAX is installed
    files = sorted((REPO / "neusky_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda_kernels.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names = [getattr(node.args[0], "value", "")] if node.args else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def _entry_points():
    from neusky_torch import cli
    from neusky_torch.configs.neusky_config import neusky_model_config
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine.reni_trainer import RENITrainer, RENITrainerConfig
    from neusky_torch.engine.trainer import Trainer, TrainerConfig
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.models.pipeline import PipelineConfig
    from neusky_torch.parallel.dryrun import dryrun_multichip
    from neusky_torch import bench, viewer
    from neusky_torch.entry import entry
    from neusky_torch.tools import (
        ab_ddf_encoding, diagnose_ckpt, eval_from_ckpt, fit_prior_init_latent, prior_fit_sanity, probe_sky_fit,
        render_animation, render_from_ckpt, train_reni_prior, train_sanity,
    )

    cfg = neusky_model_config(2, 1)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=8, height=8))
    return {
        "model": lambda: NeuSkyModel(cfg),
        "datamanager": lambda: DataManager(
            DataManagerConfig(), scene["cameras"], scene["images"], scene["masks"]
        ),
        "trainer": lambda: Trainer(
            TrainerConfig(), NeuSkyModel(cfg, device="cpu"), PipelineConfig(),
            DataManager(DataManagerConfig(), scene["cameras"], scene["images"],
                        scene["masks"], device="cpu"),
        ),
        "cli": lambda: cli.main(["train", "neusky-tiny", "--synthetic-demo"]),
        "reni_trainer": lambda: RENITrainer(RENITrainerConfig(), np.ones((1, 4, 8, 3), np.float32)),
        "reni_prior_script": lambda: train_reni_prior.main(["--quick", "--steps", "1"]),
        "train_sanity": lambda: train_sanity.main(["1", "1", "--tiny"]),
        "eval_from_ckpt": lambda: eval_from_ckpt.main(["--ckpt-dir", "no-such-dir", "--tiny"]),
        "render_from_ckpt": lambda: render_from_ckpt.main(["no-such-dir", "--tiny"]),
        "render_animation": lambda: render_animation.main(["envmaps"]),
        "viewer": lambda: viewer.main([]),
        "fit_prior_init_latent": lambda: fit_prior_init_latent.main(["--quick"]),
        "split_step_trainer": lambda: Trainer(
            TrainerConfig(use_split_step=True), NeuSkyModel(cfg, device="cpu"), PipelineConfig(),
            DataManager(DataManagerConfig(), scene["cameras"], scene["images"], scene["masks"], device="cpu"),
        ),
        "probe_sky_fit": lambda: probe_sky_fit.main(["--steps", "1"]),
        "diagnose_ckpt": lambda: diagnose_ckpt.main(["no-such-dir"]),
        "prior_fit_sanity": lambda: prior_fit_sanity.main(["1", "1"]),
        "ab_ddf_encoding": lambda: ab_ddf_encoding.main(["--ckpt", "no-such-dir"]),
        "mesh_trainer": lambda: Trainer(
            TrainerConfig(), NeuSkyModel(cfg, device="cpu"), PipelineConfig(),
            DataManager(DataManagerConfig(), scene["cameras"], scene["images"], scene["masks"], device="cpu"),
            mesh=object(),
        ),
        "dryrun_multichip": lambda: dryrun_multichip(2),
        "bench": lambda: bench.main([]),
        "bench_build": lambda: bench.build(),
        "entry": lambda: entry(),
    }


@pytest.mark.parametrize("name", ["model", "datamanager", "trainer", "cli", "reni_trainer", "reni_prior_script",
                                  "train_sanity", "eval_from_ckpt", "render_from_ckpt", "render_animation", "viewer",
                                  "fit_prior_init_latent", "split_step_trainer", "probe_sky_fit", "diagnose_ckpt",
                                  "prior_fit_sanity", "ab_ddf_encoding", "mesh_trainer", "dryrun_multichip",
                                  "bench", "bench_build", "entry"])
def test_entry_point_without_cpu_raises_when_cuda_absent(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


@pytest.mark.parametrize("call", ["make_mesh", "dryrun_multichip"])
def test_nccl_with_more_ranks_than_cards_raises(call, monkeypatch, tmp_path):
    """NCCL runs a card a rank: two ranks on one card raise before any
    process group starts (ranks that share a card take gloo)."""
    from neusky_torch.parallel.dryrun import dryrun_multichip
    from neusky_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = {
        "make_mesh": lambda: make_mesh(2, backend="nccl", rank=0, init_method=f"file://{tmp_path}/store",
                                       device="cuda:0"),
        "dryrun_multichip": lambda: dryrun_multichip(2, device="cuda", backend="nccl"),
    }
    with pytest.raises(ValueError, match="nccl runs one rank a card: 2 ranks, 1 cards"):
        calls[call]()
    assert not torch.distributed.is_initialized() and not (tmp_path / "store").exists()


@pytest.mark.parametrize("command", ["main", "split_ab", "graph_path", "graph_spread", "bench_ab"])
def test_chip_smoke_commands_refuse_without_a_card(command, monkeypatch, capsys):
    """``chip_smoke.py`` and its ``split_ab``, ``graph_path``,
    ``graph_spread`` and ``bench_ab`` commands exit non-zero and print no
    result where ``torch.cuda.is_available()`` is false."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert getattr(chip_smoke, command)() != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err


def _module_level_imports(tree):
    """Names imported when the module is imported: its top-level
    statements and class bodies, not function bodies."""
    names, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
        todo.extend(ast.iter_child_nodes(node))
    return names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_optional_package_at_module_level(path):
    """The card's machine has neither Pillow nor plyfile: the port imports
    them only inside the functions that fall back to them; ``triton``
    only where a kernel is built, never at import (this box has none)."""
    names = _module_level_imports(ast.parse(path.read_text(), filename=str(path)))
    assert not [n for n in names if n.split(".")[0] in ("PIL", "plyfile", "triton")], path


def test_guards_cover_the_trainers_and_the_protocol():
    guarded = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {f"neusky_torch/{m}.py" for m in (
        "data/sky_generator", "data/nerfosr_eval", "engine/reni_trainer", "engine/reni_convert",
        "engine/ddf_trainer", "tools/train_reni_prior")} <= guarded


def test_guards_cover_the_tools_around_a_trained_scene():
    guarded = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {f"neusky_torch/{m}.py" for m in (
        "viewer", "engine/render_features", "utils/profiling", "tools/train_sanity", "tools/eval_from_ckpt",
        "tools/render_from_ckpt", "tools/render_animation", "tools/fit_prior_init_latent")} <= guarded


def test_guards_cover_the_variants_and_the_diagnostic_tools():
    guarded = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {f"neusky_torch/{m}.py" for m in (
        "fields/illumination_alternatives", "ops/icosphere_encoding", "nets/transformer", "tools/analyze_run",
        "tools/prepare_nerfosr", "tools/probe_sky_fit", "tools/diagnose_ckpt", "tools/prior_fit_sanity",
        "tools/ab_ddf_encoding")} <= guarded


def test_guards_cover_the_bench_and_entry():
    guarded = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"neusky_torch/bench.py", "neusky_torch/entry.py"} <= guarded


def test_module_level_import_scan_sees_top_level_and_skips_functions():
    src = "import PIL\nclass A:\n    from plyfile import PlyData\ndef f():\n    import torch\n"
    assert sorted(_module_level_imports(ast.parse(src))) == ["PIL", "plyfile"]


def _jax_config_classes():
    from neusky_tpu.data.dataparsers.custom_synthetic import CustomSyntheticDataparserConfig
    from neusky_tpu.data.dataparsers.nerfosr import NeRFOSRDataparserConfig
    from neusky_tpu.engine.optimizers import OptimizerGroupConfig
    from neusky_tpu.engine.trainer import TrainerConfig
    from neusky_tpu.fields.ddf import DDFFieldConfig
    from neusky_tpu.fields.density_field import DensityFieldConfig
    from neusky_tpu.fields.reni import RENIFieldConfig
    from neusky_tpu.fields.sdf_albedo import SDFAlbedoFieldConfig
    from neusky_tpu.models.ddf_model import DDFLossConfig, DDFModelConfig
    from neusky_tpu.models.neusky import LossInclusions, NeuSkyModelConfig
    from neusky_tpu.models.pipeline import PipelineConfig
    from neusky_tpu.ops.hashgrid import HashGridConfig
    from neusky_tpu.sampling.ddf_sampler import DDFSamplerConfig
    from neusky_tpu.sampling.proposal import ProposalSamplerConfig

    return {c.__name__: c for c in (
        HashGridConfig, DensityFieldConfig, SDFAlbedoFieldConfig, RENIFieldConfig,
        ProposalSamplerConfig, LossInclusions, NeuSkyModelConfig, PipelineConfig,
        OptimizerGroupConfig, DDFFieldConfig, DDFLossConfig, DDFModelConfig, DDFSamplerConfig,
        TrainerConfig, NeRFOSRDataparserConfig, CustomSyntheticDataparserConfig,
    )}


# defaults of the port that are placeholders for a JAX default not ported yet
_PLACEHOLDERS = set()


@pytest.mark.parametrize("name", sorted(TORCH_CONFIGS))
def test_config_fields_mirror_jax(name):
    from torch_parity import LEFT_OUT_FIELDS, to_torch_config

    jcls = _jax_config_classes()[name]
    tcls = TORCH_CONFIGS[name]
    jf = [f.name for f in dataclasses.fields(jcls) if (name, f.name) not in LEFT_OUT_FIELDS]
    assert jf == [f.name for f in dataclasses.fields(tcls)]
    jdef, tdef = jcls(), tcls()
    for f in jf:
        if (name, f) in _PLACEHOLDERS:
            continue
        assert to_torch_config(getattr(jdef, f)) == getattr(tdef, f), f


def test_canonical_config_matches_jax():
    from neusky_torch.configs.neusky_config import neusky_model_config as t_cfg
    from neusky_tpu.configs.neusky_config import neusky_model_config as j_cfg
    from torch_parity import to_torch_config

    from neusky_torch.configs.neusky_config import neusky_pipeline_config as t_pipe
    from neusky_tpu.configs.neusky_config import neusky_pipeline_config as j_pipe

    assert to_torch_config(j_cfg(8, 2)) == t_cfg(8, 2)
    assert t_cfg(8, 2).ddf is not None
    assert to_torch_config(j_pipe()) == t_pipe()


# ---------------------------------------------------------------------------
# the converted prior


def read_orbax_prior(name: str = PRIOR) -> dict:
    """The prior as the JAX package restores it: flat flax paths → arrays,
    plus ``init_latent``."""
    from neusky_tpu.engine.checkpoint import load_param_subtrees
    from torch_parity import flat_jax

    src = REPO / "checkpoints" / name
    tree = load_param_subtrees(src, None, {}, include=("illumination_decoder",))
    flat = flat_jax(tree)
    init = src / "init_latent.npz"
    if init.exists():
        flat["init_latent"] = np.load(init)["latent"]
    return flat


def write_prior_asset(name: str = PRIOR) -> Path:
    """Convert ``checkpoints/<name>`` once into the port-owned
    ``neusky_torch/assets/<name>.npz`` (run:
    ``python -c "import sys; sys.path.insert(0, 'tests'); import
    test_torch_guards as t; t.write_prior_asset()"``)."""
    out = REPO / "neusky_torch" / "assets" / f"{name}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **read_orbax_prior(name))
    return out


IN_REPO_PRIORS = ("reni_prior_variational", "reni_prior_latent100", "reni_prior_var_kl1e2")


@pytest.mark.parametrize("name", IN_REPO_PRIORS)
def test_committed_prior_equals_orbax_restore(name):
    committed = np.load(Path(neusky_torch.__file__).parent / "assets" / f"{name}.npz")
    restored = read_orbax_prior(name)
    assert sorted(committed.files) == sorted(restored)
    for k, v in restored.items():
        assert committed[k].dtype == v.dtype, k
        np.testing.assert_array_equal(committed[k], v, err_msg=k)


def _prior_templates(latent_dim=100):
    """A decoder, 3 train and 2 eval latent slots: (JAX's tree, the port's)."""
    import jax
    import jax.numpy as jnp

    from neusky_tpu.fields.reni import RENIField as JField
    from neusky_torch.configs.neusky_config import neusky_model_config
    from torch_parity import jax_to_torch_params

    cfg = neusky_model_config(3, 2).illumination
    decoder = JField(cfg).init(jax.random.PRNGKey(5), jnp.zeros((2, 3)), jnp.zeros((2, latent_dim, 3)))
    tree = {"illumination_decoder": decoder,
            "illumination_field": {"train_latents": jnp.zeros((3, latent_dim, 3)), "train_scale": jnp.ones(3)},
            "eval_latents": {"eval_latents": jnp.zeros((2, latent_dim, 3)), "eval_scale": jnp.ones(2),
                             "eval_rotation": jnp.ones(2)}}
    return tree, jax_to_torch_params(tree)


@pytest.mark.parametrize("name", IN_REPO_PRIORS)
def test_in_repo_prior_dirs_load_the_decoder_jax_loads(name):
    """``illumination_prior_dir="checkpoints/<name>"`` (relative to the
    repository root): the decoder and the seeded latents JAX loads."""
    from types import SimpleNamespace

    from neusky_tpu.engine.checkpoint import load_illumination_prior as j_load
    from neusky_torch.engine.checkpoint import load_illumination_prior as t_load, prior_init_latent
    from torch_parity import flat_jax
    from neusky_torch.tree import tree_items

    cfg = SimpleNamespace(illumination_prior_dir=f"checkpoints/{name}")
    tree_j, tree_t = _prior_templates()
    want = flat_jax(j_load(tree_j, cfg))
    got = dict(tree_items(t_load(tree_t, cfg)))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    seeded = (REPO / "checkpoints" / name / "init_latent.npz").exists()
    assert seeded == (prior_init_latent(cfg) is not None)
    assert seeded == bool(np.abs(want["eval_latents/eval_latents"]).max() > 0)


def test_prior_dir_with_a_port_prior_file_loads_it(tmp_path):
    """A port-format prior written into a directory (``save_prior``) wins
    over the bundled asset of the same name; a missing prior raises."""
    from types import SimpleNamespace

    import torch

    from neusky_torch.engine.checkpoint import PRIOR_FILE, load_illumination_prior, prior_asset_path, save_prior
    from neusky_torch.tree import tree_items, tree_map

    _, tree = _prior_templates()
    decoder = tree_map(lambda t: t + 0.5, tree["illumination_decoder"])
    z0 = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    prior_dir = tmp_path / PRIOR
    save_prior(prior_dir, decoder, init_latent=z0)
    cfg = SimpleNamespace(illumination_prior_dir=str(prior_dir))
    assert prior_asset_path(cfg) == prior_dir / PRIOR_FILE
    loaded = load_illumination_prior(tree, cfg)
    want = dict(tree_items({"illumination_decoder": decoder}))
    for k, v in tree_items({"illumination_decoder": loaded["illumination_decoder"]}):
        assert torch.equal(v, want[k]), k
    for group, key in (("illumination_field", "train_latents"), ("eval_latents", "eval_latents")):
        assert all(np.array_equal(row, z0) for row in loaded[group][key].numpy())
    assert prior_asset_path(SimpleNamespace(illumination_prior_dir=str(tmp_path / "empty"))).parent == \
        Path(neusky_torch.__file__).parent / "assets"
    with pytest.raises(FileNotFoundError, match="no reni_prior.npz there"):
        load_illumination_prior(tree, SimpleNamespace(illumination_prior_dir=str(tmp_path / "empty")))
    assert load_illumination_prior(tree, SimpleNamespace(illumination_prior_dir=None)) is tree


# ---------------------------------------------------------------------------
# the knobs, the native sampler, and what their paths port


def test_guards_cover_the_knobs_and_the_native_sampler():
    guarded = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"neusky_torch/configs/env_overrides.py", "neusky_torch/data/native_sampler.py",
            "neusky_torch/nets/bf16.py"} <= guarded


def test_native_sampler_builds_only_under_the_port_build_directory():
    """The library goes to ``neusky_torch/_build/`` (listed in
    ``.gitignore``), never into the JAX package's ``native/``; its source
    is the port's own copy of ``native/batch_sampler.cpp``: the generator,
    the pixel tables and the batch draw unchanged (its prefetch thread also
    draws each batch's sky rays)."""
    from neusky_torch.data import native_sampler

    build = REPO / "neusky_torch" / "_build"
    assert native_sampler.BUILD_DIR == build and native_sampler.library_path().parent == build
    assert "neusky_torch/_build/" in (REPO / ".gitignore").read_text().split()
    assert native_sampler.SOURCE == REPO / "neusky_torch" / "csrc" / "batch_sampler.cpp"
    port, jax_src = native_sampler.SOURCE.read_text(), (REPO / "native" / "batch_sampler.cpp").read_text()
    for start, stop in (("struct Rng {", "struct Batch {"), ("  void build_tables() {", "  void prefetch_loop() {")):
        kept = jax_src[jax_src.index(start):jax_src.index(stop)]
        assert kept in port, start
    assert "native" not in [p.name for p in native_sampler.library_path().parents][:3]


# what the knobs' paths port, in the words each module used for it while it raised
PORTED_FOR_THE_KNOBS = {
    "neusky_torch/fields/ddf.py": ("use_bf16_mapping", "film_per_layer_heads"),
    "neusky_torch/models/neusky.py": ("forward_with_ddf_gt", "sdf_query_chunk", "remat"),
    "neusky_torch/models/pipeline.py": ("fused_ddf_gt_pass",),
    "neusky_torch/data/datamanager.py": ("prefetch", "native"),
    "neusky_torch/fields/sdf_albedo.py": ("bf16",),
}


@pytest.mark.parametrize("path", sorted(PORTED_FOR_THE_KNOBS))
def test_no_docstring_calls_what_the_knobs_reach_unported(path):
    """No docstring or error message of these modules still says that
    what they now do is "not ported yet"."""
    text = (REPO / path).read_text()
    for sentence in text.replace("\n", " ").split("."):
        if "not ported" in sentence:
            for word in PORTED_FOR_THE_KNOBS[path]:
                assert word.lower() not in sentence.lower(), (path, sentence.strip())


# what the model variants' branches port, in the words each module used for
# it while it raised
PORTED_VARIANTS = {
    "neusky_torch/fields/ddf.py": ("Attention", "sh"),
    "neusky_torch/fields/reni.py": ("FiLM", "Concat", "conditioning"),
    "neusky_torch/models/ddf_model.py": ("ddf_predicted_normals",),
    "neusky_torch/engine/trainer.py": ("use_split_step", "split"),
    "neusky_torch/configs/ddf_config.py": ("trainer",),
}


@pytest.mark.parametrize("path", sorted(PORTED_VARIANTS))
def test_variant_branches_run_and_no_docstring_calls_them_unported(path):
    """No docstring or error message of these modules still says that
    a variant is "not ported", and none raises ``NotImplementedError``."""
    text = (REPO / path).read_text()
    assert "NotImplementedError" not in text, path
    for sentence in text.replace("\n", " ").split("."):
        if "not ported" in sentence:
            for word in PORTED_VARIANTS[path]:
                assert word.lower() not in sentence.lower(), (path, sentence.strip())


# -- the steps build no tensor from host data -------------------------------

STEP_VARIANTS = ("fused", "fused_gt_pass", "split", "eval")


class _HostTensors(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts ``aten.lift_fresh``: what ``torch.tensor``, ``as_tensor``,
    ``from_numpy`` and ``new_tensor`` dispatch when they build a tensor from
    host data, a copy from pageable memory on the card, which a CUDA graph
    cannot capture.  (``aten.scalar_tensor`` from a Python number in
    ``torch.where`` builds a CPU scalar that a kernel takes as an argument:
    no copy, so it is not counted.)"""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _tiny_step_inputs(variant):
    """(model, pipeline, params, batch) of the tiny configuration with the
    AABB collider and the exponentially decayed visibility threshold."""
    from neusky_torch.configs.tiny_config import tiny_model_config
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.models.pipeline import PipelineConfig
    from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

    cfg = tiny_model_config(2, 2)
    cfg = dataclasses.replace(cfg, collider_shape="aabb", fused_ddf_gt_pass=variant == "fused_gt_pass",
                              losses=dataclasses.replace(cfg.losses, vis_sigmoid_method="exponential_decay"))
    pipe = PipelineConfig(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16),
                          num_sky_rays=8)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    batch = dm.next_train(0)
    model = NeuSkyModel(cfg, device="cpu")
    return model, pipe, model.init(torch.Generator().manual_seed(0)), batch


@pytest.mark.parametrize("variant", STEP_VARIANTS)
def test_steps_build_no_tensor_from_host_data(variant, one_torch_thread):  # noqa: F811
    """One step of each kind on the tiny configuration (with the AABB
    collider and the exponentially decayed visibility threshold, whose
    constants the model builds once per device) after a first step that
    fills the per-device caches: no tensor is built from host data in the
    model, the losses, the encodes, the sampler or the optimizer."""
    from neusky_torch.engine import optimizers as opt
    from neusky_torch.parallel import mesh

    model, pipe, params, batch = _tiny_step_inputs(variant)
    gen = torch.Generator().manual_seed(1)
    if variant == "eval":
        step_fn = mesh.make_eval_latent_step(model, opt.build_eval_latent_optimizer(params, max_steps=10))
        run = lambda i: step_fn(params, batch, float(i))  # noqa: E731
    else:
        make = mesh.make_train_step_split if variant == "split" else mesh.make_train_step
        step_fn = make(model, pipe, opt.GroupedAdam(params, opt.default_neusky_optimizer_groups(100)))
        run = lambda i: step_fn(params, batch, float(i), generator=gen)  # noqa: E731
    run(0)
    mode = _HostTensors()
    with mode:
        run(1)
    assert mode.count == 0, f"{mode.count} tensors built from host data in one {variant} step"


@pytest.mark.parametrize("variant", STEP_VARIANTS)
def test_step_losses_and_backward_read_nothing_on_the_host(variant, one_torch_thread):  # noqa: F811
    """The losses and the backward of each kind of step (the optimizer
    aside: on the card it is Adam's capturable update) read no value on the
    host: the CPU profiler, which records the ops ATen calls from C++ too,
    sees no ``aten::_local_scalar_dense`` (``.item()``, ``bool``,
    ``float`` of a tensor).  Such a read cannot be captured in a CUDA graph;
    torch's own ``cumprod`` backward makes one (it asks whether the input
    holds a zero), so the compositing uses ``core/rays.py``'s cumprod."""
    from torch.profiler import ProfilerActivity, profile

    from neusky_torch.models import pipeline
    from neusky_torch.tree import tree_items

    model, pipe, params, batch = _tiny_step_inputs(variant)
    for k, v in tree_items(params):
        v.requires_grad_(not k.startswith(("eval_latents", "illumination_decoder")) or variant == "eval")
    gen, step = torch.Generator().manual_seed(1), torch.tensor(3.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if variant == "eval":
            pipeline.eval_latent_loss_fn(model, params, batch, step).backward()
        elif variant == "split":
            pipeline.scene_loss_fn(model, params, batch, step, None, gen)[0].backward()
            pipeline.ddf_fit_loss_fn(model, pipe, params, batch, None, gen)[0].backward()
        else:
            pipeline.train_loss_fn(model, pipe, params, batch, step, None, gen)[0].backward()
    reads = [e.name for e in prof.events() if e.name == "aten::_local_scalar_dense"]
    assert not reads, f"{len(reads)} host reads in the {variant} step's losses and backward"


def test_compositing_cumprod_is_torchs():
    """``core/rays.py``'s cumprod (no host read in its backward) equals
    ``torch.cumprod`` along the samples, values and gradients bit for bit,
    on factors without zeros as the compositing's are."""
    from neusky_torch.core.rays import _CumprodNonzero

    g = torch.Generator().manual_seed(0)
    for shape in ((7, 13, 1), (3, 2, 1), (4, 1, 1)):
        x = (torch.rand(shape, generator=g) * 0.9 + 1e-7).requires_grad_(True)
        ct = torch.randn(shape, generator=g)
        want = torch.cumprod(x, dim=-2)
        (want_grad,) = torch.autograd.grad(want, x, ct)
        got = _CumprodNonzero.apply(x)
        (got_grad,) = torch.autograd.grad(got, x, ct)
        assert torch.equal(got, want) and torch.equal(got_grad, want_grad), shape
