"""Guards of the PyTorch port: it imports nothing of the JAX side (and
neither Pillow nor plyfile when a module is imported), its
entry points refuse to silently run on the CPU, its config dataclasses
mirror the JAX ones field for field, and its converted RENI++ prior equals
the orbax checkpoint the JAX package restores."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import neusky_torch
from torch_parity import TORCH_CONFIGS

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
    from neusky_torch.engine.trainer import Trainer, TrainerConfig
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.models.pipeline import PipelineConfig

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
    }


@pytest.mark.parametrize("name", ["model", "datamanager", "trainer", "cli"])
def test_entry_point_without_cpu_raises_when_cuda_absent(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


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
    them only inside the functions that fall back to them."""
    names = _module_level_imports(ast.parse(path.read_text(), filename=str(path)))
    assert not [n for n in names if n.split(".")[0] in ("PIL", "plyfile")], path


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


def test_committed_prior_equals_orbax_restore():
    committed = np.load(Path(neusky_torch.__file__).parent / "assets" / f"{PRIOR}.npz")
    restored = read_orbax_prior()
    assert sorted(committed.files) == sorted(restored)
    for k, v in restored.items():
        assert committed[k].dtype == v.dtype, k
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
