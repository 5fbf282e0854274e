"""``--eager`` of ``cli train|eval|render`` and of the tools: it reaches
every step, fit, render and LPIPS factory the command builds as
``graphed=False`` (each runs op by op on the card), and without it they get
``graphed=None`` (captured on the card).  On the CPU both run eagerly, so
the factories' ``use_graph`` is wrapped to record what each was given; the
commands run end to end at the tiny recipe's size.  No JAX."""

import sys

import pytest
import torch

from neusky_torch import cli as t_cli
from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.data.fixtures import make_nerfosr_fixture
from neusky_torch.engine import ddf_trainer, eval_loop, lpips, reni_trainer
from neusky_torch.engine.checkpoint import save_checkpoint
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.parallel import mesh
from neusky_torch.tools import (eval_from_ckpt, prior_fit_sanity, render_animation, render_from_ckpt,
                                train_reni_prior)
from torch_parity import one_torch_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = ["--device", "cpu"]
SYNTHETIC = ["--synthetic-demo", *CPU, "--rays-per-batch", "64"]
FIT_STEPS = 3  # the protocol's fits, cut from 250


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A ``train neusky-tiny --synthetic-demo`` run, a one-step run on a
    NeRF-OSR fixture, and checkpoints of seed-0 tiny params with 6 and 8
    train images (``eval_from_ckpt --tiny``, ``render_from_ckpt --tiny``)."""
    root = tmp_path_factory.mktemp("eager")
    t_cli.main(["train", "neusky-tiny", *SYNTHETIC, "--max-iterations", "1", "--output-dir", str(root / "synthetic")])
    osr = make_nerfosr_fixture(root / "osr", num_sessions=2, train_per_session=2, test_per_session=2, width=24,
                               height=16)
    osr_args = ["--data", str(osr), "--session-holdout-indices", "0,0", *CPU]
    t_cli.main(["train", "neusky-tiny", *osr_args, "--max-iterations", "1", "--rays-per-batch", "32",
                "--output-dir", str(root / "osr_run")])
    for n_train in (6, 8):
        model = NeuSkyModel(tiny_model_config(n_train, 2), device="cpu")
        save_checkpoint(root / f"ckpt{n_train}", 1, model.init(torch.Generator().manual_seed(0)), {})
    return root, osr_args


def _commands(root, osr_args):
    """name → (main, its argv, the factories its path builds)."""
    synthetic, osr_run = str(root / "synthetic"), str(root / "osr_run")
    protocol = ["eval", "neusky-tiny", *osr_args, "--load-dir", osr_run, "--protocol", "nerfosr", "--output",
                str(root / "m.json"), "--model.eval_latent_optimise_method"]
    return {
        "cli train": (t_cli.main, ["train", "neusky-tiny", *SYNTHETIC, "--max-iterations", "1",
                                   "--output-dir", str(root / "train")],
                      {"make_train_step"}),
        "cli train ddf": (t_cli.main, ["train", "ddf", *SYNTHETIC, "--max-iterations", "2", "--load-dir", synthetic,
                                       "--output-dir", str(root / "ddf")],
                          {"DDFTrainer.__init__"}),
        "cli eval": (t_cli.main, ["eval", "neusky-tiny", *osr_args, "--rays-per-batch", "32", "--load-dir", osr_run],
                     {"make_eval_latent_step", "make_render_chunk_fn", "distance_fn"}),
        "cli eval nerfosr": (t_cli.main, [*protocol, "per_image"],
                             {"make_eval_latent_step", "make_render_chunk_fn", "distance_fn"}),
        "cli eval nerfosr envmap": (t_cli.main, [*protocol, "nerf_osr_envmap"],
                                    {"make_envmap_fit_step", "make_rotation_fit_step", "make_render_chunk_fn",
                                     "distance_fn"}),
        "cli render": (t_cli.main, ["render", "neusky-tiny", *osr_args, "--load-dir", osr_run,
                                    "--output", str(root / "render.npy")],
                       {"make_render_chunk_fn"}),
        "eval_from_ckpt": (eval_from_ckpt.main, ["--ckpt-dir", str(root / "ckpt6"), "--tiny", *CPU, "--fit-steps", "3",
                                                 "--width", "16", "--out", str(root / "eval.json")],
                           {"make_eval_latent_step", "make_render_chunk_fn", "distance_fn"}),
        "render_from_ckpt": (render_from_ckpt.main, [str(root / "ckpt8"), "--tiny", *CPU,
                                                     "--out-prefix", str(root / "r")],
                             {"make_render_chunk_fn"}),
        "render_animation": (render_animation.main, ["illumination-rotation", "--frames", "2", "--load-dir", synthetic,
                                                     *CPU, "--out", str(root / "anim")],
                             {"make_render_chunk_fn"}),
        "prior_fit_sanity": (prior_fit_sanity.main, ["1", "1", *CPU],
                             {"make_train_step", "make_render_chunk_fn"}),
        "train_reni_prior": (train_reni_prior.main, ["--quick", "--steps", "4", *CPU, "--output", str(root / "prior")],
                             {"RENITrainer.__init__", "make_envmap_fit_step"}),
    }


def _run(runs, name, monkeypatch, eager: bool):
    """Run command ``name`` (with ``--eager`` or not) → the factories its
    path builds."""
    protocol = eval_loop.run_nerfosr_protocol
    monkeypatch.setattr(eval_loop, "run_nerfosr_protocol", lambda *a, **k: protocol(*a, fit_steps=FIT_STEPS, **k))
    main, argv, factories = _commands(*runs)[name]
    main(argv + ["--eager"] * eager)
    return factories


@pytest.fixture
def factories_given(monkeypatch):
    """[(factory, graphed)]: each call of ``use_graph`` by a factory (through
    its module's ``_graphed*`` helper, where it has one)."""
    given = []
    for module in (eval_loop, ddf_trainer, reni_trainer, lpips, mesh):
        real = module.use_graph

        def spy(graphed, *args, _real=real):
            frame = sys._getframe(1)
            while frame.f_code.co_name.startswith("_graphed"):
                frame = frame.f_back
            given.append((frame.f_code.co_qualname, graphed))
            return _real(graphed, *args)

        monkeypatch.setattr(module, "use_graph", spy)
    return given


NAMES = ("cli train", "cli train ddf", "cli eval", "cli eval nerfosr", "cli eval nerfosr envmap", "cli render",
         "eval_from_ckpt", "render_from_ckpt", "render_animation", "prior_fit_sanity", "train_reni_prior")


@pytest.mark.parametrize("name", NAMES)
def test_eager_reaches_every_factory_as_graphed_false(runs, factories_given, monkeypatch, name):
    """With ``--eager`` every factory the command builds is given
    ``graphed=False``, and those are the factories its path runs."""
    factories = _run(runs, name, monkeypatch, eager=True)
    assert {f for f, _ in factories_given} == factories, factories_given
    assert all(g is False for _, g in factories_given), factories_given


@pytest.mark.parametrize("name", ("cli eval", "render_from_ckpt"))
def test_without_eager_the_factories_get_graphed_none(runs, factories_given, monkeypatch, name):
    """Without the flag the same factories get ``graphed=None`` (captured on
    the card, eager on the CPU)."""
    factories = _run(runs, name, monkeypatch, eager=False)
    assert {f for f, _ in factories_given} == factories, factories_given
    assert all(g is None for _, g in factories_given), factories_given
