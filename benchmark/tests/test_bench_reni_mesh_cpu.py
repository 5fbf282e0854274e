"""The cells ``reni-pp.train`` and ``neusky.train-mesh4`` on the CPU at a
tiny size, each added as data files alone: the RENI loop at
``train_reni_prior --quick``'s recipe against the RENI reference, and the
mesh loop on two gloo ranks of the ``neusky-tiny`` recipe against the
training reference; and each check failing on the RENI faults.

The runs skip the harness's look for a card (``run.run_cell`` on the CPU);
their times are the CPU's and are no measurement."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run

SEED = 2**33 + 4242  # larger than 32 signed bits hold
RENI_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "grad_gap_later": 1e-3, "change_gap": 0.02,
               "leaf_grad_gap": 5e-3, "leaf_change_gap": 0.02}
MESH_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 0.3, "leaf_grad_gap": 1e-3,
               "leaf_change_gap": 1e-3}


@pytest.fixture
def new_cells(tiny_cells):
    """(base folder, manifest) of ``tiny.train``'s folder with the cells
    ``tinyreni.train`` (the tool's ``--quick`` recipe, 64 pixels a step)
    and ``tiny.train-mesh2`` (``tiny.train`` on two ranks)."""
    from benchmark import cfgjson
    from benchmark.loops.reni import program_recipe  # noqa: F401  (the loop the cell names)
    from neusky_torch.engine.reni_trainer import RENITrainerConfig
    from neusky_torch.tools.train_reni_prior import parse_args, prior_field_config

    base, bench = tiny_cells
    args = parse_args(["--quick"])
    tcfg = RENITrainerConfig(field=prior_field_config(True), lr=args.lr, latent_lr=args.latent_lr,
                             kl_weight=args.kl_weight, num_steps=args.steps, pixels_per_step=args.pixels_per_step,
                             steps_per_call=min(100, args.steps), seed=args.seed)
    files = {
        "configs/tinyreni.json": {
            "name": "tinyreni", "tool_args": ["--quick"], "bundle": {"trainer_config": cfgjson.encode(tcfg)},
            "assumed": {"train_images": args.num_skies, "eval_images": args.holdout, "width": args.width,
                        "height": args.width // 2}},
        "traffic/tinyreni_p64.json": {"pixels_per_step": 64},
        "workloads/tinyreni.train.json": {"name": "tinyreni.train", "config": "tinyreni", "traffic": "tinyreni_p64",
                                          "loop": "reni", "chips": 1, "limits": RENI_LIMITS},
        "workloads/tiny.train-mesh2.json": {"name": "tiny.train-mesh2", "config": "tiny", "traffic": "tiny_batch",
                                            "loop": "train_mesh", "chips": 2, "limits": MESH_LIMITS},
    }
    for rel, obj in files.items():
        (base / rel).write_text(json.dumps(obj))
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"] += ["tinyreni.train", "tiny.train-mesh2"]
    return base, bench


def _run(cells, cell, traced=False, seconds=0.5):
    base, bench = cells
    return run.run_cell(cell, SEED, seconds, traced, torch.device("cpu"), bench, base=base)


def test_reni_cell_matches_the_reference(new_cells):
    res = _run(new_cells, "tinyreni.train")
    assert res["correct"], res["checks"]
    assert res["checks"]["loss_gap"]["value"] < 1e-6 and res["checks"]["grad_gap"]["value"] < 1e-5
    assert set(res["metrics"]) == {"setup_s", "train_rays_per_s"} and res["attempted"] >= 100


def test_reni_cell_traced_reads_the_program_off_the_card(new_cells):
    """Traced on the CPU: of the per-layer metrics the FLOP share is read,
    the device spans and the trace are not (no card), and the program's
    tracing is off again."""
    from neusky_torch.utils import profiling

    base, bench = new_cells
    bench["per_layer"] = [m for m in bench["per_layer"] if m["name"].endswith(".reni")]
    for m in bench["per_layer"]:
        m["workloads"] = ["tinyreni.train"]
    res = _run((base, bench), "tinyreni.train", traced=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"step_mfu.reni"}
    assert not profiling.enabled()


def _decoder_grads_zeroed(monkeypatch):
    from neusky_torch.engine import optimizers

    step = optimizers.GroupedAdam.step

    def step_without_decoder(self):
        for group in self.optimizer.param_groups[:1]:  # the decoder's group, built first
            for t in group["params"]:
                if t.grad is not None:
                    t.grad.zero_()
        step(self)

    monkeypatch.setattr(optimizers.GroupedAdam, "step", step_without_decoder)


def _half_pixels(monkeypatch):
    from benchmark.reference.reni import half_pixels
    from neusky_torch.engine.reni_trainer import RENITrainer

    loss = RENITrainer.loss
    monkeypatch.setattr(RENITrainer, "loss", lambda self, draws: loss(self, half_pixels(draws)))


@pytest.mark.parametrize("fault", [_decoder_grads_zeroed, _half_pixels], ids=["decoder_grads_zeroed", "half_pixels"])
def test_reni_check_fails_on_a_fault(new_cells, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(new_cells, "tinyreni.train")
    assert not res["correct"], res["checks"]


def test_mesh_cell_on_two_gloo_ranks_matches_the_reference(new_cells):
    res = _run(new_cells, "tiny.train-mesh2")
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"setup_s", "train_rays_per_s"}



@pytest.mark.parametrize("cell", ["neusky.train-mesh4", "reni-pp.train"])
def test_new_cell_is_the_only_one_of_its_config_and_traffic(cell):
    """Each pair of configuration and traffic is one cell: the mesh cell
    takes ``site_16x64``'s numbers under a traffic name of its own."""
    from benchmark import common

    bench = run.manifest()
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    mine = next((w["config"], w["traffic"]) for w in bench["workloads"] if w["name"] == cell)
    assert pairs.count(mine) == 1
    if cell == "neusky.train-mesh4":
        keys = ("images_per_batch", "rays_per_batch", "sky_rays")
        site, data4 = common.load_json("traffic", "site_16x64"), common.load_json("traffic", mine[1])
        assert {k: data4[k] for k in keys} == {k: site[k] for k in keys}


def test_new_config_is_not_an_existing_one_by_source_and_cuts():
    bench = run.manifest()
    ids = [(c["source"], tuple(c["reduced"])) for c in bench["configs"]]
    assert len(ids) == len(set(ids))

@pytest.mark.cuda
def test_reni_control_and_each_fault_are_not_correct():
    """On the card at the cell's size: the TF32 reference and each RENI
    fault planted in the reference, judged by ``reni-pp.train``'s limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cell's size exist only there")
    from benchmark import control_reni

    out = control_reni.readings(SEED, torch.device("cuda", 0))
    judged = {name: r["correct"] for name, r in out.items() if isinstance(r, dict)}
    assert set(judged) == {"control_tf32", "fault_decoder_grads", "fault_half_pixels"} and not any(judged.values())
