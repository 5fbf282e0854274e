"""The harness end to end on the CPU at a tiny size, on a cell added as
data files alone (``conftest.tiny_cells``): the program against the
reference, and the check failing on each fault the cells can have.

The runs skip the harness's look for a card (``run.run_cell`` on the CPU);
their times are the CPU's and are no measurement."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run

SEED = 2**33 + 12345  # larger than 32 signed bits hold


def _run(tiny_cells, cell, seconds=1.0):
    base, bench = tiny_cells
    return run.run_cell(cell, SEED, seconds, False, torch.device("cpu"), bench, base=base)


def test_train_cell_matches_the_reference(tiny_cells):
    res = _run(tiny_cells, "tiny.train")
    assert res["correct"], res
    assert res["checks"]["loss_gap"]["value"] < 1e-6 and res["checks"]["grad_gap"]["value"] < 1e-5
    assert set(res["metrics"]) == {"setup_s", "train_rays_per_s"} and res["attempted"] >= 3
    assert list(res)[-1] == "checks"


def test_view_cell_matches_the_reference(tiny_cells):
    res = _run(tiny_cells, "tiny.view")
    assert res["correct"], res
    assert res["checks"]["rgb_rmse"]["value"] < 1e-6
    assert set(res["metrics"]) == {"setup_s", "render_rays_per_s", "view_frame_ms_p90"}


def test_same_seed_same_inputs():
    from benchmark import common, scene

    a, b = common.Seeds.of(SEED), common.Seeds.of(SEED)
    assert a == b and a != common.Seeds.of(SEED + 1)
    s1, s2 = scene.make_scene(a.scene, 3, 1, 8, 8), scene.make_scene(b.scene, 3, 1, 8, 8)
    assert np.array_equal(s1["train"]["images"], s2["train"]["images"])


def _state_unchanged(monkeypatch):
    from neusky_torch.engine import optimizers

    monkeypatch.setattr(optimizers.GroupedAdam, "step", lambda self: None)


def _half_batch(monkeypatch):
    from benchmark.reference.train import half_batch
    from neusky_torch.parallel import mesh

    inner = mesh.train_loss_fn
    monkeypatch.setattr(mesh, "train_loss_fn",
                        lambda model, pc, params, batch, *a, **k: inner(model, pc, params, half_batch(batch), *a, **k))


def _proposal_tables_zeroed(monkeypatch):
    from benchmark.reference.train import is_proposal_table
    from neusky_torch.engine import optimizers
    from neusky_torch.tree import tree_items

    init, step = optimizers.GroupedAdam.__init__, optimizers.GroupedAdam.step

    def init_naming_tables(self, params, *a, **k):
        init(self, params, *a, **k)
        self.fault_tables = [t for path, t in tree_items(params) if is_proposal_table(path)]
        assert self.fault_tables

    def step_without_tables(self):
        for t in self.fault_tables:
            if t.grad is not None:
                t.grad.zero_()
        step(self)

    monkeypatch.setattr(optimizers.GroupedAdam, "__init__", init_naming_tables)
    monkeypatch.setattr(optimizers.GroupedAdam, "step", step_without_tables)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _proposal_tables_zeroed],
                         ids=["state_unchanged", "half_batch", "proposal_tables_zeroed"])
def test_train_check_fails_on_a_fault(tiny_cells, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tiny_cells, "tiny.train")
    assert not res["correct"], res["checks"]
    if fault is _proposal_tables_zeroed:  # held by the leaf numbers, which see the tables' own scale
        assert res["checks"]["leaf_grad_gap"]["value"] > 0.5, res["checks"]


def test_view_check_fails_on_an_altered_answer(tiny_cells, monkeypatch):
    from neusky_torch import viewer

    inner = viewer.ViewerState.render

    def altered(self, q):
        img = np.array(inner(self, q))
        img[0, 0, 0] += 0.05
        return img

    monkeypatch.setattr(viewer.ViewerState, "render", altered)
    res = _run(tiny_cells, "tiny.view")
    assert not res["correct"], res["checks"]


def test_a_new_metric_is_a_file(tiny_cells, tmp_path):
    """A per-layer metric added as a reader file and a manifest entry."""
    base, bench = tiny_cells
    (base / "metrics").mkdir()
    (base / "metrics" / "steps.train.py").write_text("def read(record):\n    return float(record['steps'])\n")
    bench["per_layer"] = [{"name": "steps.train", "unit": "steps", "better": "higher", "source": "host_clock",
                           "layer": "engine", "moves": "train_rays_per_s", "workloads": ["tiny.train"]}]
    res = run.run_cell("tiny.train", SEED, 0.5, True, torch.device("cpu"), bench, base=base)
    assert res["metrics"]["steps.train"]["value"] >= 3
