"""The control and the faults on the card, at each cell's own size: the
reference in TF32 put in the program's place, and each fault a training
cell can have planted in the reference (half of each batch left out, the
proposal hash tables' gradients zeroed), judged by the cell's own limits
as a run judges it, come out as not correct.  The readings that set the
limits, on more seeds, come from ``python3 -m benchmark.control``.  Also
the harness's card path on the tiny cells."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, run

SEED = 2**33 + 99
CELLS = [w["name"] for w in run.manifest()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cells' sizes exist only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_each_fault_are_not_correct(workload):
    device = _card()
    out = control.readings(workload, SEED, device)
    judged = {name: r["correct"] for name, r in out.items() if isinstance(r, dict)}
    assert "control_tf32" in judged and not any(judged.values()), out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.train", "tiny.view"])
def test_the_tiny_cells_run_correct_on_the_card(tiny_cells, cell):
    device = _card()
    base, bench = tiny_cells
    res = run.run_cell(cell, SEED, 1.0, False, device, bench, base=base)
    assert res["correct"] and res["device"]["platform"] == "gpu", res["checks"]
