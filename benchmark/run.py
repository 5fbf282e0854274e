"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``workloads/<cell>.json``: its configuration
(``configs/<name>.json``), its traffic (``traffic/<name>.json``), its
window loop (``loops/<loop>.py``) and the limits of the numbers
that decide ``correct``.  ``--trace 0`` reports the cell's end-to-end
metrics and ``--trace 1`` its per-layer ones, as ``BENCHMARK.json``
assigns them; each is read by ``metrics/<name>.py`` from the loop's
record.

The run exits with a code other than 0 and prints no result when no card
is there (or fewer than the cell asks for), when a ``NEUSKY_*`` knob is
set, or when the JAX package or JAX itself was loaded."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from benchmark import common

def manifest(path: Optional[Path] = None) -> Dict[str, Any]:
    return json.loads((path or common.ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: Dict[str, Any], cell: str, traced: bool) -> List[Dict[str, Any]]:
    """The metrics ``bench`` assigns to ``cell``: its end-to-end ones, or
    with ``traced`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m and m["moves"] in reported)]


def reader(name: str, base: Path = common.BENCH_DIR):
    """``read`` of ``metrics/<name>.py`` (under ``base``, else this folder)."""
    path = base / "metrics" / f"{name}.py"
    if not path.exists():
        path = common.BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def checks_of(numbers: Dict[str, Any], limits: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """(name, number, limit) of every number that has a limit."""
    out = []
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"the cell has a limit for {name!r}, which its check does not compute")
        out.append((name, float(numbers[name]), float(limit)))
    return out


def within(checks: List[Tuple[str, float, float]]) -> bool:
    """Every number finite and at most its limit."""
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def run_record(workload: str, seed: int, seconds: float, traced: bool, device,
               base: Path = common.BENCH_DIR) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(cell, the window loop's record) of one run of one cell on ``device``."""
    cell = common.load_json("workloads", workload, base)
    cell = {**cell, "traffic": common.load_json("traffic", cell["traffic"], base)}
    config = common.load_json("configs", cell["config"], base)
    loop = importlib.import_module(f"benchmark.loops.{cell['loop']}")
    return cell, loop.run(cell, config, common.Seeds.of(seed), seconds, traced, device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device, bench: Dict[str, Any],
             base: Path = common.BENCH_DIR, process_start: Optional[float] = None) -> Dict[str, Any]:
    """One run of one cell on ``device`` → the result line's object; the
    compared numbers with their limits are under ``checks``, last."""
    cell, record = run_record(workload, seed, seconds, traced, device, base)
    record["process_start"] = common.process_start_time() if process_start is None else process_start
    checks = checks_of(record["numbers"], cell["limits"])
    correct = record["attempted"] > 0 and record["failed"] == 0 and within(checks)
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        value = reader(m["name"], base)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: Dict[str, Any] = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
                              "metrics": metrics, "device": dict(record["device"])}
    tr = record.get("trace")
    if traced and tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    reported = {k: v for k, v in record["numbers"].items() if k not in result["checks"]}
    print("reported, not compared: " + json.dumps(reported), file=sys.stderr)
    return result


def main(argv=None) -> int:
    start = common.process_start_time()
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    knobs = common.knobs_set()
    if knobs:
        print(f"the recipe runs with no NEUSKY_* knob; set: {sorted(knobs)}", file=sys.stderr)
        return 2
    import torch

    cell = common.load_json("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no measurement: the cell needs {cell['chips']} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      manifest(), process_start=start)
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"no result: the process loaded {loaded}", file=sys.stderr)
        return 4
    print(f"power limit: {common.power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
