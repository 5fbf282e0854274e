"""The readings that set the limits of ``correct``, on the card at a cell's
own size, each judged by the cell's own limits as a run judges it: the
control (the reference put in the program's place, computed in TF32, the
precision just below the configuration's float32 with TF32 off) and the
faults a cell can have, each against the float32 reference; with
``--program``, the program's own readings too, from its first steps and a
one-second window.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--program [--no-controls]] [--out readings.jsonl]

Training cells: the control; half of each batch's scene rays left out
(the loss the mean over the rest); the proposal hash tables' gradients
zeroed.  A state left unchanged reads 1 on ``change_gap`` by its
definition and needs no run.  The viewer cell: the control.  Prints one
JSON line per seed with each reading's ``correct``; ``--out`` also keeps
every leaf's norms (training cells)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict

from benchmark import common

PROGRAM_SECONDS = 1.0  # the program's readings need its first steps, not a measured window


def _judged(numbers: Dict[str, Any], limits: Dict[str, float]) -> Dict[str, Any]:
    from benchmark import run

    checks = run.checks_of(numbers, limits)
    return {"correct": run.within(checks), "numbers": {k: v for k, v in numbers.items() if isinstance(v, float)},
            "worst": numbers.get("worst", {})}


def readings(workload: str, seed: int, device, program: bool = False, controls: bool = True,
             leaves: bool = False, base: Path = common.BENCH_DIR) -> Dict[str, Any]:
    """Each reading of one seed, judged by the cell's limits: ``program``
    (with ``program``), and with ``controls`` ``control_tf32`` and the
    training cells' faults."""
    import numpy as np
    import torch

    from benchmark import run, scene
    from benchmark.loops.view import POSE_HIGH, POSE_LOW
    from benchmark.reference import train as ref_train
    from benchmark.reference import view as ref_view

    cell = common.load_json("workloads", workload, base)
    traffic = common.load_json("traffic", cell["traffic"], base)
    config = common.load_json("configs", cell["config"], base)
    seeds = common.Seeds.of(seed)
    out: Dict[str, Any] = {"workload": workload, "seed": seed}
    if program:
        _, record = run.run_record(workload, seed, PROGRAM_SECONDS, False, device, base)
        out["program"] = _judged(record["numbers"], cell["limits"])
        if leaves and "leaf_norms" in record:
            out["program"]["leaves"] = record["leaf_norms"]
        common.note(f"seed {seed}: the program; {torch.cuda.memory_reserved(device) / 2**30:.2f} GiB reserved after it")
    if not controls:
        return out
    if cell["loop"] == "train":
        a = config["assumed"]
        split = scene.make_scene(seeds.scene, a["train_images"], a["eval_images"], a["width"], a["height"])["train"]
        base_steps = ref_train.run_steps(config, split, traffic, seeds, 3, device)
        for name, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"fault_batch": ref_train.half_batch}),
                         ("fault_proposal_tables", {"fault_grads": ref_train.zero_proposal_tables})):
            got = ref_train.run_steps(config, split, traffic, seeds, 3, device, **kw)
            out[name] = _judged(ref_train.compare(got, base_steps), cell["limits"])
            if leaves:
                out[name]["leaves"] = ref_train.leaf_norms(got, base_steps)
            common.note(f"seed {seed}: {name}")
    else:
        rng = np.random.default_rng([seeds.window, 3])
        poses = rng.uniform(POSE_LOW, POSE_HIGH, size=(traffic["check_frames"], 3))
        res = traffic["resolution"]
        base_frames = ref_view.render_frames(config, seeds, poses, res, device)
        got = ref_view.render_frames(config, seeds, poses, res, device, tf32=True)
        out["control_tf32"] = _judged(ref_view.compare(got, base_frames), cell["limits"])
    return out


def _without_leaves(out: Dict[str, Any]) -> Dict[str, Any]:
    return {k: ({kk: vv for kk, vv in v.items() if kk != "leaves"} if isinstance(v, dict) else v)
            for k, v in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true", help="read the program's numbers too")
    p.add_argument("--no-controls", action="store_true", help="read the program's numbers alone")
    p.add_argument("--out", help="a JSON-lines file that keeps every leaf's norms too")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control's readings are taken on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(args.workload, seed, device, program=args.program, controls=not args.no_controls,
                       leaves=bool(args.out))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(out) + "\n")
        print(json.dumps(_without_leaves(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
