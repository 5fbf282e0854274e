"""The readings that set the limits of ``correct`` in ``reni-pp.train``, on
the card at the cell's own size, each judged by the cell's limits as a run
judges it: the control (the reference put in the program's place, computed
in TF32, the precision just below the configuration's float32 with TF32
off) and the cell's faults planted in the reference (the decoder's weight
gradients zeroed, as a step that kept the decoder frozen would leave them;
the first half of each step's pixels alone), each against the float32
reference; with ``--program``, the program's own readings too, from its
first steps and a one-second window.

    python3 -m benchmark.control_reni --seeds 1,2,3 [--program [--no-controls]] [--out readings.jsonl]

Prints one JSON line per seed with each reading's ``correct``; ``--out``
also keeps every leaf's norms.  (``benchmark/control.py`` reads the
NeuSky cells.)"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

from benchmark import common
from benchmark.control import PROGRAM_SECONDS, _judged, _without_leaves

WORKLOAD = "reni-pp.train"


def readings(seed: int, device, program: bool = False, controls: bool = True, leaves: bool = False,
             workload: str = WORKLOAD) -> Dict[str, Any]:
    """Each reading of one seed, judged by the cell's limits: ``program``
    (with ``program``), and with ``controls`` ``control_tf32``,
    ``fault_decoder_grads`` and ``fault_half_pixels``."""
    from benchmark import run
    from benchmark.reference import reni as ref_reni
    from benchmark.reference import train as ref_train

    cell = common.load_json("workloads", workload)
    traffic = common.load_json("traffic", cell["traffic"])
    config = common.load_json("configs", cell["config"])
    seeds = common.Seeds.of(seed)
    out: Dict[str, Any] = {"workload": workload, "seed": seed}
    if program:
        _, record = run.run_record(workload, seed, PROGRAM_SECONDS, False, device)
        out["program"] = _judged(record["numbers"], cell["limits"])
        if leaves:
            out["program"]["leaves"] = record["leaf_norms"]
    if not controls:
        return out
    from neusky_torch.data.sky_generator import generate_sky_corpus  # the cell's data, as the loop makes it

    a, p = config["assumed"], traffic["pixels_per_step"]
    skies = generate_sky_corpus(a["train_images"] + a["eval_images"], width=a["width"],
                                seed=seeds.scene)[:a["train_images"]]
    base = ref_reni.run_steps(config, skies, p, seeds, 3, device)
    for name, kw in (("control_tf32", {"tf32": True}),
                     ("fault_decoder_grads", {"fault_grads": ref_reni.zero_decoder_grads}),
                     ("fault_half_pixels", {"fault_draws": ref_reni.half_pixels})):
        got = ref_reni.run_steps(config, skies, p, seeds, 3, device, **kw)
        out[name] = _judged(ref_reni.compare(got, base), cell["limits"])
        if leaves:
            out[name]["leaves"] = ref_train.leaf_norms(got, base)
        common.note(f"seed {seed}: {name}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control_reni")
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
        out = readings(seed, device, program=args.program, controls=not args.no_controls, leaves=bool(args.out))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(out) + "\n")
        print(json.dumps(_without_leaves(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
