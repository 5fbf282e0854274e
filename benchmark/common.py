"""What every window loop shares: the cell's files, the seeds, the guards
and the program's configuration checked against the configuration file."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from benchmark import cfgjson

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# modules that may not be loaded in the process that prints a result,
# compared by their top-level name whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "neusky_tpu")


def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock, from
    ``/proc/self/stat`` (jiffies since boot); the current time where
    ``/proc`` is not there."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


_T0 = process_start_time()


def note(msg: str) -> None:
    """A line on standard error with the seconds since the process began."""
    print(f"[{time.time() - _T0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def load_json(kind: str, name: str, base: Optional[Path] = None) -> Dict[str, Any]:
    """``<base>/<kind>/<name>.json`` (base: this folder)."""
    path = (base or BENCH_DIR) / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} does not exist")
    return json.loads(path.read_text())


@dataclasses.dataclass(frozen=True)
class Seeds:
    """The run's seeds, all from ``--seed``: the scene, the weights, the
    step's draws on the device, the pixel sampler and the window's
    sample (poses, frames to check)."""

    scene: int
    weights: int
    draws: int
    sampler: int
    window: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        if seed < 0:
            raise ValueError(f"--seed takes a whole number >= 0, not {seed}")
        words = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32]).generate_state(5, dtype=np.uint32)
        return cls(*(int(w) for w in words))


def knobs_set() -> Dict[str, str]:
    """The program's ``NEUSKY_*`` environment knobs that are set: a cell runs
    its recipe as the registry builds it, with none of them."""
    return {k: v for k, v in os.environ.items() if k.startswith("NEUSKY_")}


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def program_bundle(config: Dict[str, Any]) -> Dict[str, Any]:
    """The recipe as the program's registry builds it for the configuration
    file's data sizes; raises unless it is the recipe the file holds."""
    from neusky_torch.configs import METHOD_REGISTRY

    a = config["assumed"]
    bundle = METHOD_REGISTRY[config["method"]].build(num_train_data=a["train_images"],
                                                     num_eval_data=a["eval_images"])
    got = json.loads(json.dumps(cfgjson.encode(bundle)))
    if got != config["bundle"]:
        diff = [k for k in set(got) | set(config["bundle"]) if got.get(k) != config["bundle"].get(k)]
        raise ValueError(f"the program's recipe {config['method']!r} differs from benchmark/configs/"
                         f"{config['name']}.json under {sorted(diff)}")
    return bundle


def check_prior(config: Dict[str, Any], model_config) -> None:
    """The program reads the illumination prior from the file the reference
    reads."""
    from neusky_torch.engine.checkpoint import prior_asset_path

    path, want = prior_asset_path(model_config), config["prior_file"]
    if (path is None) != (want is None) or (path is not None and path.resolve() != (ROOT / want).resolve()):
        raise ValueError(f"the program reads its prior from {path}, the benchmark from {config['prior_file']}")


def device_info(device) -> Dict[str, Any]:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_reserved(device))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
