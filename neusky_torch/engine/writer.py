"""Experiment writer (mirror of ``neusky_tpu/engine/writer.py``, without its
optional wandb mirror): scalars per step to ``events.jsonl``, image panels
to ``images/step-%09d/<name>.png``."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np

from neusky_torch.utils.viz import save_png


class Writer:
    def __init__(self, output_dir: str):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._events = open(self.dir / "events.jsonl", "a")

    def write_scalars(self, step: int, scalars: Dict[str, float]):
        self._events.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        self._events.flush()

    def write_image(self, step: int, name: str, image: np.ndarray):
        img_dir = self.dir / "images" / f"step-{step:09d}"
        img_dir.mkdir(parents=True, exist_ok=True)
        save_png(str(img_dir / f"{name}.png"), image)

    def close(self):
        self._events.close()
