"""Flax parameters → the port's parameters.

The port keeps the flax tree's names and layouts, so conversion is a
re-nesting plus a copy to tensors:

- flax ``Dense`` / ``WNDense`` kernels are ``[in, out]`` and stay so (the
  port computes ``x @ kernel``); ``WNDense`` keeps ``kernel``/``bias``/
  ``scale`` with the weight norm over axis 0 (``nets/mlp.py``);
- attention ``DenseGeneral`` kernels keep their ``[in, heads, head_dim]``
  and ``[heads, head_dim, out]`` shapes;
- hash tables stay ``[L, F, T]``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from neusky_torch.tree import unflatten


def convert_params(
    flat: Mapping[str, np.ndarray], device="cpu", dtype=torch.float32
) -> Dict:
    """``{flax_path: array}`` (paths joined with ``/``, e.g.
    ``fields/params/geo_0/kernel``) → nested dict of tensors on ``device``.
    Floating arrays become ``dtype``; integer arrays keep their type."""
    out = {}
    for path, arr in flat.items():
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if t.is_floating_point():
            t = t.to(dtype)
        out[path] = t.to(device)
    return unflatten(out)
