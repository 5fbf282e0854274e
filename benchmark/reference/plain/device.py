"""Device resolution for the port's entry points."""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is requested (the default) but absent, so a
    missing card is never silently replaced by the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=None)
def device_constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values)`` (a number or nested tuples) built once per
    (values, dtype, device).  A step reads its constants from here, so it
    builds no tensor from host data per call and can be captured as a CUDA
    graph.  Shared: never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)
