"""LPIPS (VGG16) with ``F.conv2d`` / ``F.max_pool2d`` (mirror of
``neusky_tpu/engine/lpips.py``).

Weights, in order: a torchvision VGG16 ``state_dict`` on disk
(``NEUSKY_VGG_WEIGHTS``, else ``checkpoints/vgg16.pth``), or a seeded
random-feature VGG — He-normal draws from ``np.random.default_rng(0)``,
the same draws as the JAX package's, so both compute the same distance.
The random flavour is labelled ``"vgg16-random"``: comparable across runs
of this repo, not with published (pretrained) LPIPS.  Nothing is fetched.

Distance: the five classic taps (relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3), each unit-normalised over channels; the mean squared difference
of each (uniform linear weights), summed over the taps.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neusky_torch.device import resolve_device

# VGG16 conv plan: (out_channels, tap after its relu) per conv; "M" = maxpool
_VGG16 = [
    (64, False), (64, True), "M",
    (128, False), (128, True), "M",
    (256, False), (256, False), (256, True), "M",
    (512, False), (512, False), (512, True), "M",
    (512, False), (512, False), (512, True),
]

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_cache: Dict[str, object] = {}


def _find_torch_weights() -> Optional[Path]:
    cand = os.environ.get("NEUSKY_VGG_WEIGHTS")
    if cand and Path(cand).exists():
        return Path(cand)
    p = Path(__file__).resolve().parent.parent.parent / "checkpoints" / "vgg16.pth"
    return p if p.exists() else None


def load_torchvision_vgg(path: Path) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The 13 convs of a torchvision VGG16 ``state_dict`` (keys
    ``[prefix]features.{i}.weight``/``.bias``, in index order) →
    [(weight [cout, cin, 3, 3], bias [cout])]."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    found = {}
    for k in sd:
        m = re.fullmatch(r"(.*features\.(\d+)\.)weight", k)
        if m:
            found[int(m.group(2))] = m.group(1)
    convs = [(sd[found[i] + "weight"].numpy(), sd[found[i] + "bias"].numpy()) for i in sorted(found)]
    if len(convs) != 13:
        raise ValueError(f"expected 13 VGG16 convs, found {len(convs)}")
    return convs


def random_vgg(seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """He-normal convs drawn as the JAX package draws them ([3, 3, cin,
    cout] per conv, in order), transposed to [cout, cin, 3, 3]."""
    rng = np.random.default_rng(seed)
    convs = []
    cin = 3
    for spec in _VGG16:
        if spec == "M":
            continue
        cout, _ = spec
        k = rng.normal(0.0, np.sqrt(2.0 / (3 * 3 * cin)), (3, 3, cin, cout)).astype(np.float32)
        convs.append((np.ascontiguousarray(k.transpose(3, 2, 0, 1)), np.zeros((cout,), np.float32)))
        cin = cout
    return convs


def _features(x: torch.Tensor, convs) -> List[torch.Tensor]:
    """x [N, 3, H, W] in [0, 1] → the tap activations."""
    mean = torch.as_tensor(_IMAGENET_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(_IMAGENET_STD, device=x.device).reshape(1, 3, 1, 1)
    x = (x - mean) / std
    taps = []
    ci = 0
    for spec in _VGG16:
        if spec == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w, b = convs[ci]
        ci += 1
        x = torch.relu(F.conv2d(x, w, b, padding=1))
        if spec[1]:
            taps.append(x)
    return taps


def _weights(device: torch.device):
    key = str(device)
    if key not in _cache:
        path = _find_torch_weights()
        convs = load_torchvision_vgg(path) if path is not None else random_vgg()
        _cache["flavour"] = "vgg16-pretrained" if path is not None else "vgg16-random"
        _cache[key] = [(torch.from_numpy(w).to(device), torch.from_numpy(b).to(device)) for w, b in convs]
    return _cache[key]


def flavour() -> Optional[str]:
    return _cache.get("flavour")


@torch.inference_mode()
def lpips(pred: np.ndarray, target: np.ndarray, device="cuda") -> Tuple[float, str]:
    """LPIPS of two [H, W, 3] images in [0, 1] on ``device`` → (value,
    flavour); report the flavour beside the value."""
    dev = resolve_device(device)
    convs = _weights(dev)
    a = torch.as_tensor(np.asarray(pred, np.float32), device=dev).permute(2, 0, 1)[None]
    b = torch.as_tensor(np.asarray(target, np.float32), device=dev).permute(2, 0, 1)[None]
    total = torch.zeros((), device=dev)
    # full float32 convolutions whatever the caller's TF32 setting, as JAX
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for xa, xb in zip(_features(a, convs), _features(b, convs)):
            na = xa / torch.sqrt(torch.sum(xa**2, dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb**2, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean((na - nb) ** 2)
    return float(total), _cache["flavour"]
