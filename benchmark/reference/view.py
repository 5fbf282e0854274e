"""The reference's render of a viewer frame, and the number that judges the
program's frames against it.

A frame is the orbit camera of a pose (azimuth and elevation in degrees,
distance) looking at the origin, at ``res`` × ``res`` pixels with a focal
length of 0.9 · ``res``, rendered in eval mode with the sky of eval slot 0:
the viewer's ``rgb`` mode.  The reference computes the camera, the rays and
the eval forward itself, in float32 with TF32 off (or on, for the control)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import model as ref
from benchmark.reference.plain.core.cameras import Cameras, CameraType
from benchmark.reference.plain.core.spherical import look_at_target
from benchmark.reference.train import precision


def camera_rays(pose: Sequence[float], res: int, device):
    az, el = np.deg2rad(pose[0]), np.deg2rad(pose[1])
    dist = pose[2]
    pos = dist * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
    c2w = look_at_target(pos[None], np.zeros((1, 3)))[..., :3, :]
    cam = Cameras(camera_to_worlds=torch.from_numpy(np.ascontiguousarray(c2w)),
                  fx=torch.tensor([0.9 * res]), fy=torch.tensor([0.9 * res]),
                  cx=torch.tensor([res / 2.0]), cy=torch.tensor([res / 2.0]),
                  width=res, height=res, camera_type=int(CameraType.PERSPECTIVE)).to(device)
    return cam.generate_rays(0)


def render(model, params, pose: Sequence[float], res: int, device) -> np.ndarray:
    """The ``rgb`` map [res, res, 3] of one pose, in one chunk."""
    rb = camera_rays(pose, res, device)
    analytic = model.field.config.gradient_mode == "forward"
    with torch.inference_mode(analytic), torch.set_grad_enabled(not analytic):
        out = model.forward(params, rb, torch.tensor([0], device=device),
                            torch.zeros((rb.num_rays,), dtype=torch.long, device=device), step=0.0, train=False)
        return out["rgb"].detach().reshape(res, res, 3).cpu().numpy()


def render_frames(config: Dict, seeds, poses: List[Sequence[float]], res: int, device,
                  tf32: bool = False) -> List[np.ndarray]:
    with precision(tf32):
        model = ref.make_model(config, device)
        params = ref.make_params(config, seeds.weights, device)
        return [render(model, params, p, res, device) for p in poses]


def count_frame_flops(config: Dict, seeds, pose: Sequence[float], res: int, device) -> float:
    """FLOPs of the matrix products of one frame's forward, by torch's flop
    counter on the reference render at the frame's shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ref.make_model(config, device)
    params = ref.make_params(config, seeds.weights, device)
    with FlopCounterMode(display=False) as counter:
        render(model, params, pose, res, device)
    return float(counter.get_total_flops())


def compare(program: List[np.ndarray], reference: List[np.ndarray]) -> Dict[str, float]:
    """``rgb_rmse``: the worst frame's root mean square gap of its rgb map;
    ``rgb_max_abs``: the widest gap of one channel of one pixel."""
    rmse, widest = 0.0, 0.0
    for p, r in zip(program, reference, strict=True):
        d = np.asarray(p, np.float64) - np.asarray(r, np.float64)
        if not np.all(np.isfinite(d)):
            return {"rgb_rmse": float("inf"), "rgb_max_abs": float("inf")}
        rmse = max(rmse, float(np.sqrt(np.mean(d * d))))
        widest = max(widest, float(np.max(np.abs(d))))
    return {"rgb_rmse": rmse, "rgb_max_abs": widest}
