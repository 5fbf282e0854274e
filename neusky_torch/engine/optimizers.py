"""Optimizer groups + LR schedules (mirror of
``neusky_tpu/engine/optimizers.py``).

Five Adam groups (eps 1e-15) with per-group cosine/exponential schedules;
``eval_latents`` and ``illumination_decoder`` are frozen (the JAX
``set_to_zero``): their tensors get ``requires_grad_(False)`` and no
optimizer state.  Each schedule is evaluated at optax's update count —
the number of updates applied before this one, so the first update uses
``schedule(0)``.  :func:`build_eval_latent_optimizer` is the test-time
fit's Adam over the eval group alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from neusky_torch.tree import tree_items


def cosine_decay_schedule(lr_init: float, max_steps: int, warm_up_end: int = 500,
                          learning_rate_alpha: float = 0.05) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        warm = min(max(step / max(warm_up_end, 1), 0.0), 1.0)
        t = min(max((step - warm_up_end) / max(max_steps - warm_up_end, 1), 0.0), 1.0)
        decay = learning_rate_alpha + (1.0 - learning_rate_alpha) * 0.5 * (1.0 + math.cos(math.pi * t))
        return lr_init * (warm if step < warm_up_end else decay)

    return schedule


def exponential_decay_schedule(lr_init: float, lr_final: float, max_steps: int,
                               warmup_steps: int = 0, lr_pre_warmup: float = 1e-8) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            ramp = math.sin(0.5 * math.pi * min(max(step / warmup_steps, 0.0), 1.0))
            return lr_pre_warmup + (lr_init - lr_pre_warmup) * ramp
        t = min(max((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
        return math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    lr: float = 1e-3
    eps: float = 1e-15
    schedule: str = "cosine"  # cosine | exponential | constant
    lr_final: float = 1e-5
    warm_up_end: int = 500
    warmup_steps: int = 0
    learning_rate_alpha: float = 0.05
    max_steps: int = 100001
    weight_decay: float = 0.0


def _group_schedule(g: OptimizerGroupConfig) -> Callable[[int], float]:
    if g.schedule == "cosine":
        return cosine_decay_schedule(g.lr, g.max_steps, g.warm_up_end, g.learning_rate_alpha)
    if g.schedule == "exponential":
        return exponential_decay_schedule(g.lr, g.lr_final, g.max_steps, g.warmup_steps)
    return lambda step: g.lr


def default_neusky_optimizer_groups(max_steps: int = 100001) -> Dict[str, OptimizerGroupConfig]:
    return {
        "proposal_networks": OptimizerGroupConfig(lr=1e-2, schedule="cosine", max_steps=max_steps),
        "fields": OptimizerGroupConfig(lr=1e-3, schedule="cosine", max_steps=max_steps),
        "illumination_field": OptimizerGroupConfig(
            lr=1e-2, schedule="exponential", lr_final=1e-5, max_steps=max_steps
        ),
        "visibility_sigmoid": OptimizerGroupConfig(
            lr=1e-3, schedule="exponential", lr_final=1e-4, warmup_steps=4000, max_steps=max_steps,
        ),
        "ddf_field": OptimizerGroupConfig(lr=1e-4, schedule="cosine", max_steps=max_steps),
    }


def param_group_label(path_key: str) -> str:
    if path_key.startswith("proposal_networks"):
        return "proposal_networks"
    if path_key in ("eval_latents", "illumination_decoder"):
        return "frozen"
    if path_key == "gt_probe_illumination":
        return "illumination_field"
    return path_key


class GroupedAdam:
    """``torch.optim.Adam`` over the trainable groups, with each group's
    learning rate set from its schedule before every update.  Updates the
    parameter tensors in place (JAX returns new arrays).  ``label_fn`` maps
    a leaf's ``"a/b/c"`` path to its group (default: the top-level key's
    :func:`param_group_label`); leaves of no group in ``groups`` are
    frozen."""

    def __init__(self, params: Dict[str, dict], groups: Dict[str, OptimizerGroupConfig],
                 label_fn: Optional[Callable[[str], str]] = None):
        label_fn = label_fn or (lambda path: param_group_label(path.split("/")[0]))
        labelled = [(label_fn(path), t) for path, t in tree_items(params)]
        for label, t in labelled:
            t.requires_grad_(label in groups)
        torch_groups: List[dict] = []
        self.schedules: List[Callable[[int], float]] = []
        for name, g in groups.items():
            leaves = [t for label, t in labelled if label == name]
            if not leaves:
                continue
            torch_groups.append({"params": leaves, "lr": 0.0, "eps": g.eps, "name": name})
            self.schedules.append(_group_schedule(g))
        self.optimizer = torch.optim.Adam(torch_groups, betas=(0.9, 0.999))
        self.count = 0

    @property
    def group_names(self) -> List[str]:
        return [g["name"] for g in self.optimizer.param_groups]

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for group, schedule in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = schedule(self.count)
            for p in group["params"]:
                if p.grad is None:  # optax sees a zero gradient
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        """The Adam moments and step counts (by parameter position) and the
        update count the schedules read."""
        return {"adam": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["adam"])
        self.count = int(state["count"])


def build_eval_latent_optimizer(
    params: Dict[str, dict], lr: float = 1e-1, lr_final: float = 1e-7, max_steps: int = 250,
    eps: float = 1e-15, scale_only: bool = False,
) -> GroupedAdam:
    """Adam with the exponential decay ``lr`` → ``lr_final`` over
    ``max_steps`` for test-time latent fitting, over the ``eval_latents``
    group only (``eval_latents``, ``eval_scale``, ``eval_rotation``);
    ``scale_only`` moves ``eval_scale`` alone.  Every other leaf of
    ``params`` is frozen."""
    group = {"eval": OptimizerGroupConfig(lr=lr, eps=eps, schedule="exponential", lr_final=lr_final,
                                          max_steps=max_steps)}

    def label_fn(path: str) -> str:
        top, *rest = path.split("/")
        if top != "eval_latents" or (scale_only and rest != ["eval_scale"]):
            return "frozen"
        return "eval"

    return GroupedAdam(params, group, label_fn)

