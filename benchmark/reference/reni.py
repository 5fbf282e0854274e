"""The reference's RENI++ prior-training steps: a variational autodecoder
over a corpus of HDR skies, in plain PyTorch, float32, TF32 off.

The equations (``neusky_torch/engine/reni_trainer.py``'s docstring and
ns_reni's variational autodecoder): every sky b has a posterior (μ_b,
log σ²_b) over [D, 3]; a step draws P (image, pixel) pairs and for each
a standard normal ε [D, 3], decodes z = μ_img + ε · exp(½ log σ²_img) at
the pixel's direction, and takes

    loss = mean over P × 3 of (f(d, z) − n(x))² + kl_weight · KL,
    KL = −½ · mean over B × D × 3 of (1 + log σ² − μ² − σ²),

with n(x) = 2 (log max(x, 1e-8) − lo) / (hi − lo) − 1 the normalised
log-HDR target.  The decoder and the posteriors are two Adam groups
(β = 0.9, 0.999, optax's ε = 1e-8, constant rates).

The decoder f is the explicit RENI field of ``plain/fields/reni.py`` and
``plain/nets/transformer.py``: every block embeds, normalises and projects
the D latent tokens (the copy predates the program's folded path).
Departures: the KL is a mean over every element, not a sum (the program's
scaling, ``kl_weight`` 3e-3 on it); the draws are made on the device by
``torch.randint`` / ``torch.randn`` from a generator seeded as the
program's, in the order its ``RENITrainer.draw`` makes them.  Nothing of
the program is imported: the corpus (data, like the weights) comes in as
an array."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import cfgjson
from benchmark.reference.plain.fields.reni import RENIField, RENIFieldConfig
from benchmark.reference.plain.sampling.illumination import EquirectangularSampler
from benchmark.reference.plain.tree import tree_items
from benchmark.reference.train import leaf_norms, leaf_numbers, precision

ADAM_BETAS = (0.9, 0.999)


def recipe(config: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration file's trainer recipe: its numbers, with ``field``
    as the reference's own ``RENIFieldConfig``."""
    tc = dict(config["bundle"]["trainer_config"])
    tc.pop("type")
    tc["field"] = cfgjson.decode(tc["field"], {"RENIFieldConfig": RENIFieldConfig})
    return tc


def make_params(config: Dict[str, Any], num_images: int, seed: int, device) -> Dict[str, Any]:
    """The run's starting weights: the decoder's initialisation drawn from
    ``seed`` on ``device``, every posterior mean zero and every log-variance
    ``logvar_init``."""
    tc = recipe(config)
    field = RENIField(tc["field"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (num_images, tc["field"].latent_dim, 3)
    params = {"decoder": field.init(gen, device), "latents": torch.zeros(shape, device=device)}
    if tc["variational"]:
        params["logvar"] = torch.full(shape, float(tc["logvar_init"]), device=device)
    return params


def draws(config: Dict[str, Any], num_images: int, num_pixels: int, pixels_per_step: int, seed: int,
          n_steps: int, device) -> List[Dict[str, torch.Tensor]]:
    """Each step's (``img``, ``pix``, ``eps``): P uniform images, P uniform
    pixels and P × D × 3 standard normals, step by step from one generator
    seeded ``seed``."""
    tc = recipe(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p, out = pixels_per_step, []
    for _ in range(n_steps):
        d = {"img": torch.randint(0, num_images, (p,), generator=gen, device=device),
             "pix": torch.randint(0, num_pixels, (p,), generator=gen, device=device)}
        if tc["variational"]:
            d["eps"] = torch.randn((p, tc["field"].latent_dim, 3), generator=gen, device=device)
        out.append(d)
    return out


def loss(field: RENIField, tc: Dict[str, Any], params, directions, targets, d) -> torch.Tensor:
    """One step's total (module docstring); ``targets`` [B, H·W, 3] linear
    HDR."""
    img, pix = d["img"].long(), d["pix"].long()
    mu = params["latents"]
    if tc["variational"]:
        logvar = params["logvar"]
        z = mu[img] + d["eps"] * torch.exp(0.5 * logvar[img])
        kl = -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    else:
        z = mu[img]
        kl = torch.mean(mu ** 2)
    pred = field.apply(params["decoder"], directions[pix], z)["rgb"]
    recon = torch.mean((pred - field.normalise(targets[img, pix])) ** 2)
    return recon + tc["kl_weight"] * kl


def half_pixels(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A fault: the first half of a step's pixels alone (the loss then the
    mean over them)."""
    n = d["img"].shape[0] // 2
    return {k: v[:n] for k, v in d.items()}


def is_decoder(path: str) -> bool:
    return path.startswith("decoder/")


def zero_decoder_grads(named: Dict[str, torch.Tensor]) -> None:
    """A fault: the decoder's weight gradients zeroed before the update, as
    a step that kept the decoder frozen would leave them."""
    for path, t in named.items():
        if is_decoder(path) and t.grad is not None:
            t.grad.zero_()


def run_steps(config: Dict[str, Any], corpus: np.ndarray, pixels_per_step: int, seeds, n_steps: int, device,
              tf32: bool = False, fault_draws: Optional[Callable] = None,
              fault_grads: Optional[Callable] = None, params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``n_steps`` reference steps over ``corpus`` [B, H, W, 3] →
    ``losses``, ``grads`` (each step's gradient of each leaf, host) and
    ``params`` (the leaves before step 1 and after the last, host), as
    ``reference/train.py::run_steps`` gives them; ``fault_draws`` (draws →
    draws) and ``fault_grads`` (the named leaves after the backward) plant
    a fault in each step.  ``params``: other starting weights than
    :func:`make_params`'s (updated in place)."""
    with precision(tf32):
        tc = recipe(config)
        field = RENIField(tc["field"])
        b, h, w, _ = corpus.shape
        directions = EquirectangularSampler(width=w)(device)
        targets = torch.as_tensor(np.asarray(corpus, np.float32).reshape(b, h * w, 3), device=device)
        params = make_params(config, b, seeds.weights, device) if params is None else params
        named = dict(tree_items(params))
        for t in named.values():
            t.requires_grad_(True)
        groups = [{"params": [t for k, t in named.items() if is_decoder(k)], "lr": tc["lr"]},
                  {"params": [t for k, t in named.items() if not is_decoder(k)], "lr": tc["latent_lr"]}]
        opt = torch.optim.Adam(groups, betas=ADAM_BETAS, eps=1e-8)
        start = {k: t.detach().cpu().clone() for k, t in named.items()}
        losses, grads = [], []
        for d in draws(config, b, h * w, pixels_per_step, seeds.draws, n_steps, device):
            d = fault_draws(d) if fault_draws else d
            opt.zero_grad()
            total = loss(field, tc, params, directions, targets, d)
            total.backward()
            if fault_grads:
                fault_grads(named)
            grads.append({k: t.grad.detach().cpu().clone() for k, t in named.items()})
            opt.step()
            losses.append(float(total.detach()))
        end = {k: t.detach().cpu().clone() for k, t in named.items()}
    return {"losses": losses, "grads": grads, "params": (start, end)}


def is_key_bias(path: str) -> bool:
    """A block's key bias: it shifts a head's logits alike for every token,
    which the softmax takes no notice of, so its true gradient is zero."""
    return path.endswith("/MultiHeadDotProductAttention_0/key/bias")


def compare(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, Any]:
    """``reference/train.py::compare``'s numbers, with each key bias held to
    its true gradient, zero: its reference gradient (round-off) is taken as
    exactly zero, so the program's is held by the median leaf's scale alone
    (``grad_gap``, ``grad_gap_later``); its change, which Adam makes of that
    round-off at a full step, is compared on neither side."""
    norms = leaf_norms(program, reference)
    for k, n in norms.items():
        if is_key_bias(k):
            n.update(g_ref=[0.0] * len(n["g_ref"]), d_ref=0.0, d_prog=0.0)
    out = leaf_numbers(norms)
    pl, rl = program["losses"], reference["losses"]
    if len(pl) != len(rl):
        raise ValueError(f"{len(pl)} program steps against {len(rl)} reference steps")
    out["loss_gap"] = max(abs(p - r) / max(abs(r), 1e-12) if p == p else float("inf") for p, r in zip(pl, rl))
    return out
