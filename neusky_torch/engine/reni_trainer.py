"""RENI++ prior training and frozen-decoder latent fits (mirror of
``neusky_tpu/engine/reni_trainer.py``).

:class:`RENITrainer` fits the sky decoder on a corpus of HDR
equirectangular skies as a variational autodecoder: one posterior (mean
``latents``, ``logvar``) per sky, z = μ + ε·σ drawn every step, the
normalised log-HDR reconstruction plus an analytic KL to N(0, I)
(``variational=False``: plain latents with an L2 pull).  The decoder and the
latents are two Adam groups.  :func:`fit_latents_to_envmaps` fits latents
to skies with the decoder frozen, as NeuSky consumes the prior (and as the
``nerf_osr_envmap`` eval mode takes its latents).

Randomness is explicit: a step's draws are ``img`` and ``pix`` ([P] image
and pixel indices) and, when variational, ``eps`` ([P, latent_dim, 3]
normals); a fit's are the [steps, P] pixel indices of each chunk of skies.
Whatever is not given is drawn from a ``torch.Generator`` seeded from the
config.

On the card a trainer step and a fit step each run as one CUDA graph
replay (``neusky_torch/parallel/graphs.py``), as JAX scans them in one jit
(``neusky_tpu/engine/reni_trainer.py:174``, ``:274``): the draws are made
before the replays, and the host reads the losses only at log records and
a fit's PSNRs once at its end.  ``graphed=False`` runs them eagerly.

Tracing (``neusky_torch/utils/profiling.py``, on after ``profiling.enable()``):
host spans ``reni.step`` (a :meth:`RENITrainer.train_step` call: the
static copies and the replay's launch) and ``reni.draws`` (:meth:`RENITrainer.
draw`); a step's device span ``reni_step``, timed on every replay, with
``reni_step/decode`` (z = μ + ε·σ, the featurisation and the decoder's
forward), ``reni_step/loss`` (the reconstruction and the KL),
``reni_step/backward`` and ``reni_step/adam``; and the counter
``reni.pixels``, the P (image, pixel) pairs of each step that ran, made
again on each replay.  With tracing off a step's graph has no more nodes
than without the spans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from neusky_torch.device import resolve_device
from neusky_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig
from neusky_torch.fields.reni import RENIField, RENIFieldConfig
from neusky_torch.parallel.graphs import CapturedStep, use_graph
from neusky_torch.sampling.illumination import EquirectangularSampler
from neusky_torch.tree import tree_leaves, tree_map
from neusky_torch.utils import profiling
from neusky_torch.utils.profiling import span

OPTAX_ADAM_EPS = 1e-8  # optax.adam's default
PIXELS = "reni.pixels"  # counter: (image, pixel) pairs of the training steps that ran


@dataclasses.dataclass(frozen=True)
class RENITrainerConfig:
    field: RENIFieldConfig = RENIFieldConfig(fixed_decoder=False)
    lr: float = 1e-4
    latent_lr: float = 1e-2
    kl_weight: float = 3e-3
    num_steps: int = 50000
    pixels_per_step: int = 2048
    steps_per_call: int = 100
    """Steps per chunk: the run advances, and logs, in whole chunks."""
    seed: int = 0
    variational: bool = True
    """Per-image (μ, logvar) posteriors and an analytic KL; False is an
    unregularised autodecoder (``kl_weight`` on ‖z‖²)."""
    logvar_init: float = 0.0
    """Initial per-image log-variance.  0 (σ = 1) lets early samples
    overlap at the origin, so the decoder learns a mean sky at z = 0."""


def _constant_adam(lr: float) -> OptimizerGroupConfig:
    return OptimizerGroupConfig(lr=lr, eps=OPTAX_ADAM_EPS, schedule="constant")


def psnr_normalised(mse: float) -> float:
    """PSNR in the normalised [-1, 1] domain (peak-to-peak 2)."""
    return 10.0 * float(np.log10(4.0 / max(mse, 1e-12)))


class RENITrainer:
    """Autodecoder training over ``envmaps`` [B, H, W, 3] (linear HDR, H =
    W / 2).  Entry point: runs on ``device`` (default CUDA; raises without
    a card unless ``device="cpu"``).  The corpus is copied to the device
    once.  ``graphed``: None captures the step as a CUDA graph on the card,
    False runs it eagerly, True raises on the CPU."""

    def __init__(self, config: RENITrainerConfig, envmaps: np.ndarray, device="cuda",
                 graphed: Optional[bool] = None):
        self.config = config
        self.device = resolve_device(device)
        b, h, w, _ = envmaps.shape
        self.num_images = b
        self.field = RENIField(config.field)
        self.directions = EquirectangularSampler(width=w)(self.device)  # [H·W, 3]
        self.targets = torch.as_tensor(np.asarray(envmaps, np.float32).reshape(b, h * w, 3), device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        lat = config.field.latent_dim
        self.params: Dict = {
            "decoder": self.field.init(self.generator, self.device),
            # the posterior means in variational mode, so every consumer of
            # "the latents" reads them the same way in both modes
            "latents": torch.zeros((b, lat, 3), device=self.device),
        }
        if config.variational:
            self.params["logvar"] = torch.full((b, lat, 3), config.logvar_init, device=self.device)
        self.optimizer = GroupedAdam(
            self.params, {"decoder": _constant_adam(config.lr), "latents": _constant_adam(config.latent_lr)},
            label_fn=lambda path: "decoder" if path.startswith("decoder/") else "latents",
        )
        self.step = 0
        self.history: List[dict] = []
        self._step_fn = lambda params, _, draws: self._train_step(draws)
        if use_graph(graphed, self.device):
            self._step_fn = CapturedStep(self._step_fn, self.optimizer)

    def draw(self) -> Dict[str, torch.Tensor]:
        """One step's draws from the trainer's generator."""
        c = self.config
        g, dev, p = self.generator, self.device, c.pixels_per_step
        with span("reni.draws"):
            d = {"img": torch.randint(0, self.num_images, (p,), generator=g, device=dev),
                 "pix": torch.randint(0, self.directions.shape[0], (p,), generator=g, device=dev)}
            if c.variational:
                d["eps"] = torch.randn((p, c.field.latent_dim, 3), generator=g, device=dev)
        return d

    def loss(self, draws: Dict[str, torch.Tensor]):
        """(total, {"recon", "kl"}) of one step: P (image, pixel) pairs, each
        with its own latent on the decoder's per-sample [P, D, 3] path."""
        c, p = self.config, self.params
        img, pix = draws["img"].long(), draws["pix"].long()
        with span("decode"):
            z = p["latents"][img]
            if c.variational:
                z = z + draws["eps"] * torch.exp(0.5 * p["logvar"][img])
            pred = self.field.apply(p["decoder"], self.directions[pix], z)["rgb"]
        with span("loss"):
            if c.variational:
                kl = -0.5 * torch.mean(1.0 + p["logvar"] - p["latents"] ** 2 - torch.exp(p["logvar"]))
            else:
                kl = torch.mean(p["latents"] ** 2)
            recon = torch.mean((pred - self.field.normalise(self.targets[img, pix])) ** 2)
            total = recon + c.kl_weight * kl
        return total, {"recon": recon, "kl": kl}

    def _train_step(self, draws) -> Dict[str, torch.Tensor]:
        with span("reni_step", self.device):
            profiling.count(PIXELS, draws["img"].shape[0])
            self.optimizer.zero_grad()
            total, aux = self.loss(draws)
            with span("backward"):
                total.backward()
            with span("adam"):
                self.optimizer.step()
            return {"recon": aux["recon"].detach(), "kl": aux["kl"].detach(), "total": total.detach()}

    def train_step(self, draws) -> Dict[str, torch.Tensor]:
        """One update from one step's draws (:meth:`draw`) → its detached
        ``recon``, ``kl`` and ``total``: a graph replay on the card."""
        with span("reni.step"):
            return self._step_fn(self.params, None, draws)

    def run(self, num_steps: Optional[int] = None, log_every: int = 500, log_fn=None,
            draws: Optional[Sequence[dict]] = None) -> List[dict]:
        """Train ``num_steps`` (default ``config.num_steps``) rounded up to
        whole chunks of ``steps_per_call`` (a ``note`` record says so).  A
        record (the step, and the last step's ``recon``, ``kl`` and
        ``total``) is kept every ``log_every // steps_per_call`` chunks and
        at the end.  ``draws``: one dict per step of this run (as
        :meth:`draw` makes), else a chunk's draws are made before its
        steps, in the order a step-by-step loop makes them."""
        requested = num_steps or self.config.num_steps
        per_call = self.config.steps_per_call
        if requested % per_call:
            requested = (requested // per_call + 1) * per_call
            if log_fn:
                log_fn({"note": f"rounded to {requested} steps (chunks of {per_call})"})
        start, target = self.step, self.step + requested
        while self.step < target:
            chunk = (draws[self.step - start:self.step - start + per_call] if draws is not None
                     else [self.draw() for _ in range(per_call)])
            for d in chunk:
                aux = self.train_step(d)
            self.step += per_call
            if (self.step // per_call) % max(1, log_every // per_call) == 0 or self.step >= target:
                rec = {"step": self.step, **{k: float(v) for k, v in aux.items()}}
                self.history.append(rec)
                if log_fn:
                    log_fn(rec)
        return self.history

    # ------------------------------------------------------------------
    # evaluation

    @torch.no_grad()
    def reconstruction_psnr(self, image_idx: int) -> float:
        """PSNR of the normalised log-HDR reconstruction of training sky
        ``image_idx`` from its (mean) latent."""
        out = self.field.apply(self.params["decoder"], self.directions, self.params["latents"][image_idx])
        gt = self.field.normalise(self.targets[image_idx])
        return psnr_normalised(float(torch.mean((out["rgb"] - gt) ** 2)))

    def fit_heldout_latents(self, envmaps: np.ndarray, steps: int = 400, lr: float = 1e-1,
                            pixels_per_step: int = 2048, seed: int = 1, sky_chunk: int = 4, pixel_draws=None,
                            graphed: Optional[bool] = None):
        """Latents fitted to held-out skies with this decoder frozen → (latents
        [B, D, 3], PSNR [B]): the prior's generalisation gate."""
        return fit_latents_to_envmaps(self.field, self.params["decoder"], envmaps, steps=steps, lr=lr,
                                      pixels_per_step=pixels_per_step, seed=seed, sky_chunk=sky_chunk,
                                      pixel_draws=pixel_draws, graphed=graphed)

    @torch.no_grad()
    def decode_envmap(self, latent, width: int = 128) -> np.ndarray:
        """Latent [D, 3] → HDR envmap [width / 2, width, 3]."""
        sampler = EquirectangularSampler(width=width)
        z = torch.as_tensor(latent, dtype=torch.float32).to(self.device)
        out = self.field.apply(self.params["decoder"], sampler(self.device), z)
        return self.field.unnormalise(out["rgb"]).cpu().numpy().reshape(sampler.height, width, 3)


def envmap_fit_loss(field: RENIField, decoder, dirs: torch.Tensor, z: torch.Tensor, targets: torch.Tensor,
                    pix: torch.Tensor) -> torch.Tensor:
    """The envmap fit's loss: the C skies' latents ``z`` [C, D, 3] decoded
    at the directions ``dirs[pix]`` (one batched decode of C·P samples,
    sky-major) against ``targets`` [C, H·W, 3] (normalised) at ``pix``."""
    c, p = z.shape[0], pix.shape[0]
    d = dirs[pix].repeat(c, 1)  # [C·P, 3], sky-major
    lat = z[:, None].expand(c, p, *z.shape[1:]).reshape(c * p, *z.shape[1:])
    pred = field.apply(decoder, d, lat)["rgb"].reshape(c, p, 3)
    return torch.mean((pred - targets[:, pix]) ** 2)


def make_envmap_fit_step(field: RENIField, decoder, dirs: torch.Tensor, z: torch.Tensor, targets: torch.Tensor,
                         lr: float, graphed: Optional[bool] = None):
    """(step_fn, optimizer): ``step_fn({"z": z}, None, pix)`` is one Adam
    update (lr ``lr``, optax's ε; capturable on the card) of the latents
    ``z`` on :func:`envmap_fit_loss` → the loss, detached; a CUDA graph
    replay on the card (``graphed`` None or True), reading ``z`` and
    ``targets`` where they lie."""
    opt = torch.optim.Adam([z], lr=lr, betas=(0.9, 0.999), eps=OPTAX_ADAM_EPS, capturable=z.device.type == "cuda")

    def step_fn(_, __, pix):
        loss = envmap_fit_loss(field, decoder, dirs, z, targets, pix)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    if use_graph(graphed, z.device):
        return CapturedStep(step_fn, opt), opt
    return step_fn, opt


def fit_latents_to_envmaps(
    field: RENIField,
    decoder_params,
    envmaps: np.ndarray,
    steps: int = 400,
    lr: float = 1e-1,
    pixels_per_step: int = 2048,
    seed: int = 1,
    sky_chunk: int = 4,
    pixel_draws: Optional[Sequence] = None,
    graphed: Optional[bool] = None,
):
    """Fit one latent per sky of ``envmaps`` [B, H, W, 3] (linear HDR, H =
    W / 2) with the decoder frozen, on the decoder's device → (latents
    [B, D, 3], PSNR [B] of the whole sky in the normalised domain).

    Skies go in host chunks of ``sky_chunk`` (the last padded with copies
    of its last sky, which are dropped), each from zero latents for
    ``steps`` Adam steps (lr ``lr``) of one batched decode over the
    chunk's C skies × ``pixels_per_step`` pixels.  Each sky's latent sees
    only its own pixels, so chunking does not change the fit; it bounds the
    [C·P, D, hidden] attention temporaries.  ``pixel_draws``: one [steps,
    P] index array per chunk; else chunk ``lo`` draws from a generator
    seeded ``seed + lo``.

    One latent buffer [C, D, 3] and one Adam state (optax's ε, capturable
    on the card) serve every chunk, zeroed in place before each, so on the
    card (``graphed`` None or True) one CUDA graph of a step serves the
    call; the latents and the PSNRs are read once at the end."""
    b, h, w, _ = envmaps.shape
    sampler = EquirectangularSampler(width=w)
    if sampler.height != h:
        raise ValueError(f"equirectangular envmaps must be H = W / 2, got {h} × {w}")
    decoder = tree_map(lambda t: t.detach(), decoder_params)
    dev = tree_leaves(decoder)[0].device
    dirs = sampler(dev)
    latent_dim = field.config.latent_dim
    n_pix, p = h * w, pixels_per_step
    c = min(sky_chunk, b)
    flat = np.asarray(envmaps, np.float32).reshape(b, n_pix, 3)
    z = torch.zeros((c, latent_dim, 3), device=dev, requires_grad=True)
    gt_all = torch.empty((c, n_pix, 3), device=dev)
    step_fn, opt = make_envmap_fit_step(field, decoder, dirs, z, gt_all, lr, graphed)
    zs, mses = [], []
    for chunk_i, lo in enumerate(range(0, b, c)):
        chunk = flat[lo:lo + c]
        keep = chunk.shape[0]
        if keep < c:
            chunk = np.concatenate([chunk, chunk[-1:].repeat(c - keep, 0)], 0)
        with torch.no_grad():
            gt_all.copy_(field.normalise(torch.as_tensor(chunk, device=dev)))  # [C, H·W, 3]
            z.zero_()
            for state in opt.state.values():  # a fresh Adam state, in place
                for t in state.values():
                    t.zero_()
        if pixel_draws is not None:
            pix_all = torch.as_tensor(np.asarray(pixel_draws[chunk_i]), device=dev).long()
        else:
            g = torch.Generator(device=dev).manual_seed(seed + lo)
            pix_all = torch.randint(0, n_pix, (steps, p), generator=g, device=dev)
        for s in range(steps):
            step_fn({"z": z}, None, pix_all[s])
        with torch.no_grad():
            for i in range(keep):
                pred = field.apply(decoder, dirs, z[i])["rgb"]
                mses.append(torch.mean((pred - gt_all[i]) ** 2))
        zs.append(z.detach()[:keep].clone())
    psnrs = [psnr_normalised(m) for m in torch.stack(mses).cpu().tolist()]
    return torch.cat(zs, 0).cpu().numpy(), np.asarray(psnrs, np.float32)
