"""Checkpoints with sub-tree restore, and the frozen RENI++ prior (mirror of
``neusky_tpu/engine/checkpoint.py``).

Layout, as in JAX: ``<base>/checkpoints/step-%09d/`` per saved step and
``<base>/latest.json`` naming the newest.  The file format is the port's
own: ``state.pt`` holds host copies of ``{params, opt_state, step}``
written with ``torch.save`` and read back with
``torch.load(weights_only=True)``.  JAX (orbax) checkpoints and the port's
do not read each other; ``convert.py`` carries parameters from JAX to the
port.

The JAX package keeps its priors as orbax checkpoints.  The port reads its
own prior file: a flat npz holding the ``illumination_decoder`` tree under
its flax paths (``illumination_decoder/params/decoder/...``) and, where the
prior ships one, the fitted mean-sky latent under ``init_latent``.  It is
looked for first in ``illumination_prior_dir`` itself (``reni_prior.npz``,
which ``neusky_torch/tools/train_reni_prior.py`` writes; a relative
directory is taken from the repository root, as in JAX), then among the
bundled conversions of the repository's orbax priors,
``neusky_torch/assets/<prior dir name>.npz``.  Every training entry point
calls :func:`load_illumination_prior` after ``model.init`` — without it the
model trains against a random frozen decoder.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from neusky_torch.tree import tree_items, unflatten

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
ASSETS = REPO_ROOT / "neusky_torch" / "assets"
STATE_FILE = "state.pt"
PRIOR_FILE = "reni_prior.npz"


def _ckpt_dir(base: Path, step: int) -> Path:
    return Path(base) / "checkpoints" / f"step-{step:09d}"


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_checkpoint(base: Path, step: int, params, opt_state) -> Path:
    """Write ``{params, opt_state, step}`` (host copies) for ``step`` and
    point ``latest.json`` at it."""
    base = Path(base)
    path = _ckpt_dir(base, step)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"params": _to_host(params), "opt_state": _to_host(opt_state), "step": int(step)},
               path / STATE_FILE)
    (base / "latest.json").write_text(json.dumps({"step": int(step)}))
    return path


def latest_step(base: Path) -> Optional[int]:
    f = Path(base) / "latest.json"
    if not f.exists():
        return None
    return json.loads(f.read_text())["step"]


def _read(base: Path, step: Optional[int], device) -> Tuple[dict, int]:
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {base}")
    state = torch.load(_ckpt_dir(base, step) / STATE_FILE, weights_only=True, map_location=device)
    return state, step


def load_checkpoint(base: Path, step: Optional[int], params_template, opt_state_template) -> Tuple[Any, Any, int]:
    """Full restore (resume) onto the template's device: → (params,
    opt_state, step).  The params must match the template leaf for leaf in
    structure and shape; the restored leaves keep the template's
    ``requires_grad``."""
    device = next(iter(tree_items(params_template)))[1].device
    state, step = _read(base, step, device)
    mismatch = _subtree_mismatch(params_template, state["params"])
    if mismatch is not None:
        raise ValueError(f"checkpoint {base} step {step} does not match the model: {mismatch}")
    template = dict(tree_items(params_template))
    params = unflatten({k: v.requires_grad_(template[k].requires_grad) for k, v in tree_items(state["params"])})
    return params, state["opt_state"], state["step"]


def resume_into(base: Path, step: Optional[int], params, optimizer) -> int:
    """Resume: the checkpoint's params copied into ``params`` in place (the
    optimizer holds those tensors) and its state into ``optimizer`` (a
    ``GroupedAdam``) → the step."""
    restored, opt_state, step = load_checkpoint(base, step, params, optimizer.state_dict())
    restored = dict(tree_items(restored))
    with torch.no_grad():
        for k, t in tree_items(params):
            t.copy_(restored[k])
    optimizer.load_state_dict(opt_state)
    return step


def load_param_subtrees(
    base: Path,
    step: Optional[int],
    params: Dict[str, Any],
    include: Tuple[str, ...] = (),
    exclude: Tuple[str, ...] = (),
    reinit_on_mismatch: Tuple[str, ...] = ("eval_latents",),
) -> Dict[str, Any]:
    """Merge top-level groups of a checkpoint into ``params`` (on their
    device): ``include`` names them (all when empty), ``exclude`` leaves
    some out — decoder only ``include=("illumination_decoder",)``, model
    minus visibility ``exclude=("ddf_field",)``, DDF only
    ``include=("ddf_field",)``.  A group whose structure or leaf shapes
    differ from ``params`` raises, except groups in ``reinit_on_mismatch``
    (the eval latents, sized by the eval split and refit by the eval loop),
    which keep the template."""
    device = next(iter(tree_items(params)))[1].device
    src = _read(base, step, device)[0]["params"]
    out = dict(params)
    keys = include if include else tuple(k for k in src if k not in exclude)
    for k in keys:
        if k not in src:
            continue
        mismatch = _subtree_mismatch(params[k], src[k]) if k in params else None
        if mismatch is not None:
            if k in reinit_on_mismatch:
                print(f"checkpoint subtree '{k}' shape-mismatches the model ({mismatch}) — keeping the "
                      "fresh template (it is refit by the eval loop)", file=sys.stderr)
                continue
            raise ValueError(f"checkpoint subtree '{k}' does not match the model: {mismatch}")
        out[k] = src[k]
    return out


def _flat(tree) -> Dict[str, Any]:
    return dict(tree_items(tree)) if isinstance(tree, dict) else {"": tree}


def _subtree_mismatch(target, restored) -> Optional[str]:
    """None if ``restored`` matches ``target`` in structure and leaf
    shapes, else a description of the first difference."""
    t, r = _flat(target), _flat(restored)
    if sorted(t) != sorted(r):
        return f"tree structure {sorted(r)} != expected {sorted(t)}"
    for k, tl in t.items():
        ts, rs = tuple(getattr(tl, "shape", ())), tuple(getattr(r[k], "shape", ()))
        if ts != rs:
            return f"leaf {k or '<root>'} shape {rs} != expected {ts}"
    return None


def prior_asset_path(model_config) -> Optional[Path]:
    """The configured prior's file: ``<illumination_prior_dir>/reni_prior.npz``
    when the directory holds one, else the bundled
    ``assets/<dir name>.npz``; None when no prior is configured."""
    prior_dir = getattr(model_config, "illumination_prior_dir", None)
    if not prior_dir:
        return None
    path = Path(prior_dir)
    if not path.is_absolute():
        path = REPO_ROOT / path
    own = path / PRIOR_FILE
    return own if own.exists() else ASSETS / f"{path.name}.npz"


def save_prior(prior_dir: Path, decoder_params, init_latent=None) -> Path:
    """Write a decoder tree (``{"params": {"decoder": ...}}``) and an
    optional mean-sky latent [latent_dim, 3] as ``<prior_dir>/reni_prior.npz``,
    the file :func:`load_illumination_prior` reads."""
    prior_dir = Path(prior_dir)
    prior_dir.mkdir(parents=True, exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() for k, v in tree_items({"illumination_decoder": decoder_params})}
    if init_latent is not None:
        arrays["init_latent"] = np.asarray(init_latent, np.float32)
    np.savez(prior_dir / PRIOR_FILE, **arrays)
    return prior_dir / PRIOR_FILE


def prior_init_latent(model_config) -> Optional[np.ndarray]:
    """The configured prior's fitted mean-sky latent [latent_dim, 3], or
    None when no prior is configured or it ships none.  Every latent fit
    starts from it: the in-framework prior decodes z = 0 out of its domain
    (a saturated sky on which the fit loss is flat)."""
    path = prior_asset_path(model_config)
    if path is None or not path.exists():
        return None
    with np.load(path) as z:
        return z["init_latent"] if "init_latent" in z.files else None


def load_illumination_prior(params: Dict[str, Any], model_config, init_latent: bool = True) -> Dict[str, Any]:
    """Replace ``params["illumination_decoder"]`` with the configured prior
    and (``init_latent``) seed ``train_latents`` / ``eval_latents`` with its
    mean-sky latent.  No-op when no prior is configured; raises when one is
    configured but neither its directory nor the bundled assets hold its
    file, or the file does not fit (JAX only warns, and a run then trains
    against a random decoder)."""
    path = prior_asset_path(model_config)
    if path is None:
        return params
    if not path.exists():
        raise FileNotFoundError(f"illumination prior {model_config.illumination_prior_dir!r}: no {PRIOR_FILE} "
                                f"there and no bundled {path}")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    template = dict(tree_items({"illumination_decoder": params["illumination_decoder"]}))
    device = next(iter(template.values())).device
    decoder_flat = {}
    for key, ref in template.items():
        if key not in arrays or tuple(arrays[key].shape) != tuple(ref.shape):
            got = None if key not in arrays else arrays[key].shape
            raise ValueError(f"prior {path}: {key} is {got}, the model wants {tuple(ref.shape)}")
        decoder_flat[key] = torch.from_numpy(arrays[key]).to(device)
    params = dict(params)
    params["illumination_decoder"] = unflatten(decoder_flat)["illumination_decoder"]
    print(f"loaded RENI++ prior decoder from {path}", file=sys.stderr)
    if init_latent and "init_latent" in arrays:
        z0 = torch.from_numpy(arrays["init_latent"]).to(device)
        for group, key in (("illumination_field", "train_latents"), ("eval_latents", "eval_latents")):
            cur = params[group][key]
            if tuple(cur.shape[1:]) != tuple(z0.shape):
                print(f"WARNING: init_latent shape {tuple(z0.shape)} != {key} slot "
                      f"shape {tuple(cur.shape[1:])} — keeping zero init", file=sys.stderr)
                continue
            params[group] = {**params[group], key: z0[None].expand_as(cur).clone().to(cur.dtype)}
        print("seeded sky latents from the prior's init_latent", file=sys.stderr)
    return params
