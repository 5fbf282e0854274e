"""Shared helpers for the ``test_torch_*`` parity tests: JAX params and
configs → the port's, and the JAX key tree of one training step → the
port's explicit draws (the scene half and the DDF half)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_torch.convert import convert_params
from neusky_torch.data.dataparsers import custom_synthetic as t_cs
from neusky_torch.data.dataparsers import nerfosr as t_osr
from neusky_torch.engine import optimizers as t_opt
from neusky_torch.engine import trainer as t_trainer
from neusky_torch.fields import ddf as t_ddf
from neusky_torch.fields import density_field as t_df
from neusky_torch.fields import reni as t_reni
from neusky_torch.fields import sdf_albedo as t_sdf
from neusky_torch.models import ddf_model as t_ddf_model
from neusky_torch.models import neusky as t_neusky
from neusky_torch.models import pipeline as t_pipe
from neusky_torch.ops import hashgrid as t_hash
from neusky_torch.sampling import ddf_sampler as t_ddf_sampler
from neusky_torch.sampling import proposal as t_prop

TORCH_CONFIGS = {
    cls.__name__: cls
    for cls in (
        t_hash.HashGridConfig, t_df.DensityFieldConfig, t_sdf.SDFAlbedoFieldConfig,
        t_reni.RENIFieldConfig, t_prop.ProposalSamplerConfig, t_neusky.LossInclusions,
        t_neusky.NeuSkyModelConfig, t_pipe.PipelineConfig, t_opt.OptimizerGroupConfig,
        t_ddf.DDFFieldConfig, t_ddf_model.DDFLossConfig, t_ddf_model.DDFModelConfig,
        t_ddf_sampler.DDFSamplerConfig, t_trainer.TrainerConfig,
        t_osr.NeRFOSRDataparserConfig, t_cs.CustomSyntheticDataparserConfig,
    )
}

# JAX config fields the port leaves out, as nothing reads them:
# ``TrainerConfig.mixed_precision`` is read by neither trainer
LEFT_OUT_FIELDS = {("TrainerConfig", "mixed_precision")}


def to_torch_config(obj):
    """A JAX config dataclass (recursively) → the port's class of the same
    name, field for field (a left-out field must hold its default)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        kept = {}
        for f in dataclasses.fields(obj):
            if (name, f.name) in LEFT_OUT_FIELDS:
                assert getattr(obj, f.name) == f.default, (name, f.name)
                continue
            kept[f.name] = to_torch_config(getattr(obj, f.name))
        return TORCH_CONFIGS[name](**kept)
    if isinstance(obj, tuple):
        return tuple(to_torch_config(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_torch_config(v) for k, v in obj.items()}
    return obj


def flat_jax(tree, prefix=""):
    """Nested dict of arrays → ``{"a/b/c": np.ndarray}``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat_jax(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def jax_to_torch_params(params, device="cpu"):
    return convert_params(flat_jax(params), device=device)


def u32_tensor(x) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x).astype(np.uint32)), dtype=torch.int64)


def jax_scene_draws(cfg_j, rng, n_rays: int) -> dict:
    """The draws that ``neusky_tpu`` ``train_loss_fn(rng)`` makes in its
    scene half, re-derived from the same key tree:
    train_loss_fn → split(2)[0] → forward split(4) → proposal split(3),
    density_fns split(2) of k_stoch, ``_field_salt(k_stoch)``, the light
    rotation normal(k_illum, 4) and ``_hashgrid_density_samples(k_grid)``."""
    return jax_forward_draws(cfg_j, jax.random.split(rng)[0], n_rays)


def jax_forward_draws(cfg_j, rng, n_rays: int) -> dict:
    """The draws of ``neusky_tpu`` ``NeuSkyModel.forward(rng, train=True)``
    over ``n_rays`` rays (its key tree: split(4) into the proposal,
    illumination, density-grid and stochastic-gradient keys)."""
    k_prop, k_illum, k_grid, k_stoch = jax.random.split(rng, 4)
    prop = cfg_j.proposal
    nit = len(prop.num_proposal_samples)
    pkeys = jax.random.split(k_prop, nit + 1)
    skeys = jax.random.split(k_stoch, len(cfg_j.proposal_fields))
    t = lambda a: torch.from_numpy(np.asarray(a))
    draws = {
        "proposal_jitters": [t(jax.random.uniform(pkeys[i], (n_rays, 1))) for i in range(nit + 1)],
        "proposal_stoch_u": [
            t(jax.random.uniform(skeys[i], (n_rays * s,)))
            for i, s in enumerate(prop.num_proposal_samples)
        ],
        "sdf_salt": u32_tensor(jax.random.bits(k_stoch, dtype=jnp.uint32)),
        "light_rotation": t(jax.random.normal(k_illum, (4,))),
    }
    res = cfg_j.losses.hashgrid_density_grid_resolution
    k1, k2 = jax.random.split(k_grid)
    draws["grid_jitter"] = t(jax.random.uniform(k1, (res**3, 3)))
    draws["grid_dirs"] = t(jax.random.normal(k2, (res**3, 3)))
    draws["grid_salt"] = u32_tensor(jax.random.bits(jax.random.split(k2)[0], dtype=jnp.uint32))
    return draws


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def jax_sphere_uniforms(rng, n: int):
    """The uniforms of ``random_points_on_unit_sphere(rng, n)``."""
    k_t, k_p = jax.random.split(rng)
    return _t(jax.random.uniform(k_t, (n,))), _t(jax.random.uniform(k_p, (n,)))


def jax_vmf_draws(rng, sampler) -> dict:
    """The draws of ``vmf_ddf_samples(rng, sampler)``: the sphere points'
    uniforms from ``split(rng)[0]``, then ``sample_vmf(split(rng)[1])``'s
    uniforms in [1e-7, 1) and tangent normals."""
    p, m = sampler.num_samples_on_sphere, sampler.num_rays_per_sample
    k_p, k_d = jax.random.split(rng)
    k_u, k_t = jax.random.split(k_d)
    return {
        "sphere_u": jax_sphere_uniforms(k_p, p),
        "vmf_u": _t(jax.random.uniform(k_u, (p, m), minval=1e-7, maxval=1.0)),
        "vmf_z": _t(jax.random.normal(k_t, (p, m, 3))),
    }


def jax_gt_draws(cfg_j, rng, n_rays: int) -> dict:
    """The draws of ``generate_ddf_ground_truth(rng)`` (stop_gradients
    off): ``split(rng)[1]`` = k_stoch → the proposal fields' ``stoch_u``
    and the SDF salt."""
    _, k_stoch = jax.random.split(rng)
    skeys = jax.random.split(k_stoch, len(cfg_j.proposal_fields))
    return {
        "proposal_stoch_u": [_t(jax.random.uniform(skeys[i], (n_rays * s,)))
                             for i, s in enumerate(cfg_j.proposal.num_proposal_samples)],
        "sdf_salt": u32_tensor(jax.random.bits(k_stoch, dtype=jnp.uint32)),
    }


def jax_ddf_draws(cfg_j, pcfg_j, rng) -> dict:
    """The draws that ``neusky_tpu`` ``train_loss_fn(rng)`` makes in its
    DDF half (unfused), re-derived from the same key tree:
    train_loss_fn → split(2)[1] = k_ddf → split(k_ddf, 3) = (k_vis_sample,
    k_vis_gt, k_ddf'); the vMF rays from k_vis_sample, the GT pass from
    k_vis_gt, and the multi-view sphere points from split(k_ddf')[0]
    (``ddf_train_outputs``).  Goes under ``draws["ddf"]``."""
    _, k_ddf = jax.random.split(rng)
    k_vis_sample, k_vis_gt, k3 = jax.random.split(k_ddf, 3)
    s = pcfg_j.visibility_train_sampler
    n = s.num_samples_on_sphere * s.num_rays_per_sample
    return {
        "vmf": jax_vmf_draws(k_vis_sample, s),
        "gt": jax_gt_draws(cfg_j, k_vis_gt, n),
        "multi_view_u": jax_sphere_uniforms(jax.random.split(k3)[0], n),
    }


def max_rel_err(a, b) -> float:
    """max |a − b| / max(max |b|, tiny) — one scale per array."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch CPU work on one thread: its tiny shapes gain
    nothing from more, and the test workers share the machine's cores
    (eight threads a worker spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
