"""The port's ``entry()`` (``neusky_torch/entry.py``) against JAX's
``__graft_entry__.entry()`` on the CPU: the eval-mode forward of the tiny
model from JAX's params (converted by ``neusky_torch/convert.py``) on JAX's
example rays and image indices gives JAX's rgb, depth, normal and
accumulation within 1e-4 of each output's largest magnitude; the tiny
configuration is JAX's field for field, and the port's own example
arguments have JAX's shapes."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from neusky_torch.core.rays import RayBundle
from neusky_torch.entry import entry, tiny_configs
from torch_parity import jax_to_torch_params, one_torch_thread, to_torch_config  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-4
NAMES = ("rgb", "depth", "normal", "accumulation")


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = graft.entry()
    return args, [np.asarray(o) for o in jax.jit(fn)(*args)]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def test_tiny_configs_are_jaxs():
    assert tiny_configs() == to_torch_config(graft._tiny_configs())


def test_entry_matches_jax(jax_entry):
    args_j, want = jax_entry
    fn, _ = entry("cpu")
    params_j, _, rb_j, image_indices, ray_image_idx = args_j
    rb = RayBundle(**{f.name: _t(getattr(rb_j, f.name)) for f in dataclasses.fields(RayBundle)})
    got = fn(jax_to_torch_params(params_j), torch.Generator().manual_seed(2), rb, _t(image_indices),
             _t(ray_image_idx))
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) <= REL * scale, (name, float(np.abs(g - w).max()) / scale)


def test_entry_example_args_have_jaxs_shapes(jax_entry):
    args_j, want = jax_entry
    fn, args = entry("cpu")
    assert args[0].keys() == args_j[0].keys()
    assert [tuple(x.shape) for x in args[3:]] == [tuple(np.shape(x)) for x in args_j[3:]]
    assert args[2].origins.shape == args_j[2].origins.shape
    out = fn(*args)
    assert [tuple(o.shape) for o in out] == [w.shape for w in want]
    assert all(torch.isfinite(o).all() for o in out)
