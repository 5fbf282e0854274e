"""The test-time eval-latent fit of the PyTorch port against the JAX
package, on the CPU, in the setting of ``test_torch_eval.py`` (tiny joint
config, canonical RENI++ decoder and prior, 2 eval slots, 2 × 16 region
rays a step): five Adam steps on the same region batches, the loss trace
and the fitted eval group to 1e-4 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.engine import eval_loop as j_eval

from neusky_torch.engine import checkpoint as t_ckpt
from neusky_torch.engine import eval_loop as t_eval
from neusky_torch.tree import tree_items
from test_torch_eval import RTOL, _count_scatters, eval_setup, make_datamanagers
from torch_parity import flat_jax, max_rel_err, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIT_STEPS = 5


@pytest.fixture(scope="module")
def setup():
    return eval_setup()


FIT_CASES = {
    "every_slot_auto_init": dict(init_latent="auto"),
    "slot_1_zero_init": dict(image_idx=1, init_latent=None),
    "scale_only_array_init": dict(scale_only=True, init_latent="array"),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_eval_latents_matches_jax(setup, case, monkeypatch):
    """Five fit steps on the same region batches (the default round-robin
    over both eval slots, or one slot): the loss trace and the fitted eval
    group agree with JAX's; the port's per-step reference loop
    (``host_loop``) agrees with its default path; the input params are
    untouched and no hash-table gradient is scattered."""
    jm, tm, pj, pt = setup["jm"], setup["tm"], setup["params_j"], setup["params_t"]
    kw = dict(FIT_CASES[case])
    if kw["init_latent"] == "array":
        kw["init_latent"] = (0.5 * np.random.default_rng(9).normal(size=(100, 3))).astype(np.float32)
    jdm, tdm = make_datamanagers()
    fit_j, losses_j = j_eval.fit_eval_latents(jm, pj, jdm, jax.random.PRNGKey(4), steps=FIT_STEPS, **kw)
    before = {k: v.clone() for k, v in tree_items(pt)}
    calls = _count_scatters(monkeypatch)
    fit_t, losses_t = t_eval.fit_eval_latents(tm, pt, tdm, steps=FIT_STEPS, **kw)
    assert calls == [] and all(torch.equal(before[k], v) for k, v in tree_items(pt))
    np.testing.assert_allclose(losses_t, losses_j, rtol=RTOL)
    assert losses_t[-1] != losses_t[0]
    gj = flat_jax(fit_j)
    for k, v in tree_items(fit_t):
        if k.startswith("eval_latents/"):
            assert max_rel_err(v.detach().numpy(), gj[k]) < RTOL, (k, max_rel_err(v.detach().numpy(), gj[k]))
    init = kw["init_latent"]
    reset = t_eval._eval_fit_params(pt, t_ckpt.prior_init_latent(tm.config) if isinstance(init, str) else init)
    reset = reset["eval_latents"]
    moved = {k for k, v in fit_t["eval_latents"].items() if not torch.equal(v, reset[k])}
    assert moved == ({"eval_scale"} if kw.get("scale_only") else {"eval_latents", "eval_scale"})
    ref_t, ref_losses = t_eval.fit_eval_latents(tm, pt, make_datamanagers()[1], steps=FIT_STEPS, host_loop=True, **kw)
    np.testing.assert_allclose(ref_losses, losses_t, rtol=1e-6)
    for k, v in tree_items(ref_t["eval_latents"]):
        np.testing.assert_allclose(v.detach().numpy(), fit_t["eval_latents"][k].detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("scale_only", [False, True], ids=["eval_group", "scale_only"])
def test_eval_latent_optimizer_matches_optax(scale_only):
    """Three updates with seeded gradients: the eval group moves as JAX's
    masked Adam (exponential decay 1e-1 → 1e-7 over 250 steps, at optax's
    count) moves it; ``scale_only`` moves ``eval_scale`` alone; nothing
    else moves."""
    from neusky_tpu.engine.optimizers import build_eval_latent_optimizer as j_build

    from neusky_torch.engine.optimizers import build_eval_latent_optimizer as t_build

    g = np.random.default_rng(0)
    arrays = {"eval_latents": {"eval_latents": g.normal(size=(2, 4, 3)), "eval_scale": g.normal(size=2),
                               "eval_rotation": g.normal(size=2)},
              "fields": {"w": g.normal(size=3)}}
    grads = [{k: {kk: g.normal(size=vv.shape) for kk, vv in v.items()} for k, v in arrays.items()} for _ in range(3)]
    to_j = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    pj = to_j(arrays)
    opt_j = j_build(scale_only=scale_only)
    state = opt_j.init(pj)
    pt = {k: {kk: torch.tensor(vv, dtype=torch.float32) for kk, vv in v.items()} for k, v in arrays.items()}
    opt_t = t_build(pt, scale_only=scale_only)
    for gr in grads:
        updates, state = opt_j.update(to_j(gr), state, pj)
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, updates)
        opt_t.zero_grad()
        for k, v in pt.items():
            for kk, t in v.items():
                if t.requires_grad:
                    t.grad = torch.tensor(gr[k][kk], dtype=torch.float32)
        opt_t.step()
    moved = set()
    for k, v in pt.items():
        for kk, t in v.items():
            # optax forms 1 - β₂ in float32: its Adam steps are 1 - 6.7e-6 of torch's
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(pj[k][kk]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{k}/{kk}")
            if not np.allclose(t.detach().numpy(), arrays[k][kk]):
                moved.add(kk)
    assert moved == ({"eval_scale"} if scale_only else {"eval_latents", "eval_scale", "eval_rotation"})
