"""The port's bf16 products, ``dots`` recompute and chunked level-set query
against the JAX package (and against themselves), on the CPU:

- ``nets/bf16.py::bf16_matmul`` against ``jnp.dot`` of bf16 inputs with a
  float32 result, values and the bf16-rounded input cotangents;
- FiLM-SIREN with the bf16 mapping network, with and without per-layer
  heads (JAX ``mapping_compute_dtype``, ``per_layer_mapping_heads``);
- the SDF field with ``use_bf16_compute`` (JAX ``WNDense.compute_dtype``):
  SDF, analytic gradient, normals, and the eikonal loss's parameter
  gradients through the hand-carried bf16 tangents;
- ``_chunked_apply(remat_policy="dots")`` against ``"full"``;
- the level-set SDF query in chunks (``sdf_query_chunk``) against the
  query in one piece.

Tolerances.  Both sides round the same float32 numbers to bfloat16, but a
float32 sum a few ulps apart (another summation order) can round to the
neighbouring bfloat16 value, a step of 2⁻⁸ relative.  Where that rounding
feeds a value (the mapping outputs, the SDF MLP's activations) one flip
moves it by up to 2⁻⁸ of its size; each test states the bound it holds and
the value it reached.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neusky_tpu.fields.sdf_albedo import SDFAlbedoField as JSDF, SDFAlbedoFieldConfig
from neusky_tpu.models.neusky import _chunked_apply as j_chunked_apply
from neusky_tpu.nets import siren as js
from neusky_tpu.ops.hashgrid import HashGridConfig

from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.fields.sdf_albedo import SDFAlbedoField as TSDF
from neusky_torch.models import neusky as t_neusky
from neusky_torch.nets import siren as ts
from neusky_torch.nets.bf16 import bf16_matmul
from neusky_torch.tree import tree_items
from test_torch_fields import _ray_samples
from test_torch_joint_slice import _ray_samples as vis_ray_samples
from torch_parity import flat_jax, jax_to_torch_params, max_rel_err, one_torch_thread, to_torch_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HASH = HashGridConfig(num_levels=4, features_per_level=2, log2_hashmap_size=12, base_res=4, max_res=64)
BF16_STEP = 2.0**-8


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _trainable(params):
    for _, v in tree_items(params):
        v.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# nets/bf16.py


def test_bf16_matmul_matches_jax_bf16_dot():
    """Values: the same exact products summed in float32 (1e-6 relative;
    reached 9.5e-7 absolute on sums of 40 products of normal draws).
    Cotangents: JAX rounds the cotangent of each bf16 input to bfloat16,
    and so does the port; a rounding flip would be one bf16 step (reached:
    equal)."""
    a, b, g = _rand((33, 40), 0), _rand((40, 17), 1), _rand((33, 17), 2)

    def f(a_, b_):
        return jnp.dot(a_.astype(jnp.bfloat16), b_.astype(jnp.bfloat16), preferred_element_type=jnp.float32)

    out_j, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(b))
    da_j, db_j = vjp(jnp.asarray(g))
    ta, tb = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    out_t = bf16_matmul(ta, tb)
    out_t.backward(torch.from_numpy(g))
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)
    for got, want in ((ta.grad, da_j), (tb.grad, db_j)):
        got, want = got.numpy(), np.asarray(want, np.float32)
        assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))  # bf16-rounded
        np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=1e-30)


def test_bf16_matmul_takes_leading_dims():
    """[3, M, K] tangents (the SDF MLP's) multiply as three [M, K] blocks."""
    a, b = torch.from_numpy(_rand((3, 11, 8), 3)), torch.from_numpy(_rand((8, 5), 4))
    want = torch.stack([bf16_matmul(x, b) for x in a])
    torch.testing.assert_close(bf16_matmul(a, b), want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# FiLM-SIREN with the bf16 mapping network


FILM = dict(hidden_layers=3, hidden_features=32, mapping_network_layers=2, mapping_network_features=32, out_dim=2)


def _film_inputs():
    return _rand((96, 15), 5, 0.5), _rand((96, 15), 6, 0.5)


def _film_pair(heads: bool):
    net_j = js.FiLMSiren(**FILM, compute_dtype=jnp.bfloat16, mapping_compute_dtype=jnp.bfloat16,
                         per_layer_mapping_heads=heads)
    x, cond = _film_inputs()
    pj = net_j.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(cond))
    net_t = ts.FiLMSiren(3, 32, 2, 32, 2, bf16=True, mapping_bf16=True, per_layer_heads=heads)
    return net_j, pj, net_t


@pytest.mark.parametrize("heads", [False, True], ids=["one_head", "per_layer_heads"])
def test_film_siren_bf16_mapping_matches_jax(heads):
    """Outputs to 2e-3 absolute on outputs of scale ~0.2 and gradients to
    5e-3 of each array's scale: a mapping output a few float32 ulps apart
    from JAX's may round to the neighbouring bfloat16 value, which moves
    its frequency 15·f by up to 15·2⁻⁸·|f|.  Reached: outputs 3.0e-8 on a
    scale of 0.25, gradients ≤ 1.5e-7 of scale (no output rounds
    differently at this size)."""
    net_j, pj, net_t = _film_pair(heads)
    x, cond = _film_inputs()
    pt = _trainable(jax_to_torch_params(pj["params"]))
    out_t = net_t(pt, torch.from_numpy(x), torch.from_numpy(cond))
    out_j = np.asarray(net_j.apply(pj, jnp.asarray(x), jnp.asarray(cond)))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=2e-3)
    gj = flat_jax(jax.grad(lambda p: jnp.sum(net_j.apply({"params": p}, jnp.asarray(x), jnp.asarray(cond)) ** 2))(
        pj["params"]))
    torch.sum(out_t**2).backward()
    for k, v in tree_items(pt):
        assert max_rel_err(v.grad.numpy(), gj[k]) < 5e-3, (k, max_rel_err(v.grad.numpy(), gj[k]))


def test_mapping_network_bf16_outputs_are_bfloat16():
    net = ts.MappingNetwork(2, 16, 2 * 3 * 8, head_block=8, bf16=True)
    p = net.init(7, torch.Generator().manual_seed(0), "cpu")
    pairs = net(p, torch.from_numpy(_rand((10, 7), 8)))
    assert len(pairs) == 3 and all(t.dtype == torch.bfloat16 for pair in pairs for t in pair)


@pytest.mark.parametrize("mapping_bf16", [False, True], ids=["fp32_mapping", "bf16_mapping"])
def test_film_siren_heads_on_equals_heads_off(mapping_bf16):
    """Per-layer heads are column blocks of the same ``kernel_out``: the
    port's outputs with them equal its outputs without them bit for bit,
    and so do the gradients of the heads and the FiLM layers.  The mapping
    trunk's gradients differ only by rounding: its cotangent is the sum of
    the heads' cotangents, and with the bf16 mapping each head's is
    rounded to bfloat16 before the sum (one product's is rounded once,
    after it), as in JAX.  Bounds: 1e-6 of scale in float32, 1e-2 with the
    bf16 mapping (ten roundings of 2⁻⁹ each); reached 4.6e-7 and 5.5e-3."""
    x, cond = (torch.from_numpy(a) for a in _film_inputs())
    outs = {}
    for heads in (False, True):
        net = ts.FiLMSiren(3, 32, 2, 32, 2, bf16=True, mapping_bf16=mapping_bf16, per_layer_heads=heads)
        p = _trainable(net.init(15, 15, torch.Generator().manual_seed(1), "cpu"))
        out = net(p, x, cond)
        torch.sum(out**2).backward()
        outs[heads] = (out.detach(), {k: v.grad for k, v in tree_items(p)})
    assert torch.equal(outs[True][0], outs[False][0])
    trunk = [k for k in outs[False][1] if k.startswith("MappingNetwork_0/") and not k.endswith("_out")]
    assert len(trunk) == 4
    for k, g in outs[False][1].items():
        if k in trunk:
            assert max_rel_err(outs[True][1][k].numpy(), g.numpy()) < (1e-2 if mapping_bf16 else 1e-6), k
        else:
            assert torch.equal(outs[True][1][k], g), k


# ---------------------------------------------------------------------------
# the SDF field with use_bf16_compute


def test_sdf_field_bf16_compute_matches_jax():
    """SDF, analytic gradient, normals and albedo, and the parameter
    gradients of the eikonal loss plus a colour term.  The tangents are
    rounded to bfloat16 at each product, as JAX's ``jax.linearize`` of the
    bf16 MLP rounds them.  Bounds: values 2e-3 of scale (an activation
    rounding one bf16 step apart moves the next layer's products by 2⁻⁸ of
    their size), gradients 1e-2 of scale (each kernel's cotangent is
    rounded to bfloat16, as in JAX, and one rounding flip moves an element
    by up to 2⁻⁷ of it); reached: values ≤ 2.4e-7 of scale, gradients
    6.2e-3 (``geo_2``'s kernel; the float32 field's SDF differs from the
    bf16 one by 6.0e-3 of scale)."""
    cfg_j = SDFAlbedoFieldConfig(num_layers=2, hidden_dim=32, geo_feat_dim=16, num_layers_color=2,
                                 hidden_dim_color=32, bias=0.3, hash=HASH, use_bf16_compute=True)
    jf, tf = JSDF(cfg_j), TSDF(to_torch_config(cfg_j))
    params_j = jf.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)))
    k0 = params_j["params"]["geo_0"]["kernel"]
    params_j["params"]["geo_0"]["kernel"] = k0 + 0.05 * jax.random.normal(jax.random.PRNGKey(1), k0.shape)
    table = params_j["params"]["hash_table"]
    params_j["params"]["hash_table"] = 0.1 * jax.random.normal(jax.random.PRNGKey(2), table.shape)
    rs_j, rs_t = _ray_samples()

    def loss(p):
        out = jf.apply(p, rs_j, True, 1.0, None, method=jf.field_outputs)
        eik = jnp.mean((jnp.sqrt(jnp.sum(out["gradient"] ** 2, -1) + 1e-12) - 1.0) ** 2)
        return eik + jnp.mean(out["albedo"] * out["alpha"]), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)
    params_t = _trainable(jax_to_torch_params(params_j))
    out_t = tf.field_outputs(params_t, rs_t, True, 1.0, None)
    eik = torch.mean((torch.sqrt(torch.sum(out_t["gradient"] ** 2, -1) + 1e-12) - 1.0) ** 2)
    (eik + torch.mean(out_t["albedo"] * out_t["alpha"])).backward()
    for k in ("sdf", "gradient", "normal", "albedo", "alpha"):
        assert max_rel_err(out_t[k].detach().numpy(), out_j[k]) < 2e-3, k
    gj = flat_jax(g_j)
    for k, v in tree_items(params_t):
        assert max_rel_err(v.grad.numpy(), gj[k]) < 1e-2, (k, max_rel_err(v.grad.numpy(), gj[k]))
    # and the field did round: the float32 field gives another SDF
    f32 = TSDF(dataclasses.replace(tf.config, use_bf16_compute=False))
    assert not torch.equal(f32.geo(params_t, rs_t.start_positions().reshape(-1, 3))[0], out_t["sdf"].reshape(-1, 1))


# ---------------------------------------------------------------------------
# dots recompute and the chunked level-set query


def test_chunked_apply_dots_equals_full():
    """``remat_policy="dots"`` changes what the backward recomputes, never
    the function: outputs and gradients bit for bit equal to ``"full"``
    (mirror of ``tests/test_losses.py::test_chunked_apply_remat_policy_identical``),
    and JAX's ``_chunked_apply`` gives the same numbers."""
    w0 = torch.from_numpy(_rand((8, 8), 0))
    x = torch.from_numpy(_rand((37, 8), 1))
    got = {}
    for policy in ("full", "dots"):
        w = w0.clone().requires_grad_(True)
        out = t_neusky._chunked_apply(lambda xx: {"y": torch.sin(xx @ w) @ w.t()}, (x,), 16, policy)["y"]
        loss = torch.sum(out**2)
        loss.backward()
        got[policy] = (loss.detach(), w.grad)
    assert torch.equal(got["full"][0], got["dots"][0]) and torch.equal(got["full"][1], got["dots"][1])

    def j_loss(w_):
        out = j_chunked_apply(lambda xx: jnp.sin(xx @ w_) @ w_.T, (jnp.asarray(x.numpy()),), 16, remat_policy="dots")
        return jnp.sum(out**2)

    v, g = jax.value_and_grad(j_loss)(jnp.asarray(w0.numpy()))
    np.testing.assert_allclose(float(got["dots"][0]), float(v), rtol=1e-6)
    assert max_rel_err(got["dots"][1].numpy(), g) < 1e-5


def test_chunked_apply_dots_keeps_the_products():
    """Under ``dots`` the backward recomputes no matrix product (``full``
    runs the forward's again): ``mm`` calls counted below the checkpoint's
    own dispatch, so a product served from what ``dots`` kept is not
    counted."""

    class CountProducts(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.overloadpacket is torch.ops.aten.mm
            return func(*args, **(kwargs or {}))

    w = torch.from_numpy(_rand((8, 8), 2)).requires_grad_(True)
    x = torch.from_numpy(_rand((32, 8), 3))
    counts = {}
    for policy in ("full", "dots"):
        with CountProducts() as mode:
            out = t_neusky._chunked_apply(lambda xx: {"y": torch.sin(xx @ w)}, (x,), 16, policy)["y"]
            forward = mode.n
            out.sum().backward()
        counts[policy] = (forward, mode.n - forward)
    # forward: 2 chunks × 1 product; backward: 2 × 1 (w's gradient), plus the
    # forward's 2 again under "full"
    assert counts == {"full": (2, 4), "dots": (2, 2)}, counts


def _level_set_model(chunk: int):
    cfg = dataclasses.replace(tiny_model_config(), sdf_query_chunk=chunk, sdf_level_set_subset=0)
    cfg = dataclasses.replace(cfg, sdf_field=dataclasses.replace(cfg.sdf_field, stochastic_table_grads=False))
    return t_neusky.NeuSkyModel(cfg, device="cpu")


@pytest.mark.parametrize("chunk", [100, 512, 4096], ids=["ragged", "512", "one_chunk"])
def test_chunked_level_set_query_equals_one_piece(chunk):
    """The SDF at the DDF's termination points, with exact table
    gradients: values and the gradients into the SDF field equal whether
    the query runs in one piece or in chunks of ``chunk`` points (the last
    one short), to float32 rounding: CPU matrix products of other row
    counts may sum in another order (values to 1e-6 relative, reached
    2.1e-7), the table's scatter sums too (gradients to 1e-5 of each
    array's scale)."""
    res = {}
    for c in (0, chunk):
        model = _level_set_model(c)
        params = model.init(torch.Generator().manual_seed(0))
        params["fields"]["params"]["geo_0"]["kernel"] += 0.05 * torch.randn(
            params["fields"]["params"]["geo_0"]["kernel"].shape, generator=torch.Generator().manual_seed(1))
        params["fields"]["params"]["hash_table"] = 0.1 * torch.randn(
            params["fields"]["params"]["hash_table"].shape, generator=torch.Generator().manual_seed(2))
        _trainable(params)
        g = np.random.default_rng(3)
        _, rs, p2p = vis_ray_samples(n=40)
        dirs = torch.from_numpy(g.normal(size=(12, 3)).astype(np.float32))
        dirs = dirs / dirs.norm(dim=-1, keepdim=True)
        out = model.compute_visibility(params, rs, torch.from_numpy(p2p), dirs, torch.tensor(0.3),
                                       torch.tensor(25.0), False, True)
        torch.sum(out["sdf_at_termination"] ** 2).backward()
        res[c] = (out["sdf_at_termination"].detach(), {k: v.grad for k, v in tree_items(params["fields"])})
    assert res[0][0].shape[0] == 40 * 12
    torch.testing.assert_close(res[chunk][0], res[0][0], rtol=1e-6, atol=1e-7)
    for k, want in res[0][1].items():
        if want is None:  # the colour layers and the variance: not in the SDF
            assert res[chunk][1][k] is None, k
            continue
        assert max_rel_err(res[chunk][1][k].numpy(), want.numpy()) < 1e-5, k
    assert res[0][1]["params/hash_table"].abs().max() > 0
