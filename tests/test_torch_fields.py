"""The port's fields against the JAX flax modules through ``convert.py``:
the SDF/albedo field (values, analytic spatial gradients, the eikonal
loss's parameter gradients — the hand-carried MLP tangents), the proposal
density field (exact and stochastic), and the RENI++ attention decoder
(outputs, latent gradients, the straight-through unnormalise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.core.rays import RaySamples as JRaySamples
from neusky_tpu.fields.density_field import DensityFieldConfig, HashMLPDensityField as JDensity
from neusky_tpu.fields.reni import RENIField as JReni, RENIFieldConfig
from neusky_tpu.fields.sdf_albedo import SDFAlbedoField as JSDF, SDFAlbedoFieldConfig
from neusky_tpu.ops.hashgrid import HashGridConfig

from neusky_torch.core.rays import RaySamples as TRaySamples
from neusky_torch.fields.density_field import HashMLPDensityField as TDensity
from neusky_torch.fields.reni import RENIField as TReni, so2_invariant_features
from neusky_torch.fields.sdf_albedo import SDFAlbedoField as TSDF
from neusky_torch.tree import tree_items
from torch_parity import flat_jax, jax_to_torch_params, max_rel_err, to_torch_config

HASH = HashGridConfig(num_levels=4, features_per_level=2, log2_hashmap_size=12, base_res=4, max_res=64)
# float32 with reordered sums: values to ~1e-5 relative; parameter
# gradients of a scalar loss held per array at 1e-4 of the array's scale
VAL_RTOL, GRAD_REL = 2e-5, 1e-4


def _ray_samples(n=24, s=6, seed=0):
    g = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, -0.9, 0.2]], np.float32), (n, 1))
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    starts = np.sort(g.uniform(0.05, 1.8, (n, s, 1)).astype(np.float32), axis=1)
    ends = starts + 0.05
    arr = dict(
        origins=np.broadcast_to(o[:, None], (n, s, 3)).copy(),
        directions=np.broadcast_to(d[:, None], (n, s, 3)).copy(),
        starts=starts, ends=ends, pixel_area=np.ones((n, s, 1), np.float32),
        camera_indices=np.zeros((n, s, 1), np.int32), deltas=ends - starts,
        spacing_starts=starts / 2, spacing_ends=ends / 2,
    )
    return (JRaySamples(**{k: jnp.asarray(v) for k, v in arr.items()}),
            TRaySamples(**{k: torch.from_numpy(v) for k, v in arr.items()}))


def _trainable(params):
    for _, v in tree_items(params):
        v.requires_grad_(True)
    return params


@pytest.mark.parametrize("stoch", [False, True], ids=["exact", "stochastic_table_grad"])
def test_sdf_field_outputs_gradients_and_eikonal(stoch):
    cfg_j = SDFAlbedoFieldConfig(num_layers=2, hidden_dim=32, geo_feat_dim=16, num_layers_color=2,
                                 hidden_dim_color=32, bias=0.3, hash=HASH, stochastic_table_grads=stoch)
    jf, tf = JSDF(cfg_j), TSDF(to_torch_config(cfg_j))
    params_j = jf.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)))
    # break the geometric init's zero encoding weights so the hash path counts
    k0 = params_j["params"]["geo_0"]["kernel"]
    params_j["params"]["geo_0"]["kernel"] = k0 + 0.05 * jax.random.normal(jax.random.PRNGKey(1), k0.shape)
    params_j["params"]["hash_table"] = 0.1 * jax.random.normal(jax.random.PRNGKey(2), params_j["params"]["hash_table"].shape)
    rs_j, rs_t = _ray_samples()
    salt = 0x12345678

    def loss(p):
        out = jf.apply(p, rs_j, True, 1.0, jnp.uint32(salt) if stoch else None, method=jf.field_outputs)
        eik = jnp.mean((jnp.sqrt(jnp.sum(out["gradient"] ** 2, -1) + 1e-12) - 1.0) ** 2)
        return eik + jnp.mean(out["albedo"] * out["alpha"]), out

    (lj, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)

    params_t = _trainable(jax_to_torch_params(params_j))
    out_t = tf.field_outputs(params_t, rs_t, True, 1.0, torch.tensor(salt) if stoch else None)
    eik = torch.mean((torch.sqrt(torch.sum(out_t["gradient"] ** 2, -1) + 1e-12) - 1.0) ** 2)
    (eik + torch.mean(out_t["albedo"] * out_t["alpha"])).backward()

    for k in ("sdf", "gradient", "normal", "albedo", "alpha"):
        assert max_rel_err(out_t[k].detach().numpy(), out_j[k]) < VAL_RTOL, k
    gj = flat_jax(g_j)
    for k, v in tree_items(params_t):
        assert max_rel_err(v.grad.numpy(), gj[k]) < GRAD_REL, (k, max_rel_err(v.grad.numpy(), gj[k]))


def test_sdf_analytic_gradient_matches_autograd_of_the_sdf():
    """The hand-carried tangents equal torch autograd of the SDF itself
    (``gradient_mode="reverse"``), independent of JAX."""
    cfg = to_torch_config(SDFAlbedoFieldConfig(num_layers=2, hidden_dim=32, geo_feat_dim=8, hash=HASH))
    f = TSDF(cfg)
    params = f.init(torch.Generator().manual_seed(0), "cpu")
    params["params"]["hash_table"] = 0.1 * torch.randn(params["params"]["hash_table"].shape)
    params["params"]["geo_0"]["kernel"] = params["params"]["geo_0"]["kernel"] + 0.05 * torch.randn(
        params["params"]["geo_0"]["kernel"].shape)
    pos = torch.rand(64, 3) * 1.6 - 0.8
    _, _, g_fwd = f.geo_with_grad(params, pos)
    rev = TSDF(to_torch_config(SDFAlbedoFieldConfig(num_layers=2, hidden_dim=32, geo_feat_dim=8, hash=HASH,
                                                    gradient_mode="reverse")))
    _, _, g_rev = rev.geo_with_grad(params, pos)
    torch.testing.assert_close(g_fwd, g_rev, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "stoch_u", "stoch_u_fp"])
def test_density_field_matches(mode):
    cfg_j = DensityFieldConfig(
        hidden_dim=16, num_layers=2,
        hash=HashGridConfig(num_levels=3, features_per_level=2, log2_hashmap_size=11, base_res=4, max_res=32),
        stochastic_forward=(mode == "stoch_u_fp"),
    )
    jf, tf = JDensity(cfg_j), TDensity(to_torch_config(cfg_j))
    params_j = jf.init(jax.random.PRNGKey(3), jnp.zeros((1, 2, 3)))
    params_j["params"]["hash_table"] = 0.5 * jax.random.normal(jax.random.PRNGKey(4), params_j["params"]["hash_table"].shape)
    pos = np.random.default_rng(5).uniform(-1.5, 1.5, (16, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6) if mode != "exact" else None
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (16 * 8,)))) if key is not None else None

    def loss(p):
        d = jf.apply(p, jnp.asarray(pos), key)
        return jnp.sum(jnp.log(d + 1.0) * jnp.arange(d.size).reshape(d.shape) / d.size), d

    (_, d_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)
    params_t = _trainable(jax_to_torch_params(params_j))
    d_t = tf.apply(params_t, torch.from_numpy(pos), u)
    (torch.log(d_t + 1.0) * torch.arange(d_t.numel()).reshape(d_t.shape) / d_t.numel()).sum().backward()
    assert max_rel_err(d_t.detach().numpy(), d_j) < VAL_RTOL
    gj = flat_jax(g_j)
    for k, v in tree_items(params_t):
        assert max_rel_err(v.grad.numpy(), gj[k]) < GRAD_REL, k


def test_reni_decoder_matches_with_latent_gradients():
    cfg_j = RENIFieldConfig(latent_dim=6, hidden_features=32, num_attention_heads=4, num_attention_layers=2)
    jr, tr = JReni(cfg_j), TReni(to_torch_config(cfg_j))
    g = np.random.default_rng(7)
    m = 20
    dirs = g.normal(size=(m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    lat = g.normal(size=(m, 6, 3)).astype(np.float32)
    scale = g.uniform(0.5, 1.5, m).astype(np.float32)
    params_j = jr.init(jax.random.PRNGKey(8), jnp.asarray(dirs), jnp.asarray(lat))

    def f(p, z):
        rgb = jr.apply(p, jnp.asarray(dirs), z, jnp.asarray(scale))["rgb"]
        return jnp.sum(jr.unnormalise(rgb) * 1e-3), rgb

    (_, rgb_j), (gp_j, gz_j) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(params_j, jnp.asarray(lat))
    params_t = _trainable(jax_to_torch_params(params_j))
    z = torch.from_numpy(lat).requires_grad_(True)
    rgb_t = tr.apply(params_t, torch.from_numpy(dirs), z, torch.from_numpy(scale))["rgb"]
    torch.sum(tr.unnormalise(rgb_t) * 1e-3).backward()
    assert max_rel_err(rgb_t.detach().numpy(), rgb_j) < 1e-5
    assert max_rel_err(z.grad.numpy(), gz_j) < GRAD_REL
    gp = flat_jax(gp_j)
    # the key bias's true gradient is zero (softmax ignores a shift shared
    # by all keys): arrays are held at 1e-4 of max(their scale, 1% of the
    # tree's largest gradient)
    floor = 1e-2 * max(np.abs(g).max() for g in gp.values())
    for k, v in tree_items(params_t):
        err = np.abs(v.grad.numpy() - gp[k]).max()
        assert err <= GRAD_REL * max(np.abs(gp[k]).max(), floor), (k, err)


def test_reni_unnormalise_straight_through_and_invariants():
    cfg = to_torch_config(RENIFieldConfig())
    tr = TReni(cfg)
    x = torch.tensor([-2.0, -0.5, 0.3, 1.7], requires_grad=True)
    y = tr.unnormalise(x)
    assert torch.allclose(y[0], tr.unnormalise(torch.tensor(-1.0)))  # clipped value
    y.sum().backward()
    assert (x.grad > 0).all()  # gradient survives the clip
    # invariance under a joint rotation about z
    g = torch.Generator().manual_seed(0)
    d = torch.nn.functional.normalize(torch.randn(5, 3, generator=g), dim=-1)
    z = torch.randn(5, 4, 3, generator=g)
    a = 0.7
    r = torch.tensor([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    f1, t1 = so2_invariant_features(d, z)
    f2, t2 = so2_invariant_features(d @ r.T, z @ r.T)
    torch.testing.assert_close(f1, f2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(t1, t2, atol=1e-5, rtol=1e-5)
