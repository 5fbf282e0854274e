"""The port's model variants against the JAX package on the CPU, from the
same numpy inputs and converted parameters: ``sh_encoding``, the
transformer decoder, the DDF field with ``Attention`` conditioning and the
``sh`` encodings, ``ddf_predicted_normals``, the RENI ``FiLM`` and
``Concat`` decoders (and the torch-checkpoint converters' refusal of
them), the SH / SG / envmap sky fields and the icosphere encoding.

Tolerances: ``sh_encoding`` to 1e-6 absolute; the DDF field's outputs to
1e-5 relative and its parameter gradients to 1e-4 of each array's scale;
the normals to 1e-5 under Attention, 2e-5 under FiLM (``NORMAL_ATOL``); the RENI decoders' outputs and latent gradients to
1e-5 (relative, gradients of each array's scale); the sky fields and the
icosphere encoding to 1e-6.  Both sides are float32 and differ only in
the order of their sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.engine import reni_convert as j_conv
from neusky_tpu.fields import illumination_alternatives as j_alt
from neusky_tpu.fields.ddf import DDFFieldConfig
from neusky_tpu.fields.reni import RENIField as JRENI, RENIFieldConfig as JRENIConfig
from neusky_tpu.models import ddf_model as jdm
from neusky_tpu.nets.transformer import TransformerDecoder as JDecoder
from neusky_tpu.ops import icosphere_encoding as j_ico
from neusky_tpu.ops.encodings import sh_encoding as j_sh
from neusky_tpu.ops.hashgrid import HashGridConfig

from neusky_torch.engine import reni_convert as t_conv
from neusky_torch.fields import illumination_alternatives as t_alt
from neusky_torch.fields.reni import RENIField as TRENI
from neusky_torch.models import ddf_model as tdm
from neusky_torch.nets.transformer import TransformerDecoder as TDecoder
from neusky_torch.ops import icosphere_encoding as t_ico
from neusky_torch.ops.encodings import sh_encoding as t_sh
from neusky_torch.tree import tree_items
from torch_parity import flat_jax, jax_to_torch_params, max_rel_err, one_torch_thread, to_torch_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VAL_RTOL, GRAD_REL = 1e-5, 1e-4
TINY_HASH = HashGridConfig(num_levels=3, features_per_level=2, log2_hashmap_size=10, base_res=4, max_res=32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _unit(shape, seed):
    x = _rand(shape, seed)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _trainable(params):
    for _, v in tree_items(params):
        v.requires_grad_(True)
    return params


def _grads_match(gj, params_t):
    """Each array's gradient to ``GRAD_REL`` of its scale.  An attention
    key bias has a zero gradient (softmax ignores a constant added to all
    logits): where JAX's whole array is rounding noise (under 1e-6 of the
    tree's largest gradient), the port's must be noise too."""
    noise = 1e-6 * max(np.abs(g).max() for g in gj.values())
    for k, v in tree_items(params_t):
        got = np.zeros_like(gj[k]) if v.grad is None else v.grad.numpy()
        if np.abs(gj[k]).max() <= noise:
            assert np.abs(got).max() <= noise, k
            continue
        assert max_rel_err(got, gj[k]) < GRAD_REL, (k, max_rel_err(got, gj[k]))


def _same_tree(flat_j, params_t):
    assert {k: tuple(v.shape) for k, v in flat_j.items()} == {k: tuple(v.shape) for k, v in tree_items(params_t)}


# ---------------------------------------------------------------------------
# ops/encodings.py::sh_encoding


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_sh_encoding_matches_jax(levels):
    d = _unit((64, 3), 0)
    got = t_sh(torch.from_numpy(d), levels).numpy()
    want = np.asarray(j_sh(jnp.asarray(d), levels))
    assert got.shape == want.shape == (64, levels**2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("levels", [0, 5])
def test_sh_encoding_refuses_levels_outside_one_to_four(levels):
    for fn, x in ((t_sh, torch.ones(2, 3)), (j_sh, jnp.ones((2, 3)))):
        with pytest.raises(ValueError, match="1..4 levels"):
            fn(x, levels)


# ---------------------------------------------------------------------------
# nets/transformer.py::TransformerDecoder


@pytest.mark.parametrize("tokens", [None, 5], ids=["one_token", "five_tokens"])
def test_transformer_decoder_matches_jax(tokens):
    """A 2-D conditioning is one key/value token, a 3-D one a sequence."""
    x = _rand((20, 7), 1)
    cond = _rand((20, 6) if tokens is None else (20, tokens, 6), 2)
    net_j = JDecoder(hidden_features=16, num_heads=4, num_layers=2, out_dim=3)
    pj = net_j.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(cond))
    net_t = TDecoder(16, 4, 2, 3)
    _same_tree(flat_jax(pj["params"]), net_t.init(7, 6, torch.Generator().manual_seed(0), "cpu"))
    pt = _trainable(jax_to_torch_params(pj["params"]))
    out_t = net_t(pt, torch.from_numpy(x), torch.from_numpy(cond))
    out_j = np.asarray(net_j.apply(pj, jnp.asarray(x), jnp.asarray(cond)))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=VAL_RTOL, atol=1e-6)
    gj = flat_jax(jax.grad(lambda p: jnp.sum(net_j.apply({"params": p}, jnp.asarray(x), jnp.asarray(cond)) ** 2))(
        pj["params"]))
    torch.sum(out_t**2).backward()
    _grads_match(gj, pt)


# ---------------------------------------------------------------------------
# fields/ddf.py: Attention conditioning and the sh encodings


def _ddf_config(pos: str, conditioning: str, direction: str = "nerf") -> jdm.DDFModelConfig:
    return jdm.DDFModelConfig(field=DDFFieldConfig(
        position_encoding_type=pos, direction_encoding_type=direction, hash=TINY_HASH, conditioning=conditioning,
        hidden_layers=2, hidden_features=32, mapping_layers=2, mapping_features=32, num_attention_heads=4,
        num_attention_layers=2, use_bf16_compute=False,
    ))


def _sphere_queries(m: int, seed: int):
    o = _unit((m, 3), seed)
    o[:, 2] = np.abs(o[:, 2])
    d = _unit((m, 3), seed + 1)
    d = np.where(np.sum(d * -o, -1, keepdims=True) < 0, -d, d).astype(np.float32)
    return o, d


DDF_VARIANTS = [
    ("nerf", "Attention", "nerf"), ("sh", "Attention", "sh"), ("hash", "Attention", "nerf"),
    ("sh", "FiLM", "sh"), ("sh", "Concat", "nerf"),
]


@pytest.mark.parametrize("pos, conditioning, direction", DDF_VARIANTS)
def test_ddf_variant_matches_jax(pos, conditioning, direction):
    """The model (localisation + field): its parameter tree is JAX's
    (``convert.py`` carries the flax names), outputs and every gradient."""
    cfg = _ddf_config(pos, conditioning, direction)
    jm, tm = jdm.DDFModel(cfg), tdm.DDFModel(to_torch_config(cfg))
    o, d = _sphere_queries(48, 4)
    pj = jm.init(jax.random.PRNGKey(3), jnp.asarray(o), jnp.asarray(d))
    _same_tree(flat_jax(pj), tm.init(torch.Generator().manual_seed(0), "cpu"))
    pt = _trainable(jax_to_torch_params(pj))
    out_j = jm.apply(pj, jnp.asarray(o), jnp.asarray(d))
    out_t = tm.apply(pt, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(out_t["expected_termination_dist"].detach().numpy(),
                               np.asarray(out_j["expected_termination_dist"]), rtol=VAL_RTOL, atol=1e-6)
    gj = flat_jax(jax.grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(o), jnp.asarray(d))["expected_termination_dist"] ** 2))(pj))
    torch.sum(out_t["expected_termination_dist"] ** 2).backward()
    _grads_match(gj, pt)


# The FiLM-SIREN's sines (ω = 30) and the hash grid's d/dx sum their terms
# in another order in each framework: the raw origin gradient agrees to
# 1.1e-5 (nerf) and 3.4e-6 (hash) of its scale, but a row's normalisation
# turns a 2.6e-5 relative row error into up to 1.4e-5 of a unit vector.
NORMAL_ATOL = {"Attention": 1e-5, "FiLM": 2e-5}


@pytest.mark.parametrize("pos, conditioning", [("sh", "Attention"), ("nerf", "FiLM"), ("hash", "FiLM")])
def test_ddf_predicted_normals_match_jax(pos, conditioning):
    """Unit normals, oriented against the rays (``NORMAL_ATOL``)."""
    cfg = _ddf_config(pos, conditioning)
    jm, tm = jdm.DDFModel(cfg), tdm.DDFModel(to_torch_config(cfg))
    o, d = _sphere_queries(40, 8)
    o = o * 0.9
    pj = jm.init(jax.random.PRNGKey(5), jnp.asarray(o), jnp.asarray(d))
    want = np.asarray(jdm.ddf_predicted_normals(jm, pj, jnp.asarray(o), jnp.asarray(d)))
    got = tdm.ddf_predicted_normals(tm, jax_to_torch_params(pj), torch.from_numpy(o), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL[conditioning])
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert (np.sum(got * d, -1) <= 0).all()


def test_sh_ddf_encoding_trains_through_the_env_knob(monkeypatch):
    """``NEUSKY_DDF_ENCODING=sh`` builds a model whose DDF runs."""
    from neusky_torch.configs.env_overrides import apply_env_knobs
    from neusky_torch.configs.tiny_config import tiny_model_config
    from neusky_torch.models.neusky import NeuSkyModel

    monkeypatch.setenv("NEUSKY_DDF_ENCODING", "sh")
    cfg = apply_env_knobs(tiny_model_config(2, 1))
    assert cfg.ddf.field.position_encoding_type == "sh"
    model = NeuSkyModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    o, d = _sphere_queries(8, 1)
    out = model.ddf.apply(params["ddf_field"], torch.from_numpy(o), torch.from_numpy(d))
    assert torch.isfinite(out["expected_termination_dist"]).all()


# ---------------------------------------------------------------------------
# fields/reni.py: the FiLM and Concat decoders


def _reni_config(conditioning: str) -> JRENIConfig:
    return JRENIConfig(conditioning=conditioning, latent_dim=6, hidden_features=32, hidden_layers=3,
                       mapping_layers=2, mapping_features=32, fixed_decoder=True)


@pytest.mark.parametrize("conditioning", ["FiLM", "Concat"])
def test_reni_decoder_matches_jax(conditioning):
    """Rotated directions and scaled latents: ``rgb`` and the latents'
    and scales' gradients."""
    cfg = _reni_config(conditioning)
    jf, tf = JRENI(cfg), TRENI(to_torch_config(cfg))
    d, z = _unit((30, 3), 9), _rand((30, 6, 3), 10, 0.5)
    s = (1.0 + 0.1 * _rand((30,), 11)).astype(np.float32)
    theta = 0.7
    rot = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    pj = jf.init(jax.random.PRNGKey(4), jnp.asarray(d), jnp.asarray(z))
    _same_tree(flat_jax(pj), tf.init(torch.Generator().manual_seed(0), "cpu"))
    pt = jax_to_torch_params(pj)

    def loss_j(zz, ss):
        return jnp.sum(jf.apply(pj, jnp.asarray(d), zz, ss, jnp.asarray(rot))["rgb"] ** 2)

    gz, gs = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(s))
    zt = torch.from_numpy(z).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    out_t = tf.apply(pt, torch.from_numpy(d), zt, st, torch.from_numpy(rot))["rgb"]
    out_j = np.asarray(jf.apply(pj, jnp.asarray(d), jnp.asarray(z), jnp.asarray(s), jnp.asarray(rot))["rgb"])
    assert out_j.shape == (30, 3)
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=VAL_RTOL, atol=1e-6)
    torch.sum(out_t**2).backward()
    assert max_rel_err(zt.grad.numpy(), gz) < 1e-5
    assert max_rel_err(st.grad.numpy(), gs) < 1e-5


@pytest.mark.parametrize("conditioning", ["FiLM", "Concat"])
def test_reni_converters_refuse_non_attention_decoders_as_jax_does(conditioning):
    cfg = _reni_config(conditioning)
    tcfg = to_torch_config(cfg)
    with pytest.raises(NotImplementedError):
        j_conv.torch_state_to_params({}, cfg)
    with pytest.raises(NotImplementedError):
        t_conv.torch_state_to_params({}, tcfg)
    with pytest.raises(NotImplementedError):
        j_conv.params_to_torch_state({}, cfg)
    with pytest.raises(NotImplementedError):
        t_conv.params_to_torch_state({}, tcfg)
    # the Attention decoder passes the gate in both (and then misses its leaves)
    for conv, c in ((j_conv, _reni_config("Attention")), (t_conv, to_torch_config(_reni_config("Attention")))):
        with pytest.raises(KeyError):
            conv.torch_state_to_params({}, c)


# ---------------------------------------------------------------------------
# fields/illumination_alternatives.py


def _rotation(kind: str, m: int):
    if kind == "none":
        return None
    if kind == "single":
        q = np.linalg.qr(_rand((3, 3), 12).astype(np.float64))[0]
        return q.astype(np.float32)
    return np.stack([np.linalg.qr(a.astype(np.float64))[0] for a in _rand((m, 3, 3), 13)]).astype(np.float32)


def _alt_fields():
    return {
        "sh": (j_alt.SphericalHarmonicIlluminationField(levels=4), t_alt.SphericalHarmonicIlluminationField(levels=4),
               (16, 3)),
        "sg": (j_alt.SphericalGaussianField(sg_num=40), t_alt.SphericalGaussianField(sg_num=40), (40, 3)),
        "envmap": (j_alt.EnvironmentMapField(height=8, width=16), t_alt.EnvironmentMapField(height=8, width=16),
                   (3, 8, 16)),
    }


@pytest.mark.parametrize("rotation", ["none", "single", "per_direction"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared_latents", "per_direction_latents"])
@pytest.mark.parametrize("kind", ["sh", "sg", "envmap"])
def test_alternative_sky_field_matches_jax(kind, batched, rotation):
    """``rgb`` (with a scale) and ``unnormalise``, to 1e-6.  The directions
    include the poles and the envmap's seam, where u wraps around."""
    jf, tf, shape = _alt_fields()[kind]
    m = 64
    d = _unit((m, 3), 14)
    d[0], d[1], d[2] = [0, 0, 1], [0, 0, -1], [-1, 0, 0]
    d[3] = [-0.8, -1e-7, 0.6]
    lat = _rand(((m,) if batched else ()) + shape, 15, 0.3)
    scale = (1.0 + 0.2 * _rand((m,), 16)).astype(np.float32)
    rot = _rotation(rotation, m)
    want = jf(jnp.asarray(d), jnp.asarray(lat), jnp.asarray(scale), None if rot is None else jnp.asarray(rot))["rgb"]
    got = tf(torch.from_numpy(d), torch.from_numpy(lat), torch.from_numpy(scale),
             None if rot is None else torch.from_numpy(rot))["rgb"]
    assert tuple(got.shape) == (m, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.unnormalise(got).numpy(), np.asarray(jf.unnormalise(want)), rtol=1e-6, atol=1e-6)


def test_alternative_sky_field_sizes_match_jax():
    for jf, tf, shape in _alt_fields().values():
        for attr in ("latent_dim", "latent_shape", "num_sh_coeffs"):
            if hasattr(jf, attr):
                assert getattr(tf, attr) == getattr(jf, attr)
    for n in (12, 40, 42):
        np.testing.assert_array_equal(t_alt.SphericalGaussianField(sg_num=n).axes().numpy(),
                                      np.asarray(j_alt.SphericalGaussianField(sg_num=n)._axes()))


def test_sg_field_with_fewer_icosphere_vertices_than_lobes_raises_as_jax():
    """The default ``sg_num=24`` takes the 12-vertex icosphere (the nearest
    count): 12 axes for 24 latent rows.  JAX's einsum raises on it; so does
    the port, naming the cause."""
    d, lat = _unit((5, 3), 18), _rand((24, 3), 19)
    with pytest.raises(ValueError):
        j_alt.SphericalGaussianField()(jnp.asarray(d), jnp.asarray(lat))
    with pytest.raises(ValueError, match="12 icosphere vertices for 24 lobes"):
        t_alt.SphericalGaussianField()(torch.from_numpy(d), torch.from_numpy(lat))


def test_envmap_field_lookup_is_bilinear_and_wraps_in_u():
    """A pixel centre returns its pixel; halfway across the seam (u = −0.5
    wraps to the last column) averages the first and last columns."""
    f = t_alt.EnvironmentMapField(height=4, width=8)
    lat = torch.arange(3 * 4 * 8, dtype=torch.float32).reshape(3, 4, 8)
    phi = torch.tensor([(1 + 0.5) / 4 * torch.pi])
    theta = torch.tensor([(2 + 0.5) / 8 * 2 * torch.pi - torch.pi])
    d = torch.stack([torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta), torch.cos(phi)], -1)
    torch.testing.assert_close(f(d, lat)["rgb"][0], lat[:, 1, 2], rtol=0, atol=1e-4)
    d = torch.stack([-torch.sin(phi), torch.zeros(1), torch.cos(phi)], -1)
    torch.testing.assert_close(f(d, lat)["rgb"][0], 0.5 * (lat[:, 1, 0] + lat[:, 1, 7]), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# ops/icosphere_encoding.py


def test_icosphere_encoding_matches_jax():
    """Random directions (no ties among the neighbours' cosines), the
    same tables: 1e-6.  The vertex sets are JAX's."""
    cfg = j_ico.IcosphereEncodingConfig(num_levels=3, features_per_level=2, base_order=1, k_neighbours=3)
    je, te = j_ico.IcosphereEncoding(cfg), t_ico.IcosphereEncoding(to_torch_config_ico(cfg))
    for vj, vt in zip(je.vertices, te.vertices):
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    tables_j = je.init(jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in te.init(torch.Generator().manual_seed(0), "cpu")] == \
        [tuple(t.shape) for t in tables_j]
    d = _unit((200, 3), 17)
    want = np.asarray(je(tables_j, jnp.asarray(d)))
    got = te([torch.from_numpy(np.asarray(t)) for t in tables_j], torch.from_numpy(d)).numpy()
    assert got.shape == (200, te.out_dim) == (200, 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def to_torch_config_ico(cfg):
    return t_ico.IcosphereEncodingConfig(**dataclasses.asdict(cfg))
