"""The port's hash-grid encode against ``neusky_tpu/ops/hashgrid.py``:
bit-exact indices and uint32 hashes, and the forward, ``encode_with_dx``
and table/position gradients of every custom-gradient path under the same
salt and ``stoch_u``; plus the exact stratum-enumeration unbiasedness
checks of ``tests/test_pallas_scatter.py:53-137`` on the port's
``take_interp_stoch(_fp)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.ops import hashgrid as J
from neusky_torch.ops import hashgrid as T
from neusky_torch.ops.hashgrid_cuda import take_interp_stoch, take_interp_stoch_fp

# mixes dense levels (res 4, 7, 13) and hashed ones (24, 45) in a 2^10 table
SMALL = dict(num_levels=5, features_per_level=2, log2_hashmap_size=10, base_res=4, max_res=45)
CANONICAL = dict()  # HashGridConfig defaults: 16 levels, 2^19, 16 → 2048
PROPOSAL = dict(num_levels=5, log2_hashmap_size=17, base_res=16, max_res=256)
# Forward values agree to float32 rounding of reordered 8-term sums;
# gradients to the rounding of reordered scatter sums.
FWD_ATOL, GRAD_RTOL = 1e-6, 1e-5


def _positions(n, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1.0], [1e-7, 0.999999, 0.5]]  # edges
    return x


@pytest.mark.parametrize("kw", [SMALL, CANONICAL, PROPOSAL], ids=["small", "canonical_2p19", "proposal"])
def test_level_indices_and_weights_bit_exact(kw):
    je, te = J.HashGridEncoding(J.HashGridConfig(**kw)), T.HashGridEncoding(T.HashGridConfig(**kw))
    assert list(je._dense) == list(te._dense) and any(te._dense) and not all(te._dense)
    x = _positions(4096).T.copy()
    for lvl in range(je.config.num_levels):
        i1, w1, d1 = je._level_iw(jnp.asarray(x), lvl, True)
        i2, w2, d2 = te._level_iw(torch.from_numpy(x), lvl, True)
        np.testing.assert_array_equal(i2.numpy(), np.asarray(i1), err_msg=f"level {lvl}")
        np.testing.assert_array_equal(w2.numpy(), np.asarray(w1), err_msg=f"level {lvl}")
        np.testing.assert_allclose(d2.numpy(), np.asarray(d1), rtol=1e-6, err_msg=f"level {lvl}")


@pytest.mark.parametrize("salt", [0, 1, 0x9E3779B9, 2**32 - 12345, 2**32 - 1])
def test_cheap_hash_u_bit_exact(salt):
    n = 1 << 20
    for lvl in (0, 7, 15, 131 + 15):
        a = np.asarray(J._cheap_hash_u(n, lvl, jnp.uint32(salt)))
        b = T._cheap_hash_u(n, lvl, torch.tensor(salt)).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f"level {lvl}")


def test_mul_u32_matches_uint32_wraparound():
    x = np.random.default_rng(1).integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 1, 2**32 - 1]
    for c in (1, 2654435761, 805459861, 0x9E3779B9, 0x7FEB352D, 0x846CA68B, 2**32 - 1):
        want = (x * np.uint32(c)).astype(np.uint32)  # numpy wraps mod 2^32
        got = T._mul_u32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=hex(c))


# ---------------------------------------------------------------------------
# every encode path, forward and gradients, against the JAX custom VJPs

SALT = 0xDEADBEEF

ENCODE_PATHS = {
    # name: (kwargs of __call__, position grad compared?)
    "plain": (dict(), True),
    "level_encode": (dict(custom_take=True), True),
    "level_encode_stoch": (dict(custom_take=True, stoch_salt=SALT), True),
    "level_encode_stoch_sdxt": (dict(custom_take=True, stoch_salt=SALT, stoch_dxt=True), True),
    "take_interp_stoch": (dict(custom_take=True, stoch_u=True), False),
    "take_interp_stoch_fp": (dict(custom_take=True, stoch_u=True, stoch_fwd=True), False),
}


def _setup(n=300):
    cfg_kw = SMALL
    je, te = J.HashGridEncoding(J.HashGridConfig(**cfg_kw)), T.HashGridEncoding(T.HashGridConfig(**cfg_kw))
    rng = np.random.default_rng(3)
    table = rng.normal(size=(5, 2, 1024)).astype(np.float32)
    x = _positions(n, seed=4)
    u = rng.uniform(0, 1, n).astype(np.float32)
    ct = rng.normal(size=(n, 10)).astype(np.float32)
    ctd = rng.normal(size=(n, 3, 10)).astype(np.float32)
    return je, te, table, x, u, ct, ctd


def _jax_kw(kw, u):
    out = dict(kw)
    if out.get("stoch_u"):
        out["stoch_u"] = jnp.asarray(u)
    if "stoch_salt" in out:
        out["stoch_salt"] = jnp.uint32(out["stoch_salt"])
    return out


def _torch_kw(kw, u):
    out = dict(kw)
    if out.get("stoch_u"):
        out["stoch_u"] = torch.from_numpy(u)
    if "stoch_salt" in out:
        out["stoch_salt"] = torch.tensor(out["stoch_salt"])
    return out


@pytest.mark.parametrize("path", sorted(ENCODE_PATHS))
def test_encode_forward_and_gradients_match(path):
    kw, pos_grad = ENCODE_PATHS[path]
    je, te, table, x, u, ct, _ = _setup()

    def jloss(t, xx):
        return jnp.sum(je(t, xx, **_jax_kw(kw, u)) * ct)

    out_j = np.asarray(je(jnp.asarray(table), jnp.asarray(x), **_jax_kw(kw, u)))
    gt_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))

    tt = torch.from_numpy(table).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(pos_grad)
    out_t = te(tt, xx, **_torch_kw(kw, u))
    (out_t * torch.from_numpy(ct)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=FWD_ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j), rtol=GRAD_RTOL, atol=1e-6)
    if pos_grad:
        # position cotangents scale with the finest resolution (45)
        np.testing.assert_allclose(xx.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "stoch, custom_take",
    [(False, True), (True, True), (False, False)],
    ids=["level_encode_dx", "level_encode_dx_stoch", "autograd"],
)
def test_encode_with_dx_matches(stoch, custom_take):
    je, te, table, x, _, ct, ctd = _setup()
    salt_j = jnp.uint32(SALT) if stoch else None
    salt_t = torch.tensor(SALT) if stoch else None

    def jloss(t):
        o, d = je.encode_with_dx(t, jnp.asarray(x), custom_take=custom_take, stoch_salt=salt_j)
        return jnp.sum(o * ct) + jnp.sum(d * ctd)

    o_j, d_j = je.encode_with_dx(jnp.asarray(table), jnp.asarray(x), custom_take=custom_take, stoch_salt=salt_j)
    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    o_t, d_t = te.encode_with_dx(tt, torch.from_numpy(x), custom_take=custom_take, stoch_salt=salt_t)
    ((o_t * torch.from_numpy(ct)).sum() + (d_t * torch.from_numpy(ctd)).sum()).backward()
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=FWD_ATOL)
    # d/dx carries the resolution factor (≤ 45)
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j), atol=45 * FWD_ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), g_j, rtol=GRAD_RTOL, atol=1e-4)


# ---------------------------------------------------------------------------
# unbiasedness of the stochastic-corner lookups, by exact stratum enumeration


def _one_sample(seed):
    g = np.random.default_rng(seed)
    t2 = torch.from_numpy(g.normal(size=(2, 256)).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, 256, (8, 1)).astype(np.int32))
    w = torch.from_numpy(g.uniform(size=(8, 1)).astype(np.float32) + 0.01)
    cdf = np.cumsum(w[:, 0].numpy().astype(np.float64)) / float(w.sum())
    lo = np.concatenate([[0.0], cdf[:-1]])
    return t2, idx, w, cdf, lo


def test_take_interp_stoch_forward_exact_backward_unbiased():
    t2, idx, w, cdf, lo = _one_sample(10)
    exact_fwd = torch.sum(w[None] * t2[:, idx], dim=1)
    u = torch.rand(1)
    np.testing.assert_allclose(take_interp_stoch(t2, idx, w, u).numpy(), exact_fwd.numpy(), atol=1e-6)
    te = t2.clone().requires_grad_(True)
    (torch.sum(w[None] * te[:, idx], dim=1) ** 2).sum().backward()
    expected = np.zeros((2, 256))
    for c in range(8):
        tc = t2.clone().requires_grad_(True)
        u_mid = torch.tensor([(lo[c] + cdf[c]) / 2.0], dtype=torch.float32)
        (take_interp_stoch(tc, idx, w, u_mid) ** 2).sum().backward()
        expected += (cdf[c] - lo[c]) * tc.grad.numpy()
    np.testing.assert_allclose(expected, te.grad.numpy(), atol=1e-4)


def test_take_interp_stoch_fp_unbiased_both_ways():
    t2, idx, w, cdf, lo = _one_sample(20)
    ref_fwd = torch.sum(w[None] * t2[:, idx], dim=1)
    te = t2.clone().requires_grad_(True)
    (torch.sum(w[None] * te[:, idx], dim=1) ** 2).sum().backward()
    exp_fwd, exp_grad = np.zeros((2, 1)), np.zeros((2, 256))
    for c in range(8):
        p_c = cdf[c] - lo[c]
        u_mid = torch.tensor([(lo[c] + cdf[c]) / 2.0], dtype=torch.float32)
        tc = t2.clone().requires_grad_(True)
        out = take_interp_stoch_fp(tc, idx, w, u_mid)
        exp_fwd += p_c * out.detach().numpy()
        (out * (2.0 * ref_fwd)).sum().backward()
        exp_grad += p_c * tc.grad.numpy()
    np.testing.assert_allclose(exp_fwd, ref_fwd.numpy(), atol=1e-4)
    np.testing.assert_allclose(exp_grad, te.grad.numpy(), atol=1e-4)


def test_level_encode_dx_stoch_table_grad_unbiased():
    """E over the uniform corner draw of the stochastic d/dx table gradient
    equals the exact one: average over many salts at a handful of points."""
    cfg = T.HashGridConfig(**SMALL)
    te = T.HashGridEncoding(cfg)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(5, 2, 1024)).astype(np.float32))
    x = torch.from_numpy(_positions(4, seed=6))
    ct = torch.from_numpy(rng.normal(size=(4, 10)).astype(np.float32))
    ctd = torch.from_numpy(rng.normal(size=(4, 3, 10)).astype(np.float32))

    def grad(salt):
        tt = table.clone().requires_grad_(True)
        o, d = te.encode_with_dx(tt, x, stoch_salt=salt)
        ((o * ct).sum() + (d * ctd).sum()).backward()
        return tt.grad.numpy().astype(np.float64)

    exact = grad(None)
    n = 4000
    mean = sum(grad(torch.tensor(s * 2654435761 % 2**32)) for s in range(n)) / n
    # Monte-Carlo: per-entry std of the 1/8-corner ×8 estimator / sqrt(n)
    scale = np.abs(exact).max()
    assert np.abs(mean - exact).max() < 0.15 * scale, np.abs(mean - exact).max() / scale
