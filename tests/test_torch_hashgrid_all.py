"""The port's all-level hash-grid ops against the JAX package, on the CPU:
``_all_iw`` and the uint32 hashes bit for bit; each of the seven all-level
ops against both the JAX ``_encode_all*`` (``vectorized=True``) and the JAX
per-level path, under the same salt and ``u``; the plain
``_scatter_levels`` against JAX's; and the two calls that stay per level.

The grid is ``tests/test_encodings.py::TestVectorizedLevels``'s: 6 levels,
2^12 rows, resolutions 4 → 128, so levels 0-1 are dense and 2-5 hashed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.ops import hashgrid as J
from neusky_torch.ops import hashgrid as T

VEC = dict(num_levels=6, features_per_level=2, log2_hashmap_size=12, base_res=4, max_res=128)
IW_CONFIGS = {
    "vec_grid": VEC,
    "smoothstep": dict(VEC, smoothstep=True),
    "dense_only": dict(VEC, use_hash=False),  # dense indices clamped to the table
    "canonical_2p19": dict(),
}
SALT = 0xDEADBEEF
N = 300
# Forward values: float32 rounding of 8-term sums in another order (values
# O(1)).  Table gradients: the JAX test's rtol 1e-5, atol 3e-6, the atol
# scaled by the finest resolution (128) where the d/dx cotangent, which
# carries it, enters the table gradient.  Position cotangents carry the
# resolution too.
FWD_ATOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 3e-6
DX_SCALE = 128.0


def _positions(n, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1.0], [1e-7, 0.999999, 0.5]]  # edges
    return x


@pytest.mark.parametrize("kw", list(IW_CONFIGS.values()), ids=list(IW_CONFIGS))
def test_all_iw_bit_exact(kw):
    """Indices and weights equal JAX ``_all_iw`` and, row by row, the port's
    own ``_level_iw``."""
    je, te = J.HashGridEncoding(J.HashGridConfig(vectorized=True, **kw)), T.HashGridEncoding(T.HashGridConfig(**kw))
    x = _positions(4096).T.copy()
    i1, w1, d1 = je._all_iw(jnp.asarray(x), True)
    i2, w2, d2 = te._all_iw(torch.from_numpy(x), True)
    assert i2.dtype == torch.int32 and tuple(i2.shape) == (te.config.num_levels, 8, 4096)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_array_equal(w2.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    for lvl in range(te.config.num_levels):
        il, wl, dl = te._level_iw(torch.from_numpy(x), lvl, True)
        assert torch.equal(i2[lvl], il) and torch.equal(w2[lvl], wl) and torch.equal(d2[lvl], dl), lvl


@pytest.mark.parametrize("salt", [0, 1, 2**32 - 12345, 2**32 - 1])
def test_cheap_hash_u_all_bit_exact(salt):
    n, levels = 1 << 14, 16
    a = np.asarray(J._cheap_hash_u_all(n, levels, jnp.uint32(salt)))
    b = T._cheap_hash_u_all(n, levels, torch.tensor(salt))
    np.testing.assert_array_equal(b.numpy(), a)
    for lvl in (0, 7, 15):
        assert torch.equal(b[lvl], T._cheap_hash_u(n, lvl, torch.tensor(salt))), lvl


def test_golden_u_all_bit_exact():
    u = np.random.default_rng(1).uniform(0, 1, 4096).astype(np.float32)
    u[:3] = [0.0, 0.38196602, 0.99999994]
    a = np.asarray(J._golden_u_all(jnp.asarray(u), 16))
    b = T._golden_u_all(torch.from_numpy(u), 16)
    np.testing.assert_array_equal(b.numpy(), a)


# ---------------------------------------------------------------------------
# the seven all-level ops, forward and gradients

OPS = {
    # name: (entry, kwargs, port Function or None for plain autograd, position grad compared?)
    "encode_all_plain": ("call", dict(), None, True),
    "encode_all": ("call", dict(custom_take=True), "_EncodeAll", True),
    "encode_all_stoch": ("call", dict(custom_take=True, stoch_salt=SALT), "_EncodeAllStoch", True),
    "encode_all_stoch_u": ("call", dict(stoch_u=True), "_EncodeAllStochU", False),
    "encode_all_stoch_fp": ("call", dict(stoch_u=True, stoch_fwd=True), "_EncodeAllStochFp", False),
    "encode_all_dx": ("dx", dict(), "_EncodeAllDx", False),
    "encode_all_dx_stoch": ("dx", dict(stoch_salt=SALT), "_EncodeAllDxStoch", False),
}


def _setup(vectorized: bool):
    je = J.HashGridEncoding(J.HashGridConfig(vectorized=vectorized, **VEC))
    te = T.HashGridEncoding(T.HashGridConfig(**VEC))
    rng = np.random.default_rng(3)
    table = rng.normal(size=(6, 2, 4096)).astype(np.float32)
    x = _positions(N, seed=4)
    u = rng.uniform(0, 1, N).astype(np.float32)
    ct = rng.normal(size=(N, 12)).astype(np.float32)
    ctd = rng.normal(size=(N, 3, 12)).astype(np.float32)
    return je, te, table, x, u, ct, ctd


def _kw(kw, u, jax_side: bool):
    out = dict(kw)
    if out.get("stoch_u"):
        out["stoch_u"] = jnp.asarray(u) if jax_side else torch.from_numpy(u)
    if "stoch_salt" in out:
        out["stoch_salt"] = jnp.uint32(out["stoch_salt"]) if jax_side else torch.tensor(out["stoch_salt"])
    return out


@pytest.mark.parametrize("reference", ["jax_encode_all", "jax_per_level"])
@pytest.mark.parametrize("op", list(OPS))
def test_all_level_op_matches_jax(op, reference):
    entry, kw, fn_name, pos_grad = OPS[op]
    je, te, table, x, u, ct, ctd = _setup(vectorized=reference == "jax_encode_all")
    jkw, tkw = _kw(kw, u, True), _kw(kw, u, False)

    if entry == "call":
        def jfwd(t, xx):
            return (je(t, xx, **jkw),)
    else:
        def jfwd(t, xx):
            return je.encode_with_dx(t, xx, **jkw)

    def jloss(t, xx):
        outs = jfwd(t, xx)
        return jnp.sum(outs[0] * ct) + (jnp.sum(outs[1] * ctd) if len(outs) > 1 else 0.0)

    outs_j = jfwd(jnp.asarray(table), jnp.asarray(x))
    gt_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))

    tt = torch.from_numpy(table).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(pos_grad)
    outs_t = (te(tt, xx, **tkw),) if entry == "call" else te.encode_with_dx(tt, xx, **tkw)
    if fn_name is not None:
        assert type(outs_t[0].grad_fn).__name__ == f"{fn_name}Backward"
    loss = (outs_t[0] * torch.from_numpy(ct)).sum()
    if len(outs_t) > 1:
        loss = loss + (outs_t[1] * torch.from_numpy(ctd)).sum()
    loss.backward()

    np.testing.assert_allclose(outs_t[0].detach().numpy(), np.asarray(outs_j[0]), atol=FWD_ATOL)
    scale = 1.0
    if len(outs_t) > 1:
        scale = DX_SCALE
        np.testing.assert_allclose(outs_t[1].detach().numpy(), np.asarray(outs_j[1]), atol=DX_SCALE * FWD_ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j), rtol=GRAD_RTOL, atol=scale * GRAD_ATOL)
    if pos_grad:
        np.testing.assert_allclose(xx.grad.numpy(), np.asarray(gx_j), rtol=GRAD_RTOL, atol=DX_SCALE * GRAD_ATOL)


# ---------------------------------------------------------------------------
# the scatter


@pytest.mark.parametrize("kind", ["heavy_duplicates", "odd_m", "encode_rows"])
def test_scatter_levels_plain_matches_jax(kind):
    """The plain ``_scatter_levels`` (the CPU side of the dispatch) against
    JAX ``_scatter_levels`` (the XLA scatter on the CPU).  Both drop rows
    ≥ T.  Sums of up to ~300 duplicates of N(0, 1) values in another
    order: atol 1e-4, the Pallas scatter test's."""
    rng = np.random.default_rng({"heavy_duplicates": 0, "odd_m": 1, "encode_rows": 2}[kind])
    te = T.HashGridEncoding(T.HashGridConfig(**VEC))
    levels, t = 6, 4096
    if kind == "heavy_duplicates":
        m = 4096
        rows = rng.integers(0, 13, (levels, m))
        rows[:, ::97] = t + 5  # out of range: dropped
    elif kind == "odd_m":
        m = 3001
        rows = rng.integers(0, t, (levels, m))
    else:  # the rows of the encoding's own indices
        m = 3001
        idx, _, _ = te._all_iw(torch.from_numpy(_positions(m, seed=5).T.copy()), False)
        rows = idx[:, 3].numpy()
    rows = rows.astype(np.int32)
    vals = rng.normal(size=(levels, 2, m)).astype(np.float32)
    out = T._scatter_levels(torch.from_numpy(rows), torch.from_numpy(vals), t)
    ref = np.asarray(J._scatter_levels(jnp.asarray(rows), jnp.asarray(vals), t))
    assert out.shape == (levels, 2, t) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_scatter_levels_plain_drops_rows_outside_the_table():
    rows = torch.tensor([[0, 3, 3, 9, 10, -1], [0, 3, 4, 9, 12, -2]], dtype=torch.int32)
    vals = torch.ones(2, 2, 6)
    out = T._scatter_levels(rows, vals, 10)
    assert out[0, 0].tolist() == [1, 0, 0, 2, 0, 0, 0, 0, 0, 1]
    assert out[1, 1].tolist() == [1, 0, 0, 1, 1, 0, 0, 0, 0, 1]


# ---------------------------------------------------------------------------
# the calls with no all-level twin in JAX stay per level


ROUTED = {
    # name: (config kwargs, entry, call kwargs, the per-level Function)
    "stoch_dxt": (dict(), "call", dict(custom_take=True, stoch_salt=SALT, stoch_dxt=True), "_LevelEncodeStoch"),
    "bf16_gather": (dict(bf16_gather=True), "call", dict(custom_take=True), "_LevelEncode"),
    "bf16_gather_dx_stoch": (dict(bf16_gather=True), "dx", dict(stoch_salt=SALT), "_LevelEncodeDxStoch"),
}


@pytest.mark.parametrize("name", list(ROUTED))
def test_calls_without_an_all_level_twin_stay_per_level(name, monkeypatch):
    """One per-level Function call per level and no all-level op; the
    result against the JAX per-level path (a bf16-gather forward: both
    round the table to bf16 alike, the sums in bf16 differ by its rounding,
    2^-8 of the largest value; ``_LevelEncodeDxStoch`` gathers in float32
    whatever ``bf16_gather`` says, as in JAX)."""
    cfg_kw, entry, kw, fn_name = ROUTED[name]
    je = J.HashGridEncoding(J.HashGridConfig(**VEC, **cfg_kw))
    te = T.HashGridEncoding(T.HashGridConfig(**VEC, **cfg_kw))
    calls = []
    fn = getattr(T, fn_name)
    orig = fn.apply
    monkeypatch.setattr(fn, "apply", lambda *a: (calls.append(a[1]), orig(*a))[1])
    rng = np.random.default_rng(6)
    table = rng.normal(size=(6, 2, 4096)).astype(np.float32)
    x = _positions(N, seed=7)
    tt = torch.from_numpy(table).requires_grad_(True)
    if entry == "call":
        out_t = te(tt, torch.from_numpy(x), **_kw(kw, None, False))
        out_j = je(jnp.asarray(table), jnp.asarray(x), **_kw(kw, None, True))
        jg = jax.grad(lambda t: jnp.sum(je(t, jnp.asarray(x), **_kw(kw, None, True))))(jnp.asarray(table))
    else:
        out_t = te.encode_with_dx(tt, torch.from_numpy(x), **_kw(kw, None, False))[0]
        out_j = je.encode_with_dx(jnp.asarray(table), jnp.asarray(x), **_kw(kw, None, True))[0]
        jg = jax.grad(lambda t: jnp.sum(je.encode_with_dx(t, jnp.asarray(x), **_kw(kw, None, True))[0]))(
            jnp.asarray(table))
    assert calls == list(range(6))
    assert not type(out_t.grad_fn).__name__.startswith("_EncodeAll")
    out_t.sum().backward()
    tol = 2.0**-8 * float(np.abs(out_j).max()) if name == "bf16_gather" else FWD_ATOL
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=tol)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
