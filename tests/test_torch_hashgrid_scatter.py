"""K1 (the hash-table gradient scatter-add) of the PyTorch port: its plain
version against the JAX Pallas kernel in interpret mode and the XLA
reference (mirrors ``tests/test_pallas_scatter.py:18-50``), the CPU
dispatch and the wrapper's refusals.  The CUDA kernel against its plain
version is in ``test_torch_cuda_kernels.py``, which imports no JAX so that
it runs on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.ops.hashgrid_pallas import (
    _HAS_PLTPU,
    scatter_add_reference,
    scatter_add_tablegrad as j_scatter,
    scatter_add_tablegrad_t as j_scatter_t,
)
from neusky_torch.ops import hashgrid_cuda as k1

# float32 sums of a few duplicates each, in different orders: the Pallas
# test's atol
ATOL = 1e-4

needs_pallas = pytest.mark.skipif(not _HAS_PLTPU, reason="pallas tpu module unavailable")


def _case(kind: str):
    rng = np.random.default_rng({"random": 0, "dup": 1, "odd": 2}[kind])
    if kind == "random":
        t, m = 1024, 5000
        idx = rng.integers(0, t, m)
    elif kind == "dup":  # heavy duplicates, M not a multiple of any block
        t, m = 256, 600
        idx = np.array([0, 0, 0, 255, 255, 7] * 100)
    else:  # odd M, indices in a dense coarse range
        t, m = 512, 3001
        idx = rng.integers(0, 17, m)
    vals = rng.normal(size=(m, 2)).astype(np.float32)
    return idx.astype(np.int32), vals, t


@needs_pallas
@pytest.mark.parametrize("kind", ["random", "dup", "odd"])
def test_plain_matches_pallas_interpret_and_reference(kind):
    idx, vals, t = _case(kind)
    out = k1.scatter_add_tablegrad(torch.from_numpy(idx), torch.from_numpy(vals), t)
    assert out.shape == (t, 2)
    pallas = np.asarray(j_scatter(jnp.asarray(idx), jnp.asarray(vals), t, interpret=True))
    ref = np.asarray(scatter_add_reference(jnp.asarray(idx), jnp.asarray(vals), t))
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@needs_pallas
@pytest.mark.parametrize("kind", ["random", "dup", "odd"])
def test_plain_transposed_matches_pallas_interpret(kind):
    idx, vals, t = _case(kind)
    vt = np.ascontiguousarray(vals.T)
    out = k1.scatter_add_tablegrad_t(torch.from_numpy(idx), torch.from_numpy(vt), t)
    assert out.shape == (2, t)
    pallas = np.asarray(j_scatter_t(jnp.asarray(idx), jnp.asarray(vt), t, interpret=True))
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)


def test_duplicates_sum_exactly():
    idx = torch.tensor([0, 0, 0, 255, 255, 7] * 100, dtype=torch.int32)
    vals = torch.tensor([[1.0, -2.0]]).repeat(600, 1)
    out = k1.scatter_add_tablegrad(idx, vals, 256)
    assert out[0].tolist() == [300.0, -600.0]
    assert out[255].tolist() == [200.0, -400.0]


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = k1.launches[k1.KERNEL_NAME]
    idx, vals, t = _case("random")
    k1.scatter_add_tablegrad_t(torch.from_numpy(idx), torch.from_numpy(vals.T.copy()), t)
    assert k1.launches[k1.KERNEL_NAME] == before


@pytest.mark.parametrize(
    "bad, err, match",
    [
        (dict(idx_dtype=torch.int64), TypeError, "int32"),
        (dict(val_dtype=torch.float64), TypeError, "float32"),
        (dict(shape=(8, 3)), ValueError, "shapes"),
        (dict(shape=(2, 8)), ValueError, "shapes"),
        (dict(strided=True), ValueError, "contiguous"),
        (dict(), ValueError, "CUDA device"),
    ],
    ids=["int64_idx", "fp64_values", "bad_shape", "wrong_layout", "strided", "not_cuda"],
)
def test_launch_refuses_what_the_kernel_does_not_take(bad, err, match):
    """The CUDA launcher checks types, shapes, contiguity and device before
    it touches the library; it never falls back."""
    idx = torch.zeros(16 if bad.get("strided") else 8, dtype=bad.get("idx_dtype", torch.int32))
    if bad.get("strided"):
        idx = idx[::2]
    upd = torch.zeros(bad.get("shape", (8, 2)), dtype=bad.get("val_dtype", torch.float32))
    with pytest.raises(err, match=match):
        k1._launch(idx, upd, 16, transposed=False)


@pytest.mark.parametrize(
    "bad, err, match",
    [
        (dict(rows_dtype=torch.int64), TypeError, "int32"),
        (dict(vals_shape=(2, 3, 8)), ValueError, "shapes"),
        (dict(vals_shape=(3, 2, 8)), ValueError, "shapes"),
        (dict(rows_shape=(16,)), ValueError, "shapes"),
        (dict(strided=True), ValueError, "contiguous"),
        (dict(), ValueError, "CUDA device"),
    ],
    ids=["int64_rows", "three_features", "level_mismatch", "flat_rows", "strided", "not_cuda"],
)
def test_launch_levels_refuses_what_the_kernel_does_not_take(bad, err, match):
    """The all-level launcher checks types, shapes, contiguity and device
    before it touches the library; it never falls back."""
    rows = torch.zeros(bad.get("rows_shape", (2, 16 if bad.get("strided") else 8)),
                       dtype=bad.get("rows_dtype", torch.int32))
    if bad.get("strided"):
        rows = rows[:, ::2]
    vals = torch.zeros(bad.get("vals_shape", (2, 2, 8)))
    with pytest.raises(err, match=match):
        k1._launch_levels(rows, vals, 16)


# ---------------------------------------------------------------------------
# the gathers whose backward is K1: take_rows, take_level_flat, take_level


def _take_case(seed: int, t: int = 256, n: int = 64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, t)).astype(np.float32), rng.integers(0, t, (8, n)).astype(np.int32),
            rng.normal(size=(2, 8, n)).astype(np.float32))


@pytest.mark.parametrize("op", ["take_rows", "take_level_flat", "take_level"])
def test_take_ops_match_jax(op, monkeypatch):
    """Forward (a gather: equal) and the table gradient of a weighted sum
    against the JAX custom-VJP op on the CPU (its XLA scatter; float32
    sums of up to a few duplicates in another order: ``ATOL``); on a CPU
    tensor the backward takes K1's plain version, one call per backward."""
    import jax

    from neusky_tpu.ops import hashgrid_pallas as jp

    t2, idx, w = _take_case({"take_rows": 3, "take_level_flat": 4, "take_level": 5}[op])
    t = t2.shape[1]
    if op == "take_rows":
        table, weights = np.ascontiguousarray(t2.T), np.moveaxis(w, 0, -1)  # [T, 2]; [8, N, 2]
        j_fn, t_fn = jp.take_rows, k1.take_rows
    elif op == "take_level_flat":
        table, weights = t2.reshape(-1), w
        j_fn, t_fn = (lambda x, i: jp.take_level_flat(x, i, t)), (lambda x, i: k1.take_level_flat(x, i, t))
    else:
        table, weights = t2, w
        j_fn, t_fn = jp.take_level, k1.take_level
    want, grad = jax.value_and_grad(lambda x: jnp.sum(j_fn(x, jnp.asarray(idx)) * jnp.asarray(weights)))(
        jnp.asarray(table))
    got_fwd = t_fn(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got_fwd.numpy(), np.asarray(j_fn(jnp.asarray(table), jnp.asarray(idx))))
    calls = []
    for name in ("scatter_add_tablegrad", "scatter_add_tablegrad_t"):
        fn = getattr(k1, name)
        monkeypatch.setattr(k1, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    x = torch.from_numpy(table).requires_grad_(True)
    before = k1.launches[k1.KERNEL_NAME]
    loss = torch.sum(t_fn(x, torch.from_numpy(idx)) * torch.from_numpy(weights))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), atol=ATOL, rtol=0)
    assert calls == ["scatter_add_tablegrad" if op == "take_rows" else "scatter_add_tablegrad_t"]
    assert k1.launches[k1.KERNEL_NAME] == before


def test_take_level_round_trip_mirrors_the_jax_test():
    """``tests/test_pallas_scatter.py::test_take_level_roundtrip``: the
    forward is the plain gather, the gradient the plain scatter."""
    t2, idx, _ = _take_case(6)
    x = torch.from_numpy(t2).requires_grad_(True)
    out = k1.take_level(x, torch.from_numpy(idx))
    assert out.shape == (2, 8, 64)
    torch.sum(out**2).backward()
    ref = torch.from_numpy(t2).requires_grad_(True)
    torch.sum(ref[:, torch.from_numpy(idx).long()] ** 2).backward()
    torch.testing.assert_close(x.grad, ref.grad, atol=1e-5, rtol=0)
