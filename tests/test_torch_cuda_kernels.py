"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a card and skips without one.  The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from neusky_torch.ops import hashgrid as hg
from neusky_torch.ops import hashgrid_cuda as k1

# float32 sums of a few duplicates each, in an order the atomics choose:
# the Pallas scatter test's atol
ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "planes"])
@pytest.mark.parametrize("kind", ["random", "dup", "odd"])
def test_k1_matches_plain(cuda_device, kind, transposed):
    idx, vals, t = _case(kind)
    i = torch.from_numpy(idx).to(cuda_device)
    v = torch.from_numpy(np.ascontiguousarray(vals.T) if transposed else vals).to(cuda_device)
    before = k1.launches[k1.KERNEL_NAME]
    if transposed:
        out, ref = k1.scatter_add_tablegrad_t(i, v, t), k1.scatter_add_plain_t(i, v, t)
    else:
        out, ref = k1.scatter_add_tablegrad(i, v, t), k1.scatter_add_plain(i, v, t)
    torch.cuda.synchronize()
    assert k1.launches[k1.KERNEL_NAME] == before + 1
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_k1_refuses_cuda_tensors_it_does_not_take(cuda_device):
    """No fallback: a CUDA tensor of another type raises."""
    idx = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        k1.scatter_add_tablegrad(idx, torch.zeros(8, 2, device=cuda_device), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("stoch", [False, True], ids=["exact", "stochastic"])
def test_encode_with_dx_table_gradient_on_card_matches_cpu(cuda_device, stoch):
    """The SDF field's encode backward through K1 (one launch for all
    levels) against the same backward on the CPU through the plain
    version."""
    cfg = hg.HashGridConfig(num_levels=5, log2_hashmap_size=10, base_res=4, max_res=45)
    enc = hg.HashGridEncoding(cfg)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(5, 2, 1024)).astype(np.float32)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    ct = rng.normal(size=(300, 10)).astype(np.float32)
    ctd = rng.normal(size=(300, 3, 10)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        tt = torch.from_numpy(table).to(dev).requires_grad_(True)
        salt = torch.tensor(0xDEADBEEF, device=dev) if stoch else None
        o, d = enc.encode_with_dx(tt, torch.from_numpy(x).to(dev), stoch_salt=salt)
        before = k1.launches[k1.KERNEL_NAME]
        ((o * torch.from_numpy(ct).to(dev)).sum() + (d * torch.from_numpy(ctd).to(dev)).sum()).backward()
        grads[str(dev)] = (tt.grad.cpu(), k1.launches[k1.KERNEL_NAME] - before)
    (g_cpu, n_cpu), (g_card, n_card) = grads["cpu"], grads[str(cuda_device)]
    assert (n_cpu, n_card) == (0, 1)
    # d/dx cotangents carry the resolution (≤ 45): atol scaled to match
    torch.testing.assert_close(g_card, g_cpu, atol=45 * ATOL, rtol=1e-5)


# ---------------------------------------------------------------------------
# all levels of an encode in one launch


def _levels_case(kind: str):
    """(rows [L, M] int32, vals [L, 2, M], T): only dense-sized levels (rows
    past the table included: dropped), only hashed levels, a mixed
    pyramid with an encoding's own rows in ray order (runs of equal rows),
    one level that takes heavy duplicates, and the joint step's two SDF
    query sites: the level-set query (1,024 rays × 64 termination points,
    one sampled corner each) and the DDF-fit query (1,024 points, all eight
    corners).  No other M is a multiple of the block."""
    seeds = {"dense_only": 0, "hashed_only": 1, "mixed_pyramid": 2, "heavy_duplicates": 3,
             "level_set_sdf": 4, "ddf_fit_sdf_exact": 5}
    rng = np.random.default_rng(seeds[kind])
    if kind == "dense_only":
        t, m = 4913, 5001
        rows = np.stack([rng.integers(0, r, m) for r in (125, 729, t + 40)])
    elif kind == "hashed_only":
        t, m = 1 << 14, 5001
        rows = rng.integers(0, t, (4, m))
    elif kind == "mixed_pyramid":
        enc = hg.HashGridEncoding(hg.HashGridConfig(num_levels=16, log2_hashmap_size=19))
        t, n_rays, s = 1 << 19, 1025, 48
        o, d = rng.uniform(0, 1, (n_rays, 1, 3)), rng.normal(size=(n_rays, 1, 3))
        along = np.sort(rng.uniform(0, 1, (n_rays, s, 1)), axis=1)
        x = np.clip(o + 0.5 * along * d / np.linalg.norm(d, axis=-1, keepdims=True), 0, 1).reshape(-1, 3)
        idx, _, _ = enc._all_iw(torch.from_numpy(x.T.astype(np.float32)), need_dw=False)
        m = n_rays * s
        rows = torch.gather(idx, 1, torch.from_numpy(rng.integers(0, 8, (16, 1, m)))).numpy()[:, 0]
    elif kind in ("level_set_sdf", "ddf_fit_sdf_exact"):
        enc = hg.HashGridEncoding(hg.HashGridConfig(num_levels=16, log2_hashmap_size=19))
        t, n = 1 << 19, (1024 * 64 if kind == "level_set_sdf" else 1024)
        x = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
        idx, _, _ = enc._all_iw(torch.from_numpy(x.T.copy()), need_dw=False)  # [16, 8, n]
        if kind == "level_set_sdf":
            m = n
            rows = torch.gather(idx, 1, torch.from_numpy(rng.integers(0, 8, (16, 1, m)))).numpy()[:, 0]
        else:
            m = 8 * n
            rows = idx.reshape(16, m).numpy()
    else:
        t, m = 1 << 19, 262_144 + 3
        rows = rng.integers(0, 17**2, (1, m))
    vals = rng.normal(size=(rows.shape[0], 2, m)).astype(np.float32)
    return rows.astype(np.int32), vals, t


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense_only", "hashed_only", "mixed_pyramid", "heavy_duplicates",
                                  "level_set_sdf", "ddf_fit_sdf_exact"])
def test_k1_all_levels_match_plain(cuda_device, kind):
    """One launch writes the whole [L, 2, T] output, zero rows included: the
    output's memory is filled with NaN just before, so any cell the kernel
    leaves unwritten fails the comparison.  Atomics and the warp's run sums
    reorder each row's sum: atol 1e-4 (the Pallas test's) up to 64 updates
    a row, growing linearly beyond."""
    rows, vals, t = _levels_case(kind)
    r, v = torch.from_numpy(rows).to(cuda_device), torch.from_numpy(vals).to(cuda_device)
    ref = k1.scatter_levels_plain(r, v, t)
    junk = torch.full((r.shape[0], 2, t), float("nan"), device=cuda_device)
    del junk  # the caching allocator hands this block to the kernel's output
    before = k1.launches[k1.KERNEL_NAME]
    out = k1.scatter_levels(r, v, t)
    torch.cuda.synchronize()
    assert k1.launches[k1.KERNEL_NAME] == before + 1
    max_dup = max(int(torch.bincount(r[l].long().clamp(0, t)).max()) for l in range(r.shape[0]))
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, max_dup / 64.0), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad, err, match",
    [
        (dict(rows_dtype=torch.int64), TypeError, "int32"),
        (dict(vals_shape=(2, 3, 100)), ValueError, "shapes"),
        (dict(rows_device="cpu"), ValueError, "CUDA device"),
        (dict(table_size=2**28), ValueError, "32 bits"),
    ],
    ids=["int64_rows", "three_features", "rows_on_cpu", "too_large_for_32_bit_indices"],
)
def test_k1_all_levels_refuse_what_the_kernel_does_not_take(cuda_device, bad, err, match):
    """No fallback: a CUDA call the kernel does not take raises."""
    rows = torch.zeros((4, 100), dtype=bad.get("rows_dtype", torch.int32), device=bad.get("rows_device", cuda_device))
    vals = torch.zeros(bad.get("vals_shape", (4, 2, 100)), device=cuda_device)
    with pytest.raises(err, match=match):
        k1.scatter_levels(rows, vals, bad.get("table_size", 64))


# ---------------------------------------------------------------------------
# the gathers whose backward is K1


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["take_rows", "take_level_flat", "take_level"])
def test_take_ops_gradient_on_card_matches_index_add(cuda_device, op):
    """``take_rows``, ``take_level_flat`` and ``take_level`` on the card:
    the forward is the gather, the backward one K1 launch whose table
    gradient equals ``index_add_`` of the cotangent at the gathered rows
    (atomics reorder each row's few-term sum: ``ATOL``)."""
    rng = np.random.default_rng({"take_rows": 0, "take_level_flat": 1, "take_level": 2}[op])
    t, n = 4096, 3001
    t2 = torch.from_numpy(rng.normal(size=(2, t)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, t, (8, n)).astype(np.int32)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(2, 8, n)).astype(np.float32)).to(cuda_device)
    flat_g = g.reshape(2, -1)
    want = torch.zeros(2, t, device=cuda_device)
    for f in range(2):
        want[f].index_add_(0, idx.reshape(-1).long(), flat_g[f])
    if op == "take_rows":
        x = t2.t().contiguous().requires_grad_(True)
        out, cot = k1.take_rows(x, idx), g.permute(1, 2, 0)
        fwd, want = x.detach()[idx.long()], want.t()
    elif op == "take_level_flat":
        x = t2.reshape(-1).clone().requires_grad_(True)
        out, cot = k1.take_level_flat(x, idx, t), g
        fwd, want = t2[:, idx.long()], want.reshape(-1)
    else:
        x = t2.clone().requires_grad_(True)
        out, cot = k1.take_level(x, idx), g
        fwd = t2[:, idx.long()]
    assert torch.equal(out.detach(), fwd)
    before = k1.launches[k1.KERNEL_NAME]
    out.backward(cot)
    torch.cuda.synchronize()
    assert k1.launches[k1.KERNEL_NAME] == before + 1
    torch.testing.assert_close(x.grad, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the bf16 product on the tensor cores (not a kernel of the port: a library
# GEMM, as XLA's in JAX; held here to the CPU's rounded float32 product)


@pytest.mark.cuda
def test_bf16_matmul_on_card_matches_the_cpu_product(cuda_device):
    """bf16 × bf16 → float32 on the card against the CPU's float32 product
    of the same bf16-rounded inputs: values to 1e-5 of their scale (the
    same exact products, summed in another order).  The input cotangents
    are bf16-rounded on both sides: each element within 1e-5 of the
    array's scale (the float32 sums' order) plus one bf16 step of the
    element (2⁻⁷ of it at most), where the two sums straddle a rounding
    boundary."""
    from neusky_torch.nets.bf16 import bf16_matmul

    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(4096, 256)).astype(np.float32), rng.normal(size=(256, 2560)).astype(np.float32)
    g = rng.normal(size=(4096, 2560)).astype(np.float32)
    got, want = [], []
    for dev, out in ((cuda_device, got), ("cpu", want)):
        ta = torch.from_numpy(a).to(dev).requires_grad_(True)
        tb = torch.from_numpy(b).to(dev).requires_grad_(True)
        y = bf16_matmul(ta, tb)
        y.backward(torch.from_numpy(g).to(dev))
        out += [t.detach().cpu() for t in (y, ta.grad, tb.grad)]
    assert got[0].dtype == torch.float32
    assert float((got[0] - want[0]).abs().max() / want[0].abs().max()) < 1e-5
    for x, y in zip(got[1:], want[1:]):
        assert torch.equal(x, x.bfloat16().float())
        assert bool(((x - y).abs() <= 2.0**-7 * y.abs() + 1e-5 * y.abs().max()).all())


# ---------------------------------------------------------------------------
# the port's bench on the card (K1 on the main path)


@pytest.mark.cuda
def test_bench_step_launches_k1_seven_times_a_step(cuda_device, monkeypatch):
    """``neusky_torch.bench.build`` on the card (bench's configuration (a),
    the fused step): 2 steps, each launching K1 once per differentiated
    hash-grid encode, 7 times, with a finite loss; 2,304 rays a step."""
    from neusky_torch import bench

    for name in ("NEUSKY_BENCH_SPLIT", "NEUSKY_BENCH_NATIVE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NEUSKY_BF16_MAPPING", "1")
    b = bench.build(cuda_device)
    assert b.rays_per_step == 2304
    for s in range(2):
        before = k1.launches[k1.KERNEL_NAME]
        aux = b.step(b.params, b.datamanager.next_train(s), float(s), generator=b.generator)
        torch.cuda.synchronize()
        assert k1.launches[k1.KERNEL_NAME] - before == 7
        assert torch.isfinite(aux["total_loss"])
