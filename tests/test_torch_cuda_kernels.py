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
    """The SDF field's encode backward through K1 (one launch per level)
    against the same backward on the CPU through the plain version."""
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
    assert (n_cpu, n_card) == (0, cfg.num_levels)
    # d/dx cotangents carry the resolution (≤ 45): atol scaled to match
    torch.testing.assert_close(g_card, g_cpu, atol=45 * ATOL, rtol=1e-5)
