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
    the fused step, captured): 3 steps (the first eager, the second
    captured and replayed, the third replayed), each launching K1 once per
    differentiated hash-grid encode, 7 times (counted through the
    replays), with a finite loss; 2,304 rays a step."""
    from neusky_torch import bench

    for name in ("NEUSKY_BENCH_SPLIT", "NEUSKY_BENCH_NATIVE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("NEUSKY_BF16_MAPPING", "1")
    b = bench.build(cuda_device)
    assert b.rays_per_step == 2304 and b.step.captured.replays == 0
    for s in range(3):
        before = k1.launches[k1.KERNEL_NAME]
        aux = b.step(b.params, b.datamanager.next_train(s), float(s), generator=b.generator)
        torch.cuda.synchronize()
        assert k1.launches[k1.KERNEL_NAME] - before == 7
        assert torch.isfinite(aux["total_loss"])
    assert b.step.captured.replays == 2 and b.step.captured.capture_s > 0


# ---------------------------------------------------------------------------
# the captured step (parallel/graphs.py) against the eager step, on the tiny
# configuration; phase 16 of chip_smoke.py holds bench's (a) the same way


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny(device, split=False, graphed=None, seed=0):
    """``bench.Bench`` of the tiny joint configuration: 2 images × 16 rays,
    2 × 16 vMF rays, 8 sky rays; the steps draw from a generator seeded 1."""
    from neusky_torch.bench import Bench
    from neusky_torch.configs.tiny_config import tiny_model_config
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine.optimizers import GroupedAdam, default_neusky_optimizer_groups
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.models.pipeline import PipelineConfig
    from neusky_torch.parallel import mesh
    from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

    cfg = tiny_model_config(2, 2)
    model = NeuSkyModel(cfg, device=device)
    pipe = PipelineConfig(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16),
                          num_sky_rays=8)
    params = model.init(torch.Generator(device).manual_seed(seed))
    opt = GroupedAdam(params, default_neusky_optimizer_groups(100))
    step = (mesh.make_train_step_split if split else mesh.make_train_step)(model, pipe, opt, graphed=graphed)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device=device)
    return Bench(cfg, model, pipe, dm, params, opt, step, torch.Generator(device).manual_seed(1), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_graphed_step_equals_eager_step(cuda_device, split):
    """4 steps of the tiny joint configuration, eager and captured, from the
    same params, batches and generator seed (the step a device scalar to
    both): the losses of every step within 1e-4 relative (the atomics'
    order), K1 7 a step in both (counted through the replays); then a 5th
    step of both from the captured run's state, its updates within phase
    3's bounds but where a gradient near zero flips Adam's update
    (``chip_smoke.same_state_step``)."""
    cs = _chip_smoke()
    runs = {}
    for graphed in (False, True):
        b = _tiny(cuda_device, split, graphed)
        before = k1.launches[k1.KERNEL_NAME]
        losses = [float(b.step(b.params, b.datamanager.next_train(s), torch.full((), float(s), device=cuda_device),
                               generator=b.generator)["total_loss"]) for s in range(4)]
        torch.cuda.synchronize()
        runs[graphed] = (b, losses, k1.launches[k1.KERNEL_NAME] - before)
        assert hasattr(b.step, "captured") == graphed
    (be, le, ke), (bg, lg, kg) = runs[False], runs[True]
    assert all(abs(g - e) <= 1e-4 * abs(e) for e, g in zip(le, lg)), (le, lg)
    assert ke == kg == 4 * 7
    close = cs.same_state_step(be, bg, split, 4)
    assert close["ok"] and close["loss_rel"] <= 1e-4, close


@pytest.mark.cuda
def test_graphed_step_raises_where_a_capture_fails(cuda_device, monkeypatch):
    """A step that reads a value on the host (``.item()``) runs as its eager
    warm-up but cannot be captured: the capturing call raises, and the
    params are as the warm-up left them (it did not run eagerly)."""
    from neusky_torch.parallel import mesh
    from neusky_torch.tree import tree_items

    real = mesh.train_loss_fn

    def syncing(*a, **k):
        total, aux = real(*a, **k)
        return total + 0.0 * total.item(), aux

    monkeypatch.setattr(mesh, "train_loss_fn", syncing)
    b = _tiny(cuda_device, graphed=True)
    b.step(b.params, b.datamanager.next_train(0), 0.0, generator=b.generator)
    kept = {k: v.detach().clone() for k, v in tree_items(b.params)}
    with pytest.raises(RuntimeError, match="capturing"):
        b.step(b.params, b.datamanager.next_train(1), 1.0, generator=b.generator)
    torch.cuda.synchronize()
    assert all(torch.equal(v, kept[k]) for k, v in tree_items(b.params))


@pytest.mark.cuda
def test_graphed_step_raises_on_a_changed_input(cuda_device, tmp_path):
    """After its capture the step refuses a batch of another shape and other
    params, and runs neither; ``graphed=True`` with a gloo mesh raises and
    the default with a gloo mesh is eager."""
    import torch.distributed as dist

    from neusky_torch.parallel import mesh
    from neusky_torch.tree import tree_items, tree_map

    b = _tiny(cuda_device, graphed=True)
    for s in range(3):
        b.step(b.params, b.datamanager.next_train(s), float(s), generator=b.generator)
    kept = {k: v.detach().clone() for k, v in tree_items(b.params)}
    batch = b.datamanager.next_train(3)
    with pytest.raises(ValueError, match="shape"):
        b.step(b.params, {**batch, "pixel_coords": batch["pixel_coords"][:-1]}, 3.0, generator=b.generator)
    with pytest.raises(ValueError, match="params"):
        b.step(tree_map(lambda t: t.detach().clone(), b.params), batch, 3.0, generator=b.generator)
    assert all(torch.equal(v, kept[k]) for k, v in tree_items(b.params))
    gloo = mesh.make_mesh(1, backend="gloo", rank=0, init_method=f"file://{tmp_path / 'store'}")
    try:
        b.model.set_mesh(gloo)
        with pytest.raises(ValueError, match="gloo mesh"):
            mesh.make_train_step(b.model, b.pipeline, b.optimizer, gloo, graphed=True)
        assert not hasattr(mesh.make_train_step(b.model, b.pipeline, b.optimizer, gloo), "captured")
    finally:
        b.model.set_mesh(None)
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_mesh_trainer_step_captured_equals_eager(cuda_device):
    """``Trainer(mesh=)`` on a one-rank NCCL mesh captures its step by
    default (one graph replay a step after the eager first call and the
    capture, its ``all_reduce`` inside) and ``graphed=False`` keeps it
    eager: over 4 steps from one seed the losses agree within 1e-4
    relative and K1 launches 7 a step in both (counted through the
    replays); one more step of both from the captured trainer's state is
    within phase 3's bounds (``chip_smoke.same_state_step``)."""
    from pathlib import Path

    from neusky_torch.parallel.launch import run_ranks

    (r,) = run_ranks("torch_mesh_ranks:nccl_trainer_rank", 1, dict(steps=4), paths=(Path(__file__).parent,))
    captured, eager = r[None], r[False]
    assert r["replays"] == 3 and not r["eager_has_graph"]
    assert all(abs(g - e) <= 1e-4 * abs(e) for e, g in zip(eager["losses"], captured["losses"])), r
    assert captured["launches"] == eager["launches"] == [7] * 4
    assert r["same_state"]["ok"] and r["same_state"]["loss_rel"] <= 1e-4, r["same_state"]


@pytest.mark.cuda
def test_nccl_mesh_step_capture_failure_raises(cuda_device):
    """A one-rank NCCL mesh step that reads the host cannot be captured:
    the rank raises (it does not run the step eagerly instead), and
    ``run_ranks`` raises with its traceback."""
    from pathlib import Path

    from neusky_torch.parallel.launch import run_ranks

    with pytest.raises(RuntimeError, match="capturing the step as a CUDA graph failed"):
        run_ranks("torch_mesh_ranks:nccl_capture_failure_rank", 1, paths=(Path(__file__).parent,), timeout_s=300)


@pytest.mark.cuda
def test_gloo_dryrun_on_one_card_runs_both_sides_eagerly(cuda_device):
    """``dryrun_multichip`` with gloo ranks sharing the card (the one-card
    dry run): the ranks' step is eager, and so is the one-process step it
    is held to, one call each (no replays), the losses within 1e-3."""
    from neusky_torch.parallel.dryrun import LOSS_RTOL, dryrun_multichip

    out = dryrun_multichip(2, device="cuda", backend="gloo")
    assert out["replays"] == 0 and out["rel_err"] < LOSS_RTOL, out


@pytest.mark.cuda
def test_graphed_trainer_resumes_as_the_eager_trainer(cuda_device, tmp_path):
    """A captured trainer saves at step 2, trains 2 more steps, and loads
    step 2 back into the same params and Adam (its graph was captured over
    the old Adam state, so it warms up and captures again); an eager
    trainer loads the same checkpoint.  The Adam state after the load is
    the checkpoint's bit for bit; from the same generator state and batch
    stream the next 3 steps' losses agree within 1e-4 relative, and one
    more step from one state (the captured trainer's replay against the
    eager one) within phase 3's bounds (``chip_smoke.same_state_step``)."""
    import types

    from neusky_torch.engine.trainer import Trainer, TrainerConfig

    cs = _chip_smoke()

    def trainer(graphed):
        b = _tiny(cuda_device)
        return Trainer(TrainerConfig(max_num_iterations=100, steps_per_log=1, steps_per_save=1000,
                                     steps_per_eval_image=1000, seed=0),
                       b.model, b.pipeline, b.datamanager, device=cuda_device, graphed=graphed)

    a, b = trainer(None), trainer(False)
    a.run(2)
    a.save(str(tmp_path))
    a.run(2)
    graph, replays = a.train_step.captured.graph, a.train_step.captured.replays
    assert graph is not None and replays == 3
    a.load(str(tmp_path), 2)
    b.load(str(tmp_path), 2)
    assert cs._equal_state(a.optimizer.state_dict(), b.optimizer.state_dict())
    b.generator.set_state(a.generator.get_state())
    la = [r["total_loss"] for r in a.run(3)[-3:]]
    lb = [r["total_loss"] for r in b.run(3)[-3:]]
    assert a.train_step.captured.replays == replays + 2 and a.train_step.captured.graph is not graph
    assert all(abs(x - y) <= 1e-4 * abs(y) for x, y in zip(la, lb)), (la, lb)
    as_bench = lambda t: types.SimpleNamespace(model=t.model, pipeline=t.pipeline_config,  # noqa: E731
                                               datamanager=t.datamanager, params=t.params,
                                               optimizer=t.optimizer, step=t.train_step)
    close = cs.same_state_step(as_bench(b), as_bench(a), False, a.step)
    assert close["ok"] and close["loss_rel"] <= 1e-4, close



GRAPH_PATHS = ("ddf_step", "reni_step", "envmap_fit", "rotation_fit", "render_chunk", "rotating_chunk", "lpips")


@pytest.mark.cuda
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_captured_path_equals_its_eager_self(cuda_device, path):
    """Each path captured besides the training step, on the tiny
    configuration, against itself run eagerly from the same params and
    draws (``chip_smoke.py`` phase 17's functions and bounds at a small
    size): 5 DDF and RENI steps, 10-step envmap and rotation fits, renders
    of 70 rays (a padded chunk) and 64 rays in chunks of 64, LPIPS of two
    16 × 16 images; K1 0 in both."""
    from neusky_torch.configs.tiny_config import tiny_model_config
    from neusky_torch.core.spherical import rot_z
    from neusky_torch.data.sky_generator import generate_sky_corpus
    from neusky_torch.fields.reni import RENIField, RENIFieldConfig
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

    cs = _chip_smoke()
    card = "test"
    field_cfg = RENIFieldConfig(latent_dim=8, hidden_features=16, hidden_layers=2, mapping_layers=2,
                                mapping_features=16, num_attention_heads=2, num_attention_layers=2,
                                fixed_decoder=False)
    model = NeuSkyModel(tiny_model_config(2, 2), device=cuda_device)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    make_dm = lambda: cs.eval_datamanager("cuda", train_cams=2, eval_cams=2, px=16, rays=(2, 16), sky=8)  # noqa: E731
    if path == "ddf_step":
        sampler = DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16, only_sample_upper_hemisphere=True,
                                   concentration=20.0)
        row = cs.graph_ddf(model, params, make_dm, card, steps=5, sampler=sampler, num_sky_rays=8)
    elif path == "reni_step":
        row = cs.graph_reni(generate_sky_corpus(4, width=32, seed=3), field_cfg, card, steps=5, pixels=64)
    elif path == "envmap_fit":
        field = RENIField(field_cfg)
        decoder = field.init(torch.Generator(cuda_device).manual_seed(1), cuda_device)
        row = cs.graph_envmap_fit(field, decoder, generate_sky_corpus(5, width=32, seed=4), card, steps=10, pixels=64)
    elif path == "rotation_fit":
        gt = torch.randn((2, model.config.illumination.latent_dim, 3), generator=torch.Generator(cuda_device).manual_seed(5),
                         device=cuda_device)
        row = cs.graph_rotation_fit(model, params, make_dm, gt, card, steps=10)
    elif path in ("render_chunk", "rotating_chunk"):
        rays = make_dm().eval_image_bundle(0)[0]
        rotation = rot_z(torch.tensor(0.7, device=cuda_device)) if path == "rotating_chunk" else None
        row, _ = cs.graph_render(model, params, [rays.slice(0, 70), rays.slice(70, 64)], card, rotation=rotation,
                                 chunk_size=64)
    else:
        g = np.random.default_rng(6)
        row = cs.graph_lpips(g.random((16, 16, 3)).astype(np.float32), g.random((16, 16, 3)).astype(np.float32), card)
    assert row["ok"] and row["eager_k1_launches"] == row["graphed_k1_launches"] == 0, row
    assert row["capture_s"] is not None, row


@pytest.mark.cuda
def test_a_capture_frees_the_pools_of_graphs_dropped_in_a_cycle(cuda_device):
    """A captured function kept in a reference cycle holds its static
    buffers and its graph's pool until the garbage collector breaks the
    cycle; the next capture collects first, so
    the 2 GiB they hold are no longer allocated after it (and its
    ``torch.cuda.graph`` empties the cache, so no longer reserved)."""
    import gc

    from neusky_torch.parallel.graphs import CapturedStep

    gc.disable()  # the collector runs only where the capture runs it
    try:
        x = torch.zeros(2**28, device=cuda_device)  # 1 GiB
        holder = {"step": CapturedStep(lambda _, __, t: t + 1.0)}
        holder["self"] = holder
        for _ in range(3):
            holder["step"](None, None, x)
        del holder
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        step = CapturedStep(lambda _, __, t: t * 2.0)
        small = torch.ones(8, device=cuda_device)
        outs = [step(None, None, small) for _ in range(3)]
        torch.cuda.synchronize()
        freed = held - torch.cuda.memory_allocated()
    finally:
        gc.enable()
    assert step.graph is not None and all(torch.equal(o, small * 2.0) for o in outs)
    assert freed >= 2 * 2**30 - 2**20, freed  # less the new graph's few bytes


@pytest.mark.cuda
def test_a_forward_capture_copies_its_params_once_per_params_tree(cuda_device):
    """A forward capture (the render chunk's kind) copies its params into
    its graph only when they are other tensors than its last call's or were
    written since: a second call with the same params copies none of them,
    and a call after an eager in-place write, after a captured step's
    replay wrote them (a replay moves no version counter) or with other
    tensors computes from the new values."""
    from neusky_torch.parallel.graphs import CapturedStep

    class Copies(torch.utils._python_dispatch.TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count += func is torch.ops.aten.copy_.default
            return func(*args, **(kwargs or {}))

    def copies(params):
        mode = Copies()
        with mode:
            out = forward(params, None, x)
        return mode.count, out

    params = {"a": torch.ones(4, device=cuda_device), "b": torch.full((4,), 2.0, device=cuda_device)}
    x = torch.arange(4.0, device=cuda_device)
    forward = CapturedStep(lambda p, _, t: p["a"] * t + p["b"])
    update = CapturedStep(lambda p, _: p["a"].add_(1.0), optimizer=object())
    update(params, None)  # eager
    update(params, None)  # captured, then replayed
    want = lambda p: p["a"] * x + p["b"]  # noqa: E731
    for _ in range(3):  # eager, captured, replayed
        out = forward(params, None, x)
    assert forward.graph is not None and torch.equal(out, want(params))
    n_new, out = copies(params)
    assert torch.equal(out, want(params))
    params["b"].mul_(3.0)  # an eager write
    n_written, out = copies(params)
    assert torch.equal(out, want(params)) and n_written == n_new + 2, (n_new, n_written)
    update(params, None)  # a replay: no version counter moves
    n_replayed, out = copies(params)
    assert torch.equal(out, want(params)) and n_replayed == n_written, (n_written, n_replayed)
    other = {k: v + 1.0 for k, v in params.items()}
    n_other, out = copies(other)
    assert torch.equal(out, want(other)) and n_other == n_written, (n_written, n_other)
