"""The DDF visibility query's fused FiLM-SIREN forward
(``neusky_torch/csrc/ddf_film_forward.cu``, ``ops/ddf_film_cuda.py``) and
where ``NeuSkyModel.compute_visibility`` takes it.

On the CPU: the weights packed as the kernel reads them; the kernel's gate
(``DirectionalDistanceField.film_kernel_takes``); every structure the kernel
does not compute, the CPU and the ``"dots"`` policy running the plain query
with ``ddf.fused_rows`` at 0; and, with a stand-in for the kernel (the plain
forward on the CPU), the dispatch itself: one launch when autograd records
nothing, and a chunk Function in training whose gradients equal the
checkpoint's.  The tests marked ``cuda`` need a card and skip without one:

    python -m pytest tests/test_torch_ddf_fused.py -m cuda
"""

import dataclasses
import statistics

import pytest
import torch

from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.core.rays import RaySamples
from neusky_torch.fields.ddf import DDFFieldConfig
from neusky_torch.models import neusky as t_neusky
from neusky_torch.ops import ddf_film_cuda
from neusky_torch.ops.hashgrid import HashGridConfig
from neusky_torch.tree import tree_items, tree_map
from neusky_torch.utils import profiling
from neusky_torch.utils.profiling import count_visibility_queries

CANONICAL = DDFFieldConfig(position_encoding_type="nerf")  # the recipes' DDF: FiLM, 5 × 256, bf16 FiLM products
_SMALL_HASH = HashGridConfig(num_levels=2, features_per_level=2, log2_hashmap_size=10, base_res=4, max_res=16)
FALLBACKS = {
    "tiny_width": dict(hidden_features=32, mapping_features=32),
    "concat": dict(conditioning="Concat"),
    "attention": dict(conditioning="Attention", num_attention_layers=1),
    "pddf": dict(ddf_type="pddf"),
    "hash_positions": dict(position_encoding_type="hash", hash=_SMALL_HASH),
    "hash_directions": dict(direction_encoding_type="hash", hash=_SMALL_HASH),
    "per_layer_heads": dict(film_per_layer_heads=True),
    "bf16_mapping": dict(use_bf16_mapping=True),
    "fp32_film_products": dict(use_bf16_compute=False),
}
# the query rows of a neusky.train step: 1,024 rays × 254 queried directions
STEP_ROWS = 1024 * 254


@pytest.fixture
def fused_rows():
    profiling.totals[ddf_film_cuda.FUSED_ROWS] = 0
    yield lambda: profiling.totals[ddf_film_cuda.FUSED_ROWS]
    del profiling.totals[ddf_film_cuda.FUSED_ROWS]


def _model(field: DDFFieldConfig, device="cpu", **config):
    cfg = tiny_model_config()
    cfg = dataclasses.replace(cfg, ddf=dataclasses.replace(cfg.ddf, field=field), **config)
    return t_neusky.NeuSkyModel(cfg, device=device)


def _ddf_params(model, seed: int = 0, trainable: bool = False):
    p = model.ddf.init(torch.Generator(device=model.device).manual_seed(seed), model.device)
    return tree_map(lambda t: t.requires_grad_(trainable), p)


def _ray_samples(n: int, seed: int = 0, device="cpu"):
    """Rays from around the sphere toward the scene, with surface depths
    that put some points outside the DDF sphere (the pull-back path)."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g) * 0.3 + torch.tensor([0.0, -1.6, 0.3])
    d = torch.nn.functional.normalize(torch.tensor([0.0, 1.0, -0.1]) + 0.3 * torch.randn(n, 3, generator=g), dim=-1)
    ones, zeros = torch.ones(n, 1, 1), torch.zeros(n, 1, 1)
    rs = RaySamples(origins=o[:, None], directions=d[:, None], starts=zeros, ends=ones, pixel_area=ones,
                    camera_indices=torch.zeros(n, 1, 1, dtype=torch.int32), deltas=ones, spacing_starts=zeros,
                    spacing_ends=ones)
    rs = RaySamples(**{f.name: getattr(rs, f.name).to(device) for f in dataclasses.fields(rs)})
    p2p = (0.3 + 2.9 * torch.rand(n, 1, generator=g)).to(device)
    dirs = torch.nn.functional.normalize(torch.randn(12, 3, generator=g), dim=-1).to(device)
    return rs, p2p, dirs


def _visibility(model, ddf_params, rs, p2p, dirs):
    return model.compute_visibility({"ddf_field": ddf_params}, rs, p2p, dirs, torch.tensor(0.3, device=p2p.device),
                                    torch.tensor(25.0, device=p2p.device), False, False)


@pytest.fixture
def stand_in(monkeypatch):
    """The kernel replaced by the plain forward on the CPU, counting its
    rows and its calls as the kernel's wrapper does."""
    calls = []

    def install(model, params):
        net = params["params"]["field"]["net"]

        def film_forward(packed, origins, local_dirs, scale):
            assert torch.equal(packed.biases, ddf_film_cuda.pack(net).biases)
            assert scale == 2.0 * model.ddf.ddf_radius
            calls.append(origins.shape[0])
            profiling.count(ddf_film_cuda.FUSED_ROWS, origins.shape[0])
            return model.ddf.field({"net": net}, origins, local_dirs)["expected_termination_dist"]

        monkeypatch.setattr(ddf_film_cuda, "takes", lambda rows: rows.dtype == torch.float32)
        monkeypatch.setattr(ddf_film_cuda, "film_forward", film_forward)
        return calls

    return install


class _Spy:
    """Wraps ``DDFModel.apply``: the rows and outputs of every plain query."""

    def __init__(self, monkeypatch, model):
        self.rows, self.outs = [], []
        apply = model.ddf.apply

        def spied(params, origins, directions):
            out = apply(params, origins, directions)
            self.rows.append(origins.shape[0])
            self.outs.append(out["expected_termination_dist"].detach())
            return out

        monkeypatch.setattr(model.ddf, "apply", spied)


# ---------------------------------------------------------------------------
# the packed weights and the gate


def test_pack_lays_the_weights_out_as_the_kernel_reads_them():
    """Each 16 KB chunk in a tile's order: the fp32 rows of the mapping
    kernels (the first padded to 16 rows), then per FiLM layer its kernel
    as ``mma.sync`` m16n8k16 B fragments (lane 4g + t holds column 8·tile +
    g at rows 2t, 2t + 1, 2t + 8, 2t + 9 of its 16-row tile, rounded to
    bf16), then its frequency and phase column blocks of ``kernel_out``."""
    model = _model(CANONICAL)
    net = _ddf_params(model)["params"]["field"]["net"]
    packed = ddf_film_cuda.pack(net)
    mp, w = net["MappingNetwork_0"], ddf_film_cuda.WIDTH
    nm, nf = packed.mapping_layers, packed.film_layers
    assert (nm, nf) == (5, 5)
    assert packed.n_chunks == 1 + 16 * (nm - 1) + 1 + 32 + (nf - 1) * (8 + 32)
    raw = packed.chunks
    at = 0

    def take_f32(rows):
        nonlocal at
        out = raw[at:at + rows * w * 4].view(torch.float32).reshape(rows, w)
        at += rows * w * 4
        return out

    def take_fragments(k):
        nonlocal at
        tiles = -(-k // 16)
        frag = raw[at:at + tiles * 16 * w * 2].view(torch.bfloat16).reshape(tiles, w // 8, 32, 4)
        at += tiles * 16 * w * 2
        out = torch.zeros(tiles * 16, w, dtype=torch.bfloat16)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for j, dk in enumerate((0, 1, 8, 9)):
                rows = torch.arange(tiles)[:, None] * 16 + 2 * t + dk
                cols = torch.arange(w // 8)[None, :] * 8 + g
                out[rows, cols] = frag[:, :, lane, j]
        return out

    first = take_f32(16)
    assert torch.equal(first[:15], mp["kernel_0"]) and not first[15].any()
    for i in range(1, nm):
        assert torch.equal(take_f32(w), mp[f"kernel_{i}"]), i
    ko = mp["kernel_out"]
    for i in range(nf):
        k = net[f"film_kernel_{i}"].shape[0]
        frag = take_fragments(k)
        assert torch.equal(frag[:k], net[f"film_kernel_{i}"].bfloat16()) and not frag[k:].float().any(), i
        if i == 0:  # the first layer's single tile fills half a chunk
            assert not raw[at:at + 8192].any()
            at += 8192
        assert torch.equal(take_f32(w), ko[:, i * w:(i + 1) * w]), i
        assert torch.equal(take_f32(w), ko[:, (nf + i) * w:(nf + i + 1) * w]), i
    assert at == raw.numel()
    want = [mp[f"bias_{i}"] for i in range(nm)] + [mp["bias_out"]] + [net[f"film_bias_{i}"] for i in range(nf)]
    want += [net["out_kernel"][:, 0], net["out_bias"]]
    assert torch.equal(packed.biases, torch.cat(want))


@pytest.mark.parametrize("variant", ["canonical", *FALLBACKS])
def test_the_kernel_takes_only_the_canonical_field(variant):
    field = dataclasses.replace(CANONICAL, **FALLBACKS.get(variant, {}))
    assert _model(field).ddf.field.film_kernel_takes() == (variant == "canonical")


# ---------------------------------------------------------------------------
# the dispatch


@pytest.mark.parametrize("variant", ["cpu", "dots", *FALLBACKS])
def test_each_fallback_runs_the_plain_query(variant, monkeypatch, stand_in, fused_rows):
    """With the stand-in in place of the kernel, every structure it does
    not compute, and the ``"dots"`` policy in training, run the plain query
    on every row with the counter at 0; without the stand-in the CPU does,
    at the canonical widths too."""
    field = dataclasses.replace(CANONICAL, **FALLBACKS.get(variant, {}))
    model = _model(field, visibility_remat_policy="dots" if variant == "dots" else "full")
    params = _ddf_params(model, trainable=variant == "dots")
    calls = [] if variant == "cpu" else stand_in(model, params)
    spy = _Spy(monkeypatch, model)
    rs, p2p, dirs = _ray_samples(4)
    out = _visibility(model, params, rs, p2p, dirs)
    assert fused_rows() == 0 and calls == []
    assert sum(spy.rows) == 4 * 12
    assert torch.equal(out["expected_termination_dist"].detach(), torch.cat(spy.outs))


def test_the_canonical_field_takes_one_launch_without_autograd(monkeypatch, stand_in, fused_rows):
    """Autograd recording nothing, every query row goes to the kernel in
    one launch (in place of the plain query's chunks), and the counter
    counts them; the distances are those of the plain query."""
    model = _model(CANONICAL, visibility_query_chunk=16)
    rs, p2p, dirs = _ray_samples(4)
    params = _ddf_params(model)
    spy = _Spy(monkeypatch, model)
    want = _visibility(model, params, rs, p2p, dirs)["expected_termination_dist"]
    assert spy.rows == [16, 16, 16] and fused_rows() == 0
    calls = stand_in(model, params)
    with torch.no_grad():
        got = _visibility(model, params, rs, p2p, dirs)["expected_termination_dist"]
    assert calls == [48] and fused_rows() == 48 and spy.rows == [16, 16, 16]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("chunk", [16, 48], ids=["ragged_chunks", "one_chunk"])
def test_training_chunks_take_the_checkpoints_gradients(chunk, monkeypatch, stand_in, fused_rows):
    """Under the ``"full"`` policy each chunk's forward is the kernel and its
    backward the checkpoint's recomputation: the same distances, and every
    DDF leaf's gradient and the surface depth's bitwise equal to the
    checkpointed plain chunks'."""
    model = _model(CANONICAL, visibility_query_chunk=chunk)
    rs, _, dirs = _ray_samples(5, seed=1)
    rows = 5 * 12
    res = {}
    for arm in ("checkpoint", "fused"):
        params = _ddf_params(model, seed=2, trainable=True)
        calls = stand_in(model, params) if arm == "fused" else []
        p2p = _ray_samples(5, seed=1)[1].requires_grad_(True)
        out = _visibility(model, params, rs, p2p, dirs)
        g = torch.Generator().manual_seed(3)
        loss = (out["visibility"] * torch.randn(out["visibility"].shape, generator=g)).sum() \
            + (out["difference"] * torch.randn(out["difference"].shape, generator=g)).sum()
        loss.backward()
        res[arm] = (out["expected_termination_dist"].detach(), p2p.grad, {k: v.grad for k, v in tree_items(params)})
        assert calls == ([] if arm == "checkpoint" else [min(chunk, rows - s) for s in range(0, rows, chunk)])
    assert fused_rows() == rows
    (e0, d0, g0), (e1, d1, g1) = res["checkpoint"], res["fused"]
    assert torch.equal(e0, e1) and torch.equal(d0, d1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert g0[k] is not None and torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_compute_visibility_on_the_cpu_is_the_plain_query(grad, monkeypatch, fused_rows):
    """On the CPU, at the canonical widths, the termination distances are
    the plain query's on every row, as before the kernel."""
    model = _model(CANONICAL, visibility_query_chunk=20)
    spy = _Spy(monkeypatch, model)
    rs, p2p, dirs = _ray_samples(4, seed=4)
    with torch.set_grad_enabled(grad):
        out = _visibility(model, _ddf_params(model, trainable=grad), rs, p2p, dirs)
    assert spy.rows == [20, 20, 8] and fused_rows() == 0
    assert torch.equal(out["expected_termination_dist"].detach(), torch.cat(spy.outs))


@pytest.mark.parametrize("arm", ["plain", "fused_no_grad", "fused_training"])
def test_visibility_queries_are_counted_on_either_path(arm, monkeypatch, stand_in, fused_rows):
    """``count_visibility_queries`` counts the rows the query is handed,
    whether the plain query or the kernel answers them, and the forward's
    alone: a chunk's recomputation in the backward adds nothing."""
    model = _model(CANONICAL, visibility_query_chunk=16)
    training = arm == "fused_training"
    params = _ddf_params(model, trainable=training)
    if arm != "plain":
        stand_in(model, params)
    rs, p2p, dirs = _ray_samples(4)
    with count_visibility_queries(model) as queries, torch.set_grad_enabled(training):
        out = _visibility(model, params, rs, p2p, dirs)
        if training:
            out["visibility"].sum().backward()
    assert queries == [4 * 12]
    assert fused_rows() == (0 if arm == "plain" else 4 * 12)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused DDF forward is CUDA C++ with no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _query_rows(m: int, seed: int, device):
    """Origins on the unit DDF sphere and world directions into it."""
    g = torch.Generator().manual_seed(seed)
    o = torch.nn.functional.normalize(torch.randn(m, 3, generator=g), dim=-1)
    d = torch.nn.functional.normalize(torch.randn(m, 3, generator=g), dim=-1)
    d = torch.where((d * o).sum(-1, keepdim=True) > 0, -d, d)
    return o.to(device), d.to(device)


def _adam_like(params, seed: int, steps: int = 5, lr: float = 1e-4):
    """``params`` moved as ``steps`` Adam steps of the recipe's DDF rate
    would: each entry by up to ``steps`` · ``lr``, in a random direction."""
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t + lr * torch.randint(-steps, steps + 1, t.shape, generator=g).to(t), params)


def _chip_smoke():
    """``chip_smoke.py`` as a module: its float64 FiLM-SIREN
    (``ddf_film_f64``) is the answer both float32 paths are held to."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["seeded", "adam_steps"])
def test_fused_forward_within_twice_the_plain_paths_error(card, weights, fused_rows):
    """A neusky.train step's 260,096 query rows at the recipe's DDF widths:
    the fused forward's worst and median gaps to the float64 answer (bf16
    FiLM inputs) at most twice the plain float32 path's."""
    model = _model(CANONICAL, device=card)
    params = _ddf_params(model, seed=5)
    if weights == "adam_steps":
        params = _adam_like(params, seed=6)
    o, d = _query_rows(STEP_ROWS, seed=7, device=card)
    with torch.no_grad():
        plain = model.ddf.apply(params, o, d)["expected_termination_dist"]
        fused = model.ddf.fused_query(params)(o, d)
        exact = _chip_smoke().ddf_film_f64(params["params"]["field"]["net"], o, model.ddf.local_directions(o, d),
                                           model.ddf.field.distance_scale)
    torch.cuda.synchronize()
    assert fused_rows() == STEP_ROWS
    gaps = {k: (v.double() - exact).abs().cpu() for k, v in (("plain", plain), ("fused", fused))}
    worst = {k: v.max().item() for k, v in gaps.items()}
    median = {k: statistics.median(v.tolist()) for k, v in gaps.items()}
    print(f"{weights}: worst {worst}, median {median}")
    assert worst["plain"] > 0 and worst["fused"] <= 2.0 * worst["plain"], worst
    assert median["fused"] <= 2.0 * median["plain"], median


@pytest.mark.cuda
def test_fused_chunks_take_the_checkpoints_gradients_on_the_card(card, monkeypatch, fused_rows):
    """Two and a half 16,384-row chunks with one upstream cotangent: every
    DDF leaf's gradient and the rows' own bitwise equal to the checkpointed
    plain chunks'."""
    model = _model(CANONICAL, device=card, visibility_query_chunk=16384)
    o, d = _query_rows(40960, seed=8, device=card)
    cot = torch.randn(40960, generator=torch.Generator().manual_seed(9)).to(card)
    res = {}
    for arm in ("checkpoint", "fused"):
        if arm == "checkpoint":
            monkeypatch.setattr(model, "_fuses_ddf", lambda rows, records: False)
        else:
            monkeypatch.undo()
        params = _ddf_params(model, seed=10, trainable=True)
        oo, dd = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
        expected = model._ddf_query(params, oo, dd)
        torch.autograd.backward(expected, cot)
        res[arm] = {"origins": oo.grad, "directions": dd.grad, **{k: v.grad for k, v in tree_items(params)}}
    assert fused_rows() == 40960
    for k, want in res["checkpoint"].items():
        assert want is not None and torch.equal(res["fused"][k], want), k


@pytest.mark.cuda
def test_captured_fused_query_replays_and_counts_each_replay(card, fused_rows):
    """The one-launch query captured in a CUDA graph: each replay gives the
    eager distances and adds its rows to ``ddf.fused_rows``."""
    from neusky_torch.parallel.graphs import CapturedStep

    model = _model(CANONICAL, device=card)
    params = _ddf_params(model, seed=11)
    o, d = _query_rows(100_000, seed=12, device=card)

    def query(p, step, oo, dd):
        with torch.no_grad():
            return model._ddf_query(p, oo, dd)

    with torch.no_grad():
        eager = model._ddf_query(params, o, d)
    captured = CapturedStep(query)
    for _ in range(2):  # the eager first call, then the capture
        captured(params, None, o, d)
    profiling.totals[ddf_film_cuda.FUSED_ROWS] = 0
    for _ in range(3):
        assert torch.equal(captured(params, None, o, d), eager)
    torch.cuda.synchronize()
    assert fused_rows() == 3 * 100_000
