"""RENI++ prior training, the benchmark's ``reni-pp`` configuration: the
port's ``RENITrainer`` (the decoder on its folded path) held to the
benchmark's plain reference (``benchmark/reference/reni.py``, the explicit
blocks), the yardstick's FLOP count held to torch's flop counter on the
program's step, and the trainer's spans and counters.  The file imports no
JAX.  The tests marked ``cuda`` need a card and skip without one:

    python -m pytest tests/test_torch_reni_config.py -m cuda
"""

import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cfgjson, reni_counts
from benchmark.reference import reni as ref_reni
from neusky_torch.data.sky_generator import generate_sky_corpus
from neusky_torch.engine.reni_trainer import PIXELS, RENITrainer, RENITrainerConfig
from neusky_torch.nets.transformer import FOLDED_KV
from neusky_torch.tools.train_reni_prior import prior_field_config
from neusky_torch.tree import tree_items
from neusky_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
SEEDS = types.SimpleNamespace(weights=11, draws=12)
PIXELS_PER_STEP = 64
# the trainer's device spans, each an event pair in a captured step's graph
STEP_SPANS = ["reni_step", "reni_step/decode", "reni_step/loss", "reni_step/backward", "reni_step/adam"]


def _config(quick: bool = True) -> dict:
    """A configuration file's recipe of ``train_reni_prior`` (``--quick``'s
    tiny decoder: latent 8, width 32, 2 heads, 2 blocks)."""
    return {"bundle": {"trainer_config": cfgjson.encode(
        RENITrainerConfig(field=prior_field_config(quick), pixels_per_step=PIXELS_PER_STEP))}}


def _skies(n: int = 6, width: int = 16) -> np.ndarray:
    return generate_sky_corpus(n, width=width, seed=7)


def _perturbed(params: dict, seed: int) -> dict:
    """``params`` with the LayerNorms' scales and every bias drawn away from
    their init, so that each term of the folded products counts."""
    g = torch.Generator().manual_seed(seed)
    for path, t in tree_items(params):
        if path.endswith("bias"):
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
        elif path.endswith("scale"):
            t.copy_(1.0 + 0.2 * torch.randn(t.shape, generator=g))
    return params


def _start(config: dict, b: int, seed: int = 11) -> dict:
    return _perturbed(ref_reni.make_params(config, b, seed, "cpu"), seed + 1)


def _trainer(skies: np.ndarray, quick: bool = True, device="cpu", graphed=False) -> RENITrainer:
    """The program's trainer of ``_config(quick)`` over ``skies``, from
    :func:`_start`'s weights, its draws seeded ``SEEDS.draws``."""
    trainer = RENITrainer(RENITrainerConfig(field=prior_field_config(quick), pixels_per_step=PIXELS_PER_STEP),
                          skies, device=device, graphed=graphed)
    with torch.no_grad():
        for (k, t), (kw, w) in zip(tree_items(trainer.params), tree_items(_start(_config(quick), skies.shape[0]))):
            assert k == kw and t.shape == w.shape
            t.copy_(w)
    trainer.generator.manual_seed(SEEDS.draws)
    return trainer


# ---------------------------------------------------------------------------
# the program against the reference


@pytest.fixture(scope="module")
def both():
    """Three steps of each side from the same perturbed weights and draws:
    the program's losses and each step's gradients (``.grad`` after the
    step), and the reference's."""
    config, skies = _config(), _skies()
    trainer = _trainer(skies)
    losses, grads = [], []
    for _ in range(3):
        losses.append(float(trainer.train_step(trainer.draw())["total"]))
        grads.append({k: t.grad.clone() for k, t in tree_items(trainer.params)})
    ref = ref_reni.run_steps(config, skies, PIXELS_PER_STEP, SEEDS, 3, "cpu", params=_start(config, skies.shape[0]))
    return {"losses": losses, "grads": grads}, ref


def test_losses_match_the_reference(both):
    """float32 on both sides, the folded decoder against the explicit one:
    the two orders of the same products differ by round-off, a few units of
    float32's 6e-8 in a loss of order 1."""
    prog, ref = both
    for p, r in zip(prog["losses"], ref["losses"]):
        assert abs(p - r) <= 1e-6 * abs(r), (p, r)


@pytest.mark.parametrize("step", [0, 2], ids=["step1", "step3"])
def test_every_gradient_matches_the_reference(both, step):
    """Every decoder weight's gradient, and the posterior means' and
    log-variances', at steps 1 and 3 (after two Adam updates of both sides).
    Each leaf is held within 1e-4 of the larger of its own largest entry and
    1e-3 of the tree's largest gradient: float32 round-off of the two
    orders of the products lies near 1e-6 of a leaf's scale, and the key
    biases' true gradient is zero (a shift of a head's logits shared by every
    token), so theirs is round-off alone, held to the tree's scale."""
    prog, ref = both
    p, r = prog["grads"][step], ref["grads"][step]
    assert set(p) == set(r) and {"latents", "logvar"} <= set(p)
    floor = 1e-3 * max(t.abs().max().item() for t in r.values())
    for k, t in r.items():
        scale = max(t.abs().max().item(), floor)
        assert (p[k] - t).abs().max().item() <= 1e-4 * scale, k


# ---------------------------------------------------------------------------
# the yardstick's FLOP count


def _program_step_flops(quick: bool) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    trainer = _trainer(_skies(2, 16), quick)
    draws = trainer.draw()
    trainer.train_step(draws)  # the optimizer's state exists before the counted step
    with FlopCounterMode(display=False) as counter:
        trainer.train_step(draws)
    return float(counter.get_total_flops())


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "published"])
def test_flop_count_is_torch_flop_counter_on_the_program_step(quick):
    """``reni_counts.step_flops`` counts every matrix product that the
    folded step runs, forward and backward, at the tool's ``--quick``
    widths and at the published ones (64 pixels)."""
    f = prior_field_config(quick)
    want = reni_counts.step_flops(PIXELS_PER_STEP, f.latent_dim, f.hidden_features, f.num_attention_heads,
                                  f.num_attention_layers)
    assert _program_step_flops(quick) == want


# ---------------------------------------------------------------------------
# spans and counters


@pytest.fixture
def tracing():
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def test_spans_and_counters_of_a_step(tracing):
    """Traced, eagerly: a step counts its P pixels and one folded decoder
    call, under ``reni.step/reni_step``, whose parts are the step's spans;
    the draws are ``reni.draws``."""
    trainer = _trainer(_skies())
    for _ in range(3):
        trainer.train_step(trainer.draw())
    snap = tracing.snapshot()
    assert tracing.totals[PIXELS] == 3 * PIXELS_PER_STEP and tracing.totals[FOLDED_KV] == 3
    assert snap["counters"][PIXELS] == {"reni.step/reni_step": 3 * PIXELS_PER_STEP}
    assert snap["counters"][FOLDED_KV] == {"reni.step/reni_step/decode": 3}
    assert {f"reni.step/{s}" for s in STEP_SPANS} | {"reni.draws", "reni.step"} == set(snap["host"])
    assert all(snap["host"][p]["calls"] == 3 for p in snap["host"])


def test_tracing_off_records_nothing_but_the_counters(monkeypatch):
    """Off (the default), a step creates no event and opens no profiler
    range; the counters count at no path."""
    assert not profiling.enabled()
    profiling.reset()
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: made.append("range"))
    trainer = _trainer(_skies())
    trainer.run(100, log_every=100)  # one chunk of the tool's 100 steps
    snap = profiling.snapshot()
    assert not made and not snap["host"]
    assert snap["counters"] == {PIXELS: {"": 100 * PIXELS_PER_STEP}, FOLDED_KV: {"": 100}}
    profiling.reset()


# ---------------------------------------------------------------------------
# on the card


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph, TF32 and the cell's size exist there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_folded_weight_gradients_at_the_cell_size_are_float32_round_off():
    """The published decoder, 8,192 pixels each with its own 100 latent
    vectors, TF32 off: leaf by leaf, each decoder weight's float32 gradient
    on the folded path lies within 1e-5 of float64's, held to the larger of
    the leaf's scale and 1e-3 of the tree's largest gradient (the key
    biases' true gradient is zero).  1e-5 is ~80 float32 ulps of the scale:
    round-off, where a dropped or misrouted term reads 1e-3 or more.  The
    folded error is not held to the explicit blocks' on the same leaf: on
    an H100 it reads 2–11× theirs on the fold's own leaves (the key and
    value kernels, ``kv_embed``, ``LayerNorm_1``), an accuracy loss of the
    fold kept as an open item; the message lists every leaf's ratio."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_folded_attention import _ExplicitDecoder

    from neusky_torch.fields.reni import RENIField
    from neusky_torch.nets.transformer import TransformerDecoder
    from neusky_torch.tree import tree_map

    dev = _card()
    cfg = prior_field_config(False)
    field = RENIField(cfg)
    params = _perturbed(tree_map(lambda t: t, field.init(torch.Generator(device=dev).manual_seed(5), dev)), 6)
    g = torch.Generator().manual_seed(7)
    n = 8192
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1).to(dev)
    lat = torch.randn(n, cfg.latent_dim, 3, generator=g).to(dev)
    target = torch.rand(n, 3, generator=g).to(dev) * 2.0 - 1.0

    def grads(decoder, dtype):
        field.decoder = decoder
        p = tree_map(lambda t: t.detach().to(dtype, copy=True).requires_grad_(True), params)
        out = field.apply(p, dirs.to(dtype), lat.to(dtype))["rgb"]
        torch.mean((out - target.to(dtype)) ** 2).backward()
        return {k: t.grad.double() for k, t in tree_items(p)}

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        explicit_decoder = _ExplicitDecoder(cfg.hidden_features, cfg.num_attention_heads, cfg.num_attention_layers, 3)
        exact = grads(explicit_decoder, torch.float64)
        explicit = grads(explicit_decoder, torch.float32)
        folded = grads(TransformerDecoder(cfg.hidden_features, cfg.num_attention_heads, cfg.num_attention_layers, 3),
                       torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    floor = 1e-3 * max(t.abs().max().item() for t in exact.values())

    def err(side, k):
        return (side[k] - exact[k]).abs().max().item() / max(exact[k].abs().max().item(), floor)

    leaves = {k: (err(folded, k), err(explicit, k)) for k in exact}
    report = "\n".join(f"{k}: folded {f:.3g}, explicit {e:.3g}, ratio {f / max(e, 1e-30):.2f}"
                        for k, (f, e) in sorted(leaves.items(), key=lambda kv: -kv[1][0]))
    assert all(f <= 1e-5 for f, _ in leaves.values()), report
    assert any(e > 0.0 for _, e in leaves.values()), report


@pytest.mark.cuda
def test_captured_step_counts_the_folded_call_and_the_pixels_a_replay():
    """A captured RENI step re-adds its counts on every replay: one folded
    decoder call and P pixels each."""
    dev = _card()
    trainer = _trainer(_skies(), device=dev, graphed=None)
    for _ in range(2):  # warm-up, then capture and the first replay
        trainer.train_step(trainer.draw())
    captured = trainer._step_fn
    replays = captured.replays
    profiling.totals[FOLDED_KV] = profiling.totals[PIXELS] = 0
    for _ in range(3):
        trainer.train_step(trainer.draw())
    assert captured.replays - replays == 3
    assert profiling.totals[FOLDED_KV] == 3 and profiling.totals[PIXELS] == 3 * PIXELS_PER_STEP
    del profiling.totals[FOLDED_KV], profiling.totals[PIXELS]


_NODES = textwrap.dedent("""
    import ctypes, functools, json, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[1] + "/tests")
    from test_torch_reni_config import _skies, _trainer
    from neusky_torch.utils import profiling

    torch.cuda.CUDAGraph = functools.partial(torch.cuda.CUDAGraph, keep_graph=True)
    cu = ctypes.CDLL("libcuda.so.1")

    def nodes():
        t = _trainer(_skies(), device=torch.device("cuda"), graphed=None)
        for _ in range(3):
            t.train_step(t.draw())
        n = ctypes.c_size_t(0)
        assert cu.cuGraphGetNodes(ctypes.c_void_p(t._step_fn.graph.raw_cuda_graph()), None, ctypes.byref(n)) == 0
        return n.value

    before = nodes()
    profiling.enable()
    traced = nodes()
    profiling.enable(False)
    print(json.dumps({"before": before, "traced": traced, "after": nodes()}))
""")


@pytest.mark.cuda
def test_graph_captured_with_tracing_off_has_the_untraced_node_count(tmp_path):
    """In a fresh process: the RENI step's graph captured before ``enable``
    was ever called, with tracing on (two event-record nodes a device span
    more) and after it is turned off again: the first and the last have
    the same number of nodes."""
    _card()
    script = tmp_path / "nodes.py"
    script.write_text(_NODES)
    out = subprocess.run([sys.executable, str(script), str(REPO)], capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    assert counts["after"] == counts["before"] > 0
    assert counts["traced"] == counts["before"] + 2 * len(STEP_SPANS)
