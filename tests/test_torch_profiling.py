"""The port's tracing (``neusky_torch/utils/profiling.py``): the switch,
the host spans of the training loop, the counters and the plain-data
table.  The tests marked ``cuda`` need a card and skip without one: the
device spans captured into the training step's CUDA graph, timed on
every replay.  The file imports no JAX:

    python -m pytest tests/test_torch_profiling.py -m cuda
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

from neusky_torch.nets.transformer import FOLDED_KV
from neusky_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent

# the device spans of the recipe's step, in the order they are entered
STEP_SPANS = ["step", "step/scene", "step/scene/field", "step/scene/sky", "step/scene/visibility",
              "step/scene/shading", "step/scene/density_grid", "step/scene/losses", "step/ddf_fit",
              "step/backward", "step/adam"]
# the host spans of a training loop step on the CPU (the step runs eagerly there)
LOOP_SPANS = ["trainer.step", "trainer.step/data.next_train", "trainer.step/data.next_train/data.sample",
              "trainer.step/data.next_train/data.to_device", "trainer.step/trainer.log"]



@pytest.fixture
def tracing():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.enable(False)
        profiling.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time a captured CUDA graph")
    return torch.device("cuda")


def _trainer(device="cpu", steps_per_log=2):
    """A ``Trainer`` of the tiny joint configuration with the recipe's step
    (not fused, not split): 2 images × 16 rays, 2 × 16 vMF rays, 8 sky
    rays; on the card its step is captured."""
    from neusky_torch.configs.tiny_config import tiny_model_config
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine.trainer import Trainer, TrainerConfig
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.models.pipeline import PipelineConfig
    from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

    model = NeuSkyModel(dataclasses.replace(tiny_model_config(2, 2), fused_ddf_gt_pass=False), device=device)
    pipe = PipelineConfig(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16),
                          num_sky_rays=8)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=2, width=32, height=32))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(2, 16), num_sky_rays=8),
                     scene["cameras"], scene["images"], scene["masks"], device=device)
    cfg = TrainerConfig(steps_per_log=steps_per_log, steps_per_save=10**9, steps_per_eval_image=10**9,
                        output_dir="unused")
    return Trainer(cfg, model, pipe, dm, device=device)


def _children(table, path):
    return [p for p in table if p.rpartition("/")[0] == path]


# ---------------------------------------------------------------------------
# the switch


def test_tracing_off_records_nothing(monkeypatch):
    """Off (the default), a span is one shared no-op context, a training
    run creates no event and opens no profiler range, and the table holds
    what ``time_function`` alone puts there, and the counters that count
    with tracing off at no path: on the CPU, the transformer decoder's
    folded calls (the sky decoded twice a step)."""
    assert not profiling.enabled()
    profiling.reset()
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: made.append("range"))
    assert profiling.span("a") is profiling.span("b", torch.device("cpu"))
    _trainer().run(2)

    @profiling.time_function
    def work():
        return 1

    work()
    snap = profiling.snapshot()
    assert not made
    assert list(profiling._TIMINGS) == [work.__qualname__] == list(snap["host"])
    assert snap["counters"] == {FOLDED_KV: {"": 4}}
    assert all(t == {"samples": 0, "spans": {}} for t in snap["device"].values())


def test_enable_and_reset(tracing):
    assert tracing.enabled()
    with tracing.span("outer"):
        tracing.count("c")
    assert tracing.snapshot()["host"]["outer"]["calls"] == 1
    tracing.reset()
    snap = tracing.snapshot()
    assert snap["host"] == {} and snap["counters"] == {}
    tracing.enable(False)
    assert not tracing.enabled() and tracing.span("x") is tracing.span("y")


# ---------------------------------------------------------------------------
# host spans


def test_training_loop_span_tree(tracing):
    """Three steps with a log read every two: each loop span and each
    device span of the eager step (host-timed on the CPU) once a step,
    ``trainer.log`` twice; every path's parent is in the table, and each
    row's self time is its total less its direct children's totals."""
    trainer = _trainer(steps_per_log=2)
    tracing.reset()
    trainer.run(3)
    host = tracing.snapshot()["host"]
    calls = {p: r["calls"] for p, r in host.items()}
    assert {p: calls.get(p) for p in LOOP_SPANS} == {**dict.fromkeys(LOOP_SPANS, 3), "trainer.step/trainer.log": 2}
    assert {p: calls.get(f"trainer.step/{p}") for p in STEP_SPANS} == dict.fromkeys(STEP_SPANS, 3)
    assert set(host) == set(LOOP_SPANS) | {f"trainer.step/{p}" for p in STEP_SPANS}
    for path, row in host.items():
        assert "/" not in path or path.rpartition("/")[0] in host
        inner = sum(host[c]["total_s"] for c in _children(host, path))
        assert row["self_s"] == pytest.approx(row["total_s"] - inner, rel=1e-9, abs=1e-12)
        assert 0 <= row["self_s"] <= row["total_s"]


def test_set_up_spans(tracing):
    trainer = _trainer()
    del trainer
    host = tracing.snapshot()["host"]
    assert sorted(_children(host, "trainer.init")) == [f"trainer.init/{n}" for n in (
        "model.init", "optimizer.build", "prior.load", "step.build")]


def test_snapshot_is_plain_data_and_reset_empties_it(tracing):
    trainer = _trainer()
    trainer.run(2)
    snap = tracing.snapshot()
    assert json.loads(json.dumps(snap)) == snap and snap["host"]
    tracing.reset()
    assert tracing.snapshot() == {"host": {}, "counters": {},
                                  "device": {k: {"samples": 0, "spans": {}} for k in ("replay", "eager")}}


def test_a_span_inside_a_backward_records_nothing(tracing):
    """A span entered while autograd runs a backward (a checkpointed
    recomputation, or autograd's worker thread) records nothing: its time
    is the enclosing ``backward`` span's."""

    class Spanned(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            with profiling.span("inner"):
                return 2 * x

        @staticmethod
        def backward(ctx, g):
            with profiling.span("inner"):
                return 2 * g

    x = torch.ones(3, requires_grad=True)
    with tracing.span("outer"):
        y = Spanned.apply(x).sum()
        with tracing.span("backward"):
            y.backward()
    host = tracing.snapshot()["host"]
    assert set(host) == {"outer", "outer/inner", "outer/backward"} and host["outer/inner"]["calls"] == 1


# ---------------------------------------------------------------------------
# counters


def test_a_counter_in_a_step_counts_once_a_call(tracing, monkeypatch):
    from neusky_torch.parallel import mesh

    real = mesh.train_loss_fn

    def counted(*a, **k):
        tracing.count("test.loss_calls")
        return real(*a, **k)

    monkeypatch.setattr(mesh, "train_loss_fn", counted)
    trainer = _trainer()
    trainer.run(3)
    assert tracing.snapshot()["counters"]["test.loss_calls"] == {"trainer.step/step": 3}
    assert tracing.totals["test.loss_calls"] == 3 and tracing.totals["never.counted"] == 0
    tracing.totals["test.loss_calls"] = 0  # as chip_smoke.py zeroes K1's count
    assert tracing.snapshot()["counters"]["test.loss_calls"] == {"": 0}


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_counts_made_in_a_capture_are_made_again_on_each_replay(on):
    """What ``CapturedStep`` does with a counter (K1's launches, with
    tracing off too): counts made while a graph is captured are taken back
    and made once per replay."""
    profiling.reset()
    profiling.enable(on)
    try:
        profiling.count("k", 2)
        with profiling.counts_taken_back() as made, profiling.span("graph.capture"):
            profiling.count("k")
            profiling.count("k")
        assert made == {"k": 2} and profiling.totals["k"] == 2
        for _ in range(3):
            with profiling.span("graph.replay"):
                for name, n in made.items():
                    profiling.count(name, n)
        assert profiling.totals["k"] == 8
        assert profiling.snapshot()["counters"]["k"] == ({"": 2, "graph.replay": 6} if on else {"": 8})
    finally:
        profiling.enable(False)
        profiling.reset()


# ---------------------------------------------------------------------------
# the repaired rays_per_sec


def test_logged_rays_per_sec_counts_since_the_previous_record(monkeypatch):
    """Each log record's ``rays_per_sec`` is the rays since the previous
    record over the time since it (a clock that reads 0, then 10 at the
    first record and 11 at the second)."""
    from neusky_torch.engine import trainer as trainer_mod

    trainer = _trainer(steps_per_log=2)
    clock = iter([0.0, 10.0, 11.0])
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    history = trainer.run(4)
    per_step = trainer._count_rays(trainer.datamanager.next_train(0))
    assert [h["rays_per_sec"] for h in history] == pytest.approx([2 * per_step / 10.0, 2 * per_step / 1.0])


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_replayed_step_yields_every_device_span(cuda_device, tracing):
    """A captured step with tracing on: each replay read (a log read every
    step) gives every device span of the recipe's step once, in order,
    each child inside its parent; self time of ``step`` and ``scene`` is
    what their children leave; the eager first call's sample is kept
    apart; the loop's graph spans are there."""
    trainer = _trainer(cuda_device, steps_per_log=1)
    trainer.run(5)
    torch.cuda.synchronize()
    events = trainer.train_step.captured._events
    sample = events.read()
    assert [p for p, _, _ in sample] == STEP_SPANS
    at = {p: (s, e) for p, s, e in sample}
    for p, (s, e) in at.items():
        assert 0.0 <= s <= e
        if "/" in p:
            ps, pe = at[p.rpartition("/")[0]]
            assert ps <= s and e <= pe
    snap = tracing.snapshot()
    replay, eager = snap["device"]["replay"], snap["device"]["eager"]
    assert replay["samples"] == 4 and eager["samples"] == 1  # step 1 eager; steps 2-5 replayed
    assert set(replay["spans"]) == set(STEP_SPANS) == set(eager["spans"])
    assert all(r["calls"] == 4 and len(r["recent_ms"]) == 4 for r in replay["spans"].values())
    for p in ("step", "step/scene"):
        row = replay["spans"][p]
        inner = sum(replay["spans"][c]["total_ms"] for c in _children(replay["spans"], p))
        assert row["self_ms"] == pytest.approx(row["total_ms"] - inner, rel=1e-6, abs=1e-6)
    host = snap["host"]
    for p in ("trainer.step/engine.draws", "trainer.step/graph.copy_inputs", "trainer.step/graph.replay",
              "trainer.step/graph.warmup", "trainer.step/graph.capture", "trainer.step/graph.capture/graph.gc"):
        assert p in host, p
    assert host["trainer.step/graph.replay"]["calls"] == 4
    assert snap["counters"]["graph.replays"] == {"trainer.step/graph.replay": 4}
    assert snap["counters"]["host.syncs"]["trainer.step/trainer.log"] > 0  # the log read's float()s
    # K1 runs in the backward, on autograd's worker thread, where no span is
    # open: the eager step's launches count at no path, the replays' at theirs
    k1 = snap["counters"]["hashgrid_scatter_levels"]
    assert k1[""] > 0 and k1 == {"": k1[""], "trainer.step/graph.replay": 4 * k1[""]}


@pytest.mark.cuda
def test_visibility_once_a_step_and_nothing_from_the_backward(cuda_device, tracing, monkeypatch):
    """``step/scene/visibility`` is sampled once a step, and a span inside
    the DDF query, which ``torch.utils.checkpoint`` reruns in the backward
    on autograd's worker thread, is recorded for the forward's calls
    alone: the recomputation counts in ``backward`` only."""
    trainer = _trainer(cuda_device, steps_per_log=1)
    ddf, calls = trainer.model.ddf, []
    real = ddf.apply

    def spanned(*a, **k):
        calls.append(torch._C._current_graph_task_id() != -1)
        with profiling.span("ddf.query"):
            return real(*a, **k)

    monkeypatch.setattr(ddf, "apply", spanned)
    trainer.run(1)  # eager
    calls.clear()
    trainer.run(1)  # captured, then replayed
    forward, backward = calls.count(False), calls.count(True)
    trainer.run(2)
    replay = tracing.snapshot()["device"]["replay"]
    spans, n = replay["spans"], replay["samples"]
    assert n == 3 and spans["step/scene/visibility"]["calls"] == n
    assert backward > 0 and forward > 0
    assert sum(r["calls"] for p, r in spans.items() if p.endswith("/ddf.query")) == forward * n
    assert not [p for p in spans if p.startswith("step/backward/")]


_NODES = textwrap.dedent("""
    import ctypes, functools, json, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[1] + "/tests")
    from test_torch_profiling import _trainer
    from neusky_torch.utils import profiling

    torch.cuda.CUDAGraph = functools.partial(torch.cuda.CUDAGraph, keep_graph=True)
    cu = ctypes.CDLL("libcuda.so.1")

    def nodes():
        t = _trainer(torch.device("cuda"))
        t.run(3)
        n = ctypes.c_size_t(0)
        assert cu.cuGraphGetNodes(ctypes.c_void_p(t.train_step.captured.graph.raw_cuda_graph()), None,
                                  ctypes.byref(n)) == 0
        return n.value

    before = nodes()
    profiling.enable()
    traced = nodes()
    profiling.enable(False)
    print(json.dumps({"before": before, "traced": traced, "after": nodes()}))
""")


@pytest.mark.cuda
def test_graph_captured_with_tracing_off_has_the_untraced_node_count(cuda_device, tmp_path):
    """In a fresh process: the step's graph captured before ``enable`` was
    ever called, with tracing on (two event-record nodes a device span
    more) and after it is turned off again: the first and the last have
    the same number of nodes."""
    script = tmp_path / "nodes.py"
    script.write_text(_NODES)
    out = subprocess.run([sys.executable, str(script), str(REPO)], capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    assert counts["after"] == counts["before"] > 0
    assert counts["traced"] == counts["before"] + 2 * len(STEP_SPANS)
