"""The yardstick's arithmetic on hand-made inputs: the percentile rule, the
idle share from the union of busy intervals, the copied K1 bound and ray
count, and the FLOP counter's rule."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import common, counts, trace
from benchmark.metrics._stats import percentile
from benchmark.reference import model as ref_model


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 90, 90),  # 90 of 100 at or below
    (list(range(1, 11)), 90, 9),
    ([5.0], 90, 5.0),
    ([3, 1, 2], 50, 2),
    (list(range(100, 0, -1)), 95, 95),
])
def test_percentile_is_nearest_rank(values, q, want):
    assert percentile(values, q) == want


def test_union_merges_overlaps_and_touching_intervals():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == [(0, 4), (5, 7)]


def _hand_trace():
    # two streams: kernels 0-4 and 2-6 overlap (busy 0-6), a copy 8-9, a
    # kernel that runs past the window's end (9.5-12 within 0-10)
    dev = [("ampere_sgemm_128x64", 0.0, 4.0), ("elementwise_kernel<add>", 2.0, 6.0),
           ("Memcpy HtoD", 8.0, 9.0), ("vectorized_elementwise_kernel", 9.5, 12.0)]
    host = [("cudaGraphLaunch", 5.5, 7.5), ("aten::copy_", 6.5, 7.2), ("cudaStreamSynchronize", 9.0, 9.6)]
    return trace.Trace(dev, host, (0.0, 10.0), units=2)


def test_idle_share_is_one_minus_the_union_not_the_sum():
    tr = _hand_trace()
    assert tr.busy_s() == pytest.approx(6.0 + 1.0 + 0.5)
    assert tr.idle_share() == pytest.approx(0.25)
    assert sum(e - s for _, s, e in tr.device) > tr.busy_s()  # the sum double-counts


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    gaps = _hand_trace().idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(2.0)]  # 6-8, middle 7
    assert gaps[1] == ["cudaStreamSynchronize", pytest.approx(0.5)]  # 9-9.5


def test_kernel_kinds():
    tr = _hand_trace()
    assert tr.kind_s("matmul") == 4.0 and tr.kind_s("elementwise") == 4.0 + 2.5 and tr.kind_s("copy/fill") == 1.0
    assert trace.kind_of("void scatter_levels_kernel<2>(...)") == "K1"


@pytest.mark.parametrize("name,rays,bound_ms,per_step", [("neusky", 1024, 0.1197, 2304),
                                                         ("neusky-synthetic", 512, 0.1132, 1792)])
def test_k1_bound_and_rays_of_the_configs(name, rays, bound_ms, per_step):
    r = ref_model.recipe(json.loads((common.BENCH_DIR / "configs" / f"{name}.json").read_text()))
    mc, pc = r["model_config"], r["pipeline_config"]
    assert counts.k1_step_bound_ms(mc, pc, rays) == pytest.approx(bound_ms, abs=5e-5)
    assert counts.rays_per_step(mc, pc, rays, 256) == per_step
    assert len(counts.k1_sites(mc, pc, rays)) == 7


def test_flop_counter_counts_three_products_a_differentiated_one():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.plain.nets.mlp import dense

    n, i, o = 64, 32, 16
    x = torch.randn(n, i, requires_grad=True)
    p = {"kernel": torch.randn(i, o, requires_grad=True), "bias": torch.zeros(o, requires_grad=True)}
    with FlopCounterMode(display=False) as c:
        dense(p, x).sum().backward()
    assert c.get_total_flops() == 3 * 2 * n * i * o
    with FlopCounterMode(display=False) as c, torch.no_grad():
        dense(p, x)
    assert c.get_total_flops() == 2 * n * i * o
