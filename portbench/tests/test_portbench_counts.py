"""The yardstick's counts and the metric arithmetic, on the CPU."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import readers, weights
from portbench.counts import knn_bytes, lfa_bound, model_flops, peaks
from portbench.reference import model as ref
from portbench.drivers import percentile
from portbench.run import Reading
from portbench.trace import Trace

TINY = dict(n_classes=2, n_points=2048, n_features=0, n_neighbors=32, decimation=4,
            layer_sizes=[16, 64, 128, 256], knn="naive")


@pytest.mark.parametrize("n", [2048, 3000])
def test_model_flops_match_flop_counter_on_the_reference(n):
    cfg = dict(TINY, n_points=n)
    p = weights.make(cfg, 5, "cpu")
    x = torch.randn(n, 3, generator=torch.Generator().manual_seed(1)) * 0.2
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(2))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(p, cfg, x, perm)
    assert model_flops.forward(cfg, n) == counter.get_total_flops()


def test_train_step_counts_three_forwards():
    assert model_flops.train_step(TINY, 2048, 4) == 12 * model_flops.forward(TINY, 2048)


def test_knn_bytes_by_hand():
    # levels 2048, 512, 128, 32: 12 bytes read, 32 × 8 written a point
    assert knn_bytes.forward(TINY, 2048) == (2048 + 512 + 128 + 32) * (12 + 256)


def test_lfa_bound_takes_the_fused_levels_only():
    k, n = 32, 65536
    want = 0.0
    for rows, h, f in ((n, 8, 8), (n // 4, 32, 32)):
        for nbytes, dots, rest in (lfa_bound.round1_work(rows, k, h),
                                   lfa_bound.pool2_work(rows, k, h, f)):
            want += max(nbytes / peaks.BYTES_PER_S, (dots + rest) / peaks.F32_OPS_PER_S)
    assert math.isclose(lfa_bound.forward_s(dict(TINY, n_points=n), n), want)


def _trace():
    # device: [0, 10] and [5, 20] overlap, [30, 40]; window 50 µs
    dev = [("knn_cull_kernel<1>", 0.0, 10.0), ("knn_box_kernel", 5.0, 20.0),
           ("lfa_round1_tile_kernel", 30.0, 40.0)]
    host = [("aten::sort", 0.0, 25.0), ("portbench.call", 25.0, 50.0)]
    return Trace(dev, host, 50e-6)


def test_trace_union_gaps_and_sums():
    t = _trace()
    assert t.busy_s == pytest.approx(30e-6)
    assert t.device_s(readers.B1) == pytest.approx(25e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(5e-6)  # 20..25
    assert gaps["portbench.call"] == pytest.approx(15e-6)  # 25..30, 40..50
    assert t.device_ops()[0] == ["knn_box_kernel", pytest.approx(15e-6)]


def test_readers_on_a_fixed_profile():
    cfg = dict(TINY, n_points=65536)
    r = Reading(cfg, {}, [0.1, 0.3, 0.2], 8, _trace(), traced_calls=2)
    assert readers.idle_pct(r) == pytest.approx(40.0)
    assert readers.median_ms(r) == pytest.approx(200.0)
    assert readers.knn_roofline_pct(r) == pytest.approx(
        knn_bytes.forward(cfg, 65536) * 16 / peaks.BYTES_PER_S / 25e-6 * 100)
    assert readers.lfa_roofline_pct(r) == pytest.approx(
        lfa_bound.forward_s(cfg, 65536) * 16 / 10e-6 * 100)
    assert readers.forward_mfu_pct(r) == pytest.approx(
        model_flops.forward(cfg, 65536) * 16 / 50e-6 / peaks.F32_OPS_PER_S * 100)
    assert readers.gather_ms_per_call(r) is None


def test_readers_return_nothing_without_a_trace():
    r = Reading(TINY, {}, [], 8)
    for fn in (readers.idle_pct, readers.knn_roofline_pct, readers.lfa_roofline_pct,
               readers.forward_mfu_pct, readers.gather_ms_per_call, readers.median_ms):
        assert fn(r) is None


def test_percentile_on_a_known_sample():
    xs = [float(v) for v in range(1, 11)]  # 1..10
    assert percentile(xs, 90) == pytest.approx(9.1)
    assert percentile(xs, 50) == pytest.approx(5.5)
    assert percentile([3.0], 90) == 3.0
    assert percentile(list(reversed(xs)), 0) == 1.0
