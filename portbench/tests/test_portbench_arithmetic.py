"""The yardstick's arithmetic: tails and rates over all requests, the
schedules drawn from a seed, roofline counts at the kernel table's shapes,
and the trace reader."""

import math
import statistics
import types

import numpy as np
import pytest

from portbench import load, roofline, spec, stats, trace


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0])
def test_quantile_matches_numpy(q):
    xs = np.random.default_rng(3).exponential(size=1001)
    assert stats.quantile(xs, q) == pytest.approx(float(np.quantile(xs, q)))


def test_tail_is_over_every_request_not_a_median_of_chunks():
    # one stall in one of ten chunks: a median of chunk tails hides it
    lat = [1.0] * 990 + [100.0] * 10
    chunks = [stats.quantile(lat[i : i + 100], 0.95) for i in range(0, 1000, 100)]
    assert statistics.median(chunks) == 1.0
    assert stats.quantile(lat, 0.995) == 100.0


def test_quantile_with_requests_that_never_came():
    assert stats.quantile([1.0, 2.0, math.inf], 0.99) == math.inf
    assert stats.quantile([1.0, 2.0, 3.0, math.inf], 0.5) == 2.5


def test_rate_over_the_window():
    assert stats.rate(12_000, 30.0) == 400.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_perturbation_and_writer_loops():
    t = {"perturb": [1e-6, 1000]}
    assert load.perturbation(1003, t) == np.float32(3e-6)
    assert load.writer_loops({}, 30) == 0
    w = {"writer": {"rate_per_s": 24000, "adds": 2000, "deletes": 2000,
                    "lead_max_s": 45}}
    assert load.writer_loops(w, 30) == 6 * (45 + 30 + 30)


def test_adc_pool_counts_at_the_sift1m_segment():
    # the kernel table's B3 shape: Q 512 x N 100,096 x M 16 x K 256
    ops, nbytes = roofline.adc_pool_work(512, 100_096, 16, 256, 150)
    assert ops == 512 * 100_096 * 16
    assert nbytes == 100_096 * 16 + 512 * 16 * 256 * 4 + 512 * 150 * 8
    peak = roofline.PEAKS["H100"]
    b = roofline.bound_s(ops, nbytes, peak)
    assert b == pytest.approx(nbytes / 3.35e12)  # bound by bytes
    # a launch taking exactly its bound reads 100%
    assert roofline.share([(ops, nbytes)], b, peak) == pytest.approx(100.0)


def test_exact_pool_counts_at_the_deep10m_group():
    # B2's 8-segment group at Deep10M: Q 512 x N 8,000,000 live x 96 features
    ops, nbytes = roofline.exact_pool_work(512, 8_000_000, 96, 40)
    assert ops == 2 * 512 * 8_000_000 * 96
    assert nbytes == 8_000_000 * 96 * 4 + 512 * 96 * 4 + 512 * 40 * 8
    assert roofline.peaks("NVIDIA H100 80GB HBM3") is roofline.PEAKS["H100"]
    assert roofline.peaks("cpu") is None
    assert roofline.share([], 1.0, roofline.PEAKS["H100"]) is None


def _ctx(name, segments, kernels, batches):
    """What a roofline reader sees: a traced second holding ``kernels``
    (name, seconds) and ``batches`` completed calls."""
    cell = spec.cell(spec.load_benchmark(), name)
    t = trace.Trace(window_s=1.0, busy_s=1.0, launches=0, device_ops=[],
                    idle_gaps=[], kernels=[(n, 0.0, s * 1e6) for n, s in kernels])
    calls = [{"te": 0.5}] * batches + [{"te": 2.0}]  # the last one after it
    return types.SimpleNamespace(cell=cell, trace=t, peaks=roofline.PEAKS["H100"],
                                 traced=(0.0, 1.0, None, None), calls=calls,
                                 segments=segments)


def test_exact_pool_reader_counts_every_live_row_whatever_the_kernels():
    read = spec.reader("exact_pool_roofline")
    segs = [dict(state="SEALED", cap=1_000_064, live=950_000)] * 10 + [
        dict(state="ACTIVE", cap=1_000_064, live=400_000),
        dict(state="WRITING", cap=1_000_064, live=300_000)]
    live = 10 * 950_000 + 400_000
    one = roofline.bound_s(*roofline.exact_pool_work(512, live, 96, 10),
                           roofline.PEAKS["H100"])
    b2 = "void exact_pool_tc_kernel<128, false, true>(Params)"
    b1 = "void exact_pool_tc_kernel<128, false, false>(Params)"
    # 20 batches taking 40 bounds of time, split however between the forms
    for split in ([(b2, 40 * 20 * one)],
                  [(b2, 30 * 20 * one), (b1, 10 * 20 * one), ("other", 1.0)]):
        assert read(_ctx("deep10m.churn", segs, split, 20)) == pytest.approx(2.5)
    assert read(_ctx("deep10m.churn", segs, [("other", 1.0)], 20)) is None


def test_adc_pool_reader_counts_every_sealed_segment_whatever_the_launches():
    read = spec.reader("adc_pool_roofline")
    segs = [dict(state="SEALED", cap=100_096, live=100_000)] * 10
    one = roofline.bound_s(*roofline.adc_pool_work(512, 100_000, 16, 256, 150),
                           roofline.PEAKS["H100"])
    k = "adc_pool_lines_kernel"
    # one launch a segment or one a batch: the same work, the same share
    for kernels in ([(k, 5 * one)] * 10 * 30, [(k, 50 * one)] * 30):
        assert read(_ctx("sift1m.batch512", segs, kernels, 30)) == pytest.approx(20.0)


def _evt(name, start, end, device=False):
    return (name, device, float(start), float(end))


def test_trace_summary():
    events = [
        _evt("portbench.query", 0, 1000),
        _evt("aten::topk", 100, 300),
        _evt("cudaLaunchKernel", 110, 120),
        _evt("cudaLaunchKernel", 400, 410),
        _evt("k_a", 200, 400, True),
        _evt("k_b", 350, 500, True),  # overlaps k_a: counted once
        _evt("k_a", 800, 900, True),
    ]
    t = trace.summarise(events, 1000.0)
    assert t.launches == 2
    assert t.busy_s == pytest.approx((300 + 100) / 1e6)
    assert t.window_s == pytest.approx(1e-3)
    assert t.kernel_time(lambda n: n == "k_a") == (pytest.approx(300 / 1e6), 2)
    assert t.device_ops[0] == ["k_a", pytest.approx(300 / 1e6)]
    # gaps: [0, 200] in topk, [500, 800] and [900, 1000] in the query span
    gaps = dict(t.idle_gaps)
    assert gaps["aten::topk"] == pytest.approx(200 / 1e6)
    assert gaps["portbench.query"] == pytest.approx(400 / 1e6)
