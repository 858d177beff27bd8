"""The readers of the flat route (``flat.calls.batch``,
``flat_rerank_roofline``) on made-up runs: the port's call spans in and out
of the window, a ring that dropped records or is missing, histograms with
records and without; and both on a tiny flat cell's traced run on the CPU,
where the port records its spans but the card's peaks are unknown."""

import time
import types

import pytest

from portbench import harness, roofline, spans, spec
from portbench.rerank_work import rerank_work
from portbench.tests.conftest import tiny

CALL = "vectorsearch.flat.call"
RERANK_MS = "vectorsearch.flat.rerank_ms"
PEAKS = roofline.PEAKS["H100"]


def _rec(name, s_s, e_s, seq=0):
    from vectorsearch_torch.utils.metrics import SpanRecord

    return SpanRecord(seq, name, None, 0, 1, int(s_s * 1e9), int(e_s * 1e9),
                      {"segments": 1, "rows": 100_096, "d": 1536})


def _ctx(n_calls, errors=0, histogram=None, peaks=PEAKS, live=(100_000,) * 5):
    cell = spec.cell(spec.load_benchmark(), "openai500k.batch512")
    calls = [{"n": 512, "ts": 10.0 + i * 0.1, "te": 10.1 + i * 0.1}
             for i in range(n_calls)]
    calls += [{"n": 512, "ts": 11.0, "te": 11.1, "error": "x"}] * errors
    segs = [dict(state="SEALED", cap=100_096, live=n) for n in live]
    segs.append(dict(state="ACTIVE", cap=100_096, live=7))
    return types.SimpleNamespace(t_open=10.0, t_close=20.0, calls=calls,
                                 histogram=histogram or (lambda *a: []),
                                 peaks=peaks, segments=segs, cell=cell)


def test_calls_in_the_window_over_the_batches_completed(monkeypatch):
    from vectorsearch_torch.utils.metrics import SpanLog

    recs = [_rec(CALL, 9.0, 9.5)]  # before the window
    recs += [_rec(CALL, 10.0 + i * 0.02, 10.01 + i * 0.02, i) for i in range(20)]
    recs += [_rec("vectorsearch.query.rerank", 10.0, 10.5)]  # another span
    recs += [_rec(CALL, 20.5, 20.6)]  # after it
    monkeypatch.setattr(spans, "log", lambda: SpanLog(recs, 0))
    read = spec.reader("flat.calls.batch")
    assert read(_ctx(4)) == pytest.approx(5.0)
    # a call that raised completed no batch
    assert read(_ctx(4, errors=1)) == pytest.approx(5.0)
    # a span that straddles the window's close is inside it
    recs.append(_rec(CALL, 19.999, 20.01))
    assert read(_ctx(4)) == pytest.approx(21 / 4)


def test_calls_read_nothing_without_spans_a_ring_or_batches(monkeypatch):
    from vectorsearch_torch.utils.metrics import SpanLog

    read = spec.reader("flat.calls.batch")
    monkeypatch.setattr(spans, "log", lambda: None)  # a port with no ring
    assert read(_ctx(4)) is None
    # a port that records no call span (an exact cell, or an older port)
    monkeypatch.setattr(spans, "log", lambda: SpanLog(
        [_rec("vectorsearch.exact_pool.wide_pass", 10.0, 10.5)], 0))
    assert read(_ctx(4)) is None
    # the ring dropped records that may have lain in the window
    monkeypatch.setattr(spans, "log", lambda: SpanLog([_rec(CALL, 15.0, 15.1)], 7))
    assert read(_ctx(4)) is None
    monkeypatch.setattr(spans, "log", lambda: SpanLog([_rec(CALL, 15.0, 15.1)], 0))
    assert read(_ctx(0)) is None


def test_rerank_roofline_is_the_batch_bound_over_the_median_record():
    seen = []

    def histogram(name, lo, hi):
        seen.append((name, lo, hi))
        return [3.0, 1.0, 2.0, 40.0] if name == RERANK_MS else []

    read = spec.reader("flat_rerank_roofline")
    # five sealed segments of 100,000 live rows: 150 candidates each (the
    # traffic's ef_search) of 1,536 f32 features for 512 queries
    ops, nbytes = rerank_work(512, 150, 1536, 10)
    assert (ops, nbytes) == (2 * 512 * 150 * 1536,
                             512 * 150 * 1536 * 4 + 512 * 1536 * 4 + 512 * 10 * 8)
    bound = 5 * roofline.bound_s(ops, nbytes, PEAKS)
    assert read(_ctx(4, histogram=histogram)) == pytest.approx(100 * bound / 2.5e-3)
    assert seen == [(RERANK_MS, 0, None)]
    # a segment with fewer live rows than ef_search reads each of them once
    small = read(_ctx(4, histogram=histogram, live=(100_000, 60)))
    want = (roofline.bound_s(*rerank_work(512, 150, 1536, 10), PEAKS)
            + roofline.bound_s(*rerank_work(512, 60, 1536, 10), PEAKS))
    assert small == pytest.approx(100 * want / 2.5e-3)


def test_rerank_roofline_reads_nothing_without_records_peaks_or_segments():
    read = spec.reader("flat_rerank_roofline")
    assert read(_ctx(4)) is None  # no record: the route never ran
    hist = lambda *a: [2.0]  # noqa: E731
    assert read(_ctx(4, histogram=hist, peaks=None)) is None  # not a known card
    assert read(_ctx(4, histogram=hist, live=())) is None  # nothing sealed


def test_the_readers_on_a_tiny_flat_cell():
    """A traced run of the tiny cell on the CPU: the port records a call
    span each flat call (the tiny cell's four segments share one call; a
    batch open at each end of the window adds its span, not its batch), and
    the re-rank's share needs the card's peaks, so it reads nothing."""
    cell = tiny("openai500k.batch512")
    res = harness.run(cell, 2**31 + 24, 1.5, True, "cpu", time.perf_counter())
    done = res["attempted"] / cell.traffic["batch"]
    assert 1.0 <= res["metrics"]["flat.calls.batch"]["value"] <= (done + 2) / done
    assert "flat_rerank_roofline" not in res["metrics"]
