"""The readers of B2's wide route (``pool.wide_passes.batch``,
``pool.pack_ms``) on made-up runs: the port's spans in and out of the
window, a ring that dropped records or is missing, histograms with records
and without."""

import types

import pytest

from portbench import spans, spec

PASS = "vectorsearch.exact_pool.wide_pass"


def _rec(name, s_s, e_s, seq=0):
    from vectorsearch_torch.utils.metrics import SpanRecord

    return SpanRecord(seq, name, None, 0, 1, int(s_s * 1e9), int(e_s * 1e9),
                      {"queries": 134, "rows": 8_000_512})


def _ctx(n_calls, errors=0, histogram=None):
    calls = [{"n": 512, "ts": 10.0 + i * 0.1, "te": 10.1 + i * 0.1}
             for i in range(n_calls)]
    calls += [{"n": 512, "ts": 11.0, "te": 11.1, "error": "x"}] * errors
    return types.SimpleNamespace(t_open=10.0, t_close=20.0, calls=calls,
                                 histogram=histogram or (lambda *a: []))


def test_passes_in_the_window_over_the_batches_completed(monkeypatch):
    from vectorsearch_torch.utils.metrics import SpanLog

    recs = [_rec(PASS, 9.0, 9.5)]  # before the window
    recs += [_rec(PASS, 10.0 + i * 0.02, 10.01 + i * 0.02, i) for i in range(20)]
    recs += [_rec("vectorsearch.query.pool", 10.0, 10.5)]  # another span
    recs += [_rec(PASS, 20.5, 20.6)]  # after it
    monkeypatch.setattr(spans, "log", lambda: SpanLog(recs, 0))
    read = spec.reader("pool.wide_passes.batch")
    assert read(_ctx(4)) == pytest.approx(5.0)
    # a call that raised completed no batch
    assert read(_ctx(4, errors=1)) == pytest.approx(5.0)
    # a span that straddles the window's opening is inside it
    recs.append(_rec(PASS, 9.99, 10.001))
    assert read(_ctx(4)) == pytest.approx(21 / 4)


def test_passes_read_nothing_without_spans_a_ring_or_batches(monkeypatch):
    from vectorsearch_torch.utils.metrics import SpanLog

    read = spec.reader("pool.wide_passes.batch")
    monkeypatch.setattr(spans, "log", lambda: None)  # a port with no ring
    assert read(_ctx(4)) is None
    # a port that records no wide pass (another route, or an older port)
    monkeypatch.setattr(spans, "log", lambda: SpanLog(
        [_rec("vectorsearch.query.pool", 10.0, 10.5)], 0))
    assert read(_ctx(4)) is None
    # the ring dropped records that may have lain in the window
    monkeypatch.setattr(spans, "log", lambda: SpanLog([_rec(PASS, 15.0, 15.1)], 7))
    assert read(_ctx(4)) is None
    monkeypatch.setattr(spans, "log", lambda: SpanLog([_rec(PASS, 15.0, 15.1)], 0))
    assert read(_ctx(0)) is None


def test_pack_ms_is_the_median_of_the_runs_records():
    seen = []

    def histogram(name, lo, hi):
        seen.append((name, lo, hi))
        return [3.0, 1.0, 2.0, 40.0] if name == "vectorsearch.exact_pool.pack_ms" else []

    read = spec.reader("pool.pack_ms")
    assert read(_ctx(4, histogram=histogram)) == pytest.approx(2.5)
    assert seen == [("vectorsearch.exact_pool.pack_ms", 0, None)]
    assert read(_ctx(4)) is None  # no record: the route never ran
