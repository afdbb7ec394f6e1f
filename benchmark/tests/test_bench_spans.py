"""The readers of the program's spans (``capture_s``, ``native_s``,
``host_gap_pct.*``) on hand-made records, and a program without them (the
parent's, whose results carry no trace and whose profiling module keeps
no spans) reading None, never an error; the span study at a tiny size on
the CPU."""

import types

import pytest

from benchmark import catalog
from benchmark.tests.tiny import tiny_cell

ROOT = catalog.HERE.parent
GAP_READERS = ("host_gap_pct.full_batch", "host_gap_pct.stochastic")


def _span(name, lo, hi, sid=1, parent=None):
    from lbfgs_ffnn_torch.utils import profiling
    return profiling.Span(name, lo, hi, sid, parent, None)


@pytest.fixture
def process(monkeypatch):
    """A fresh process record of the program's cold spans."""
    from lbfgs_ffnn_torch.utils import profiling
    record = profiling.Record()
    monkeypatch.setattr(profiling, "PROCESS", record)
    return record


def _ctx(result=None, traced=True):
    return types.SimpleNamespace(trace={"result": result} if traced else None)


def test_capture_s_sums_the_capture_spans_less_their_builds(process):
    read = catalog.reader("capture_s", ROOT)
    assert read(_ctx()) is None
    s = 1_000_000_000
    process.spans += [_span("resident.capture", 0, 2 * s),
                      _span("capture.graph", 1 * s, 3 * s // 2, 2, 1),
                      _span("resident.capture", 5 * s, 11 * s // 2, 3),
                      _span("native.load", 20 * s, 29 * s, 4)]
    assert read(_ctx()) == pytest.approx(2.5)
    # a library built in a capture's eager run is native_s's, not capture_s's
    process.spans += [_span("native.load", s // 2, 3 * s // 2, 5, 1),
                      _span("native.build", s // 2, 3 * s // 2, 6, 5)]
    assert read(_ctx()) == pytest.approx(1.5)


def test_native_s_is_the_union_of_builds_and_loads(process):
    read = catalog.reader("native_s", ROOT)
    assert read(_ctx()) is None
    s = 1_000_000_000
    process.spans += [_span("native.load", 0, 10 * s, 1),            # holds its build
                      _span("native.build", 1 * s, 9 * s, 2, 1),
                      _span("native.build", 8 * s, 12 * s, 3),        # another thread
                      _span("native.load", 20 * s, 21 * s, 4),
                      _span("resident.capture", 30 * s, 40 * s, 5)]
    assert read(_ctx()) == pytest.approx(13.0)


def test_readers_of_a_program_without_spans(monkeypatch, process):
    from lbfgs_ffnn_torch.utils import profiling
    process.spans.append(_span("resident.capture", 0, 10))
    monkeypatch.delattr(profiling, "spans")
    for name in ("capture_s", "native_s"):
        assert catalog.reader(name, ROOT)(_ctx()) is None


def _trace(gaps_ns, span=(1_000, 1_001_000), device=True):
    from lbfgs_ffnn_torch.utils import profiling
    gaps = [profiling.Gap(lo, lo + n, "chunk.read", {"chunk.read": n}) for lo, n in gaps_ns]
    return types.SimpleNamespace(span=_span("solve", *span), gaps=gaps,
                                 device=[("replay:iteration", span[1])] if device else [])


@pytest.mark.parametrize("name", GAP_READERS)
def test_host_gap_pct_over_the_solve_span(name):
    read = catalog.reader(name, ROOT)
    result = types.SimpleNamespace(trace=_trace([(2_000, 30_000), (500_000, 20_000)]))
    assert read(_ctx(result)) == pytest.approx(5.0)
    assert read(_ctx(types.SimpleNamespace(trace=_trace([])))) == 0.0


@pytest.mark.parametrize("name", GAP_READERS)
def test_host_gap_pct_without_a_trace_is_none(name):
    read = catalog.reader(name, ROOT)
    assert read(_ctx(traced=False)) is None                 # no traced solve
    assert read(_ctx(None)) is None                         # no result
    assert read(_ctx(types.SimpleNamespace(n_iters=3))) is None   # no trace field
    assert read(_ctx(types.SimpleNamespace(trace=None))) is None  # recording off
    no_device = types.SimpleNamespace(trace=_trace([(2_000, 30_000)], device=False))
    assert read(_ctx(no_device)) is None                    # a CPU solve


def test_span_study_at_a_tiny_size_on_the_cpu():
    from benchmark import span_study
    out = span_study.study("deep-sgd-b256", 4000000123, 1, device="cpu",
                           cell=tiny_cell("deep-sgd-b256", ROOT))
    split = out["setup_split_s"]
    assert sum(split.values()) == pytest.approx(out["setup_s"])
    assert out["epoch_ms"]["on"]["runs"] and out["epoch_ms"]["off"]["runs"]
    assert out["recorded"] == [] and out["profiled"] is None
