"""Profiling: the port's spans and counters, and a ``torch.profiler`` trace.

Counterpart of :mod:`lbfgs_ffnn_tpu.utils.profiling` (a ``jax.profiler``
trace). The reference's tracing is wall-clock timestamps per iteration
(std::chrono / cudaEvent); the deeper view here is a profiler trace of the
host's operators and, on a card, its kernels, written as a Chrome trace
(chrome://tracing, Perfetto), with the program's own steps in it.

A :class:`Span` is a named interval on the host clock
(``time.perf_counter_ns``) with its own id, its parent's and the id of the
solve it belongs to. Two kinds are kept in memory:

- cold spans and counters, recorded always, once a process or once a
  capture: ``import`` (the package's own import), ``native.build`` and
  ``native.load`` (per library, ``detail`` its name), ``resident.capture``
  with ``capture.eager``, ``capture.check`` and ``capture.graph``, and
  ``prepare``; the counters ``captures``, ``graph_cache.hit``/``.miss``
  and ``prepared.hit``/``.miss``. :data:`PROCESS` holds them
  (:func:`spans`, :func:`counter`).
- hot spans and counters, recorded per solve only while recording is on
  (in a :func:`trace` or :func:`recording` block, or while a profiler
  records, checked once at the solve's entry): ``solve``,
  ``resident.load``, ``chunk`` (the enqueue of a chunk's steps), one
  ``replay:<body>`` per replay of a step's body, ``chunk.read`` (the host's
  wait for a chunk's counters) and ``finalize``; the counters
  ``replays:<body>`` and ``host_syncs``. They go to the solve's
  :class:`SolveTrace`, which ``SolveResult.trace`` holds (None when
  recording is off).

Off, a hot site is one test of :data:`ACTIVE`: no allocation, no event, no
sync. While a profiler records, each span also opens a
``torch.profiler.record_function`` range of its name, so the program's
steps sit in the profiler's own host timeline beside the kernels.

On a card, a recorded solve also puts the device's progress on the host
clock: one synchronize and one calibration event at its start, a timing
event after each replay, and, before each launch, a query of the previous
replay's event. Where that event is complete the device has drained its
queue and waits for the host: a start event is recorded at once, and the
interval from the previous event to it is a :class:`Gap`, put down to the
host spans that held the host meanwhile. A graph's launch keeps the device
waiting until it returns, so a graph's gap runs to that return, and where
the previous replay was still running before the launch it is queried
again after it (a slow launch lets the queue run dry). Nothing is recorded
inside a capture, so a captured graph is the same whether recording was
on or off.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from bisect import bisect_right
from pathlib import Path
from typing import NamedTuple, Optional

import torch

RECORDING = False  # a trace() or recording() block is open
ACTIVE = 0         # recorded solves open in the process: what a hot site tests
OFF = contextlib.nullcontext()  # a hot site's context while nothing records

_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    solve: Optional[int]
    detail: str = ""

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Gap(NamedTuple):
    """An interval in which the device had nothing queued, on the host
    clock; ``by`` the host spans' self time within it, ns by span name
    (``replay:<body>``: the launch itself; ``chunk``: the Python between a
    chunk's replays; ``solve``: the solve's entry, exit and its Python
    between chunks), ``cause`` the name that held most of it."""

    start_ns: int
    end_ns: int
    cause: str
    by: dict


class Record:
    """The process's cold spans and counters."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: collections.Counter = collections.Counter()


PROCESS = Record()


def _profiler_on() -> bool:
    return torch._C._autograd._profiler_enabled()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Optional["SolveTrace"]:
    """The recorded solve open on this thread, if any."""
    return getattr(_local, "solve", None)


class _open:
    """A span on this thread's stack, ``keep(span)`` when it closes (a
    class, not a generator: it runs at every replay of a recorded solve)."""

    __slots__ = ("name", "detail", "keep", "sid", "rf", "parent", "solve", "stack", "start")

    def __init__(self, name: str, detail: str, profiled: bool, keep, sid: Optional[int] = None):
        self.name, self.detail, self.keep, self.sid = name, detail, keep, sid
        self.rf = torch.autograd.profiler.record_function(name) if profiled else None

    def __enter__(self):
        self.stack = _stack()
        self.sid = self.sid or next(_ids)
        self.parent = self.stack[-1] if self.stack else None
        t = current()
        self.solve = t.id if t is not None else None
        self.stack.append(self.sid)
        self.start = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.perf_counter_ns()
        self.stack.pop()
        self.keep(Span(self.name, self.start, end, self.sid, self.parent, self.solve,
                       self.detail))
        return False


def _keep_cold(span: Span) -> None:
    with _lock:
        PROCESS.spans.append(span)
    t = current()
    if t is not None and span.solve == t.id:
        t.spans.append(span)


def span(name: str, detail: str = ""):
    """A cold span, recorded always (set-up work: builds, loads, captures)."""
    return _open(name, detail, _profiler_on(), _keep_cold)


def record(name: str, start_ns: int, end_ns: int, detail: str = "") -> None:
    """A cold span whose interval was timed by its caller."""
    _keep_cold(Span(name, start_ns, end_ns, next(_ids), None, None, detail))


def count(name: str, n: int = 1) -> None:
    """A cold counter; also the open recorded solve's."""
    with _lock:
        PROCESS.counters[name] += n
    t = current()
    if t is not None:
        t.counters[name] += n


def counter(name: str) -> int:
    return PROCESS.counters[name]


def spans(*names: str) -> list[Span]:
    """The process's cold spans named ``names`` (all without names)."""
    with _lock:
        return [s for s in PROCESS.spans if not names or s.name in names]


def last(name: str) -> Optional[Span]:
    found = spans(name)
    return found[-1] if found else None


def hot(name: str):
    """A hot span of the open recorded solve; a site reaches it only when
    :data:`ACTIVE` is set (``with hot(n) if ACTIVE else OFF``)."""
    t = current()
    return OFF if t is None else t.open(name)


def hot_count(name: str, n: int = 1) -> None:
    t = current()
    if t is not None:
        t.counters[name] += n


class SolveTrace:
    """One recorded solve: its spans (``span`` the ``solve`` span itself),
    counters, device times (``device``: ``(label, host ns)`` of each
    replay's end on the device, empty off a card) and :class:`Gap` s, all
    on the host clock. Filled while the solve runs; complete when it
    returns. The device times and gaps are worked out at their first read
    (which waits for the device), so the solve pays nothing for them."""

    def __init__(self, device: torch.device, profiled: bool):
        self.id = next(_ids)  # the solve span's own id
        self.profiled = profiled
        self.span: Optional[Span] = None
        self.spans: list[Span] = []
        self.counters: collections.Counter = collections.Counter()
        self._device: list[tuple[str, int]] = []
        self._gaps: list[Gap] = []
        self._dev, self._cuda = device, device.type == "cuda"
        self._marks: list = []  # (previous end event, start event or None, host ns or None)
        self._ends: list = []   # (label, end event) of each replay
        self._last = self._cal = self._start = self._latest = None
        self._cal_ns = 0

    def open(self, name: str):
        """A hot span of this solve."""
        return _open(name, "", self.profiled, self.spans.append)

    def launch(self) -> None:
        """Before a launch: where the previous replay has ended on the
        device, a start event now (the device waits for the host)."""
        self._start = None
        if self._cuda and self._last.query():
            self._start = self._latest = torch.cuda.Event(enable_timing=True)
            self._start.record()

    def landed(self, label: str, graph: bool) -> None:
        """After a launch: the gap before it, and the event its end on the
        device records. A graph's launch holds the device idle until it
        returns, so a graph's gap ends on the host clock at its return, and
        the previous replay is queried again there: it may have ended
        during a slow launch. An eager body's kernels start as it runs: its
        gap ends at the start event."""
        if not self._cuda:
            return
        after = time.perf_counter_ns() if graph else None
        if self._start is not None:
            self._marks.append((self._last, self._start, after))
        elif graph and self._last.query():
            self._marks.append((self._last, None, after))
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._ends.append((label, end))
        self._last = self._latest = end

    def leave(self) -> None:
        """At the solve's exit: a gap where the device has drained."""
        self.launch()
        if self._start is not None:
            self._marks.append((self._last, self._start, None))

    def _begin(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._dev)
            self._cal = self._last = self._latest = torch.cuda.Event(enable_timing=True)
            self._cal_ns = time.perf_counter_ns()
            self._cal.record()

    @property
    def device(self) -> list[tuple[str, int]]:
        self._resolve()
        return self._device

    @property
    def gaps(self) -> list[Gap]:
        self._resolve()
        return self._gaps

    def _resolve(self) -> None:
        """Once the solve has returned: the device times and the gaps."""
        if self._cal is None or self.span is None:
            return
        self._latest.synchronize()  # recorded last: every event before it is done

        def host_ns(ev) -> int:
            return self._cal_ns + int(self._cal.elapsed_time(ev) * 1e6)

        pieces = _self_time(self.spans)
        starts = [p[0] for p in pieces]
        for prev, start, after in self._marks:
            lo = host_ns(prev)
            hi = max(host_ns(start) if start is not None else lo, after or lo)
            if hi > lo:
                self._gaps.append(_gap(lo, hi, pieces, starts))
        self._device = [(label, host_ns(end)) for label, end in self._ends]
        self._marks, self._ends = [], []
        self._last = self._cal = self._start = self._latest = None

    def gap_ns(self) -> int:
        return sum(g.end_ns - g.start_ns for g in self.gaps)

    def by_cause(self) -> dict:
        """Gap ns by host span name, largest first."""
        total: collections.Counter = collections.Counter()
        for g in self.gaps:
            total.update(g.by)
        return dict(total.most_common())


def _self_time(spans: list[Span]) -> list[tuple[int, int, str]]:
    """The solve's host timeline as ``(start, end, name)`` pieces, each
    piece the time a span held without a child span open, sorted."""
    children: dict = collections.defaultdict(list)
    ids = {s.id for s in spans}
    for s in spans:
        children[s.parent if s.parent in ids else None].append(s)
    pieces = []
    for s in spans:
        t = s.start_ns
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
            if c.start_ns > t:
                pieces.append((t, c.start_ns, s.name))
            t = max(t, c.end_ns)
        if s.end_ns > t:
            pieces.append((t, s.end_ns, s.name))
    pieces.sort()
    return pieces


def _gap(lo: int, hi: int, pieces, starts) -> Gap:
    by: collections.Counter = collections.Counter()
    i = max(bisect_right(starts, lo) - 1, 0)
    covered = 0
    while i < len(pieces) and pieces[i][0] < hi:
        a, b, name = pieces[i]
        part = min(b, hi) - max(a, lo)
        if part > 0:
            by[name] += part
            covered += part
        i += 1
    if hi - lo > covered:
        by["outside"] += hi - lo - covered
    return Gap(lo, hi, by.most_common(1)[0][0], dict(by))


@contextlib.contextmanager
def _recorded_solve(device: torch.device):
    global ACTIVE
    prev_solve = current()
    t = SolveTrace(device, _profiler_on())
    t._begin()
    with _lock:
        ACTIVE += 1
    _local.solve = t
    try:
        with _open("solve", "", t.profiled, t.spans.append, sid=t.id):
            try:
                yield t
            finally:
                t.leave()
        t.span = next(s for s in t.spans if s.id == t.id)
    finally:
        _local.solve = prev_solve
        with _lock:
            ACTIVE -= 1


def solve(device):
    """The ``solve`` span of a solver's entry: a context that yields the
    solve's :class:`SolveTrace` where recording is on (a :func:`recording`
    or :func:`trace` block, or a profiler recording), else None at no
    cost."""
    if not (RECORDING or _profiler_on()):
        return OFF
    return _recorded_solve(torch.device(device))


@contextlib.contextmanager
def recording():
    """Record the hot spans of every solve in the block."""
    global RECORDING
    saved, RECORDING = RECORDING, True
    try:
        yield
    finally:
        RECORDING = saved


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``with trace(dir): run()`` traces ``run()`` (the CPU's operators and,
    where a card is visible, its kernels, with the program's spans beside
    them) and writes the Chrome trace ``trace-<time>-<pid>.json`` into
    ``logdir`` (default: a directory under the temporary directory).
    Recording is on in the block. Yields the directory."""
    logdir = Path(logdir) if logdir else Path(tempfile.gettempdir()) / "lbfgs_ffnn_torch_trace"
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with recording():
            yield str(logdir)
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(logdir / f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"))
