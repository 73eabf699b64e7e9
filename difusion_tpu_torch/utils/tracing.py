"""The port's span recorder: one a process, off until :func:`enable`.

A span is a named interval of one thread on ``time.perf_counter_ns``: its
start and end, the index of the span it sits in on that thread (its
parent, -1 for none), the thread, the item it belongs to (a frame index or
an extract number; a span given none takes its parent's) and whether the
host was blocked on the card in it (``wait``: a count read, a download, a
pageable upload).  A span site reads::

    s = tracing.begin("slam.track") if tracing.ON else -1
    ...                               # the work
    if s >= 0:
        tracing.end(s)

so with the recorder off a site costs one test of a module flag: no call,
no allocation, no context manager.  A span whose work raises stays open
(``end_ns`` -1).  Spans stay in memory until :func:`reset`; :func:`spans`
reads them.

While ``torch.profiler`` runs, each span is also a profiler user annotation
of the same name, so a trace (``slam.py --xprof``) holds the port's spans
on the profiler's clock.  The first span after a profiler starts takes a
mark on both clocks (the annotation ``tracing.mark``); given the trace's
events, :func:`clock_offset_ns` turns the mark into the offset between
them, so the in-memory spans can be laid on the device timeline.

The recorder also decides, when a :class:`~.cudagraph.GraphProgram` is
built, whether its segments are timed on the device (its
``segment_ns()``).
"""
from __future__ import annotations

import threading
import time
from typing import Iterable, List, Optional, Tuple

import torch

# the flag every span site tests
ON = False

MARK = "tracing.mark"


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "item", "wait",
                 "_annotation")

    def __init__(self, name, start_ns, parent, thread, item, wait):
        self.name, self.start_ns, self.end_ns = name, start_ns, -1
        self.parent, self.thread, self.item, self.wait = parent, thread, item, wait
        self._annotation = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}..{self.end_ns}, parent={self.parent}, "
                f"item={self.item}, wait={self.wait})")


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[Span] = []
        self.stacks: dict = {}        # thread ident -> indices of its open spans
        self.marks: List[int] = []    # perf_counter_ns of each mark
        self.profiled = False         # a profiler ran at the last span


_rec = _Recorder()


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def reset() -> None:
    """Drop every span and mark (no span may be open)."""
    global _rec
    _rec = _Recorder()


def _mark() -> None:
    """Two annotations ``MARK``; the second, on a warm path, is the mark:
    its start on the host clock is the midpoint of its entry."""
    for _ in range(2):
        ann = torch.autograd.profiler.record_function(MARK)
        t0 = time.perf_counter_ns()
        ann.__enter__()
        t1 = time.perf_counter_ns()
        ann.__exit__(None, None, None)
    _rec.marks.append((t0 + t1) // 2)


def begin(name: str, item: Optional[int] = None, wait: bool = False) -> int:
    """Open a span on this thread; returns its index for :func:`end`."""
    profiling = torch.autograd._profiler_enabled()
    if profiling != _rec.profiled:
        _rec.profiled = profiling
        if profiling:
            _mark()
    thread = threading.get_ident()
    rec = _rec
    with rec.lock:
        stack = rec.stacks.setdefault(thread, [])
        parent = stack[-1] if stack else -1
        if item is None:
            item = rec.spans[parent].item if parent >= 0 else -1
        span = Span(name, 0, parent, thread, item, wait)
        index = len(rec.spans)
        rec.spans.append(span)
        stack.append(index)
    if profiling:
        span._annotation = torch.autograd.profiler.record_function(name)
        span._annotation.__enter__()
    span.start_ns = time.perf_counter_ns()
    return index


def end(index: int) -> None:
    """Close span ``index`` (and any span left open inside it)."""
    t = time.perf_counter_ns()
    rec = _rec
    span = rec.spans[index]
    span.end_ns = t
    if span._annotation is not None:
        span._annotation.__exit__(None, None, None)
        span._annotation = None
    stack = rec.stacks.get(span.thread, [])        # this thread's own
    if index in stack:
        del stack[stack.index(index):]


def n_spans() -> int:
    return len(_rec.spans)


def spans(since: int = 0) -> List[Span]:
    """The spans recorded from index ``since`` on (a list of the records
    themselves: an open one has ``end_ns`` -1)."""
    return _rec.spans[since:]


def clock_offset_ns(events: Iterable[Tuple[str, int]]) -> Optional[int]:
    """Profiler clock minus ``perf_counter_ns``, from the last mark: pass
    the profiled window's events as (name, start in ns), e.g.
    ``(e.name(), e.start_ns())`` of ``prof.profiler.kineto_results.events()``.
    None if the trace or the recorder holds no mark."""
    starts = [int(s) for n, s in events if n == MARK]
    if not starts or not _rec.marks:
        return None
    return max(starts) - _rec.marks[-1]
