"""Spans and counters inside the port, for an operator's own window.

    from repro_torch import obs

    with obs.recording() as rec:
        session.run_fused(program, image, mode="fused")
    rec.spans["cuda.run_fused"].self_s, rec.counters["backend.index_uploads"]

:func:`span` times a named part of the program and :func:`count` adds to
a named counter.  A :class:`Recording` holds what closed inside its
window: per span name the calls, total and self seconds (self is total
less the time its child spans cover) and the calls under each parent
span; every counter.  Spans nest on a per-thread stack; a recording
takes what any thread closes while it is open, and one recording is
open at a time.  Host times are ``time.perf_counter_ns`` readings, kept
in memory and summed when the recording closes.

Under an active ``torch.profiler`` a span also enters
``torch.profiler.record_function(name)``, so the program's spans lie on
the device trace's clock beside the kernels and copies they launched.
With no recording open and no profiler active, :func:`span` returns one
shared no-op context and :func:`count` returns at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterator, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

#: The window of the recording open now, if any.
_window: Optional["_Window"] = None
_local = threading.local()
_NOOP = contextlib.nullcontext()


@dataclasses.dataclass
class SpanStats:
    """One span name's closings in a window."""

    calls: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    #: Calls by the name of the span they were opened in (``None``: none).
    parents: dict[Optional[str], int] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class Recording:
    """What closed inside one :func:`recording` window; filled when the
    window closes."""

    window_s: float = 0.0
    spans: dict[str, SpanStats] = dataclasses.field(default_factory=dict)
    counters: dict[str, int] = dataclasses.field(default_factory=dict)


class _Window:
    __slots__ = ("events", "counts")

    def __init__(self):
        self.events: list[tuple[str, Optional[str], int, int]] = []
        self.counts: list[tuple[str, int]] = []


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "parent", "child_ns", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _profiling():
            self.range = record_function(self.name)
            self.range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter_ns() - self.t0
        _local.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += total
        event = (self.name, parent.name if parent is not None else None,
                 total, total - self.child_ns)
        window = _window
        if window is not None:
            window.events.append(event)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager timing ``name`` (see the module docstring)."""
    if _window is None and not _profiling():
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` in the open recording, if any."""
    window = _window
    if window is not None:
        window.counts.append((name, n))


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the spans and counters of the ``with`` block's window;
    raises ``RuntimeError`` while another recording is open."""
    global _window
    if _window is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    window = _window = _Window()
    t0 = time.perf_counter_ns()
    try:
        yield rec
    finally:
        rec.window_s = (time.perf_counter_ns() - t0) / 1e9
        _window = None
        for name, parent, total, self_ns in window.events:
            stats = rec.spans.setdefault(name, SpanStats())
            stats.calls += 1
            stats.total_s += total / 1e9
            stats.self_s += self_ns / 1e9
            stats.parents[parent] = stats.parents.get(parent, 0) + 1
        for name, n in window.counts:
            rec.counters[name] = rec.counters.get(name, 0) + n
