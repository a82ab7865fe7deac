"""A profiler window and what the benchmark reads from its trace.

:class:`Profiler` wraps ``torch.profiler`` over the measured window;
:class:`TraceData` holds, from the raw events of the trace (not the
profiler's own per-event objects, which are slow to build for a trace
of hundreds of thousands of events):

* the device operations — kernels, copies, memsets — as intervals on the
  trace's clock, by name and by the host time of their launch;
* the benchmark's own host spans (``record_function`` ranges named
  ``bench.*`` and ``serve.*``).

It answers the questions the per-layer readers ask: the union of busy
intervals, the idle gaps and the span the host was in during each, the
device time of the operations launched inside a span, and the device
operations that took most time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

#: Host spans the benchmark itself records (around and inside its calls).
SPAN_PREFIXES = ("bench.", "serve.")
#: The span around the whole traced window.
WINDOW_SPAN = "bench.window"
#: Host runtime and driver calls (``cudaLaunchKernel``, ``cuLaunchKernel``,
#: ``cudaMemcpyAsync``...): the one that launched a device operation has
#: its correlation id.
LAUNCH_PREFIX = "cu"
OUTSIDE = "host.outside_spans"


@dataclasses.dataclass
class TraceData:
    names: list[str]              # device operation names
    start: np.ndarray             # int64 ns, device operations
    end: np.ndarray
    launch: np.ndarray            # int64 ns of the host launch, or -1
    spans: list[tuple[int, int, str]]   # the benchmark's host spans
    window: tuple[int, int]       # the bench.window span, trace clock

    @classmethod
    def from_events(cls, events) -> "TraceData":
        names, start, end, corr = [], [], [], []
        launches: dict[int, int] = {}
        spans = []
        from torch.autograd import DeviceType

        for e in events:
            name = e.name()
            annotation = e.is_user_annotation()
            if e.device_type() != DeviceType.CPU:
                # Kernels, copies and memsets; a record_function range
                # also shows on the device's timeline, as an annotation.
                if not annotation:
                    names.append(name)
                    start.append(e.start_ns())
                    end.append(e.end_ns())
                    corr.append(e.correlation_id())
            elif annotation:
                if name.startswith(SPAN_PREFIXES):
                    spans.append((e.start_ns(), e.end_ns(), name))
            elif name.startswith(LAUNCH_PREFIX):
                launches[e.correlation_id()] = e.start_ns()
        start_a = np.asarray(start, np.int64)
        order = np.argsort(start_a, kind="stable")
        window = [s for s in spans if s[2] == WINDOW_SPAN]
        spans = [s for s in spans if s[2] != WINDOW_SPAN]
        if window:
            w = (window[0][0], window[0][1])
        elif len(start_a):
            w = (int(start_a.min()), int(np.max(end)))
        else:
            w = (0, 0)
        return cls([names[i] for i in order], start_a[order],
                   np.asarray(end, np.int64)[order],
                   np.asarray([launches.get(corr[i], -1) for i in order],
                              np.int64),
                   sorted(spans), w)

    # ------------------------------------------------------------ busy
    def union(self) -> list[tuple[int, int]]:
        """Busy intervals: the union of every device operation's, clipped
        to the window."""
        out: list[list[int]] = []
        w0, w1 = self.window
        for s, e in zip(self.start.tolist(), self.end.tolist()):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """Idle intervals of the window: before, between and after the
        busy ones."""
        out, t = [], self.window[0]
        for s, e in self.union():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    # ----------------------------------------------------------- spans
    def _levels(self):
        """The spans by nesting depth: within one depth they do not
        overlap (host spans nest on the one thread that records them)."""
        levels: list[list[tuple[int, int, str]]] = []
        stack: list[int] = []
        for s, e, n in sorted(self.spans, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1] <= s:
                stack.pop()
            depth = len(stack)
            while len(levels) <= depth:
                levels.append([])
            levels[depth].append((s, e, n))
            stack.append(e)
        return levels

    def span_at(self, times: np.ndarray) -> list[str]:
        """The innermost benchmark span the host was in at each time."""
        times = np.asarray(times, np.int64)
        label = np.full(len(times), OUTSIDE, dtype=object)
        found = np.zeros(len(times), bool)
        for level in reversed(self._levels()):
            starts = np.asarray([s for s, _, _ in level], np.int64)
            ends = np.asarray([e for _, e, _ in level], np.int64)
            idx = np.searchsorted(starts, times, side="right") - 1
            ok = (idx >= 0) & ~found
            inside = np.zeros(len(times), bool)
            inside[ok] = times[ok] < ends[idx[ok]]
            for i in np.nonzero(inside)[0]:
                label[i] = level[idx[i]][2]
            found |= inside
        return label.tolist()

    def launched_in(self, prefix: str) -> np.ndarray:
        """Mask of the device operations launched while the host was in
        a span whose name starts with ``prefix``."""
        labels = self.span_at(self.launch)
        return np.asarray([lab.startswith(prefix) and t >= 0 for lab, t
                           in zip(labels, self.launch.tolist())], bool)

    def device_s(self, mask: Optional[np.ndarray] = None,
                 name_has: Optional[str] = None) -> float:
        """Summed device seconds of the selected operations."""
        dur = (self.end - self.start).astype(np.float64)
        sel = np.ones(len(dur), bool) if mask is None else mask.copy()
        if name_has is not None:
            sel &= np.asarray([name_has in n for n in self.names], bool)
        return float(dur[sel].sum()) / 1e9

    def count(self, name_has: Optional[str] = None) -> int:
        if name_has is None:
            return len(self.names)
        return sum(name_has in n for n in self.names)

    # ------------------------------------------------------- breakdown
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by the span the host was in, each as ``[[name, seconds], ...]``."""
        by_op: dict[str, float] = {}
        dur = (self.end - self.start).tolist()
        for n, d in zip(self.names, dur):
            key = n[:120]
            by_op[key] = by_op.get(key, 0.0) + d / 1e9
        gaps = self.gaps()
        mids = np.asarray([(a + b) // 2 for a, b in gaps], np.int64)
        by_gap: dict[str, float] = {}
        for (a, b), lab in zip(gaps, self.span_at(mids)):
            by_gap[lab] = by_gap.get(lab, 0.0) + (b - a) / 1e9
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


class Profiler:
    """``torch.profiler`` over the measured window, or nothing.

    Enter before the window and exit after its last request completed;
    :attr:`data` then holds the trace's :class:`TraceData` and
    :attr:`read_s` how long reading it took.
    """

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.data: Optional[TraceData] = None
        self.read_s = 0.0
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            import torch
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t0 = time.perf_counter()
            events = self._prof.profiler.kineto_results.events()
            self.data = TraceData.from_events(events)
            self.read_s = time.perf_counter() - t0
        self._prof = None
        return False
