"""What a driver's window leaves for the metric readers."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from port_bench.harness.trace import TraceData


@dataclasses.dataclass
class Record:
    """One measured window.

    ``latencies_s`` holds every request's latency; ``work`` the totals
    the rates divide (``requests``, ``lanes``, ...); ``host`` host-clock
    samples by name (seconds); ``counters`` what the driver counted
    while the window ran (bytes a kernel's work needs, ...);
    ``trace`` the profiler's trace of the window in a traced run.
    """

    window_s: float
    attempted: int
    failed: int
    latencies_s: list[float]
    work: dict[str, float] = dataclasses.field(default_factory=dict)
    host: dict[str, list[float]] = dataclasses.field(default_factory=dict)
    counters: dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[TraceData] = None
    setup_s: float = 0.0
