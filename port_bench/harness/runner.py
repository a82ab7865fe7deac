"""Run one cell once: set up, measure a window, judge the outputs.

:func:`run_cell` is the whole run but the look for a card, which the
command line (``run.py``) makes first; tests call it on the CPU at small
sizes, with the program broken underneath, to see ``correct`` fall.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Optional

from port_bench.harness import spec as specs
from port_bench.harness.trace import Profiler


@dataclasses.dataclass
class Check:
    """One number the run compares with its limit (at most ``limit``)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def merged(base: dict, changes: Optional[dict]) -> dict:
    out = dict(base)
    out.update(changes or {})
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: Optional[dict] = None,
             spec: Optional[dict] = None, t0: Optional[float] = None,
             out=None) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``overrides`` (tests only) changes keys of the configuration
    (``"config"``) or the traffic (``"traffic"``).  ``t0`` is when the
    process started, so set-up counts the imports.
    """
    t0 = time.perf_counter() if t0 is None else t0
    out = out if out is not None else sys.stdout
    overrides = overrides or {}
    cell = specs.load_cell(workload, spec)
    config = merged(cell.config, overrides.get("config"))
    traffic = merged(cell.traffic, overrides.get("traffic"))
    drv = specs.driver(config)

    import torch

    split: dict[str, float] = {"import": time.perf_counter() - t0}
    if device == "cuda":
        from repro_torch.kernels import launch

        t = time.perf_counter()
        launch.build_all()
        split["build"] = time.perf_counter() - t
    state = drv.setup(config, traffic, seed, device, split)
    setup_s = time.perf_counter() - t0
    print(json.dumps({"workload": workload, "seed": seed,
                      "setup_s": setup_s, "setup_split_s": split}),
          file=out, flush=True)

    # A traced run measures two windows: the first without the profiler,
    # whose cost lands on every launch, for the metrics the host reads
    # (host clock, program spans); the second traced, for the device's.
    host_rec = None
    if trace:
        with Profiler(False) as quiet:
            host_rec = drv.window(state, seconds, quiet)
    with Profiler(trace) as prof:
        rec = drv.window(state, seconds, prof)
    rec.trace = prof.data
    rec.setup_s = setup_s
    host_rec = host_rec or rec
    attempted = rec.attempted + (host_rec.attempted if trace else 0)
    failed = rec.failed + (host_rec.failed if trace else 0)

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if device == "cuda" else 0}
    answers = drv.release(state)
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(answers, config, traffic, seed)
    checks.append(Check("failed_requests", failed, 0))

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        read_from = rec if m["source"] == "device_trace" else host_rec
        value = specs.metric_reader(m["name"]).read(read_from)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": all(c.ok for c in checks),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
        print(json.dumps({"trace_read_s": prof.read_s,
                          "device_ops": rec.trace.count()}),
              file=out, flush=True)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result
