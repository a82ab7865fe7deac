"""Kernel micro-benchmarks through the session API.

The counterpart of the reference's ``benchmarks/kernel_bench.py``: a
``cuda`` session against the ``oracle`` session on identical inputs, at
the reference's five shapes, each row beside the bytes its kernel must
move and the least time the H100 could take to move them (bytes over
its 3.35 TB/s), where the reference gives TPU-side traffic.  Each call
is timed after a warm-up, by CUDA events on the card and by the host's
clock on the CPU, where the ``cuda`` session runs each kernel's plain
version.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.backends import ExecutionContext
from repro_torch.core import bitplanes as bp
from repro_torch.core.costmodel import HBM_BW
from repro_torch.session import DramSession

#: Which executor the rows measure, and the one they are compared with.
BENCH_BACKEND = "cuda"
REF_BACKEND = "oracle"


def _timeit(fn, device: str, reps: int = 3) -> float:
    """Microseconds a call of ``fn``, the mean of ``reps`` after one
    warm-up call."""
    fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _traffic(n_bytes: float) -> str:
    return f"bytes={n_bytes:.0f};h100_bound_us={n_bytes / HBM_BW * 1e6:.3f}"


def kernel_benchmarks(device: str = "cuda"):
    backend = BENCH_BACKEND
    ctx = ExecutionContext(device=device)
    be = DramSession(backend, ctx)
    ref = DramSession(REF_BACKEND, ctx)
    data = np.random.default_rng(0)

    def words(shape):
        return bp.from_u32(data.integers(0, 2**32, shape, dtype=np.uint32),
                           device)

    rows = []
    x = words((9, 64, 2048))
    us_ref = _timeit(lambda: ref.majx(x), device)
    us_k = _timeit(lambda: be.majx(x), device)
    # read 9 planes, write 1
    traffic = x.numel() * 4 * 10 / 9
    rows.append((f"kernel_majx9_64x2048[{backend}]", us_k,
                 f"ref_us={us_ref:.0f};{_traffic(traffic)}"))

    a, b = words((32, 16, 512)), words((32, 16, 512))
    us_ref = _timeit(lambda: ref.add_planes(a, b), device)
    us_k = _timeit(lambda: be.add_planes(a, b), device)
    # one round trip (read a and b, write the sum); plane at a time: 32
    rows.append((f"kernel_bitserial_add_32x16x512[{backend}]", us_k,
                 f"ref_us={us_ref:.0f};traffic_reduction=32x;"
                 f"{_traffic(3 * a.numel() * 4)}"))

    src = words((8, 4096))
    us_k = _timeit(lambda: be.rowcopy(src, 31), device)
    n = src.numel() * 4
    rows.append((f"kernel_fanout31_8x4096[{backend}]", us_k,
                 f"hbm_read_bytes={n};write={n * 31};"
                 f"{_traffic(n * 32)}"))

    g, w = words((1 << 18,)), words((1 << 18,))
    us_ref = _timeit(lambda: ref.mismatch(g, w), device)
    us_k = _timeit(lambda: be.mismatch(g, w), device)
    rows.append((f"kernel_mismatch_1M_cells[{backend}]", us_k,
                 f"ref_us={us_ref:.0f};{_traffic(2 * g.numel() * 4)}"))

    # a batch of MAJX calls in one dispatch (native on cuda)
    xb = words((4, 5, 16, 512))
    us_k = _timeit(lambda: be.majx_batch(xb), device)
    rows.append((f"kernel_majx5_batch4_16x512[{backend}]", us_k,
                 f"native_batch={be.capabilities().native_batch};"
                 f"{_traffic(xb.numel() * 4 * 6 / 5)}"))
    return rows
