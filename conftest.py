"""Thread policy of every test process: one share of the usable cores.

Under ``pytest-xdist`` each worker is its own process, and torch gives
each one an intra-op pool as wide as the machine.  Tests made of
thousands of small ops then spend their time waiting on pools that
contend for the same cores, so each worker's torch gets
``max(1, usable cores // workers)`` intra-op threads.  The inter-op
pool is left alone (``set_num_interop_threads`` raises once inter-op
work has begun).

This file imports torch and nothing of the packages under test;
``tests/conftest.py`` holds the reference's fixtures.
"""

import os


def thread_share() -> int:
    """Intra-op threads a test process may use: the usable cores shared
    by the xdist workers (one worker without xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


def pytest_configure(config):
    import torch

    torch.set_num_threads(thread_share())
