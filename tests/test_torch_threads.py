"""The test processes' thread policy (the repository's root
``conftest.py``): each process's torch takes one share of the usable
cores, so that parallel workers do not wait on each other's pools."""

import os

import torch


def test_intra_op_threads_are_one_share_of_the_usable_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = len(os.sched_getaffinity(0))
    assert torch.get_num_threads() == max(1, cores // workers)
