"""Caps torch's intra-op threads when pytest-xdist runs the suite.

Every xdist worker is a process with torch's default of one intra-op thread
per core, so `-n 6` on an 8-core machine asks for 48 threads and the
workers' GEMMs and einsums wait on each other. Imported at the top of every
`tests/test_torch_*.py` (xdist workers collect every file, so the setting
holds in each worker): under xdist it gives each worker
max(1, cores // workers) threads. Outside xdist it does nothing. The rank
processes that test_torch_distributed.py and test_torch_pipeline_ranks.py
start set their own thread counts.
"""

import os

import torch


def cap_threads() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 0:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


cap_threads()
