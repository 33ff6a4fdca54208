"""torch's CPU threads in the port's tests.

Importing this module gives each pytest-xdist worker its share of the
cores: one torch thread per `os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`
cores, at least one. torch's default is one thread per core in every
process, so six workers on eight cores ran 48 threads, which spent most of
their CPU time at the barriers of their parallel regions and starved the
JAX package's tests (the suite's CPU time halved with one thread a worker).
Outside xdist nothing changes. Every port test file imports it.
"""

from __future__ import annotations

import os

import torch


def worker_threads() -> int | None:
    """The threads of one xdist worker, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


if worker_threads() is not None:
    torch.set_num_threads(worker_threads())
