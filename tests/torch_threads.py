"""The torch intra-op thread count of the port's test files.

Every ``tests/test_torch_*.py`` imports this module. Under
``pytest-xdist`` each worker process collects every file, so the first
import in a worker sets the count once for all of that worker's tests:
the host's cores shared among the workers (``PYTEST_XDIST_WORKER_COUNT``),
at least one. Torch's default, one thread per core in every worker,
oversubscribes the host by the worker count. A run without xdist keeps
every core.
"""

import os

import torch

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
