"""The benchmark's CPU tests: the program's package on the path, and
under ``pytest -n N`` each worker's share of the cores for torch."""
import os
import sys

from bench.harness import SRC

if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import torch  # noqa: E402

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
