"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once and prints one JSON result line.  Everything
that belongs to one configuration, traffic mix, cell or per-layer metric
lives in a file of its own here, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``; the cell's ``mode``
picks ``drivers/<mode>.py``.  ``yardstick/`` holds the frozen arithmetic
(traffic generation, model FLOPs, bounds, tails) and ``reference/`` the
plain float32 reference that decides ``correct``.
"""
