"""Mode drivers, found by a cell's ``mode``: ``run(cell, seed, seconds,
trace, t_start)`` -> the run's outcome (see ``bench/run.py``)."""
