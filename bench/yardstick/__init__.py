"""Frozen arithmetic of the benchmark: copies of what the program has, so
that a later change to the program cannot move the yardstick."""
