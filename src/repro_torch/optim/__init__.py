"""Optimizer of the port: AdamW with a cosine schedule and global-norm
clipping (``optim.adamw``)."""
