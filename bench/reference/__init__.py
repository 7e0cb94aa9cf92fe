"""The plain reference that decides ``correct``: float32 PyTorch with
TF32 off, independent of the program (it imports nothing of
``repro_torch``, nor ``jax``, nor ``repro``)."""
