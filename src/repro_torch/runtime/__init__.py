"""Port runtime: the two-phase MoE server, its serving engine, and the
training loop."""
