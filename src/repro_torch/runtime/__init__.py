"""Port runtime: the two-phase MoE server and its serving engine."""
