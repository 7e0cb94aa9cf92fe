"""Model stack of the port: layers, attention, the MoE transformer LM."""
