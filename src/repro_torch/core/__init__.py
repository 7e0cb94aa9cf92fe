"""Lina MoE core of the port: gating, dispatch, the MoE layer, popularity,
placement and the plan-honoring serving layer."""
