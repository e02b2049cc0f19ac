"""The engine of the port: spec params on torch, tables, step, rollouts."""
