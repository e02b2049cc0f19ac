"""Utilities of the port: state checkpoints."""
