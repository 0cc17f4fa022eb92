"""Utilities of the port (own copies; nothing is imported from the JAX package)."""
