"""Synthetic data for the port (numpy; a copy of the JAX package's generator)."""
