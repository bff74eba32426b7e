"""Synthetic data for the port: zipf streams and LM token batches (numpy; copies
of the JAX package's generators)."""
