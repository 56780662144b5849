"""Plain references the benchmark judges the port's answers against.

They import neither ``jax``, ``metrics_tpu`` nor ``metrics_tpu_torch``, and take nothing the port made:
they are handed the benchmark's own inputs and weights and work everything out again.
"""
