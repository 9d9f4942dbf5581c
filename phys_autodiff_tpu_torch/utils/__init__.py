"""Support code of the port: its own config dataclasses, tolerances and
error metrics (copies of the JAX package's jax-free modules), and timing on
the card."""
