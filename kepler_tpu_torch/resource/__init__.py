"""Host-side resource types the port needs (copies of the JAX package's)."""
