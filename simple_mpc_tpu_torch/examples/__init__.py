"""The closed-loop examples of the port (JAX package's `examples/`)."""
