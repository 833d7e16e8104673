"""Protocol constants used by the port (copied, jax-free)."""
