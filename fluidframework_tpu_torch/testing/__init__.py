"""Stream generators and digests of the port (copies of the JAX
package's jax-free helpers)."""
