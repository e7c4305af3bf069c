"""Device resolution and the JAX-state carrier."""
