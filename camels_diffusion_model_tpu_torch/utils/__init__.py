"""Weight conversion from the JAX package's layouts."""
