"""Host-side pipeline pieces of the port (copies of the JAX package's
framework-free modules): frame-level rate control."""
