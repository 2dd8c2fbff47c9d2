"""Scripts beside the port: measurements and the draw parity with the JAX package (run each as a file)."""
