"""Framework-free helpers of the port: trees of tensors in the JAX package's leaf order."""
