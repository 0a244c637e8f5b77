"""Training-side utilities of the port: checkpoints for now."""
