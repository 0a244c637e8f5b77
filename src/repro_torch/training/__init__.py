"""Training-side utilities of the port: checkpoints and the straggler watchdog."""
