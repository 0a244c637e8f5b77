"""Process topology of the port (one process for now)."""
