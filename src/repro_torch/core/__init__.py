"""Heterogeneous memory: pinned host blocks streamed through the card (Algorithm 3)."""
