"""Serving of the port: greedy / sampled decode, resident or host-offloaded KV."""
