"""Surrogate side of the port: the campaign's dataset shards for now."""
