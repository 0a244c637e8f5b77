"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import GRANITE_8B


def config():
    return GRANITE_8B
