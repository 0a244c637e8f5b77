"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import ZAMBA2_7B


def config():
    return ZAMBA2_7B
