"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import GEMMA2_2B


def config():
    return GEMMA2_2B
