"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import LLAMA3_405B


def config():
    return LLAMA3_405B
