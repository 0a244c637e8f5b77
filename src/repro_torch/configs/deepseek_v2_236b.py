"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import DEEPSEEK_V2_236B


def config():
    return DEEPSEEK_V2_236B
