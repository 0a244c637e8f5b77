"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import MIXTRAL_8X22B


def config():
    return MIXTRAL_8X22B
