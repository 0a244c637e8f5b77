"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import INTERNVL2_1B


def config():
    return INTERNVL2_1B
