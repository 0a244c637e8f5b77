"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import MAMBA2_780M


def config():
    return MAMBA2_780M
