"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import WHISPER_SMALL


def config():
    return WHISPER_SMALL
