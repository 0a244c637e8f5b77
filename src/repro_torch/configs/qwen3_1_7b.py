"""Assigned architecture config — exact dims in registry.py."""
from repro_torch.configs.registry import QWEN3_1_7B


def config():
    return QWEN3_1_7B
