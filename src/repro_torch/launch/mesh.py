"""The campaign's case mesh: one device.

The JAX package shards a campaign's case axis over a 1-D device mesh.  The
port runs one card, so the case "mesh" of one device is no mesh at all
(``None``, which the runner reads as "one device"); a mesh over more
devices raises until the multi-device campaign is ported.
"""
from __future__ import annotations

MULTI_DEVICE = "the port runs a campaign on one device; the case mesh over several devices is not ported yet"


def make_case_mesh(n_devices: int | None = None, axis: str = "case"):
    """``None`` for one device (the default); raises for more."""
    n = 1 if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"n_devices must be ≥ 1, got {n}")
    if n > 1:
        raise NotImplementedError(f"make_case_mesh({n}): {MULTI_DEVICE}")
    return None
