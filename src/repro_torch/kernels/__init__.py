"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Every wrapper keeps a :class:`LaunchCounter` that it bumps where, and only
where, it launches its kernel, so a run can show that it went through the
kernels.  Importing this package builds and loads nothing.
"""
from __future__ import annotations


class LaunchCounter:
    """Count of kernel launches made by one wrapper.  A counter made with a
    ``parent`` counts one instance of a kernel (a dtype with a kernel of its
    own) and adds each launch to its parent's count too."""

    def __init__(self, name: str, parent: "LaunchCounter | None" = None):
        self.name = name
        self.n = 0
        self.parent = parent
        self.parts: list[LaunchCounter] = []
        if parent is not None:
            parent.parts.append(self)

    def add(self) -> None:
        self.n += 1
        if self.parent is not None:
            self.parent.add()

    def reset(self) -> None:
        self.n = 0
        for part in self.parts:
            part.reset()


def check_arg(kernel: str, name: str, x, shape, dtype, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
            f"on {device}; got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})"
        )


def counters() -> dict[str, LaunchCounter]:
    """Every kernel's launch counter, by kernel name."""
    from repro_torch.kernels.ebe_matvec import ops as ebe_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.multispring import ops as ms_ops

    return {c.name: c for c in (ms_ops.counter, ebe_ops.counter_f64, ebe_ops.counter_f32, ms_ops.counter_kset,
                                ebe_ops.counter_kset_f64, ebe_ops.counter_kset_f32, fa_ops.counter)}


def launch_counts() -> dict[str, int]:
    return {name: c.n for name, c in counters().items()}


def instance_counts() -> dict[str, int]:
    """Launches of each kernel instance that has a counter of its own."""
    return {part.name: part.n for c in counters().values() for part in c.parts}


def reset_launch_counts() -> None:
    for c in counters().values():
        c.reset()
