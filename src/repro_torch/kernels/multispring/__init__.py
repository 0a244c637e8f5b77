from repro_torch.kernels.multispring.ops import (  # noqa: F401
    counter,
    multispring_cuda,
    multispring_ref,
    update,
)
