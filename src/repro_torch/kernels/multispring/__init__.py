from repro_torch.kernels.multispring.ops import (  # noqa: F401
    counter,
    counter_kset,
    multispring_cuda,
    multispring_kset_cuda,
    multispring_kset_ref,
    multispring_ref,
    update,
    update_kset,
)
