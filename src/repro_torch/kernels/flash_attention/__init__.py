from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    counter,
    flash_attention,
    flash_attention_cuda,
    flash_attention_ref,
)
