from repro_torch.kernels.ebe_matvec.ops import (  # noqa: F401
    counter_f32,
    counter_f64,
    ebe_element_matvec_ref,
    ebe_matvec_cuda,
    element_kernel,
)
