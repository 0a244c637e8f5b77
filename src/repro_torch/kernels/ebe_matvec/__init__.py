from repro_torch.kernels.ebe_matvec.ops import (  # noqa: F401
    counter_f32,
    counter_f64,
    counter_kset_f32,
    counter_kset_f64,
    ebe_element_matvec_kset_ref,
    ebe_element_matvec_ref,
    ebe_matvec_cuda,
    ebe_matvec_kset_cuda,
    element_kernel,
    element_kernel_kset,
)
