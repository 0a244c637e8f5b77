"""Plain version of the EBE element product: ``repro_torch.fem.spmv``'s
``ebe_element_matvec`` (einsum over the on-the-fly physical gradients)."""
from repro_torch.fem.spmv import ebe_element_matvec as ebe_element_matvec_ref  # noqa: F401
