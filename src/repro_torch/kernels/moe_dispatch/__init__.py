from repro_torch.kernels.moe_dispatch.kernel import (moe_combine, moe_scatter,
                                                     moe_slots)
from repro_torch.kernels.moe_dispatch.ref import (combine_ref, scatter_ref,
                                                  slots_ref)

__all__ = ["combine_ref", "moe_combine", "moe_scatter", "moe_slots",
           "scatter_ref", "slots_ref"]
