"""The OPT-HSFL simulation: channel, selection, schemes and the fused round."""
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation, run_hsfl
from repro_torch.core.schemes import (Scheme, get_scheme, register_scheme,
                                      registered_schemes)

__all__ = ["HSFLConfig", "HSFLSimulation", "Scheme", "get_scheme",
           "register_scheme", "registered_schemes", "run_hsfl"]
