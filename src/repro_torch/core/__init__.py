"""The OPT-HSFL simulation: channel, selection, schemes and the fused round;
and the multi-pod OpportunisticSync round."""
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation, run_hsfl
from repro_torch.core.opportunistic_sync import OppSyncConfig
from repro_torch.core.schemes import (Scheme, get_scheme, register_scheme,
                                      registered_schemes)

__all__ = ["HSFLConfig", "HSFLSimulation", "OppSyncConfig", "Scheme",
           "get_scheme", "register_scheme", "registered_schemes", "run_hsfl"]
