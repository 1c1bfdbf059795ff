"""The fault-tolerant FL aggregation service (``serving/fl_server``)."""
from repro_torch.serving.fl_server import (ClientRegistry, FLServer,
                                           run_with_restarts)

__all__ = ["ClientRegistry", "FLServer", "run_with_restarts"]
