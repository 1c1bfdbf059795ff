"""Lint rules — importing this package registers every rule."""
from repro_torch.analysis.rules import (dtype_policy, except_swallow,  # noqa: F401
                                        host_sync, numpy_hot, rng_discipline,
                                        scheme_strings)
