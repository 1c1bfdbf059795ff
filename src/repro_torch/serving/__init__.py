"""Serving: the zoo's decode loop (``serving/decode``) and the
fault-tolerant FL aggregation service (``serving/fl_server``)."""
from repro_torch.serving.decode import generate, prefill

__all__ = ["ClientRegistry", "FLServer", "generate", "prefill",
           "run_with_restarts"]


def __getattr__(name):
    # fl_server pulls in the whole HSFL stack; load it lazily so the
    # decode-only serving path stays light
    if name in ("FLServer", "ClientRegistry", "run_with_restarts"):
        from repro_torch.serving import fl_server
        return getattr(fl_server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
