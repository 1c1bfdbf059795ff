"""``device_idle.prefill``: the prefill cell's idle share of the card
(``shares.idle``)."""
from perfbench.shares import idle as read  # noqa: F401
