"""``device_idle.fl``: the FL cell's idle share of the card
(``shares.idle``)."""
from perfbench.shares import idle as read  # noqa: F401
