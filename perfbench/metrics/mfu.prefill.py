"""``mfu.prefill``: the whole prefill's share of the card's bf16 peak
(``shares.peak``): 2 x the active matmul parameters of every token, all k
routes and the LM head over the published vocabulary, plus causal
attention, counted by ``work/<config>.py``."""
from perfbench.shares import peak as read  # noqa: F401
