"""``mfu.fl``: the whole FL round's share of the card's float32 peak
(``shares.peak``): every SGD step's forward and backward of every user
slot, and each row's eval forward, counted by ``work/paper-cnn.py``; the
configuration is f32 with TF32 off."""
from perfbench.shares import peak as read  # noqa: F401
