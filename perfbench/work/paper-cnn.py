"""Work counts of the ``paper-cnn`` configuration from its shapes.

FLOPs count products only, two per multiply-add.  The CNN's forward is
782 848 FLOPs an image: conv1 28·28·9·1·8, conv2 14·14·9·8·16, fc
784·128 + 128·64 + 64·10 multiply-adds.  A training step's backward takes
the weight gradient of every layer and the input gradient of every layer
but the first (the images need none).

Each fused-CNN kernel's bound is, per launch, the larger of its FLOPs over
the float32 peak and its bytes over HBM bandwidth, with each input byte
read once and each output byte written once: the algorithm's inputs and
outputs (images or activations, weights, biases, the upstream gradient;
outputs, weight and bias gradients, the input gradient), not what the
kernel saves for its backward.
"""
from __future__ import annotations

import math
from typing import Dict

F32 = 4

# the launch counters of the port's kernel wrappers -> the kernels' names
# in the device trace (``short_name``)
KERNELS = {"conv_pool_fwd_k": "conv_pool_fwd_kernel",
           "conv_pool_bwd_k": "conv_pool_bwd_kernel",
           "fc_chain_fwd_k": "fc_fwd_kernel",
           "fc_chain_bwd_k": "fc_bwd_kernel"}


def _shapes(cfg: Dict):
    ps = cfg["model"]["param_shapes"]
    side = cfg["model"]["image_side"]
    convs = []
    for name in ("conv1", "conv2"):
        _, _, cin, cout = ps[name]["w"]
        convs.append((name, side, cin, cout))
        side //= 2
    fcs = [tuple(ps[n]["w"]) for n in ("fc1", "fc2", "fc3")]
    return convs, fcs


def _nparams(cfg: Dict, name: str) -> int:
    return sum(math.prod(s) for s in cfg["model"]["param_shapes"][name]
               .values())


def forward_flops_per_image(cfg: Dict) -> float:
    convs, fcs = _shapes(cfg)
    macs = sum(s * s * 9 * cin * cout for _, s, cin, cout in convs)
    macs += sum(i * o for i, o in fcs)
    return 2.0 * macs


def train_flops_per_image(cfg: Dict) -> float:
    """Forward, every weight gradient, every input gradient but conv1's."""
    convs, _ = _shapes(cfg)
    fwd = forward_flops_per_image(cfg)
    _, s, cin, cout = convs[0]
    first = 2.0 * s * s * 9 * cin * cout
    return fwd + fwd + (fwd - first)


def row_round_flops(cfg: Dict, rows: int = 1) -> float:
    """A round of ``rows`` (simulation, config) rows: every slot of the K
    users trains e·steps batches, and each row's model is evaluated on the
    test set."""
    h = cfg["hsfl"]
    images = h["k_select"] * h["local_epochs"] * h["steps_per_epoch"] \
        * h["batch_size"]
    return rows * (images * train_flops_per_image(cfg)
                   + h["n_test"] * forward_flops_per_image(cfg))


def _bound(flops: float, nbytes: float, peaks: Dict) -> float:
    return max(flops / peaks["f32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def launch_work(cfg: Dict, rows: int) -> Dict[str, list]:
    """(FLOPs, bytes) of every launch of each fused-CNN kernel in one
    round of a group of ``rows`` rows."""
    h = cfg["hsfl"]
    convs, fcs = _shapes(cfg)
    users, b = rows * h["k_select"], h["batch_size"]
    steps = h["local_epochs"] * h["steps_per_epoch"]
    out = {k: [] for k in KERNELS}

    def conv(n, side, cin, cout, models, imgs, need_dx):
        x = models * imgs * side * side * cin
        y = models * imgs * (side // 2) ** 2 * cout
        w = models * _nparams(cfg, n)
        fl = 2.0 * models * imgs * side * side * 9 * cin * cout
        fwd = (fl, F32 * (x + w + y))
        bwd = (fl * (2 if need_dx else 1),
               F32 * (x + w + y + w + (x if need_dx else 0)))
        return fwd, bwd

    def fc(models, imgs):
        f_in, f_out = fcs[0][0], fcs[-1][1]
        w = models * sum(_nparams(cfg, n) for n in ("fc1", "fc2", "fc3"))
        fl = 2.0 * models * imgs * sum(i * o for i, o in fcs)
        x, y = models * imgs * f_in, models * imgs * f_out
        return (fl, F32 * (x + w + y)), (2 * fl, F32 * (x + w + y + w + x))

    for _ in range(steps):
        for i, (n, side, cin, cout) in enumerate(convs):
            fwd, bwd = conv(n, side, cin, cout, users, b, i > 0)
            out["conv_pool_fwd_k"].append(fwd)
            out["conv_pool_bwd_k"].append(bwd)
        fwd, bwd = fc(users, b)
        out["fc_chain_fwd_k"].append(fwd)
        out["fc_chain_bwd_k"].append(bwd)
    for n, side, cin, cout in convs:                  # the eval, K = rows
        out["conv_pool_fwd_k"].append(conv(n, side, cin, cout, rows,
                                           h["n_test"], False)[0])
    out["fc_chain_fwd_k"].append(fc(rows, h["n_test"])[0])
    return out


def group_round_bound_s(cfg: Dict, rows: int, peaks: Dict) -> Dict[str, float]:
    """Each kernel's summed bound seconds over one group round."""
    return {k: sum(_bound(f, nb, peaks) for f, nb in v)
            for k, v in launch_work(cfg, rows).items()}
