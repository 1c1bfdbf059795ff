"""How far f32 training runs of one reduced zoo model fork, on the CPU.

Runs 1 sgd + 3 AdamW steps (clip 1.0, the settings of
``tests/test_torch_training.py``) of one reduced arch three ways from the
same JAX init and batch: the reference jitted, the reference eager, and
the port; prints each pair's largest relative loss difference and the
params' largest difference over the largest magnitude.  Then the port's
f32 grads at the init against a float64 run of the port, leaf by leaf
(the reference's own f32 grads beside them).  Needs JAX and torch::

    PYTHONPATH=src python scripts/train_fork.py --arch rwkv6-7b
"""
from __future__ import annotations

import argparse

import jax
import numpy as np
import torch

from repro import optim as j_optim
from repro.configs import base as j_configs
from repro.models import build_model as j_build_model
from repro.models import inputs as j_inputs
from repro.training import create_train_state as j_create_state
from repro.training import loss_fn as j_loss_fn
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs, optim
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, inputs
from repro_torch.training import create_train_state, make_train_step
from repro_torch.training.step import value_and_grad
from repro_torch.utils.tree import tree_leaves, tree_map


def runs(cfg, kind: str):
    """(losses, param leaves as numpy) after 1 sgd + 3 adamw steps."""
    jcfg = j_configs.ModelConfig(**vars(cfg))
    jm, tm = j_build_model(jcfg), build_model(cfg, "cpu")
    jb = j_inputs.materialize(j_inputs.train_specs(jcfg, 2, 16), jcfg,
                              seed=1)
    tb = inputs.materialize(inputs.train_specs(cfg, 2, 16), cfg, seed=1,
                            device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    losses = []
    for opt_of, steps in ((lambda m: m.sgd(5e-2), 1),
                          (lambda m: m.adamw(m.cosine(3e-4, 1, 3),
                                             weight_decay=0.1), 3)):
        if kind == "port":
            o = opt_of(optim)
            st, step = create_train_state(tp, o), make_train_step(
                tm, o, grad_clip=1.0)
        else:
            o = opt_of(j_optim)
            st, step = j_create_state(jp, o), j_make_train_step(
                jm, o, grad_clip=1.0)
            if kind == "jit":
                step = jax.jit(step)
        for _ in range(steps):
            st, met = step(st, tb if kind == "port" else jb)
            losses.append(float(met["loss"]))
        if kind == "port":
            tp = st.params
        else:
            jp = st.params
    leaves = ([t.numpy() for t in tree_leaves(tp)] if kind == "port"
              else [np.asarray(a) for a in jax.tree_util.tree_leaves(jp)])
    return np.array(losses), leaves


def grad_noise(cfg):
    """Largest |f32 grad - f64 grad| / max |f64 grad| per leaf, for the
    port and for the reference, at the JAX init."""
    jcfg = j_configs.ModelConfig(**vars(cfg))
    jm, tm = j_build_model(jcfg), build_model(cfg, "cpu")
    jb = j_inputs.materialize(j_inputs.train_specs(jcfg, 2, 16), jcfg,
                              seed=1)
    tb = inputs.materialize(inputs.train_specs(cfg, 2, 16), cfg, seed=1,
                            device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jg = jax.jit(jax.grad(lambda p: j_loss_fn(jm, p, jb)[0]))(jp)
    _, tg = value_and_grad(tm, tp, tb)
    # the port in float64: every f32 in its code becomes f64
    f32 = torch.float32
    torch.float32 = torch.float64
    try:
        from repro_torch.models import module
        dtype_of = module.dtype_of
        module.dtype_of = lambda n: torch.float64 if n == "float32" \
            else dtype_of(n)
        tb64 = {k: v.double() if v.is_floating_point() else v
                for k, v in tb.items()}
        _, dg = value_and_grad(tm, tree_map(lambda t: t.double(), tp), tb64)
    finally:
        torch.float32 = f32
        module.dtype_of = dtype_of
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    for path, a, b, c in zip(paths, jax.tree_util.tree_leaves(jg),
                             tree_leaves(tg), tree_leaves(dg)):
        c = c.numpy()
        scale = np.abs(c).max()
        print(f"  {path:36s} port {np.abs(b.numpy() - c).max() / scale:.2e}"
              f"  reference {np.abs(np.asarray(a) - c).max() / scale:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-7b", choices=configs.ARCH_IDS)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cfg = configs.get_config(args.arch).reduced()
    res = {k: runs(cfg, k) for k in ("jit", "eager", "port")}
    print(f"{cfg.name} reduced, 1 sgd + 3 adamw steps (clip 1.0), the loss "
          f"read before each step:")
    for a, b in (("jit", "eager"), ("jit", "port"), ("eager", "port")):
        (la, pa), (lb, pb) = res[a], res[b]
        rel = np.abs(la - lb) / np.abs(la)
        perr = max(np.abs(x - y).max() for x, y in zip(pa, pb)) / max(
            np.abs(x).max() for x in pa)
        print(f"  {a} vs {b}: loss relative per step "
              + " ".join(f"{x:.1e}" for x in rel)
              + f"; params {perr:.2e} of the largest")
    print("f32 grads at the init against the port in float64 (largest error "
          "over the leaf's largest magnitude):")
    grad_noise(cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
