"""The mixture-of-experts dispatch and combine (``kernels/moe_dispatch``)
on the CPU, where the wrappers run the plain code of ``ref.py`` that
``models/moe.py`` also runs where autograd records and on DTensors.

- Slots and keep follow the rule, checked route by route: a route's place
  in its expert is the count of earlier routes to that expert, dropped
  past the capacity (random and skewed routes, the all-ties overflow of a
  zero router, k = 1, route counts that are no multiple of the kernels'
  chunk); the counts are the routes per expert, and the dropped routes
  they give are the routes not kept.
- The (E, C, d) buffer holds each kept route's token row in its slot and
  zeros elsewhere, and is the one ``moe._dispatch`` builds.
- The combine against ``moe._combine``: both multiply each kept row by its
  weight in the compute dtype and sum the products in f32, in another
  order (the twin a route at a time), then round once.  So they differ by
  the f32 sums' order, at most 2**-20 of the sum of the products'
  magnitudes at k <= 8, plus at bf16 one bf16 ulp of the output (2**-7 of
  its magnitude) where the two sums straddle a rounding boundary.
- ``moe.dispatch_kernel`` counts one a layer call on plain tensors, and
  none where autograd records (the plain path).
The CUDA kernels are held to the same plain code on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.moe_dispatch import kernel as mk
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.training.step import make_prefill_step
from repro_torch.utils import trace

torch.set_num_threads(1)

SUM_RTOL = 2 ** -20       # f32 sums of <= 8 products in another order
BF16_ULP = 2 ** -7        # one bf16 rounding step, relative


def _routes(T: int, k: int, E: int, seed: int, skew: float = 0.0):
    """(T·k,) experts, token-major, k distinct a token, drawn with weights
    exp(skew·e): a skew overloads the high experts past their capacity."""
    w = torch.exp(skew * torch.arange(E, dtype=torch.float64))
    e = torch.multinomial(w.expand(T, E), k, replacement=False,
                          generator=torch.Generator().manual_seed(seed))
    return e.reshape(T * k)


def _slots_by_rule(flat_e, E: int, C: int):
    """The slot rule route by route: (slot, keep) as Python lists."""
    seen, slot, keep = [0] * E, [], []
    for e in flat_e.tolist():
        keep.append(seen[e] < C)
        slot.append(e * C + seen[e] if seen[e] < C else E * C)
        seen[e] += 1
    return slot, keep


def _dropped(counts, C: int) -> int:
    return int(torch.clamp(counts - C, min=0).sum())


# (T, k, E, C, skew): T·k = 8000, 1554 and 300 are no multiple of
# mk.CHUNK (512); 16384 is
SLOT_CASES = [(1000, 8, 40, 250, 0.0), (1000, 8, 40, 200, 0.1),
              (777, 2, 4, 300, 0.5), (300, 1, 16, 10, 0.3),
              (2048, 8, 40, 512, 0.05), (5, 8, 40, 8, 0.0)]


@pytest.mark.parametrize("T,k,E,C,skew", SLOT_CASES)
def test_slots_twin_equals_dispatch_slots(T, k, E, C, skew):
    flat_e = _routes(T, k, E, seed=T + k, skew=skew)
    want_slot, want_keep = _slots_by_rule(flat_e, E, C)
    slot, keep, counts = mk.moe_slots(flat_e, E, C)
    assert slot.dtype == torch.int64 and keep.dtype == torch.bool
    assert slot.tolist() == want_slot and keep.tolist() == want_keep
    assert counts.dtype == torch.int32
    assert torch.equal(counts.long(), torch.bincount(flat_e, minlength=E))
    assert _dropped(counts, C) == want_keep.count(False)


@pytest.mark.parametrize("k", [1, 8])
def test_slots_twin_on_the_all_ties_overflow(k):
    """A zero router ties every expert: every token routes to experts
    0..k-1, and all but the first C of each are dropped."""
    T, E, C = 700, 40, 64
    flat_e = torch.arange(k).repeat(T)
    want_slot, want_keep = _slots_by_rule(flat_e, E, C)
    slot, keep, counts = mk.moe_slots(flat_e, E, C)
    assert slot.tolist() == want_slot and keep.tolist() == want_keep
    assert _dropped(counts, C) == k * (T - C)
    assert counts.tolist() == [T] * k + [0] * (E - k)


def _layer(name: str, dtype, router: str, T: int = 256):
    """A reduced config's moe params (a zero router ties every expert) and
    an input (2, T/2, d) in ``dtype``."""
    cfg = configs.get_config(name).reduced().replace(
        dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    if router == "zero":
        p = {**p, "router": torch.zeros_like(p["router"])}
    x = torch.randn(2, T // 2, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    return cfg, p, x


LAYER_CASES = [("granite-moe-3b-a800m", "init"),
               ("granite-moe-3b-a800m", "zero"),
               ("llama4-maverick-400b-a17b", "init"),
               ("llama4-maverick-400b-a17b", "zero")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,router", LAYER_CASES,
                         ids=[f"{n.split('-')[0]}-{r}"
                              for n, r in LAYER_CASES])
def test_scatter_twin_builds_the_plain_buffer(name, router, dtype):
    """Each kept route's token row in its slot, zeros in every other row
    of the buffer; the buffer ``moe._dispatch`` builds."""
    cfg, p, x = _layer(name, dtype, router)
    B, S, d = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.experts_per_token
    C = moe.capacity(T, cfg)
    want, want_slot, keep, _, _ = moe._dispatch(p, cfg, x)
    _, top_e, _ = moe._route(p, cfg, x.reshape(T, d))
    slot, _, counts = mk.moe_slots(top_e.reshape(T * k), E, C)
    buf = mk.moe_scatter(x.reshape(T, d), slot, counts, E, C, k)
    assert buf.dtype == dtype and tuple(buf.shape) == (E, C, d)
    assert torch.equal(buf, want) and torch.equal(slot, want_slot)
    rows = buf.reshape(E * C, d)
    kept = slot[keep]
    assert torch.equal(rows[kept], x.reshape(T, d)[keep.nonzero()[:, 0] // k])
    empty = torch.ones(E * C, dtype=torch.bool)
    empty[kept] = False
    assert bool((rows[empty] == 0).all())
    if router == "zero":
        assert not bool(keep.all())
    assert _dropped(counts, C) == int((~keep).sum())


def _within(got, want, products, dtype):
    """|got - want| within the f32 sums' reordering (SUM_RTOL of the
    products' magnitudes) and, at bf16, one rounding of the output."""
    room = SUM_RTOL * products
    if dtype == torch.bfloat16:
        room = room + BF16_ULP * want.float().abs()
    err = (got.float() - want.float()).abs()
    assert bool((err <= room).all()), float((err - room).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,router", LAYER_CASES,
                         ids=[f"{n.split('-')[0]}-{r}"
                              for n, r in LAYER_CASES])
def test_combine_twin_matches_the_plain_combine(name, router, dtype):
    """Random expert outputs (E, C, d) gathered back by the plain path's
    slots and weights; dropped routes add nothing."""
    cfg, p, x = _layer(name, dtype, router)
    B, S, d = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.experts_per_token
    C = moe.capacity(T, cfg)
    _, slot, keep, flat_w, _ = moe._dispatch(p, cfg, x)
    out = torch.randn(E, C, d, generator=torch.Generator().manual_seed(2)
                      ).to(dtype)
    want = moe._combine(out, slot, keep, flat_w, B, S, k).reshape(T, d)
    got = mk.moe_combine(out, slot, flat_w, k)
    assert got.dtype == dtype and tuple(got.shape) == (T, d)
    rows = torch.cat([out.reshape(E * C, d), torch.zeros(1, d, dtype=dtype)])
    prods = (rows[slot].float() * flat_w.float()[:, None]).abs()
    _within(got, want, prods.reshape(T, k, d).sum(1), dtype)
    dropped = ~keep.reshape(T, k).any(1)
    assert bool((got[dropped] == 0).all())
    if router == "zero":
        assert bool(dropped.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,router", LAYER_CASES,
                         ids=[f"{n.split('-')[0]}-{r}"
                              for n, r in LAYER_CASES])
def test_kernel_path_counts_once_and_matches_the_autograd_path(name, router,
                                                               dtype):
    """The layer on plain tensors (the kernels' path, counted once) against
    the same layer where autograd records (the plain path, not counted):
    the same aux, and outputs apart only by the combine's sum order."""
    cfg, p, x = _layer(name, dtype, router)
    with trace.record() as rec:
        y, aux = moe.moe_ffn(p, cfg, x)
    T, k = x.shape[0] * x.shape[1], cfg.experts_per_token
    assert rec.counters["moe.dispatch_kernel"] == 1
    assert rec.counters["moe.routes"] == T * k
    xg = x.clone().requires_grad_(True)
    with trace.record() as rec_g:
        yg, aux_g = moe.moe_ffn(p, cfg, xg)
    assert "moe.dispatch_kernel" not in rec_g.counters
    assert rec_g.counters["moe.routes"] == T * k
    assert rec_g.counters["moe.dropped_routes"] == \
        rec.counters["moe.dropped_routes"]
    assert torch.equal(aux, aux_g.detach())
    yg = yg.detach()
    room = SUM_RTOL * k * float(yg.float().abs().max())
    if dtype == torch.bfloat16:
        room += BF16_ULP * float(yg.float().abs().max())
    assert float((y.float() - yg.float()).abs().max()) <= room


def test_prefill_counts_the_kernel_path_once_a_layer():
    """A reduced Granite prefill (inference, plain tensors) and a decode
    step's T = B tokens take the kernels at every layer; on the CPU the
    wrappers run their twins and launch nothing."""
    cfg = configs.get_config("granite-moe-3b-a800m").reduced()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (3, 16),
                           generator=torch.Generator().manual_seed(4))
    mk.reset_launches()
    with trace.record() as rec:
        make_prefill_step(model)(params, {"tokens": tokens})
    assert rec.counters["moe.dispatch_kernel"] == cfg.num_layers
    x = torch.randn(4, 1, cfg.d_model)
    lp = {"router": params["layers"]["moe"]["router"][0],
          "experts": {n: w[0] for n, w in
                      params["layers"]["moe"]["experts"].items()}}
    with trace.record() as rec:
        moe.moe_ffn(lp, cfg, x)
    assert rec.counters["moe.dispatch_kernel"] == 1
    assert set(mk.LAUNCHES.values()) == {0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(8, 12)
    e = torch.zeros(16, dtype=torch.int64)
    slot, _, counts = mk.moe_slots(e, 4, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        mk.moe_scatter(x, slot, counts, 4, 8, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mk.moe_scatter(torch.randn(8, 16).half(), slot, counts, 4, 8, 2)
    with pytest.raises(ValueError, match="E <= 1024"):
        mk.moe_slots(e, 2048, 8)
    with pytest.raises(ValueError, match="int64"):
        mk.moe_slots(e.int(), 4, 8)
    out = torch.randn(4, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        mk.moe_combine(out, slot, torch.ones(16), 2)
    with pytest.raises(TypeError, match="weights"):
        mk.moe_combine(out.detach(), slot, torch.ones(16).bfloat16(), 2)
