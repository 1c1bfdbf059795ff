"""repro_torch.analysis.contracts against the reference's eval_shape
contracts (``repro.analysis.contracts``), at the same tiny sizes.

Layout and dtype mapping between the two packages' signatures:

- the device round: the reference ``vmap``s one (simulation, config) row
  and takes a key; the port folds the group's G = S·C rows onto a leading
  axis (the contract runs S = 1 simulation under C = 2 configs, G = 2).
  So every params, straggler-stack and straggler-mask leaf of the port's
  ``DeviceSimCarry`` is the reference's with a leading G, every fleet leaf
  the reference's with a leading S, and the reference's fleet ``key`` has
  no counterpart (the port's fleet draws from the simulation's stream).
  Each ``DeviceRoundMetrics`` field is the reference's () as (G,);
- the fused round, the twins and every dtype: the same shapes and dtype
  names (``float32``, ``int8``, ``int32``, ``bool``).  Labels go in as
  int64 in the port (int32 in the reference) and come out of no output.
"""
from pathlib import Path

import pytest

import jax

import repro.analysis.contracts as jc
import repro_torch.analysis.contracts as tc

REPO = Path(__file__).resolve().parents[1]
G, S = tc._S * tc._C, tc._S


def _jax_leaves(tree):
    return [(tuple(a.shape), str(jax.numpy.result_type(a)))
            for a in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [(tuple(s.shape), tc.dtype_name(s.dtype))
            for s in tc._leaves(tc.spec_tree(tree))]


def _jax_device_round(name, extra):
    """The reference's ``check_device_round`` evaluation of one variant:
    (carry in, carry out, metrics) avals."""
    from repro.core.channel_lib import ChannelParams, fleet_init
    from repro.core.fused_round import DeviceSimCarry, build_device_round

    sds = jc._sds
    params = jc._example_params()
    chan = ChannelParams()
    fleet = jax.eval_shape(lambda k: fleet_init(k, jc._N, chan),
                           jax.random.PRNGKey(0))
    stacked = jax.tree_util.tree_map(
        lambda a: sds((jc._K,) + tuple(a.shape), a.dtype), params)
    carry = DeviceSimCarry(params=params, fleet=fleet, delayed=stacked,
                           delayed_mask=sds((jc._K,), jax.numpy.bool_))
    xdim = (28, 28, 1)
    f32, i32 = jax.numpy.float32, jax.numpy.int32
    sim = {"client_x": sds((jc._N, 32) + xdim, f32),
           "client_y": sds((jc._N, 32), i32),
           "client_len": sds((jc._N,), i32), "flops": sds((jc._N,), f32),
           "samples": sds((jc._N,), f32),
           "test_x": sds((16,) + xdim, f32), "test_y": sds((16,), i32)}
    cfg = {k: sds((), f32) for k in ("b", "tau_max", "bandwidth_ratio")}
    fn = build_device_round(
        scheme=name, local_epochs=jc._E, steps_per_epoch=jc._STEPS,
        batch_size=jc._BS, lr=0.01, k_select=jc._K, channel=chan,
        model_bytes=1e6, ue_model_fraction=0.25, interpret=True, **extra)
    out, metrics = jax.eval_shape(fn, carry, jc._key_aval(), sim, cfg)
    return carry, out, metrics


def _mapped_carry(carry):
    """The reference's carry avals in the port's layout (see the module
    docstring)."""
    rows = lambda t: [((G,) + s, d) for s, d in _jax_leaves(t)]  # noqa
    fleet = [((S,) + s, d) for s, d in _jax_leaves(
        (carry.fleet.pos, carry.fleet.k_db, carry.fleet.bad))]
    return (rows(carry.params) + fleet + rows(carry.delayed)
            + rows(carry.delayed_mask))


_VARIANTS = tc.device_round_variants()


def test_variants_are_the_references():
    from repro.core.schemes import registered_schemes as jreg
    from repro_torch.core.schemes import registered_schemes as treg
    assert treg() == jreg()
    assert [v[0] for v in _VARIANTS][-2:] == [
        "opt+['compress_ratio', 'use_codec']", "opt+['forward']"]
    assert len(_VARIANTS) == len(jreg()) + 2


@pytest.mark.parametrize("label,name,extra", _VARIANTS,
                         ids=[v[0] for v in _VARIANTS])
def test_device_round_signature_matches_eval_shape(label, name, extra):
    jextra = dict(extra)
    if "forward" in jextra:
        from repro.kernels.fused_cnn.ops import ForwardPolicy
        jextra["forward"] = ForwardPolicy(kernel="pallas", interpret=True)
    jin, jout, jmet = _jax_device_round(name, jextra)
    tin, tout, tmet = tc.device_round_signature(name, extra, "cpu")
    assert _port_leaves(tin) == _mapped_carry(jin)
    assert _port_leaves(tout) == _mapped_carry(jout)
    assert list(tmet._fields) == list(jmet._fields)
    assert _port_leaves(tmet) == [((G,) + s, d)
                                  for s, d in _jax_leaves(jmet)]


def _jax_fused_round(name):
    from repro.core.fused_round import build_fused_round
    from repro.core.schemes import get_scheme
    sds, f32 = jc._sds, jax.numpy.float32
    params = jc._example_params()
    xs = sds((jc._E, jc._K, jc._STEPS, jc._BS, 28, 28, 1), f32)
    ys = sds((jc._E, jc._K, jc._STEPS, jc._BS), jax.numpy.int32)
    chan = {k: sds(s, d) for k, (s, d) in {
        "rates": ((jc._E, jc._K), f32),
        "outages": ((jc._E, jc._K), jax.numpy.bool_),
        "payload_bits": ((jc._K,), f32), "tau_extra0": ((jc._K,), f32),
        "final_rate": ((jc._K,), f32), "train_time": ((jc._K,), f32),
        "final_outage": ((jc._K,), jax.numpy.bool_),
        "valid": ((jc._K,), jax.numpy.bool_)}.items()}
    scheme = get_scheme(name)
    kw = dict(scheme=name, local_epochs=jc._E, steps_per_epoch=jc._STEPS,
              lr=0.01, tau_max=9.0,
              probe_epochs=scheme.static_schedule(jc._E, 2), interpret=True)
    if scheme.carries_delayed:
        fn = build_fused_round(k_carry=jc._K, async_weight=0.283, **kw)
        stack = jax.tree_util.tree_map(
            lambda a: sds((jc._K,) + tuple(a.shape), a.dtype), params)
        mask = sds((jc._K,), jax.numpy.bool_)
        return params, jax.eval_shape(fn, params, stack, mask, xs, ys, chan)
    return params, jax.eval_shape(build_fused_round(**kw), params, xs, ys,
                                  chan)


@pytest.mark.parametrize("name", [v[1] for v in _VARIANTS[:-2]])
def test_fused_round_signature_matches_eval_shape(name):
    jparams, jout = _jax_fused_round(name)
    sig = tc.fused_round_signature(name, "cpu")
    assert _port_leaves(sig["params"]) == _jax_leaves(jparams)
    if "delayed_stack" in sig:
        want = jout
        got = (sig["new_params"], sig["new_delayed_stack"],
               sig["new_delayed_mask"], sig["stats"])
    else:
        want, got = jout, (sig["new_params"], sig["stats"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _port_leaves(g) == _jax_leaves(w)
    assert list(sig["stats"]._fields) == list(want[-1]._fields)


def test_scheme_programs_match_lowered_program():
    from repro.core.schemes import get_scheme as jget
    from repro_torch.core.schemes import get_scheme as tget
    from repro_torch.core.schemes import registered_schemes
    for name in registered_schemes():
        for pins in ((1.0,), (2.0,), (1.0, 2.0, 4.0), (1.0, 1.0)):
            assert tget(name).lowered_program(pins) == \
                jget(name).lowered_program(pins)
    assert tc.check_scheme_programs() == jc.check_scheme_programs() == []


_JAX_TWINS = jc.twin_registry()
_PORT_TWINS = tc.twin_registry("cpu")


def test_twin_registry_names_are_the_references():
    """The reference's pairs, in its order and under its names, then the
    port's own: the moe dispatch kernels, which replace no TPU kernel."""
    n = len(_JAX_TWINS)
    assert [t[0] for t in _PORT_TWINS[:n]] == [t[0] for t in _JAX_TWINS]
    assert [t[1].replace("src/repro_torch/", "src/repro/")
            for t in _PORT_TWINS[:n]] == [t[1] for t in _JAX_TWINS]
    assert [t[0] for t in _PORT_TWINS[n:]] == [
        "moe_dispatch.slots", "moe_dispatch.scatter",
        "moe_dispatch.combine[float32]", "moe_dispatch.combine[bfloat16]"]


@pytest.mark.parametrize("i", range(len(_JAX_TWINS)),
                         ids=[t[0] for t in _JAX_TWINS])
def test_twin_signature_matches_eval_shape(i):
    name, _, jref, jker = _JAX_TWINS[i]
    tname, _, tref, tker = _PORT_TWINS[i]
    assert tname == name
    want = _jax_leaves(jref())
    assert _jax_leaves(jker()) == want
    assert _port_leaves(tref()) == want
    assert _port_leaves(tker()) == want


def test_compare_twin_catches_mismatch():
    import torch
    x = tc.Spec((4,), torch.int8)
    bad = tc.compare_twin(
        "demo", "src/repro_torch/kernels/demo",
        lambda: tc.abstract(lambda a: a.to(torch.float32), x),
        lambda: tc.concrete(lambda a: a.to(torch.bfloat16), x))
    assert len(bad) == 1 and bad[0].rule == "contract-kernel-twin"
    assert "float32" in bad[0].message and "bfloat16" in bad[0].message
    shape = tc.compare_twin(
        "demo", "p", lambda: tc.abstract(lambda a: a[:2], x),
        lambda: tc.concrete(lambda a: (a, a), x))
    assert any("arity" in f.message for f in shape)
    good = tc.compare_twin(
        "demo", "p",
        lambda: tc.abstract(lambda a: a + 1, tc.Spec((4,), torch.float32)),
        lambda: tc.concrete(lambda a: a * 2, tc.Spec((4,), torch.float32)))
    assert good == []


def test_compare_twin_catches_failed_build():
    def boom():
        raise RuntimeError("nvcc failed (1) for kernels/demo.cu")

    bad = tc.compare_twin("demo", "src/repro_torch/kernels/demo",
                          lambda: {"ok": 1}, boom)
    assert len(bad) == 1 and "nvcc failed" in bad[0].message
    assert "kernel side" in bad[0].message


def test_abstract_runs_on_fake_tensors():
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    seen = []

    def fn(a):
        seen.append(type(a))
        return a.sum(0)

    assert tc.abstract(fn, tc.Spec((3, 5), torch.float32)) == \
        tc.Spec((5,), torch.float32)
    assert seen == [FakeTensor]


def test_twin_coverage_matches_filesystem(tmp_path):
    on_disk = tc.kernel_twin_packages(REPO)
    assert on_disk == {"delta_codec", "flash_attention", "fused_cnn",
                       "moe_dispatch", "wkv6"}
    assert on_disk == tc.covered_twin_packages()
    # a new twin package without a registry entry is a finding
    kdir = tmp_path / "src" / "repro_torch" / "kernels"
    for pkg in sorted(on_disk) + ["newpkg"]:
        (kdir / pkg).mkdir(parents=True)
        (kdir / pkg / "ref.py").write_text("")
        (kdir / pkg / "kernel.py").write_text("")
    missing = [f for f in tc.check_kernel_twins(tmp_path, device="cpu")
               if "no entry" in f.message]
    assert [f.path for f in missing] == [
        "src/repro_torch/kernels/newpkg/kernel.py"]


def test_full_contract_sweep_clean_on_the_cpu():
    assert tc.run_contracts(repo_root=REPO, device="cpu") == []


def test_contract_sweep_wants_the_card_by_default(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_contracts(repo_root=REPO)
