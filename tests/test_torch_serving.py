"""The port's serving path on the CPU: its msgpack codec, checkpoints, the
fault-tolerant ``FLServer`` and the ``serve_fl`` launcher, against the JAX
package.

- ``packb``/``unpackb`` against ``msgpack`` (the oracle only; the port does
  not import it): equal bytes for every encoding boundary, for param trees
  and for the server's checkpoint tree.
- checkpoints restore across the packages in both directions: the tree
  (bitwise), and a server that resumes the other package's run (counts
  equal, params within 1e-4).
- ``FLServer`` without faults equals the port's host engine bitwise; under
  recoverable faults and under the lossy-wire transport it matches the JAX
  server: every ``RoundLog`` field equal except test loss (within 1e-4)
  and accuracy (within one test image), params within 1e-4.
- a crash at each phase, resumed, equals the uninterrupted run bitwise.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")

from repro.checkpoint import msgpack_ckpt as jckpt  # noqa: E402
from repro.core.hsfl import HSFLConfig as JConfig  # noqa: E402
from repro.core.transport import TransportConfig as JTransport  # noqa: E402
from repro.serving import fl_server as jserve  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as ckpt  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import faults, transport  # noqa: E402
from repro_torch.core.hsfl import HSFLConfig, HSFLSimulation  # noqa: E402
from repro_torch.launch import serve_fl  # noqa: E402
from repro_torch.serving.fl_server import (FLServer, decode_tree,  # noqa: E402
                                           encode_tree, run_with_restarts)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------

VALUES = {
    "nil-bool": [None, True, False],
    "fixint": [0, 1, 127, -1, -32],
    "uint": [128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1],
    "int": [-33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
            -2 ** 63],
    "float": [0.0, -1.5, 1e300, float("inf"), 3.0e-12],
    "str": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "b" * 65535,
            "b" * 65536, "ünïcödé"],
    "bin": [b"", b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536],
    "array": [[], [1] * 15, [1] * 16, [0] * 65535, [0] * 65536, (1, "a")],
    "map": [{}, {str(i): i for i in range(15)},
            {str(i): [i] for i in range(16)}],
}


@pytest.mark.parametrize("kind", list(VALUES))
def test_packb_equals_msgpack(kind):
    for v in VALUES[kind]:
        want = msgpack.packb(v, use_bin_type=True)
        assert ckpt.packb(v) == want, repr(v)[:40]
        assert ckpt.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_unpackb_refuses_bad_data():
    good = msgpack.packb([1, b"abc"], use_bin_type=True)
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpackb(good[:-1])
    with pytest.raises(ValueError, match="extra"):
        ckpt.unpackb(good + b"\x00")
    with pytest.raises(TypeError):
        ckpt.packb(np.float32(1.0))


def _tree(seed: int):
    from repro.models import cnn as jcnn
    return jax.tree_util.tree_map(np.asarray,
                                  jcnn.init_cnn(jax.random.PRNGKey(seed)))


def _ckpt_tree(seed: int):
    """The server's checkpoint tree: params, two stragglers, fleet arrays."""
    rng = np.random.default_rng(seed)
    return {"params": _tree(seed), "delayed": [_tree(seed + 1),
                                               _tree(seed + 2)],
            "fleet_pos": rng.standard_normal((30, 3)),
            "fleet_kdb": rng.uniform(1.8, 5.0, 30),
            "fleet_bad": rng.random(30) < 0.3}


def _to_torch(tree):
    """Param leaves as tensors, fleet arrays as numpy (the server's mix)."""
    out = dict(tree)
    out["params"] = params_from_numpy(tree["params"], "cpu")
    out["delayed"] = [params_from_numpy(t, "cpu") for t in tree["delayed"]]
    return out


def test_wire_bytes_equal_jax():
    tree = _tree(0)
    assert encode_tree(params_from_numpy(tree, "cpu")) == \
        jserve.encode_tree(tree)
    back = decode_tree(jserve.encode_tree(tree), params_from_numpy(
        _tree(1), "cpu"))
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_checkpoint_files_equal_jax(tmp_path):
    tree = _ckpt_tree(3)
    aux = {"round": 3, "rng": np.random.default_rng(0).bit_generator.state}
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, tree, aux=aux)
    ckpt.save_checkpoint(str(tmp_path / "t"), 3, _to_torch(tree), aux=aux)
    for name in ("checkpoint.msgpack", "aux.json", "COMMIT"):
        assert (tmp_path / "t" / "3" / name).read_bytes() == \
            (tmp_path / "j" / "3" / name).read_bytes(), name
    jm = json.loads((tmp_path / "j" / "3" / "MANIFEST.json").read_text())
    tm = json.loads((tmp_path / "t" / "3" / "MANIFEST.json").read_text())
    assert {k: v for k, v in tm.items() if k != "treedef"} == \
        {k: v for k, v in jm.items() if k != "treedef"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    tree = _ckpt_tree(5)
    like = _ckpt_tree(9)
    if writer == "jax":
        jckpt.save_checkpoint(str(tmp_path), 1, tree)
        got = ckpt.restore_checkpoint(str(tmp_path), 1, _to_torch(like))
        assert isinstance(got["params"]["fc1"]["w"], torch.Tensor)
        assert isinstance(got["fleet_pos"], np.ndarray)
        got = dict(got, params=params_to_numpy(got["params"]),
                   delayed=[params_to_numpy(t) for t in got["delayed"]])
    else:
        # JAX restores the port's save exactly as it restores its own (which
        # casts the f64 fleet arrays to f32: jax_enable_x64 is off)
        ckpt.save_checkpoint(str(tmp_path), 1, _to_torch(tree))
        got = jckpt.restore_checkpoint(str(tmp_path), 1, like)
        jckpt.save_checkpoint(str(tmp_path / "j"), 1, tree)
        tree = jckpt.restore_checkpoint(str(tmp_path / "j"), 1, like)
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(
        str(tmp_path)) == 1
    want, have = jax.tree_util.tree_leaves(tree), \
        jax.tree_util.tree_leaves(got)
    assert len(want) == len(have) == 33
    for a, b in zip(want, have):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert np.asarray(b).dtype == np.asarray(a).dtype


def test_restore_names_a_corrupt_leaf(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 2, _to_torch(_ckpt_tree(1)))
    mpath = tmp_path / "2" / "MANIFEST.json"
    man = json.loads(mpath.read_text())
    man["leaves"][0]["shape"] = [999]
    mpath.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="leaf 0"):
        ckpt.restore_checkpoint(str(tmp_path), 2, _to_torch(_ckpt_tree(1)))
    os.remove(tmp_path / "2" / "COMMIT")
    assert ckpt.latest_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    # the reference's serving config (tests/test_fl_server.py) with the
    # int8 codec on
    base = dict(scheme="opt", b=2, rounds=3, n_uavs=8, k_select=4,
                n_train=400, n_test=100, steps_per_epoch=2, local_epochs=4,
                use_fused_round=False, seed=0, use_delta_codec=True)
    base.update(kw)
    return cls(**base)


def _equal_params(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.fixture(scope="module")
def clean():
    server = FLServer(_cfg(HSFLConfig), device="cpu")
    server.serve()
    return server


def test_fault_free_server_equals_host_engine(clean):
    host = HSFLSimulation(_cfg(HSFLConfig), device="cpu")
    log = host.run()
    assert _equal_params(host.params, clean.params)
    for a, b in zip(log.rounds, clean.log.rounds):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _assert_logs_match(got, want, n_test: int):
    for g, w in zip(got.rounds, want.rounds):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert abs(g.pop("test_loss") - w.pop("test_loss")) <= 1e-4
        assert abs(g.pop("test_acc") - w.pop("test_acc")) <= 1 / n_test + 1e-9
        assert g == w


def _assert_params_close(tparams, jparams, tol=1e-4):
    jp = jax.tree_util.tree_map(np.asarray, jparams)
    tp = params_to_numpy(tparams)
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_allclose(tp[layer][leaf], jp[layer][leaf],
                                       rtol=0, atol=tol)


SERVER_CASES = {
    "dup-corrupt": dict(fault_plan="dup@r1:c*; corrupt@r2:c*"),
    "lossy-wire": dict(transport=(0.0, 2e-5)),
    "int4-flip-trimmed": dict(fault_plan="flip@r2:c1", scheme="opt_trimmed",
                              codec_bits=4),
}


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_server_matches_jax_server(case):
    kw = dict(SERVER_CASES[case])
    plan = kw.pop("fault_plan", None)
    ber = kw.pop("transport", None)
    jt = JTransport(ber_good=ber[0], ber_bad=ber[1]) if ber else None
    tt = transport.TransportConfig(ber_good=ber[0], ber_bad=ber[1]) \
        if ber else None
    js = jserve.FLServer(_cfg(JConfig, **kw), fault_plan=plan, transport=jt)
    ts = FLServer(_cfg(HSFLConfig, **kw), device="cpu", fault_plan=plan,
                  transport=tt)
    ts.sim.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, js.params), "cpu")
    jlog, tlog = js.serve(), ts.serve()
    _assert_logs_match(tlog, jlog, 100)
    _assert_params_close(ts.params, js.params)
    if plan and "dup" in plan:
        assert sum(r.duplicates_rejected for r in tlog.rounds) > 0
        assert sum(r.corrupt_rejected for r in tlog.rounds) > 0
    if ber:
        assert sum(r.chunks_corrupt for r in tlog.rounds) > 0
        assert sum(r.chunks_recovered for r in tlog.rounds) > 0


@pytest.mark.parametrize("phase", ["train", "close", "checkpoint"])
def test_crash_and_resume_equals_uninterrupted(tmp_path, clean, phase):
    server, restarts = run_with_restarts(
        _cfg(HSFLConfig), ckpt_dir=str(tmp_path), device="cpu",
        fault_plan=f"crash@r2:{phase}; dup@r1:c*; corrupt@r3:c*")
    assert restarts == 1 and len(server.log.rounds) == 3
    assert _equal_params(server.params, clean.params)
    for a, b in zip(server.log.rounds, clean.log.rounds):
        assert (a.test_acc, a.test_loss, a.arrived_final, a.used_snapshot) \
            == (b.test_acc, b.test_loss, b.arrived_final, b.used_snapshot)
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["round"] for r in rows][-1] == 3 and rows[0]["schema"] == 2


@pytest.mark.parametrize("first", ["jax", "port"])
def test_server_resumes_the_other_packages_checkpoint(tmp_path, first):
    """Round 1 by one package, rounds 2-3 by the other from its checkpoint
    (params, fleet, RNG states, registry, round log), against the JAX
    server run start to end."""
    ref = jserve.FLServer(_cfg(JConfig))
    init = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params), "cpu")
    ref_log = ref.serve()
    d = str(tmp_path)
    if first == "jax":
        jserve.FLServer(_cfg(JConfig), ckpt_dir=d).serve(rounds=1)
        server = FLServer(_cfg(HSFLConfig), device="cpu", ckpt_dir=d)
        assert server.round == 1
        log = server.serve()
        params = server.params
    else:
        server = FLServer(_cfg(HSFLConfig), device="cpu", ckpt_dir=d)
        server.sim.params = init
        server.serve(rounds=1)
        js = jserve.FLServer(_cfg(JConfig), ckpt_dir=d)
        assert js.round == 1
        log = js.serve()
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, js.params), "cpu")
    _assert_logs_match(log, ref_log, 100)
    _assert_params_close(params, ref.params)


def test_serve_fl_cli_runs_on_the_cpu(tmp_path, capsys):
    rc = serve_fl.main([
        "--device", "cpu", "--codec", "--rounds", "2", "--n-uavs", "8",
        "--k-select", "4", "--n-train", "400", "--n-test", "100",
        "--steps-per-epoch", "2", "--local-epochs", "4", "--quiet",
        "--ckpt-dir", str(tmp_path), "--faults", "crash@r2:close",
        "--no-tuned-env"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve_fl] scheme=opt rounds=2" in out and "restarts=1" in out
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_fault_and_transport_copies_agree_with_jax():
    from repro.core import faults as jfaults
    from repro.core import transport as jtransport
    text = "dup@r2:c1; corrupt@r1:c*x2; crash@r3:checkpoint; flip@r4:c0"
    assert str(faults.FaultPlan.parse(text)) == \
        str(jfaults.FaultPlan.parse(text))
    a = faults.FaultPlan.random(3, 5, range(8), p_dup=0.2, p_flip=0.1)
    b = jfaults.FaultPlan.random(3, 5, range(8), p_dup=0.2, p_flip=0.1)
    assert str(a) == str(b)
    payload = bytes(np.random.default_rng(0).integers(0, 256, 10000,
                                                      np.uint8))
    cfg = transport.TransportConfig(chunk_bytes=1000, parity_k=3)
    jcfg = jtransport.TransportConfig(chunk_bytes=1000, parity_k=3)
    assert transport.make_chunks(payload, cfg) == [
        transport.Chunk(**dataclasses.asdict(c))
        for c in jtransport.make_chunks(payload, jcfg)]
