"""Checkpoints with exact resume, and the codec's stochastic rounding, in
the port, held against the JAX package on the CPU.

* ``repro_torch.checkpoint``: a stacked ``NodeState`` (a ``Plane``
  student with its error-feedback ``CodecState``, an ``adapter_state``
  with grams, a ``proto_acc``; a per-leaf student) and a bf16 tree
  round-trip bit for bit, onto the tree's device and dtype, parameters
  as autograd leaves; a run resumed from a checkpoint (``start_round``)
  ends bit-identical to the uninterrupted run, as
  ``tests/test_wire_state.py``'s resume checks; keys follow ``repro``'s
  ``_path_str`` (equal to its keys on a parameter tree); a key mismatch
  raises ``ValueError`` naming the keys.
* ``repro_torch.prng``: ``random_bits`` and ``uniform`` bit-equal to
  ``jax.random.bits`` / ``jax.random.uniform(key, shape, float32)``.
* Stochastic rounding (``floor(x/Δ + U[0,1))``): the codes, scales and
  residuals of ``quantize_array``, ``quantize_packed_buffer`` (one width
  and mixed, with and without the ``+ef`` residual), the plane payload,
  the packed tree and ``quantize_dequantize_per_node`` bit-equal to
  ``repro``'s for the same key (its plain path: ``use_kernels=False``);
  unbiasedness as ``tests/test_wirespec.py`` states it; the refusals
  (``ValueError`` without a key or with ``packed=False``, ``TypeError``
  for a ``torch.Generator``); and the routing: Δ from the row-absmax
  kernel, the codes never through ``quantize_rows``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.config import base as jbase
from repro.core import quantization as JQ
from repro.core import round_ops as JR
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch import prng
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.tree import keyed_leaves
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import quantization as TQ
from repro_torch.core import round_ops as TR
from repro_torch.core.wire_state import CodecState
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.models import init_params
from repro_torch.optim.plane import Plane, plane_from_tree
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

N_NODES = 3


# -- checkpoints ---------------------------------------------------------------

def _setup(rounds=2, per_node=56, channels=(4, 8), **fed_kw):
    cfg = tbase.get_config("mnist-cnn").replace(
        cnn_channels=channels, proto_dim=16, dtype="float32")
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed = tbase.FederationConfig(num_nodes=N_NODES, rounds=rounds,
                                 topology="full", **fed_kw)
    return cfg, fed, tbase.TrainConfig(batch_size=16, remat=False), \
        node_data, test_d


# the states a run carries: name -> (FederationConfig fields, model
# channels); each after one round of its run
STATES = {
    "plane+ef": (dict(quantize_bits=4, proto_quantize_bits=16,
                      error_feedback=True), (4, 8)),
    "adapters+grams": (dict(quantize_bits=4, adapter_rank=8,
                            adapter_grams=True), (24, 32)),
    "proto_ema+fused": (dict(proto_ema=0.5, proto_pass="fused"), (4, 8)),
    "per-leaf": (dict(param_plane="off"), (4, 8)),
    "fedproto": (dict(algorithm="fedproto", proto_ema=0.5), (4, 8)),
}


def _after_one_round(name):
    fed_kw, channels = STATES[name]
    cfg, fed, train, node_data, test_d = _setup(rounds=3, channels=channels,
                                                **fed_kw)
    one = TF.run_federation(cfg, dataclasses.replace(fed, rounds=1), train,
                            node_data, test_d, device="cpu")
    return one.state, (cfg, fed, train, node_data, test_d)


def _assert_bit_equal(a, b):
    ia, ib = keyed_leaves(a), keyed_leaves(b)
    assert [k for k, _ in ia] == [k for k, _ in ib]
    for (key, x), (_, y) in zip(ia, ib):
        assert type(x) is type(y), key
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.device == y.device, key
            assert x.requires_grad == y.requires_grad, key
            assert torch.equal(x.detach(), y.detach()), key
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), key


@pytest.mark.parametrize("name", list(STATES))
def test_checkpoint_round_trips_a_stacked_state(name, tmp_path):
    """A stacked state after one round comes back bit for bit: every
    leaf's dtype, shape, device and autograd flag, a Plane with its
    recipe, the ``CodecState`` (residual and ``seq``), the adapter
    reference and grams, the EMA carry; the sidecar holds the
    metadata."""
    state, _ = _after_one_round(name)
    fed_kw = STATES[name][0]
    assert (state.wire_state is not None) == bool(
        fed_kw.get("error_feedback"))
    assert (state.adapter_state is not None) == bool(
        fed_kw.get("adapter_rank"))
    assert (state.proto_acc is not None) == bool(fed_kw.get("proto_ema"))
    if state.proto_acc is not None:
        assert float(state.proto_acc[1].sum()) > 0
    path = str(tmp_path / "state")
    save_checkpoint(path, state, metadata={"round": 1, "name": name})
    assert os.path.exists(path + ".npz")
    with open(path + ".meta.json") as f:
        side = json.load(f)
    assert side["metadata"] == {"round": 1, "name": name}
    assert side["keys"] == [k for k, _ in keyed_leaves(state)]
    back = load_checkpoint(path, state)
    _assert_bit_equal(back, state)
    if isinstance(state.student, Plane):
        assert back.student.meta == state.student.meta
        assert back.student.buf.is_leaf and back.student.buf.requires_grad
    keys = [k for k, _ in keyed_leaves(state)]
    assert all(k.startswith(".") for k in keys)
    if state.wire_state is not None:
        assert ".wire_state/.residual/student/buf" in keys
        assert ".wire_state/.seq" in keys
    if state.proto_acc is not None:
        assert {".proto_acc/#0", ".proto_acc/#1"} <= set(keys)


def test_checkpoint_bf16_and_mixed_tree_round_trip(tmp_path):
    """bf16 is stored as fp32 (exact) and cast back; ints, bools, nested
    lists and tuples and numpy leaves keep their kinds; ``None`` holds
    nothing."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
            "b": [torch.randn(3, generator=g),
                  (torch.arange(4, dtype=torch.int32),
                   torch.tensor([True, False]))],
            "np": np.arange(6, dtype=np.int16).reshape(2, 3),
            "none": None}
    path = str(tmp_path / "mixed.npz")
    save_checkpoint(path, tree)
    with np.load(path) as npz:
        assert npz["w"].dtype == np.float32
        assert sorted(npz.files) == ["b/#0", "b/#1/#0", "b/#1/#1", "np", "w"]
    like = {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
            "b": [torch.zeros(3), (torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.bool))],
            "np": np.zeros((2, 3), np.int16), "none": None}
    back = load_checkpoint(path, like)
    assert back["none"] is None and isinstance(back["b"][1], tuple)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             tree["w"])
    assert torch.equal(back["b"][0], tree["b"][0])
    assert torch.equal(back["b"][1][0], tree["b"][1][0])
    assert torch.equal(back["b"][1][1], tree["b"][1][1])
    assert back["np"].dtype == np.int16
    assert np.array_equal(back["np"], tree["np"])


@pytest.mark.parametrize("name", ["plane+ef", "adapters+grams",
                                  "proto_ema+fused"])
def test_resumed_run_equals_the_uninterrupted_run(name, tmp_path):
    """Round 1 of a 3-round run, saved, loaded and resumed
    (``run_federation(start_round=1)``), ends bit-identical to the run
    that never stopped: the whole stacked state (residuals and ``seq``,
    adapter references and grams, the EMA carry) and rounds 2-3's F1 and
    accuracy."""
    state, (cfg, fed, train, node_data, test_d) = _after_one_round(name)
    full = TF.run_federation(cfg, fed, train, node_data, test_d,
                             device="cpu")
    path = str(tmp_path / "round1")
    save_checkpoint(path, state, metadata={"round": 1})
    resumed = TF.run_federation(cfg, fed, train, node_data, test_d,
                                initial_states=load_checkpoint(path, state),
                                start_round=1, device="cpu")
    _assert_bit_equal(resumed.state, full.state)
    assert resumed.f1_per_round == full.f1_per_round[1:]
    assert resumed.acc_per_round == full.acc_per_round[1:]
    if full.state.wire_state is not None:
        assert full.state.wire_state.seq.tolist() == [3] * N_NODES


def test_resume_refuses_what_it_cannot_resume():
    """``start_round`` outside the run, and the stale-by-one pipeline
    (its pending payload is in no state), raise ``ValueError``; so does
    a stacked state for another node count."""
    state, (cfg, fed, train, node_data, test_d) = _after_one_round(
        "plane+ef")
    for kw in (dict(start_round=3), dict(start_round=-1),
               dict(start_round=1, overlap="rounds")):
        with pytest.raises(ValueError):
            TF.run_federation(cfg, fed, train, node_data, test_d,
                              initial_states=state, device="cpu", **kw)
    with pytest.raises(ValueError, match="initial states for"):
        TF.run_federation(cfg, dataclasses.replace(fed, num_nodes=2),
                          train, node_data[:2], test_d,
                          initial_states=state, device="cpu")


def test_checkpoint_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"a": torch.ones(3), "c": torch.ones(1)})
    with pytest.raises(ValueError, match=r"missing=\['b'\] extra=\['a'\]"):
        load_checkpoint(path, {"b": torch.ones(3), "c": torch.ones(1)})


@pytest.mark.parametrize("model", ["mnist-cnn", "cifar10-resnet18"])
def test_checkpoint_keys_are_the_jax_packages(model, tmp_path):
    """On a parameter tree the port writes ``repro``'s keys, so the JAX
    package's checkpoint of the same parameters loads into the port's
    tree (and back) bit for bit."""
    jparams = jmodel.init_params(jbase.get_config(model),
                                 jax.random.PRNGKey(0))
    tparams = init_params(tbase.get_config(model),
                          torch.Generator().manual_seed(0))
    assert sorted(jckpt._flatten(jparams)) == \
        sorted(k for k, _ in keyed_leaves(tparams))
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jparams)
    back = load_checkpoint(path, tparams)
    for (key, t), j in zip(keyed_leaves(back), jax.tree_util.tree_leaves(
            jparams)):
        assert np.asarray(j).tobytes() == t.detach().numpy().tobytes(), key
    save_checkpoint(str(tmp_path / "torch"), back)
    again = jckpt.load_checkpoint(str(tmp_path / "torch"), jparams)
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(jparams)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# -- the threefry PRNG ---------------------------------------------------------

KEYS = [0, 1, 7, 123456, 2 ** 31 + 5]
SHAPES = [(1,), (5,), (3, 4, 5), (2, 416, 512), (0, 3)]


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_matches_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    got = prng.uniform(np.asarray(key), shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if got.size:
        assert got.min() >= 0 and got.max() < 1


@pytest.mark.parametrize("seed", KEYS)
def test_random_bits_match_jax(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.bits(key, (7, 9), jnp.uint32))
    got = prng.random_bits(tuple(int(k) for k in np.asarray(key)), (7, 9))
    assert got.tobytes() == want.tobytes()


def test_keys_are_two_uint32_words():
    k = np.asarray(jax.random.PRNGKey(9))
    assert prng.as_key(k) == prng.as_key(torch.as_tensor(k.astype(
        np.int64))) == prng.as_key((0, 9)) == (0, 9)
    for bad in (torch.Generator(), np.zeros(3, np.uint32),
                np.zeros(2, np.float32), (0, -1), (0, 2 ** 32)):
        with pytest.raises(TypeError):
            prng.as_key(bad)


# -- stochastic rounding -------------------------------------------------------

def _key(seed=11):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 5])
def test_quantize_array_stochastic_matches_jax(bits, seed):
    x = np.random.default_rng(seed).standard_normal((33, 17)).astype(
        np.float32)
    jc, jd = JQ.quantize_array(jnp.asarray(x), bits, rng=_key(seed))
    tc, td = TQ.quantize_array(torch.from_numpy(x), bits,
                               rng=np.asarray(_key(seed)))
    assert tc.dtype == {4: torch.int8, 8: torch.int8,
                        16: torch.int16}[bits]
    assert np.asarray(jc).tobytes() == tc.numpy().tobytes()
    assert np.asarray(jd).tobytes() == td.numpy().tobytes()
    nearest, _ = TQ.quantize_array(torch.from_numpy(x), bits)
    assert not torch.equal(nearest, tc)
    # a non-float tensor passes through, key or not
    idx = torch.arange(4)
    assert TQ.quantize_array(idx, bits, rng=(0, 1))[0] is idx


def _buffer(seed=0, n=3, rows=16):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((n, rows, 512)).astype(np.float32)
    buf[:, -3:, 300:] = 0.0                        # padding lanes
    res = (rng.standard_normal((n, rows, 512)) * 0.01).astype(np.float32)
    ids = np.repeat(np.arange(4), rows // 4).astype(np.int32)
    return buf, res, ids


@pytest.mark.parametrize("seg_bits", [None, (16, 4, 4, 8)],
                         ids=["uniform", "mixed"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "ef"])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_quantize_packed_buffer_stochastic_matches_jax(seg_bits, residual,
                                                       decay):
    """Codes, scales (and with a residual the new residual) bit-equal to
    ``repro``'s plain path for the same key; the noise covers the whole
    buffer, padding lanes included."""
    buf, res, ids = _buffer()
    sb = None if seg_bits is None else np.asarray(seg_bits, np.int32)
    jout = jqops.quantize_packed_buffer(
        jnp.asarray(buf), ids, 4, 16, seg_bits=sb, use_kernels=False,
        rng=_key(), residual=jnp.asarray(res) if residual else None,
        ef_decay=decay)
    tout = tqops.quantize_packed_buffer(
        torch.from_numpy(buf), ids, 4, 16, seg_bits=sb,
        rng=np.asarray(_key()),
        residual=torch.from_numpy(res) if residual else None,
        ef_decay=decay)
    assert len(jout) == len(tout) == (3 if residual else 2)
    for j, t in zip(jout, tout):
        j = np.asarray(j)
        assert j.dtype == t.numpy().dtype and j.shape == tuple(t.shape)
        assert j.tobytes() == t.numpy().tobytes()


def _plane_payload(seed=0):
    cfg = jbase.get_config("mnist-cnn").replace(cnn_channels=(4, 8),
                                                proto_dim=16)
    scfg = jmodel.derive_student(cfg)
    planes = [jplane.plane_from_tree(jmodel.init_params(
        scfg, jax.random.PRNGKey(seed + i))) for i in range(N_NODES)]
    buf = np.stack([np.asarray(p.buf) for p in planes])
    protos = np.random.default_rng(seed).standard_normal(
        (N_NODES, 10, 16)).astype(np.float32)
    tmeta = plane_from_tree(init_params(tbase.ModelConfig(
        **dataclasses.asdict(scfg)), torch.Generator().manual_seed(0))).meta
    return (protos, buf, planes[0].meta, tmeta)


SR_SPECS = {"16": dict(student_bits=16), "4/16": dict(student_bits=4,
                                                      proto_bits=16),
            "4/16+ef": dict(student_bits=4, proto_bits=16,
                            error_feedback=True, ef_decay=0.9)}


@pytest.mark.parametrize("wire", list(SR_SPECS))
def test_plane_payload_stochastic_matches_jax(wire):
    """``quantize_dequantize_plane_payload`` and
    ``quantize_dequantize_per_node`` with a stochastic spec and a key:
    the receiver view (and with ``+ef`` the new residual and ``seq``)
    bit-equal to ``repro``'s."""
    protos, buf, jmeta, tmeta = _plane_payload()
    kw = SR_SPECS[wire]
    jspec = JWireSpec(stochastic_rounding=True, **kw)
    tspec = WireSpec(stochastic_rounding=True, **kw)
    rng = np.random.default_rng(1)
    rp = (rng.standard_normal(protos.shape) * 1e-3).astype(np.float32)
    rs = (rng.standard_normal(buf.shape) * 1e-3).astype(np.float32)
    jpay = {"protos": jnp.asarray(protos),
            "student": jplane.Plane(jnp.asarray(buf), (), jmeta)}
    tpay = {"protos": torch.from_numpy(protos.copy()),
            "student": Plane(torch.from_numpy(buf.copy()), tmeta)}
    ef = tspec.error_feedback
    jres = {"protos": jnp.asarray(rp),
            "student": jplane.Plane(jnp.asarray(rs), (), jmeta)}
    tres = {"protos": torch.from_numpy(rp.copy()),
            "student": Plane(torch.from_numpy(rs.copy()), tmeta)}
    j = jqops.quantize_dequantize_plane_payload(
        jpay, spec=jspec, use_kernels=False, rng=_key(),
        residual=jres if ef else None)
    t = tqops.quantize_dequantize_plane_payload(
        tpay, spec=tspec, rng=np.asarray(_key()),
        residual=tres if ef else None)
    jr, tr = (j[0], t[0]) if ef else (j, t)
    assert np.asarray(jr["protos"]).tobytes() == \
        tr["protos"].numpy().tobytes()
    assert np.asarray(jr["student"].buf).tobytes() == \
        tr["student"].buf.numpy().tobytes()
    if ef:
        assert np.asarray(j[1]["protos"]).tobytes() == \
            t[1]["protos"].numpy().tobytes()
        assert np.asarray(j[1]["student"].buf).tobytes() == \
            t[1]["student"].buf.numpy().tobytes()
    # the round-ops entry point, with a CodecState on +ef
    jstate = tstate = None
    if ef:
        from repro.core.wire_state import CodecState as JCodecState
        jstate = JCodecState(jres, jnp.zeros((N_NODES,), jnp.int32))
        tstate = CodecState(tres, torch.zeros((N_NODES,),
                                              dtype=torch.int32))
    j2 = JR.quantize_dequantize_per_node(jpay, spec=jspec, use_kernels=False,
                                         rng=_key(), state=jstate)
    t2 = TR.quantize_dequantize_per_node(tpay, spec=tspec,
                                         rng=np.asarray(_key()), state=tstate)
    jr2, tr2 = (j2[0], t2[0]) if ef else (j2, t2)
    assert np.asarray(jr2["student"].buf).tobytes() == \
        tr2["student"].buf.numpy().tobytes()
    assert np.asarray(jr2["protos"]).tobytes() == \
        tr2["protos"].numpy().tobytes()
    if ef:
        assert t2[1].seq.tolist() == np.asarray(j2[1].seq).tolist() == \
            [1] * N_NODES


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    arrs = {"adapters": {"w": rng.standard_normal((N_NODES, 33, 9))},
            "protos": rng.standard_normal((N_NODES, 10, 16)),
            "student": {"b": rng.standard_normal((N_NODES, 5)),
                        "h": rng.standard_normal((N_NODES, 3, 700)) * 5}}
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), arrs)


@pytest.mark.parametrize("wire", ["8", "4/16"])
def test_tree_packed_stochastic_matches_jax(wire):
    """The packed tree (the adapter wire's codec): codes, scales and the
    receiver view bit-equal to ``repro``'s for the same key."""
    tree = _tree()
    jspec = dataclasses.replace(JWireSpec.parse(wire),
                                stochastic_rounding=True)
    tspec = dataclasses.replace(WireSpec.parse(wire),
                                stochastic_rounding=True)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = jax.tree_util.tree_map(torch.from_numpy, tree)
    j = jqops.quantize_tree_packed_nodes(jt, spec=jspec, use_kernels=False,
                                         rng=_key(3))
    t = tqops.quantize_tree_packed_nodes(tt, spec=tspec,
                                         rng=np.asarray(_key(3)))
    for key in ("codes", "scales"):
        assert np.asarray(j[key]).tobytes() == t[key].numpy().tobytes()
    jr = jqops.quantize_dequantize_tree_packed_nodes(
        jt, spec=jspec, use_kernels=False, rng=_key(3))
    tr = TR.quantize_dequantize_per_node(tt, spec=tspec,
                                         rng=np.asarray(_key(3)))
    for a, b in zip(jax.tree_util.tree_leaves(jr),
                    jax.tree_util.tree_leaves(tr)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_stochastic_rounding_is_unbiased_over_draws():
    """``tests/test_wirespec.py``'s claim on the port: over 256 keys the
    mean round trip of values between int8 code points sits within a
    5-sigma CLT band of the input (per-draw error below Δ, std at most
    Δ/2) and its mean error is under a quarter of nearest rounding's."""
    xv = (np.linspace(-1.0, 1.0, 1024, dtype=np.float32) * 0.731)[None, :]
    x = {"student": torch.from_numpy(xv)}
    spec = WireSpec(student_bits=8, stochastic_rounding=True)
    draws = 256
    acc = np.zeros_like(xv)
    for k in range(draws):
        acc += tqops.dequantize_tree_packed_nodes(
            tqops.quantize_tree_packed_nodes(
                x, spec=spec, rng=(0, k)))["student"].numpy()
    mean_sr = acc / draws
    det = tqops.dequantize_tree_packed_nodes(tqops.quantize_tree_packed_nodes(
        x, spec=WireSpec.from_bits(8)))["student"].numpy()
    delta = np.abs(xv).max() / 127
    assert np.abs(mean_sr - xv).max() < 5 * delta / (2 * np.sqrt(draws))
    assert np.abs(mean_sr - xv).mean() < 0.25 * np.abs(det - xv).mean()


def test_stochastic_codes_step_at_most_one_and_stay_unbiased():
    x = {"student": torch.full((2, 2048), 0.37) *
         torch.linspace(0.5, 1.0, 2048)}
    det = tqops.quantize_tree_packed_nodes(x, spec=WireSpec.from_bits(8))
    sr = tqops.quantize_tree_packed_nodes(
        x, spec=WireSpec(student_bits=8, stochastic_rounding=True),
        rng=np.asarray(jax.random.PRNGKey(3)))
    diff = sr["codes"].to(torch.int32) - det["codes"].to(torch.int32)
    assert int(diff.abs().max()) == 1 and int(diff.abs().sum()) > 0
    deq = tqops.dequantize_tree_packed_nodes(sr)["student"]
    assert abs(float((deq - x["student"]).mean())) < 1e-4


def test_stochastic_rounding_refusals():
    """No key with a stochastic spec, and ``packed=False`` with one,
    raise ``repro``'s ``ValueError``s; a ``torch.Generator`` raises
    ``TypeError`` (its stream is not the reference's)."""
    protos, buf, _, tmeta = _plane_payload()
    pay = {"protos": torch.from_numpy(protos),
           "student": Plane(torch.from_numpy(buf), tmeta)}
    spec = WireSpec(student_bits=4, stochastic_rounding=True)
    with pytest.raises(ValueError, match="rng"):
        tqops.quantize_dequantize_plane_payload(pay, spec=spec)
    with pytest.raises(ValueError, match="rng"):
        tqops.quantize_tree_packed_nodes(_tree(), spec=spec)
    with pytest.raises(ValueError, match="rng"):
        TR.quantize_dequantize_per_node(pay, spec=spec)
    for kw in (dict(spec=spec, rng=(0, 1)), dict(rng=(0, 1))):
        with pytest.raises(ValueError, match="per-leaf reference path"):
            TR.quantize_dequantize_per_node(pay, packed=False, **kw)
    with pytest.raises(TypeError, match="Generator"):
        TR.quantize_dequantize_per_node(pay, spec=spec,
                                        rng=torch.Generator())
    with pytest.raises(TypeError, match="Generator"):
        TQ.quantize_array(torch.ones(3), 8, rng=torch.Generator())


def test_stochastic_codes_take_the_plain_sweep(monkeypatch):
    """The reference's routing with a key: Δ from one row-absmax sweep
    (``rowabs``, or ``rowabs_sum`` with a residual), the codes never
    through ``quantize_rows`` / ``quantize_rows_mixed`` /
    ``quantize_rows_ef``; without a key the kernels' wrappers run."""
    calls = []
    for name in ("rowabs", "rowabs_sum", "quantize_rows",
                 "quantize_rows_mixed", "quantize_rows_ef"):
        fn = getattr(tqops, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(tqops, name, counted)
    buf, res, ids = _buffer()
    for seg_bits in (None, np.asarray((16, 4, 4, 8), np.int32)):
        for residual in (None, torch.from_numpy(res)):
            calls.clear()
            tqops.quantize_packed_buffer(torch.from_numpy(buf), ids, 4, 16,
                                         seg_bits=seg_bits, rng=(0, 3),
                                         residual=residual)
            assert calls == ["rowabs" if residual is None
                             else "rowabs_sum"]
            calls.clear()
            tqops.quantize_packed_buffer(torch.from_numpy(buf), ids, 4, 16,
                                         seg_bits=seg_bits,
                                         residual=residual)
            assert len(calls) == 2 and calls[1].startswith("quantize_rows")


def test_the_mesh_round_refuses_stochastic_rounding():
    """``repro``'s mesh round takes no key and rounds to nearest whatever
    the spec says; the port's refuses the spec with a ``ValueError``."""
    from repro_torch.core import mesh_federation as M
    with pytest.raises(ValueError, match="no PRNG key"):
        M.make_profe_round(None, spec=WireSpec(4, stochastic_rounding=True))
