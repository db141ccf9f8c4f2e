"""The port's slice as a whole, held against the JAX package on the CPU:
the stacked ProFe round program driven for 2 rounds, and a 2-round
``run_federation``, both started from weights carried over from
``repro``, on the uniform 16-bit wire and on the ``4/16+ef`` wire (int4
student, int16 prototypes, error feedback).

The round programs run under an fp32 ``dtype`` override with
``run_federation``'s per-round staging (training seeds
``seed + rnd*997 + i``, the proto stream ``[seed + rnd]*N``, the
schedule slice of each round), so the two frameworks differ only in
summation order.  ``repro`` runs its jitted train / share / mix phases
(``_make_phase_fns``), so the share codec's input is observable.  After
each round: the mixed student plane and the teacher to ``atol=2e-5``
(Adam steps of ``lr=1e-3`` that agree to a few ulp, plus a 16-bit wire
code that may flip by one where the two trained students straddle a
rounding boundary: one Δ ≈ 3e-6, weighted by the gossip weight); Eq. 4
prototypes to ``atol=1e-4``; the Adam moments to ``atol=1e-6`` (mu) and
``1e-8`` (nu); masks, round counters and step counters exactly; node
0's test logits to ``atol=1e-5`` and its predictions exactly.

The ``4/16+ef`` wire, per round, adds:

* the share codecs from the same pre-share state (``repro``'s, after its
  train phase): codes, scales and the new residual identical to the
  eager ``repro`` codec's (bit for bit — the jitted ``repro`` round is
  not that oracle: XLA contracts ``eff - codes·Δ`` into an FMA);
* int4 code flips, counted: where the port's codes on its own pre-share
  state differ from ``repro``'s on ``repro``'s.  At most
  ``MAX_INT4_FLIPS`` per round; at a flip the student and the residual
  may differ by that flip's step ``|Δcode|·Δ`` more than their atol
  (one int4 step is ≈ max|x| / 7, far outside any atol);
* int16 prototype code flips, counted the same way: at most
  ``MAX_INT16_PROTO_FLIPS`` per round (1 of the 480 seen in round 1,
  16 in round 2: the pre-share prototypes differ by up to 8.3e-7
  between the frameworks, against a prototype Δ of about 2.5e-5 in
  round 1 and 2e-6 in round 2);
* the EF residual: student part to ``RES_ATOL`` (the trained students'
  difference plus the FMA's last bit), prototype part to
  ``PROTO_RES_ATOL`` (the largest gap seen away from a flip, 8.3e-7,
  with headroom) plus the step of each prototype flip; ``seq`` exactly.
  In round 1 a prototype residual is typically Δ/4 ≈ 6e-6, far outside
  that atol; round 2's is within it, so there a wrongly carried
  prototype residual shows in the same-state codec check (bit for bit)
  and in the flip count, not in the atol.

Whole runs: the wire bytes exactly; per-round node-0 macro-F1 and
accuracy exactly in fp32 (on ``4/16+ef`` also the residual: at most
``MAX_INT16_PROTO_FLIPS`` prototype residuals beyond ``PROTO_RES_ATOL``,
each within ``PROTO_RES_ATOL`` plus one of the port's own prototype
Δ), and accuracy within one of the 64 test predictions in the default
bf16 (the two frameworks round bf16 convolutions differently).
"""
import ast
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import comm as jcomm
from repro.core import distillation as jdist
from repro.core import federation as JF
from repro.core import quantization as jquant
from repro.core import topology as jtopo
from repro.core import wire_state as jwire_state
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.models import forward, init_params
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
from repro_torch.tree import tree_leaves
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(st, ws=None):
    """One JAX node state (and its error-feedback ``CodecState`` ``ws``)
    as the port's."""
    kw = {}
    if ws is not None:
        kw = dict(residual={"protos": np.asarray(ws.residual["protos"]),
                            "student": np.asarray(ws.residual["student"].buf)},
                  seq=int(ws.seq))
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), device="cpu", **kw)


WIRES = {"16": {},
         "4/16+ef": dict(quantize_bits=4, proto_quantize_bits=16,
                         error_feedback=True)}


def _setup(rounds=2, per_node=56, batch=16, dtype="float32", **fed_extra):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype=dtype)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed_kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full",
                  **fed_extra)
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tcfg, node_data, test_d,
            jbase.FederationConfig(**fed_kw), tbase.FederationConfig(**fed_kw),
            jbase.TrainConfig(**train_kw), tbase.TrainConfig(**train_kw))


def _jax_states(jcfg, jfed, jtrain):
    """The per-node states JAX's run_federation initializes itself."""
    scfg = jmodel.derive_student(jcfg)
    opt_s = jplane.make_plane_optimizer("adamw", jtrain.learning_rate,
                                        weight_decay=jtrain.weight_decay,
                                        grad_clip=jtrain.grad_clip)
    opt_t = jmake_optimizer("adamw", jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    states = JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                             plane=True)
    return scfg, opt_s, opt_t, states


def _snapshot(state, logits, leaves):
    """numpy copies of a stacked state (the port updates in place)."""
    def a(x):
        return np.array(x.detach() if isinstance(x, torch.Tensor) else x)
    def moments(opt):
        """The optimizer's tensors but the step counter and the norm, in
        flatten order (adamw: mu then nu; adafactor: per leaf vc, vr)."""
        return [a(x) for x in leaves({k: v for k, v in opt.items()
                                      if k not in ("step", "gnorm")})]
    return {"student": a(state.student.buf),
            "teacher": [a(x) for x in leaves(state.teacher)],
            "opt_s": moments(state.opt_s), "opt_t": moments(state.opt_t),
            "steps": (int(np.ravel(a(state.opt_s["step"]))[0]),
                      int(np.ravel(a(state.opt_t["step"]))[0])),
            "global_protos": a(state.global_protos),
            "proto_mask": a(state.proto_mask),
            "round_idx": a(state.round_idx).tolist(),
            "logits": np.asarray(logits, np.float32),
            "residual": None if state.wire_state is None else (
                a(state.wire_state.residual["protos"]),
                a(state.wire_state.residual["student"].buf)),
            "seq": None if state.wire_state is None
            else a(state.wire_state.seq).tolist()}


def _share_codes(pkg, protos, student, residual, spec, meta):
    """The share phase's codec output for one pre-share state (numpy
    ``protos [N, C, P]``, student plane buffer ``[N, R, 512]`` and
    ``residual`` pair or None), through the port's codec
    (``pkg="torch"``) or ``repro``'s, eagerly: numpy ``codes [N, R',
    512]``, ``scales [N, T]``, the new residual ``res`` (or None), the
    per-row Δ ``row_delta [N, R']`` and the student's packed rows
    ``[r_p, r_p + span)``."""
    if pkg == "torch":
        ops, arr = tqops, torch.from_numpy

        def plane(b):
            return Plane(arr(b.copy()), meta)
    else:
        ops, arr = jqops, jnp.asarray

        def plane(b):
            return jplane.Plane(arr(b), (), meta)
    buf, ids, m, r_p, span = ops.pack_plane_payload(arr(protos.copy()),
                                                    plane(student), spec)
    n_seg, seg_bits = (m[1], m[3]) if pkg == "torch" else (m[2], m[4])
    kw = {} if pkg == "torch" else dict(use_kernels=False)
    if residual is not None:
        kw.update(residual=ops.pack_plane_payload(
            arr(residual[0].copy()), plane(residual[1]))[0],
            ef_decay=spec.ef_decay)
    out = [np.asarray(x) for x in ops.quantize_packed_buffer(
        buf, ids, n_seg, 16, seg_bits=seg_bits, **kw)]
    return {"codes": out[0], "scales": out[1],
            "res": out[2] if residual is not None else None,
            "row_delta": out[1][:, np.asarray(ids)],
            "student_rows": (r_p, r_p + span)}


def _residual_of(state):
    ws = state.wire_state
    if ws is None:
        return None
    return tuple(np.array(x.detach() if isinstance(x, torch.Tensor) else x)
                 for x in (ws.residual["protos"], ws.residual["student"].buf))


@pytest.fixture(scope="module", params=list(WIRES))
def two_rounds(request):
    """Both packages' round phases (train, share, mix), driven for 2
    rounds from the same carried states as ``run_federation`` stages
    them, on the wire ``request.param``; per round the snapshots
    ``(port, jax)``, the batches each staged, and the share codecs'
    outputs: both codecs on JAX's pre-share state, and the port's on its
    own."""
    wire = request.param
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        **WIRES[wire])
    scfg, j_opt_s, j_opt_t, jstates = _jax_states(jcfg, jfed, jtrain)
    step, wire_model, share, bits, _ = JF._algo_wiring(
        "profe", jcfg, scfg, jfed, jtrain, j_opt_s, j_opt_t, jit=False)
    j_train, j_share, j_mix = JF._make_phase_fns(
        step, scfg, 10, share_protos=share, wire_model=wire_model, bits=bits)
    t_opt_s = make_plane_optimizer("adamw", ttrain.learning_rate,
                                   grad_clip=ttrain.grad_clip)
    t_opt_t = make_optimizer("adamw", ttrain.learning_rate)
    tscfg = tbase.ModelConfig(**dataclasses.asdict(scfg))
    tstep, _, _, tbits, _ = TF._algo_wiring("profe", tcfg, tscfg, tfed,
                                            ttrain, t_opt_s, t_opt_t)
    assert tbits.describe() == bits.describe()
    t_train, t_share, t_mix = TF._make_round_parts(tstep, tscfg, 10,
                                                   bits=tbits)

    sizes = [len(d["label"]) for d in node_data]
    jsched = jtopo.make_schedule(N_NODES, jfed.topology, rounds=jfed.rounds,
                                 seed=jfed.seed)
    jw = jsched.lower(sizes)
    tw = [torch.from_numpy(x) for x in ttopo.make_schedule(
        N_NODES, tfed.topology, rounds=tfed.rounds, seed=tfed.seed
    ).lower(sizes)]
    jst = JF._stack_states(jstates)
    if bits.error_feedback:      # run_federation's zero residual, carried
        jst = jst._replace(wire_state=jwire_state.init_codec_state(
            {"protos": jnp.zeros((N_NODES, 10, scfg.proto_dim), jnp.float32),
             "student": jst.student}, n_nodes=N_NODES))
        tst = tprofe.stack_states([
            _carry(s, jax.tree_util.tree_map(lambda x: x[i], jst.wire_state))
            for i, s in enumerate(jstates)])
    else:
        tst = tprofe.stack_states([_carry(s) for s in jstates])
    jtest = {k: jnp.asarray(v) for k, v in test_d.items()}
    ttest = {k: torch.from_numpy(v) for k, v in test_d.items()}
    jmeta, tmeta = jst.student.meta, tst.student.meta

    rounds, staged_pairs, codecs = [], [], []
    for rnd in range(jfed.rounds):
        t_on = jdist.teacher_active(jfed.alpha_s, jfed.alpha_limit, rnd)
        seeds = [jfed.seed + rnd * 997 + i for i in range(N_NODES)]
        proto_seeds = [jfed.seed + rnd] * N_NODES
        js = JF._stack_round_batches(node_data, jtrain.batch_size, seeds,
                                     jfed.local_epochs)
        jp = JF._stack_round_batches(node_data, jtrain.batch_size,
                                     proto_seeds, 1)
        ts = TF._stack_round_batches(node_data, ttrain.batch_size, seeds,
                                     tfed.local_epochs)
        tp = TF._stack_round_batches(node_data, ttrain.batch_size,
                                     proto_seeds, 1)
        staged_pairs.append(((ts, tp), (js, jp)))
        p = jsched.phase_index(rnd)
        jst, jprotos, jcounts = j_train(jst, *js, *jp, teacher_on=t_on,
                                        all_valid=True)
        tst, tprotos, tcounts = t_train(tst, *TF._to_device(ts, "cpu"),
                                        *TF._to_device(tp, "cpu"), t_on,
                                        True)
        pre = (np.asarray(jprotos), np.asarray(jst.student.buf),
               _residual_of(jst))
        codecs.append({
            "same_state": (_share_codes("torch", *pre, tbits, tmeta),
                           _share_codes("jax", *pre, bits, jmeta)),
            "port_own": _share_codes(
                "torch", tprotos.numpy(), tst.student.buf.detach().numpy(),
                _residual_of(tst), tbits, tmeta)})
        jst, j_recv, j_prx = j_share(jst, jprotos)
        tst, t_recv, t_prx = t_share(tst, tprotos)
        jst = j_mix(jst, j_recv, j_prx, jcounts, jw[0][p], jw[1][p],
                    jw[2][p])
        tst = t_mix(tst, t_recv, t_prx, tcounts, tw[0][p], tw[1][p],
                    tw[2][p])
        j_logits = jmodel.forward(
            scfg, jax.tree_util.tree_map(lambda x: x[0],
                                         jplane.as_tree(jst.student)),
            jtest, remat=False).logits
        with torch.no_grad():
            t_logits = forward(tscfg, as_tree(Plane(tst.student.buf[0],
                                                    tst.student.meta)),
                               ttest).logits
        rounds.append((_snapshot(tst, t_logits, tree_leaves),
                       _snapshot(jst, j_logits, jax.tree_util.tree_leaves)))
    return wire, rounds, staged_pairs, codecs, tst.student.meta


# At int4 one flipped code moves a value by a whole Δ (≈ max|x| / 7), so
# the +ef wire's flips are counted and bounded, not folded into an atol.
MAX_INT4_FLIPS = 2          # per round, of N·R·512 student codes
RES_ATOL = 2e-6             # EF student residual, away from flips
PROTO_RES_ATOL = 1.5e-6     # EF prototype residual, away from flips
MAX_INT16_PROTO_FLIPS = 24  # per round, of N·C·P prototype codes


def _flip_steps(codec):
    """The round's code flips as value steps ``|Δcode|·Δ_row`` ``[N, R',
    512]`` (0 where the codes agree): the port's codes on its own
    pre-share state against ``repro``'s on ``repro``'s."""
    ref = codec["same_state"][1]
    diff = codec["port_own"]["codes"].astype(np.int64) - \
        ref["codes"].astype(np.int64)
    return np.abs(diff) * ref["row_delta"][:, :, None], ref["student_rows"]


def _assert_round_matches(t, j, codec=None):
    """One round's state against ``repro``'s.  With ``codec`` (the +ef
    wire), the student and the residual are held per element: away from
    the round's int4 code flips to the usual atol, at a flip to that
    flip's step more (it moves the sender's residual and, through the
    gossip, every receiver's value at that position)."""
    if codec is None:
        np.testing.assert_allclose(t["student"], j["student"], rtol=0,
                                   atol=2e-5)
    else:
        steps, (r0, r1) = _flip_steps(codec)
        s_steps = steps[:, r0:r1]
        n_flips = int(np.count_nonzero(s_steps))
        assert n_flips <= MAX_INT4_FLIPS, f"{n_flips} int4 code flips"
        rows = s_steps.shape[1]
        allow = 2e-5 + s_steps.max(axis=0)
        assert np.all(np.abs(t["student"][:, :rows] - j["student"][:, :rows])
                      <= allow)
        assert np.array_equal(t["student"][:, rows:], j["student"][:, rows:])
        tp_res, ts_res = t["residual"]
        jp_res, js_res = j["residual"]
        assert np.all(np.abs(ts_res[:, :rows] - js_res[:, :rows])
                      <= RES_ATOL + s_steps)
        assert not ts_res[:, rows:].any() and not js_res[:, rows:].any()
        n = tp_res.shape[0]
        p_steps = steps[:, :r0].reshape(n, -1)[:, :tp_res[0].size]
        n_p_flips = int(np.count_nonzero(p_steps))
        gap = np.abs(tp_res - jp_res).reshape(n, -1)
        assert n_p_flips <= MAX_INT16_PROTO_FLIPS, \
            f"{n_p_flips} int16 prototype code flips"
        assert np.all(gap <= PROTO_RES_ATOL + p_steps)
        assert t["seq"] == j["seq"]
    assert len(t["teacher"]) == len(j["teacher"])
    for a, b in zip(t["teacher"], j["teacher"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                               rtol=0, atol=1e-4)
    (mu_s, nu_s), (jmu_s, jnu_s) = t["opt_s"], j["opt_s"]   # adamw
    np.testing.assert_allclose(mu_s, jmu_s, rtol=0, atol=1e-6)
    np.testing.assert_allclose(nu_s, jnu_s, rtol=0, atol=1e-8)
    assert len(t["opt_t"]) == len(j["opt_t"]) == 2 * len(t["teacher"])
    for a, b in zip(t["opt_t"], j["opt_t"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
    assert t["round_idx"] == j["round_idx"]
    assert t["steps"] == j["steps"]
    np.testing.assert_allclose(t["logits"], j["logits"], rtol=0, atol=1e-5)
    assert (t["logits"].argmax(-1) == j["logits"].argmax(-1)).all()


def _assert_codecs_agree(wire, codec):
    """From the same (``repro``'s) pre-share state both codecs give
    identical codes and scales, and with +ef the identical new residual
    (the eager ``repro`` codec is the bit-exact oracle)."""
    t, j = codec["same_state"]
    assert t["codes"].dtype == j["codes"].dtype
    for key in ("codes", "scales"):
        assert t[key].tobytes() == j[key].tobytes(), key
    if wire.endswith("+ef"):
        assert t["res"].tobytes() == j["res"].tobytes()
    else:
        assert t["res"] is None and j["res"] is None


def _ef_codec(wire, codec):
    return codec if wire.endswith("+ef") else None


def test_one_round_matches_the_jax_round_program(two_rounds):
    wire, rounds, staged_pairs, codecs, meta = two_rounds
    (ts, tp), (js, jp) = staged_pairs[0]
    for a, b in zip(jax.tree_util.tree_leaves((ts, tp)),
                    jax.tree_util.tree_leaves((js, jp))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    t, j = rounds[0]
    _assert_codecs_agree(wire, codecs[0])
    _assert_round_matches(t, j, _ef_codec(wire, codecs[0]))
    assert t["round_idx"] == [1] * N_NODES
    assert t["steps"] == (3, 3)
    # padding lanes of the mixed plane (and of the EF residual) stay zero
    real = np.zeros(t["student"].shape[1:], dtype=bool)
    for _, _, shape, row, r_leaf in meta.recipe:
        real[row:row + r_leaf].reshape(-1)[:int(np.prod(shape))] = True
    assert not t["student"][:, ~real].any()
    if wire.endswith("+ef"):
        assert t["seq"] == j["seq"] == [1] * N_NODES
        res = t["residual"][1]
        assert not res[:, ~real].any() and np.abs(res).max() > 0


def test_two_rounds_match_the_jax_round_program(two_rounds):
    """Round 2 runs on round 1's state: the per-round training and proto
    stream seeds, step counters and bias corrections past the first
    round, the teacher gate and round 1's Eq. 4 prototypes and mask."""
    wire, rounds, staged_pairs, codecs, _ = two_rounds
    (ts, tp), (js, jp) = staged_pairs[1]
    for a, b in zip(jax.tree_util.tree_leaves((ts, tp)),
                    jax.tree_util.tree_leaves((js, jp))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # round 2 draws other batches than round 1
    assert np.asarray(ts[0]["label"]).tobytes() != \
        np.asarray(staged_pairs[0][0][0][0]["label"]).tobytes()
    t1, j1 = rounds[0]
    assert j1["proto_mask"].any()       # round 2 trains against Eq. 4
    t, j = rounds[1]
    _assert_codecs_agree(wire, codecs[1])
    _assert_round_matches(t, j, _ef_codec(wire, codecs[1]))
    assert t["round_idx"] == [2] * N_NODES
    assert t["steps"] == (6, 6)
    if wire.endswith("+ef"):
        # round 2 quantized x + residual: the carried error re-entered
        assert t["seq"] == j["seq"] == [2] * N_NODES
        assert not np.array_equal(t["residual"][1], t1["residual"][1])


def _recording(make_round_fn, calls, leaves):
    """Wrap a package's ``_make_round_fn`` so that every round
    ``run_federation`` drives is recorded: its staged inputs, flags and
    (copied) output state."""
    def make(*args, **kwargs):
        fn = make_round_fn(*args, **kwargs)

        def round_fn(state, *inputs, teacher_on, all_valid=False):
            out = fn(state, *inputs, teacher_on=teacher_on,
                     all_valid=all_valid)
            calls.append({
                "inputs": [np.array(x) for x in
                           jax.tree_util.tree_leaves(inputs)],
                "flags": (teacher_on, all_valid),
                "state": _snapshot(out, np.zeros(()), leaves)})
            return out
        return round_fn
    return make


@pytest.mark.parametrize("dtype,wire", [
    ("float32", "16"), ("bfloat16", "16"), ("float32", "4/16+ef")],
    ids=["float32", "bfloat16", "float32-4/16+ef"])
def test_run_federation_matches_jax_from_carried_states(dtype, wire,
                                                        monkeypatch):
    """Whole runs from the same carried weights; on the +ef wire both
    start from run_federation's own zero residual."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        dtype=dtype, **WIRES[wire])
    jcalls, tcalls = [], []
    monkeypatch.setattr(JF, "_make_round_fn", _recording(
        JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_make_round_fn", _recording(
        TF._make_round_fn, tcalls, tree_leaves))
    proto_deltas = []       # the port's prototype Δ per node, each round

    def quantize_packed_buffer(*args, **kwargs):
        out = quantize(*args, **kwargs)
        proto_deltas.append(np.array(out[1][:, 0]))     # segment 0: protos
        return out
    quantize = tqops.quantize_packed_buffer
    monkeypatch.setattr(tqops, "quantize_packed_buffer",
                        quantize_packed_buffer)
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
    _, _, _, jstates = _jax_states(jcfg, jfed, jtrain)
    tres = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             initial_states=[_carry(s) for s in jstates],
                             device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    assert tres.comm.summary() == jres.comm.summary()
    # every round: the same staged batches, proto stream, schedule slice
    # and flags, so run_federation's own per-round staging agrees
    assert len(tcalls) == len(jcalls) == 2
    for t, j in zip(tcalls, jcalls):
        assert t["flags"] == j["flags"]
        # image, label, valid; proto image, label, valid; 3 matrices
        assert len(t["inputs"]) == len(j["inputs"]) == 9
        for a, b in zip(t["inputs"], j["inputs"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert len(tres.f1_per_round) == len(jres.f1_per_round) == 2
    if dtype == "float32":
        assert len(proto_deltas) == len(tcalls)
        for t, j, p_delta in zip(tcalls, jcalls, proto_deltas):
            t["state"]["logits"] = j["state"]["logits"]
            _assert_round_matches(t["state"], j["state"])
            if wire.endswith("+ef"):
                assert t["state"]["seq"] == j["state"]["seq"]
                (tp_res, ts_res), (jp_res, js_res) = (
                    t["state"]["residual"], j["state"]["residual"])
                np.testing.assert_allclose(ts_res, js_res, rtol=0,
                                           atol=RES_ATOL)
                # an int16 prototype flip moves one residual by one Δ:
                # counted, and held to PROTO_RES_ATOL plus that Δ
                gap = np.abs(tp_res - jp_res).reshape(N_NODES, -1)
                off = gap > PROTO_RES_ATOL
                assert np.count_nonzero(off) <= MAX_INT16_PROTO_FLIPS
                assert np.all(gap <= PROTO_RES_ATOL + off * p_delta[:, None])
        assert ("wire_state" in tres.extras) == wire.endswith("+ef")
        if wire.endswith("+ef"):
            assert tres.extras["wire_state"].seq.tolist() == [2] * N_NODES
        assert tres.f1_per_round == jres.f1_per_round
        assert tres.acc_per_round == jres.acc_per_round
    else:
        n_test = len(test_d["label"])
        np.testing.assert_allclose(tres.acc_per_round, jres.acc_per_round,
                                   rtol=0, atol=1 / n_test + 1e-12)


def _resnet_setup(optimizer, rounds=2, per_node=48, batch=16):
    """A tiny CIFAR-shaped federation: a two-stage ResNet teacher
    (blocks (2, 2), width 4) and its student (1, 1) on 8x8x3 images,
    fp32, 3 nodes on a full graph, the 16-bit wire."""
    jcfg = jbase.get_config("cifar10-resnet18").replace(
        name="small-resnet", resnet_blocks=(2, 2), resnet_width=4,
        proto_dim=16, input_hw=(8, 8, 3), dtype="float32")
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    data = make_image_dataset(1, N_NODES * per_node + 64, (8, 8, 3), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed_kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full")
    train_kw = dict(batch_size=batch, remat=False, optimizer=optimizer)
    return (jcfg, tcfg, node_data, test_d,
            jbase.FederationConfig(**fed_kw), tbase.FederationConfig(**fed_kw),
            jbase.TrainConfig(**train_kw), tbase.TrainConfig(**train_kw))


# Whole ResNet runs, fp32, per optimizer: atol of (student plane,
# teacher, optimizer moments) after each of 2 rounds (3 steps a round).
# The student as the mnist runs: a 16-bit wire code may flip where the
# two trained students straddle a rounding boundary (one Δ ≈ max|x| /
# 32767 ≈ 3e-5, weighted by the gossip weight; largest gap seen 3.9e-6).
# The teacher never travels: the steps' own last-bit gaps (sgd 3.0e-8,
# adafactor 1.2e-7 seen, an adafactor step being about lr·1e-4 of the
# gradients' relative gap).  The moments: sgd's momentum is a sum of
# gradients (2.8e-7 seen), adafactor's are squares of them (7.5e-9).
RESNET_RUN_ATOL = {"sgd": (2e-5, 1e-6, 1e-6),
                   "adafactor": (2e-5, 1e-6, 1e-8)}


@pytest.mark.parametrize("optimizer", ["sgd", "adafactor"])
def test_run_federation_resnet_matches_jax_from_carried_states(optimizer,
                                                               monkeypatch):
    """A tiny ResNet federation under the sgd / adafactor plane and
    per-leaf optimizers: ``run_federation`` of both packages from the
    same carried states (JAX's own ``_init_states``, carried through
    numpy).  Bytes exactly; every round's staged inputs byte-identical;
    after each round the state to ``RESNET_RUN_ATOL``, prototypes to
    ``atol=1e-4``, masks and counters exactly; F1 and accuracy exactly."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = \
        _resnet_setup(optimizer)
    jcalls, tcalls = [], []
    monkeypatch.setattr(JF, "_make_round_fn", _recording(
        JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_make_round_fn", _recording(
        TF._make_round_fn, tcalls, tree_leaves))
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
    assert jres.extras["param_plane"] is True
    scfg = jmodel.derive_student(jcfg)
    opt_s = jplane.make_plane_optimizer(optimizer, jtrain.learning_rate,
                                        weight_decay=jtrain.weight_decay,
                                        momentum=jtrain.momentum,
                                        grad_clip=jtrain.grad_clip)
    opt_t = jmake_optimizer(optimizer, jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay,
                            momentum=jtrain.momentum)
    jstates = JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                              plane=True)
    tres = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             initial_states=[_carry(s) for s in jstates],
                             device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    assert tres.comm.summary() == jres.comm.summary()
    assert len(tcalls) == len(jcalls) == 2
    s_atol, t_atol, m_atol = RESNET_RUN_ATOL[optimizer]
    for t, j in zip(tcalls, jcalls):
        assert t["flags"] == j["flags"]
        for a, b in zip(t["inputs"], j["inputs"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        t, j = t["state"], j["state"]
        np.testing.assert_allclose(t["student"], j["student"], rtol=0,
                                   atol=s_atol)
        assert len(t["teacher"]) == len(j["teacher"]) == 32
        for a, b in zip(t["teacher"], j["teacher"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=t_atol)
        for key in ("opt_s", "opt_t"):
            assert len(t[key]) == len(j[key]) > 0
            for a, b in zip(t[key], j[key]):
                np.testing.assert_allclose(a, b, rtol=0, atol=m_atol)
        np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                                   rtol=0, atol=1e-4)
        assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
        assert t["round_idx"] == j["round_idx"]
        assert t["steps"] == j["steps"]
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round


@pytest.mark.parametrize("optimizer", ["sgd", "adamw", "adafactor", "lion"])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_param_plane_resolves_like_jax(mode, optimizer, param_dtype):
    """``param_plane`` resolves as ``repro``'s ``_plane_mode``: the plane
    for the profe student under sgd / adamw / adafactor with fp32
    parameters; ``"on"`` raises ValueError otherwise."""
    jcfg = jmodel.derive_student(jbase.get_config("mnist-cnn").replace(
        param_dtype=param_dtype))
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    out = []
    for pkg, cfg, fed, train in (
            (JF, jcfg, jbase.FederationConfig(param_plane=mode),
             jbase.TrainConfig(optimizer=optimizer)),
            (TF, tcfg, tbase.FederationConfig(param_plane=mode),
             tbase.TrainConfig(optimizer=optimizer))):
        try:
            out.append(pkg._plane_mode(fed, train, "profe", cfg))
        except ValueError as e:
            out.append(type(e))
    assert out[0] == out[1]


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("wire,rounds", [
    ("16", 2), ("4/16+ef", 2), ("4/16", 1), ("cifar10/sgd", 2),
    ("cifar10/adafactor", 1), ("adapters8", 2), ("adapters8+grams", 1)])
def test_run_federation_full_width_bytes_match_jax_accounting(wire, rounds):
    """The 20-node wire numbers chip_smoke.py holds the card runs to, for
    each of its paths (``wire`` names the path): the port's accountants
    and the JAX package's, from the same payload template shapes of the
    path's full-width student, equal each other and the script's
    constants — for the mnist-cnn 16-bit main path, the 4/16 wire (whose
    bytes +ef leaves unchanged), the cifar10-resnet18 paths (the ResNet8
    student on the 16-bit wire), and the adapter-rank wire at rank 8 on
    the int4 wire, naive and with grams (conv2, fc1 and fc2 travel as
    factors), over each path's rounds."""
    smoke = _chip_smoke_module()
    n = smoke.N_NODES
    model, _, wire_arg, smoke_rounds, want = smoke.PATHS[wire]
    assert smoke_rounds == rounds
    jspec, tspec = JWireSpec.parse(wire_arg), WireSpec.parse(wire_arg)
    # the script's FederationConfig fields make the spec it names
    extra = smoke.PATH_FED.get(wire, {})
    fed = tbase.FederationConfig(**smoke.wire_fields(tspec), **extra)
    assert WireSpec(student_bits=fed.quantize_bits,
                    proto_bits=fed.proto_quantize_bits,
                    error_feedback=fed.error_feedback) == tspec
    assert tspec.describe() == jspec.describe() == {
        "16": "int16", "4": "int4", "4/16": "student=int4,protos=int16",
        "4/16+ef": "student=int4,protos=int16+ef"}[wire_arg]
    cfg = tbase.get_config(model)
    student = plane_from_tree(init_params(TF.derive_student(cfg),
                                          torch.Generator().manual_seed(0)))
    state = tprofe.NodeState(student, None, None, None, None, None, None)
    ncls, pdim = cfg.num_classes, cfg.proto_dim
    tpay = TF._payload_template("student", True, state, ncls, pdim,
                                adapter_rank=fed.adapter_rank,
                                adapter_grams=fed.adapter_grams)
    tmeter = TF.ScheduleCommAccountant(ttopo.make_schedule(n, "full",
                                                           rounds=rounds))
    for r in range(rounds):
        tmeter.record_round(tpay, "profe", r, tspec)

    jscfg = jmodel.derive_student(jbase.get_config(model))
    jpay = {"model": jax.eval_shape(lambda: jmodel.init_params(
        jscfg, jax.random.PRNGKey(0))),
        "protos": jax.ShapeDtypeStruct((ncls, pdim), np.dtype(np.float32)),
        "counts": jax.ShapeDtypeStruct((ncls,), np.dtype(np.float32))}
    if fed.adapter_rank:
        # the matrix leaves leave "model" and meter as their factors
        from repro.core import adapters as jadapters
        layout = jadapters.adapter_layout(jpay["model"], fed.adapter_rank)
        jpay.update(jadapters.adapter_payload_template(
            layout, grams=fed.adapter_grams))
        jpay["model"] = jadapters.split_student(layout, jpay["model"])[1]
        assert layout.mat_names == ("['conv2']['kernel']",
                                    "['fc1']['kernel']", "['fc2']['kernel']")
    assert [tuple(x.shape) for x in tree_leaves(tpay)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jpay)]
    jmeter = jcomm.ScheduleCommAccountant(jtopo.make_schedule(
        n, "full", rounds=rounds))
    for r in range(rounds):
        jmeter.record_round(jpay, "profe", r, jspec)

    assert tmeter.avg_sent_gb() == jmeter.avg_sent_gb() == want[0]
    assert TF.packed_copy_bytes(tpay, tspec) == \
        jcomm.packed_copy_bytes(jpay, jspec) == want[1]
    assert TF.tree_wire_bytes(tpay, tspec) == \
        jquant.tree_wire_bytes(jpay, jspec) == want[2]
    if wire_arg.startswith("4/16"):
        # the residual never travels: +ef costs no byte
        assert TF.packed_copy_bytes(tpay, tspec.stateless()) == want[1]
        assert want == ({1: 0.002015254, 2: 0.004030508}[rounds], 108876,
                        106066)
    if fed.adapter_rank:
        # the same student's dense int4 copy: the naive adapter wire
        # sends 0.095x its logical and 0.116x its packed bytes
        dense = TF._payload_template("student", True, state, ncls, pdim)
        assert TF.tree_wire_bytes(dense, tspec) == 104146
        assert TF.packed_copy_bytes(dense, tspec) == 106572
        if not fed.adapter_grams:
            assert (round(want[2] / 104146, 3),
                    round(want[1] / 106572, 3)) == (0.095, 0.116)
    if model == "cifar10-resnet18":
        # the ResNet8 student: 27 leaves, a [208, 512] plane, its lists
        # of stages kept in the template
        assert tuple(student.buf.shape) == (208, 512)
        assert len(tpay["model"]["stages"]) == 3
        assert want[1:] == (221336, 198076)


@pytest.mark.parametrize("fed_kw,train_kw,run_kw", [
    (dict(adapter_rank=4, quantize_bits=0), {}, {}),
])
def test_options_outside_the_slice_raise(fed_kw, train_kw, run_kw):
    """No option of ``run_federation`` is left outside the port (the
    adapter wire with ``+ef`` runs since it took the tree payload's error
    feedback); what ``repro`` refuses, the port refuses alike: the
    adapter wire without a quantized codec."""
    _, tcfg, node_data, test_d, _, _, _, _ = _setup(per_node=16)
    fed = tbase.FederationConfig(num_nodes=N_NODES, rounds=1, **fed_kw)
    with pytest.raises(ValueError, match="quantized wire"):
        TF.run_federation(tcfg, fed, tbase.TrainConfig(**train_kw),
                          node_data, test_d, device="cpu", **run_kw)


def test_run_federation_refuses_a_residual_without_error_feedback():
    """Initial states that carry an error-feedback residual on a wire
    without ``+ef`` are a mismatch, not a state to ignore."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        rounds=1, per_node=16, quantize_bits=4, proto_quantize_bits=16)
    scfg, _, _, jstates = _jax_states(jcfg, jfed, jtrain)
    states = [_carry(s, jwire_state.init_codec_state(
        {"protos": jnp.zeros((10, scfg.proto_dim), jnp.float32),
         "student": s.student})) for s in jstates]
    with pytest.raises(ValueError, match="no error feedback"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                          initial_states=states, device="cpu")


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup(per_node=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprofe.init_node_state(tcfg, TF.derive_student(tcfg),
                               torch.Generator(), make_plane_optimizer(
                                   "adamw", 1e-3), make_optimizer(
                                   "adamw", 1e-3), 10)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    # the port's user scripts
    files += sorted((ROOT / "benchmarks").glob("torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(alone)], capture_output=True,
                           text=True, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")],
            capture_output=True, text=True, timeout=120, cwd=ROOT))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
