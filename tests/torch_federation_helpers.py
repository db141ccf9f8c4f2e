"""The shared helpers of the slice's whole-federation tests
(tests/test_torch_federation*.py).

The port's slice as a whole, held against the JAX package on the CPU:
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
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import distillation as jdist
from repro.core import federation as JF
from repro.core import topology as jtopo
from repro.core import wire_state as jwire_state
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.models import forward
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim.plane import Plane, as_tree
from repro_torch.tree import tree_leaves

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


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
