"""The shared helpers of the tree-payload error-feedback tests
(tests/test_torch_tree_ef*.py).

Error feedback on a tree payload in the port, held against the JAX
package on the CPU: the stateful tree codec, the adapter merge off the
plane, and whole runs of the adapter wire with ``+ef`` and of a per-leaf
student with ``+ef`` or on the adapter wire, on both engines.

What is compared, and how:

* the stateful tree codec (``quantize_tree_packed_nodes(residual=)``,
  ``quantize_dequantize_tree_packed_nodes(residual=)`` and
  ``round_ops.quantize_dequantize_per_node(state=)``) on the adapter
  payload and on a per-leaf student's ``{protos, student}``: codes,
  scales, the reconstruction and the new residual bit for bit against
  ``repro``'s eager chain (``use_kernels=False``, not jitted: the jitted
  chain contracts ``eff - codes·Δ`` into an FMA on XLA:CPU).  The port's
  round trip, through the buffer, equals ``repro``'s leaf-local one bit
  for bit, and a residual of another layout raises;
* ``adapter_apply_tree`` against ``repro``'s (``rtol=1e-6``, ``atol``
  1e-6 of the largest delta entry, as ``tests/test_torch_adapters.py``
  holds ``lowrank_apply``: XLA sums each ``B @ A`` in its own order);
* whole 2-round runs on a small mnist-cnn (channels (4, 8), proto_dim
  16, fp32; its student factors fc1 and fc2 at rank 8), 3 nodes on a
  ring, from ``repro``'s own initial states carried through numpy, on
  the stacked engine (``run_federation``) and the per-node loop engine
  (``run_federation_loop``): every byte extra exactly, per-round F1 and
  accuracy exactly, every node's student after every round (read where
  both engines evaluate it) to ``atol=2e-5`` but for at most
  ``MAX_EPS_ELEMENTS`` parameters, each within ``atol + 2·lr`` (the rule
  of ``tests/test_torch_baselines.py``); a RegMean run to that ``atol``
  plus ``REGMEAN_RTOL`` of the round's largest step (the ridge solve
  amplifies last-bit gaps up to ~1e3, ``tests/test_torch_adapters.py``);
  ``seq`` exactly;
* a checkpoint of the ``adapters8+ef`` state after round 1 (a tree
  residual and the adapter state), resumed for round 2, bit-identical to
  the uninterrupted run.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.config import base as jbase
from repro.core import federation as JF
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.tree import tree_leaves, tree_paths
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

N_NODES = 3
MAX_EPS_ELEMENTS = 2
LR = 1e-3
ATOL = 2e-5
REGMEAN_RTOL = 1e-3


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _to(tree, fn):
    return jax.tree_util.tree_map(fn, tree)


def _payload(kind, seed, n=N_NODES):
    """A stacked wire payload and a residual of the size error feedback
    leaves: the adapter wire's (factors of a conv and a matrix leaf,
    grams, the dense rest, prototypes) or a per-leaf student's
    ``{protos, student}`` (with an empty subtree)."""
    rng = np.random.default_rng(seed)
    if kind == "adapters":
        pay = {"adapters": {
            "['conv2']['kernel']": {"A": _normal(rng, n, 3, 3, 8, 16),
                                    "B": _normal(rng, n, 3, 3, 12, 8)},
            "['fc1']['kernel']": {"A": _normal(rng, n, 8, 16),
                                  "B": _normal(rng, n, 300, 8)}},
            "grams": {"['conv2']['kernel']": _normal(rng, n, 3, 3, 16, 16),
                      "['fc1']['kernel']": _normal(rng, n, 16, 16)},
            "protos": _normal(rng, n, 10, 16, scale=0.1),
            "student": {"['conv1']['bias']": _normal(rng, n, 12),
                        "['fc1']['bias']": _normal(rng, n, 16) * 0}}
    else:
        pay = {"protos": _normal(rng, n, 10, 16, scale=0.1),
               "student": {"w": _normal(rng, n, 33, 20),
                           "b": _normal(rng, n, 7),
                           "rem": []}}
    res = jax.tree_util.tree_map(lambda x: x * np.float32(1e-2) *
                                 _normal(rng, *x.shape), pay)
    return pay, res


CODEC_CASES = {
    "adapters8+ef": ("adapters", "4,adapters=8+ef", 1.0),
    "4/16+ef/per-leaf": ("per-leaf", "4/16+ef", 1.0),
    "4/16+ef/per-leaf/decay0.5": ("per-leaf", "4/16+ef", 0.5),
    "16+ef/adapters": ("adapters", "16+ef", 1.0),
}


def _specs(wire, decay):
    j, t = JWireSpec.parse(wire), WireSpec.parse(wire)
    return (dataclasses.replace(j, ef_decay=decay),
            dataclasses.replace(t, ef_decay=decay))


def _assert_trees_equal(t, j):
    tl = tree_paths(t)
    jl = jax.tree_util.tree_flatten_with_path(j)[0]
    assert len(tl) == len(jl)
    for (_, a), (_, b) in zip(tl, jl):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# -- whole runs ----------------------------------------------------------------

RUNS = {"adapters8+ef": dict(quantize_bits=4, adapter_rank=8,
                             error_feedback=True),
        "adapters8+grams+ef": dict(quantize_bits=4, adapter_rank=8,
                                   adapter_grams=True, error_feedback=True),
        "4/16+ef/per-leaf": dict(quantize_bits=4, proto_quantize_bits=16,
                                 error_feedback=True, param_plane="off"),
        "adapters8/per-leaf": dict(quantize_bits=4, adapter_rank=8,
                                   param_plane="off")}


def _setup(name, rounds=2, per_node=56, batch=16):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32")
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    kw = dict(num_nodes=N_NODES, rounds=rounds, topology="ring", **RUNS[name])
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tcfg, node_data, test_d, jbase.FederationConfig(**kw),
            tbase.FederationConfig(**kw), jbase.TrainConfig(**train_kw),
            tbase.TrainConfig(**train_kw))


def _jax_states(jcfg, jfed, jtrain):
    scfg = jmodel.derive_student(jcfg)
    plane = JF._plane_mode(jfed, jtrain, "profe", scfg)
    opt_t = jmake_optimizer("adamw", jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    opt_s = jplane.make_plane_optimizer(
        "adamw", jtrain.learning_rate, weight_decay=jtrain.weight_decay,
        grad_clip=jtrain.grad_clip) if plane else opt_t
    return JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                           plane=plane), plane


def _carry(st, plane):
    return tprofe.node_state_from_numpy(
        _to(jplane.as_tree(st.student), np.asarray),
        _to(st.teacher, np.asarray), _to(st.opt_s, np.asarray),
        _to(st.opt_t, np.asarray), np.asarray(st.global_protos),
        np.asarray(st.proto_mask), int(st.round_idx), plane=plane,
        device="cpu")


def _recording_eval(pkg, rounds, leaves):
    """Record every round's students of every node, as both engines
    evaluate them."""
    inner = pkg._eval_nodes

    def eval_nodes(eval_cfg, students_of, n_nodes, *args, **kwargs):
        rounds.append([[_np(x) for x in leaves(students_of(i))]
                       for i in range(n_nodes)])
        return inner(eval_cfg, students_of, n_nodes, *args, **kwargs)
    return eval_nodes


def _assert_students_close(t_rounds, j_rounds, before, regmean: bool):
    assert len(t_rounds) == len(j_rounds) == 2
    for t_nodes, j_nodes in zip(t_rounds, j_rounds):
        step = max(float(np.abs(b - p).max())
                   for j, q in zip(j_nodes, before) for b, p in zip(j, q))
        atol = ATOL + (REGMEAN_RTOL * step if regmean else 0.0)
        beyond, gap = 0, 0.0
        for t, j in zip(t_nodes, j_nodes):
            assert len(t) == len(j) > 0
            for a, b in zip(t, j):
                d = np.abs(a.reshape(b.shape) - b)
                beyond += int(np.count_nonzero(d > atol))
                gap = max(gap, float(d.max(initial=0.0)))
        assert beyond <= MAX_EPS_ELEMENTS and gap <= atol + 2 * LR, \
            (beyond, gap)
        before = j_nodes


def _bits(x) -> bytes:
    x = x.detach().cpu().contiguous()
    return x.view(torch.uint8).numpy().tobytes() if x.numel() else b""


# -- chip_smoke.py's new paths ---------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NEW_PATHS = ("adapters8+ef", "adapters8+grams+ef", "4/16+ef/per-leaf",
             "adapters8/per-leaf", "adapters8+ef/ragged")


def check_run(name, engine, monkeypatch):
    """The run ``name`` of :data:`RUNS` on ``engine`` (``stacked`` or
    ``loop``) in both packages from the same initial states: the wire's
    bytes exactly, the students each round, F1 and accuracy, and the
    error feedback's and the adapters' state."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(name)
    jrounds, trounds = [], []
    monkeypatch.setattr(JF, "_eval_nodes", _recording_eval(
        JF, jrounds, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_eval_nodes", _recording_eval(
        TF, trounds, tree_leaves))
    run = {"stacked": "run_federation", "loop": "run_federation_loop"}[engine]
    jres = getattr(JF, run)(jcfg, jfed, jtrain, node_data, test_d)
    jstates, plane = _jax_states(jcfg, jfed, jtrain)
    assert plane == (tfed.param_plane != "off")
    tres = getattr(TF, run)(tcfg, tfed, ttrain, node_data, test_d,
                            initial_states=[_carry(s, plane)
                                            for s in jstates],
                            device="cpu")
    assert tres.extras["param_plane"] is jres.extras["param_plane"] is plane
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    before = [[_np(x) for x in tree_leaves(_carry(s, False).student)]
              for s in jstates]
    _assert_students_close(trounds, jrounds, before,
                           regmean=bool(tfed.adapter_grams))
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round
    if tfed.error_feedback:
        ws = tres.extras["wire_state"]
        assert ws.seq.tolist() == [2] * N_NODES
        assert all(bool(torch.isfinite(r).all())
                   for r in tree_leaves(ws.residual) if r is not None)
        if tfed.adapter_rank:
            # the residual mirrors the adapter payload, not the student
            assert sorted(ws.residual) == sorted(
                ["adapters", "protos", "student"] +
                (["grams"] if tfed.adapter_grams else []))
    if tfed.adapter_rank:
        f = tres.extras["adapter_factors"]
        assert len(f) == 2 and all(float(x["A"].abs().max()) > 0
                                   for x in f.values())
