"""The shared helpers of the loop-engine tests
(tests/test_torch_loop_engine*.py).

The port's per-node loop engine (``run_federation_loop``) and its
helpers, held against the JAX package on the CPU.

* The helpers, bit for bit: ``data.batches``,
  ``CommMeter.record_broadcast``, ``aggregation.weighted_tree_mean`` /
  ``neighborhood_aggregate`` / ``weighted_plane_mean``,
  ``kernels/quantize/ops.quantize_dequantize_plane_rows`` (4, 8 and 16
  bits, an unstacked plane and a one-node stack), and
  ``wire_state.ef_quantize_dequantize_plane`` against ``repro``'s eager
  call (its jitted call, the JAX loop engine's, divides by qmax as a
  multiply by the reciprocal and contracts the residual's
  multiply-subtract into an FMA on XLA:CPU, so against that the views
  are held to ``rtol=1e-6`` and the residual to ``RES_ATOL``);
  ``round_ops.weighted_node_mean`` to ``rtol=1e-6`` (two
  tensordots that may sum in other orders).
* Whole ``run_federation_loop`` runs of both packages from the same
  carried states (``repro``'s own ``_init_states``) on a ragged split (4
  nodes of a tiny mnist-cnn, fp32, node 0 cut to 10 images, under one
  batch of 16, so its one batch is short): the plane and a per-leaf
  student, the ``16``, ``4/16+ef`` and adapter wires (naive and
  RegMean), the fused pass with the prototype EMA, and FedProto with
  every node evaluated.
  ``avg_sent_gb``, ``comm.sent``, ``comm.received``, ``comm.by_round``
  and the byte extras exactly; after every round every node's student
  (read where both engines evaluate it) to ``atol=2e-5`` (as
  ``tests/test_torch_federation.py``), but for at most
  ``MAX_EPS_ELEMENTS`` parameters in Adam's eps regime, each within
  ``atol + 2·lr`` (``tests/test_torch_baselines.py``); per-round F1 and
  accuracy exactly.
* ``run_federation`` falls back to the loop engine for a ragged split
  (its result the loop's, bit for bit), and the loop engine against the
  port's own stacked engine on an equal split: bytes exactly, the final
  stacked state to the same tolerances (the stacked mix sums its
  senders in one tensordot, the loop one sender after another), step
  counters, masks and round counters exactly.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from repro.config import base as jbase
from repro.core import federation as JF
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import profe as tprofe
from repro_torch.data import make_image_dataset, partition, train_test_split

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 4
RES_ATOL = 2e-6             # EF student residual against the jitted codec
MAX_EPS_ELEMENTS = 2        # parameters in Adam's eps regime, a round
LR = 1e-3                   # TrainConfig's learning rate


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _bits(x) -> bytes:
    return _a(x).tobytes()


# -- the helpers -----------------------------------------------------------------


def _student_tree(seed: int):
    cfg = jbase.get_config("mnist-cnn").replace(cnn_channels=(4, 8),
                                                proto_dim=16)
    return _np_tree(jmodel.init_params(jmodel.derive_student(cfg),
                                       jax.random.PRNGKey(seed)))


# -- whole runs against the JAX loop engine ------------------------------------

WIRES = {"16": {}, "fp32": dict(quantize_bits=0),
         "4/16+ef": dict(quantize_bits=4, proto_quantize_bits=16,
                         error_feedback=True),
         "adapters8": dict(quantize_bits=4, adapter_rank=8),
         "adapters8+grams": dict(quantize_bits=4, adapter_rank=8,
                                 adapter_grams=True)}


def _setup(wire, *, ragged=True, rounds=2, per_node=56, batch=16,
           channels=(4, 8), **fed):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=channels, proto_dim=16, dtype="float32")
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    if ragged:
        parts[0] = parts[0][:10]            # under one batch of 16
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full",
              **WIRES[wire], **fed)
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg)), node_data,
            test_d, jbase.FederationConfig(**kw),
            tbase.FederationConfig(**kw), jbase.TrainConfig(**train_kw),
            tbase.TrainConfig(**train_kw))


def _jax_states(jcfg, jfed, jtrain):
    algo = jfed.algorithm
    scfg = jmodel.derive_student(jcfg)
    plane = JF._plane_mode(jfed, jtrain, algo, scfg)
    opt_t = jmake_optimizer("adamw", jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    opt_s = jplane.make_plane_optimizer(
        "adamw", jtrain.learning_rate, weight_decay=jtrain.weight_decay,
        grad_clip=jtrain.grad_clip) if plane else opt_t
    _, _, _, _, cfgs = JF._algo_wiring(algo, jcfg, scfg, jfed, jtrain,
                                       opt_s, opt_t, jit=False)
    return JF._init_states(algo, cfgs, jfed, opt_s, opt_t, 10,
                           plane=plane), plane


def _carry(st, plane: bool):
    acc = None if st.proto_acc is None else tuple(np.asarray(x)
                                                  for x in st.proto_acc)
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), plane=plane, proto_acc=acc, device="cpu")


def _recording_eval(pkg, rounds, leaves):
    """Wrap ``pkg._eval_nodes`` so that every round's students of every
    node (the models both engines evaluate) are recorded as numpy."""
    inner = pkg._eval_nodes

    def eval_nodes(eval_cfg, students_of, n_nodes, *args, **kwargs):
        rounds.append([[_a(x) for x in leaves(students_of(i))]
                       for i in range(n_nodes)])
        return inner(eval_cfg, students_of, n_nodes, *args, **kwargs)
    return eval_nodes


def _assert_students_close(t_rounds, j_rounds, eps_elements, atol=2e-5):
    assert len(t_rounds) == len(j_rounds)
    for t_nodes, j_nodes in zip(t_rounds, j_rounds):
        beyond, gap = 0, 0.0
        for t, j in zip(t_nodes, j_nodes):
            assert len(t) == len(j) > 0
            for a, b in zip(t, j):
                a = a.reshape(b.shape)
                d = np.abs(a - b)
                beyond += int(np.count_nonzero(d > atol))
                gap = max(gap, float(d.max(initial=0.0)))
        assert beyond <= eps_elements and gap <= atol + 2 * LR, (beyond,
                                                                 gap)


LOOP_RUNS = {
    "plane/16": ("16", {}),
    "plane/4/16+ef": ("4/16+ef", {}),
    "plane/adapters8": ("adapters8", dict(channels=(24, 32))),
    "plane/adapters8+grams": ("adapters8+grams",
                              dict(channels=(24, 32), rounds=1)),
    "per-leaf/16/fused+ema": ("16", dict(param_plane="off",
                                         proto_pass="fused",
                                         proto_ema=0.5)),
    "fedproto/fp32/all-nodes": ("fp32", dict(algorithm="fedproto",
                                             eval_all_nodes=True)),
}


# -- chip_smoke.py's non-iid paths ----------------------------------------------

def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
