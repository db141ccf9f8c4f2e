"""What sets the ablation rows of ``benchmarks/torch_ablations.py`` apart
(the wire width, ``alpha_s``, ``alpha_limit``, ``beta_s`` / ``beta_t``)
held against the JAX package.

Each row runs through the script's own ``run()`` on a float32 mnist-cnn
cut to channels (4, 8) and 16-dim prototypes, 4 nodes, 5 rounds: the
script's ``run_federation`` is replaced by one that runs the JAX
package's ``run_federation`` on the row's ``FederationConfig`` and then
the port's from the same carried weights (JAX's ``_init_states``), both
recorded round by round through ``_make_round_fn``.  Bytes, F1 and
accuracy are held exactly.  After every round the student's and the
teacher's parameters are held within ``ATOL`` but for at most
1 % of them, each within ``ATOL + 2·lr``, and the
prototypes within ``PROTO_ATOL``: a difference of 1e-6 between the two
packages' students moves a 16-bit code by one step where it sits at a
rounding tie, and later rounds spread that step (on the paper row, 32
parameters beyond ``ATOL`` after round 3 and 230 of 59,944 after round
4; prototypes within 2.2e-4).  Five rounds, since ``alpha_limit`` first
matters in round 4 (``alpha_s·0.5^4`` = 0.04375 falls below the
paper's 0.05, not below 0).  The JAX states of the rows that change the
training (8-bit wire, ``alpha_limit``, ``alpha_s``, ``beta``) differ
from the paper row's in more than 10 % of the parameters in some round
(38 % or more), so a port that dropped one of those overrides could not
pass.  The 32-bit row's states lie within the 16-bit wire's own noise of
the paper row's; its bytes (exactly JAX's, the codes twice the 16-bit
row's) and ``test_32bit_codes_saturate_as_jax`` set it apart.
"""
import dataclasses
import functools
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import torch_ablations as ablations  # noqa: E402
from repro.config import base as jbase  # noqa: E402
from repro.core import federation as JF  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim import plane as jplane  # noqa: E402
from repro_torch.config import base as tbase  # noqa: E402
from repro_torch.core import federation as TF  # noqa: E402
from repro_torch.core import profe as tprofe  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

NODES, SAMPLES, ROUNDS = 4, 320, 5
PAPER = "paper (16-bit, decay, protos)"
WIDER = "32-bit wire"
LR = 1e-3                       # the script's TrainConfig
ATOL, PROTO_ATOL = 2e-5, 1e-3
PARAMS = ("student", "teacher")


def _jcfg():
    return jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32")


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _snapshot(state, leaves):
    student = state.student
    student = student.buf if hasattr(student, "buf") else student
    return {"student": [_a(x) for x in leaves(student)],
            "teacher": [_a(x) for x in leaves(state.teacher)],
            "global_protos": [_a(state.global_protos)],
            "proto_mask": _a(state.proto_mask)}


def _recording(make_round_fn, calls, leaves):
    """A package's ``_make_round_fn`` that records each round's state."""
    def make(*args, **kwargs):
        fn = make_round_fn(*args, **kwargs)

        def round_fn(state, *inputs, teacher_on, all_valid=False):
            out = fn(state, *inputs, teacher_on=teacher_on,
                     all_valid=all_valid)
            calls.append(_snapshot(out, leaves))
            return out
        return round_fn
    return make


def _carried(jcfg, jfed, jtrain):
    """JAX's own initial states, carried over as the port's."""
    scfg = jmodel.derive_student(jcfg)
    plane = JF._plane_mode(jfed, jtrain, "profe", scfg)
    kw = dict(weight_decay=jtrain.weight_decay, momentum=jtrain.momentum)
    opt_t = jmake_optimizer(jtrain.optimizer, jtrain.learning_rate, **kw)
    opt_s = jplane.make_plane_optimizer(
        jtrain.optimizer, jtrain.learning_rate, grad_clip=jtrain.grad_clip,
        **kw) if plane else jmake_optimizer(jtrain.optimizer,
                                            jtrain.learning_rate, **kw)
    states = JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                             plane=plane)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return [tprofe.node_state_from_numpy(
        tree(jplane.as_tree(s.student)), tree(s.teacher), tree(s.opt_s),
        tree(s.opt_t), np.asarray(s.global_protos),
        np.asarray(s.proto_mask), int(s.round_idx), plane=plane,
        device="cpu") for s in states]


@functools.lru_cache(maxsize=None)
def _rows():
    """Every ablation row through ``ablations.run``: name -> (the JAX
    result, the port's, JAX's round states, the port's)."""
    jcfg = _jcfg()
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    runs = []
    mp = pytest.MonkeyPatch()
    real_setting = ablations.setting

    def setting(**kw):
        return (tcfg,) + real_setting(**kw)[1:]

    def run_federation(cfg, fed, train, node_data, test_d, device=None):
        assert cfg is tcfg
        jfed = jbase.FederationConfig(**dataclasses.asdict(fed))
        jtrain = jbase.TrainConfig(**dataclasses.asdict(train))
        jcalls, tcalls = [], []
        with pytest.MonkeyPatch.context() as m:
            m.setattr(JF, "_make_round_fn", _recording(
                JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
            m.setattr(TF, "_make_round_fn", _recording(
                TF._make_round_fn, tcalls, tree_leaves))
            jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
            tres = TF.run_federation(
                cfg, fed, train, node_data, test_d,
                initial_states=_carried(jcfg, jfed, jtrain), device=device)
        runs.append((jres, tres, jcalls, tcalls))
        return tres
    try:
        mp.setattr(ablations, "setting", setting)
        mp.setattr(ablations, "run_federation", run_federation)
        out = ablations.run(rounds=ROUNDS, n_nodes=NODES, n=SAMPLES,
                            device="cpu")
    finally:
        mp.undo()
    assert list(out) == list(ablations.ABLATIONS) and \
        len(runs) == len(out)
    return {name: (out[name],) + run for name, run in zip(out, runs)}


def _gap(a, b, key):
    return max(float(np.abs(x - y).max(initial=0.0))
               for x, y in zip(a[key], b[key]))


def _beyond(a, b):
    """Parameters (student and teacher) beyond ``ATOL``: their count, the
    largest gap and the parameter count."""
    diffs = np.concatenate([np.abs(x - y).ravel() for key in PARAMS
                            for x, y in zip(a[key], b[key])])
    far = diffs[diffs > ATOL]
    return far.size, float(far.max(initial=0.0)), diffs.size


@pytest.mark.parametrize("name", list(ablations.ABLATIONS))
def test_ablation_row_matches_jax_from_carried_weights(name):
    row, jres, tres, jcalls, tcalls = _rows()[name]
    assert row["avg_sent_gb"] == tres.extras["avg_sent_gb"] == \
        jres.extras["avg_sent_gb"]
    assert row["f1_curve"] == tres.f1_per_round == jres.f1_per_round
    assert len(row["f1_curve"]) == ROUNDS and \
        all(math.isfinite(f) for f in row["f1_curve"])
    assert tres.acc_per_round == jres.acc_per_round
    assert len(tcalls) == len(jcalls) == ROUNDS
    for r, (t, j) in enumerate(zip(tcalls, jcalls)):
        for key in PARAMS + ("global_protos",):
            assert len(t[key]) == len(j[key]) > 0, (r, key)
        n, gap, total = _beyond(t, j)
        assert n <= total // 100 and gap <= ATOL + 2 * LR, (r, n, gap)
        assert _gap(t, j, "global_protos") <= PROTO_ATOL, r
        assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes(), r
    if name not in (PAPER, WIDER):
        # the override shows in JAX's run, far beyond the allowance above
        paper = _rows()[PAPER][3]
        assert max(_beyond(j, p)[0] for j, p in zip(jcalls, paper)) > \
            _beyond(jcalls[0], paper[0])[2] // 10, name


def test_32bit_codes_saturate_as_jax():
    """At 32 bits ``qmax`` = 2^31 - 1 rounds to 2^31 in fp32: the code of
    a row's (or a tensor's) largest positive element saturates to
    2^31 - 1 in the JAX package (XLA's convert) and on the card
    (``cvt.rzi.s32.f32``); the port's plain versions must not wrap it to
    -2^31.  Every fp32 -> int32 codes path at 32 bits, bit for bit."""
    import jax.numpy as jnp

    from repro.core import quantization as JQ
    from repro.core import round_ops as JR
    from repro.kernels.quantize import ref as JK
    from repro_torch.core import quantization as TQ
    from repro_torch.core import round_ops as TR
    from repro_torch.kernels.quantize import ref as TK
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 512)).astype(np.float32)
    x[:, 7] = np.abs(x).max(axis=1) + 1.0          # each row's max is > 0
    x[2, 9] = -x[2, 7]                             # and a row with -max
    qmax = (1 << 31) - 1
    delta = (np.abs(x).max(axis=1, keepdims=True) / np.float32(qmax)) \
        .astype(np.float32)
    t, td = torch.from_numpy(x), torch.from_numpy(delta)
    want = np.asarray(JK.quantize_ref(jnp.asarray(x), jnp.asarray(delta),
                                      bits=32))
    assert (want[:, 7] == qmax).all() and want[2, 9] == -qmax - 1
    qm = torch.full((6, 1), float(qmax))
    for got in (TK.quantize_rows_ref(t, td, bits=32),
                TK.quantize_rows_mixed_ref(t, td, qm),
                TK.quantize_rows_ef_ref(t, torch.zeros_like(t), td, qm,
                                        torch.ones(()))[0]):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    jc, jd = JQ.quantize_array(jnp.asarray(x), 32)
    tc, tdl = TQ.quantize_array(t, 32)
    assert tdl.numpy().tobytes() == np.asarray(jd).tobytes()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.max().item() == qmax
    codes, _ = TK.fused_quantize_ref(t, torch.tensor(float(qmax)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    jc, jd = JR.quantize_leaf_per_node(jnp.asarray(x), 32)
    tc, tdl = TR.quantize_leaf_per_node(t, 32)
    assert tdl.numpy().tobytes() == np.asarray(jd).tobytes()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
