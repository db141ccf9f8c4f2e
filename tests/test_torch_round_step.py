"""The port of the round-step microbenchmark
(``benchmarks/torch_round_step.py``) held against the JAX script
(``benchmarks/round_step.py``) on the CPU.

* ``legacy_round``, the seed's per-node loop, one round at N = 2 against
  the JAX script's own ``legacy_round``, both from the JAX script's
  seeded states (carried with ``core/profe.node_state_from_numpy``) on
  the JAX script's data (equal bytes) and its reduced mnist-cnn, in
  float32 (the scripts' bfloat16 activations round at other places in
  the two frameworks).  Students to ``atol=2e-5`` but for at most
  ``MAX_EPS_ELEMENTS`` parameters in Adam's eps regime, each within
  ``atol + 2·lr`` (``tests/test_torch_loop_engine.py``); the Eq. 4
  prototypes to ``1e-4`` (JAX sums Eq. 3 as a one-hot einsum, the port
  as ``proto_accum`` batches: fp32 sums in other orders); the masks
  exactly.
* The stacked round as the script wires it (the plane, the fused sweep,
  the packed codec) against the port's own ``legacy_round`` after one
  round from the same seeded states: the tolerances above (the stacked
  mix sums its senders in one tensordot, the loop one after another),
  Adam's moments ``1e-6`` / ``1e-8``, step counters exactly.
* ``main`` at N = 2 with ``--phases`` writes exactly the JAX script's
  keys, read from its source (``measure``'s and ``measure_phases``'
  dicts), and ``local_steps_per_round`` is the JAX ``_setup``'s count.
* One spawn of 4 gloo ranks for ``--wire`` at ``16``, ``4/16+ef`` and
  ``4+adapters8``: the ``ppermute``, ``packed`` and full-gather bytes
  equal the JAX package's (``repro.launch.wire.measure_exchange_bytes``,
  as ``tests/test_torch_dryrun.py`` obtains them), and every exchange
  has a ``round_ms``.
* Every flag of the JAX parser with its default (read from the JAX
  script's source), ``--out`` excepted (the port's own report name); the
  JAX report names refused; no card and no ``--device cpu`` raises.
"""
import ast
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import round_step as JR  # noqa: E402
from benchmarks import torch_round_step as S  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.optim import plane as jplane  # noqa: E402
from repro_torch.core import profe as tprofe  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

N = 2
SAMPLES, BATCH = 32, 8          # the JAX script's defaults
ATOL = 2e-5
PROTO_ATOL = 1e-4
MAX_EPS_ELEMENTS = 2
LR = 1e-3                       # the script's TrainConfig learning rate
JAX_SRC = (ROOT / "benchmarks" / "round_step.py").read_text()


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _f32(cfg):
    return cfg.replace(dtype="float32")


def _carry(st):
    return tprofe.stack_states([tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), plane=False, device="cpu")])


def _assert_students_close(got, want, atol=ATOL):
    """``got`` / ``want``: per node, the student's leaves as numpy."""
    beyond, gap = 0, 0.0
    for t_leaves, j_leaves in zip(got, want):
        assert len(t_leaves) == len(j_leaves) > 0
        for a, b in zip(t_leaves, j_leaves):
            d = np.abs(a.reshape(b.shape) - b)
            beyond += int(np.count_nonzero(d > atol))
            gap = max(gap, float(d.max(initial=0.0)))
    assert beyond <= MAX_EPS_ELEMENTS and gap <= atol + 2 * LR, (beyond, gap)


def _port_setup():
    cfg, fed, train, node_data = S._setup(N, SAMPLES, BATCH)
    return _f32(cfg), fed, train, node_data


def test_setup_is_the_jax_scripts():
    jcfg, jfed, jtrain, jdata = JR._setup(N, SAMPLES, BATCH)
    cfg, fed, train, node_data = S._setup(N, SAMPLES, BATCH)
    assert cfg.cnn_channels == jcfg.cnn_channels == (8, 16)
    assert (fed.num_nodes, fed.local_epochs, fed.algorithm, fed.topology,
            fed.seed) == (jfed.num_nodes, jfed.local_epochs,
                          jfed.algorithm, jfed.topology, jfed.seed)
    assert (train.batch_size, train.learning_rate, train.optimizer) == \
        (jtrain.batch_size, jtrain.learning_rate, jtrain.optimizer)
    for t, j in zip(node_data, jdata):
        for k in j:
            assert np.asarray(t[k]).tobytes() == np.asarray(j[k]).tobytes()


def test_legacy_round_matches_the_jax_scripts():
    jcfg, jfed, jtrain, jdata = JR._setup(N, SAMPLES, BATCH)
    jcfg = _f32(jcfg)
    jstep, jbits, ncls, _, jstates, jscfg = JR._wiring(jcfg, jfed, jtrain,
                                                       jit=True, plane=False)
    carried = [_carry(s) for s in jstates]
    adj = jtopo.adjacency(N, jfed.topology)
    sizes = [len(d["label"]) for d in jdata]
    jstates = JR.legacy_round(jstep, jstates, jdata, jcfg, jscfg, jfed,
                              jtrain, adj, sizes, ncls, jbits, 0)

    cfg, fed, train, node_data = _port_setup()
    dev = torch.device("cpu")
    step, bits, tncls, _, _, scfg = S._wiring(cfg, fed, train, dev,
                                              plane=False)
    assert tncls == ncls
    tadj = ttopo.adjacency(N, fed.topology)
    assert (tadj == adj).all()
    tstates = S.legacy_round(step, carried, node_data, cfg, scfg, fed, train,
                             tadj, sizes, ncls, bits, 0, dev)
    _assert_students_close(
        [[_a(x) for x in tree_leaves(s.student)] for s in tstates],
        [[np.asarray(x) for x in jax.tree_util.tree_leaves(s.student)]
         for s in jstates])
    for t, j in zip(tstates, jstates):
        np.testing.assert_allclose(_a(t.global_protos[0]),
                                   np.asarray(j.global_protos), rtol=0,
                                   atol=PROTO_ATOL)
        assert _a(t.proto_mask[0]).tobytes() == \
            np.asarray(j.proto_mask).tobytes()
        assert int(t.round_idx[0]) == int(j.round_idx) == 1


def test_stacked_round_matches_the_ports_legacy_round():
    cfg, fed, train, node_data = _port_setup()
    dev = torch.device("cpu")
    adj = ttopo.adjacency(N, fed.topology)
    sizes = [len(d["label"]) for d in node_data]

    step, bits, ncls, _, states, scfg = S._wiring(cfg, fed, train, dev,
                                                  plane=False)
    legacy = S.legacy_round(step, [tprofe.stack_states([s]) for s in states],
                            node_data, cfg, scfg, fed, train, adj, sizes,
                            ncls, bits, 0, dev)

    step_p, bits_p, _, _, states_p, _ = S._wiring(cfg, fed, train, dev)
    stacked = tprofe.stack_states(states_p)
    assert isinstance(stacked.student, S.Plane)
    round_fn = S.F._make_round_fn(step_p, scfg, ncls, share_protos=True,
                                  wire_model="student", bits=bits_p)
    xb, valid, pxb, pvalid, av = S._round_inputs(node_data, BATCH, fed, 0,
                                                 dev)
    stacked = round_fn(stacked, xb, valid, pxb, pvalid,
                       *S._gossip(adj, sizes, dev), teacher_on=True,
                       all_valid=av)

    _assert_students_close(
        [[_a(x) for x in tree_leaves(tprofe.node_params(stacked.student, i))]
         for i in range(N)],
        [[_a(x[0]) for x in tree_leaves(s.student)] for s in legacy])
    for i, s in enumerate(legacy):
        for a, b in zip(tree_leaves(tprofe.node_params(stacked.teacher, i)),
                        tree_leaves(s.teacher)):
            np.testing.assert_allclose(_a(a), _a(b[0]), rtol=0, atol=ATOL)
        for key, atol in (("mu", 1e-6), ("nu", 1e-8)):
            for a, b in zip(tree_leaves(s.opt_t[key]),
                            tree_leaves(stacked.opt_t[key])):
                np.testing.assert_allclose(_a(a[0]), _a(b[i]), rtol=0,
                                           atol=atol)
        assert int(s.opt_s["step"][0]) == int(stacked.opt_s["step"][i])
        assert int(s.opt_t["step"][0]) == int(stacked.opt_t["step"][i])
        np.testing.assert_allclose(_a(s.global_protos[0]),
                                   _a(stacked.global_protos[i]), rtol=0,
                                   atol=PROTO_ATOL)
        assert _a(s.proto_mask[0]).tobytes() == \
            _a(stacked.proto_mask[i]).tobytes()
        assert int(s.round_idx[0]) == int(stacked.round_idx[i]) == 1


def _dict_keys(func: str) -> set:
    """The string keys of every dict literal in the JAX script's
    ``func``."""
    fn = next(n for n in ast.walk(ast.parse(JAX_SRC))
              if isinstance(n, ast.FunctionDef) and n.name == func)
    return {k.value for d in ast.walk(fn) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}


def test_main_writes_the_jax_keys(tmp_path, capsys):
    out = tmp_path / "rs.json"
    got = S.main(["--nodes", str(N), "--rounds", "1", "--phases",
                  "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert set(got) == {"benchmark", "backend", "card", "config", "nodes"}
    assert (got["backend"], got["card"]) == ("cpu", None)
    assert set(got["nodes"]) == {str(N)}
    row = got["nodes"][str(N)]
    phases = row.pop("phases")
    assert set(row) == _dict_keys("measure")
    assert set(phases) == _dict_keys("measure_phases")
    for v in list(row.values()) + list(phases.values()):
        assert np.isfinite(v) and v >= 0
    _, _, _, jdata = JR._setup(N, SAMPLES, BATCH)
    assert row["local_steps_per_round"] == sum(
        len(d["label"]) // BATCH for d in jdata) == 8
    assert "speedup" in capsys.readouterr().out


def test_wire_sweep_bytes_match_jax(tmp_path):
    """One spawn of 4 ranks: ``16``, ``4/16+ef`` and the int4 adapter
    row; each row's ``ppermute``, ``packed`` and full-gather bytes the
    JAX package's; every exchange timed."""
    from repro.launch.wire import measure_exchange_bytes as jmeasure
    out = tmp_path / "wire.json"
    got = S.main(["--wire", "--wire-nodes", "4", "--wire-bits", "16",
                  "4/16+ef", "--wire-adapters", "8", "--rounds", "2",
                  "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert got["config"]["timed_rounds"] == 10      # --wire takes >= 10
    rows = got["per_bits"]
    assert list(rows) == ["16", "4/16+ef", "4+adapters8"]
    assert got["per_pods"] == {"4": rows}
    for label, (bits, rank) in (("16", ("16", 0)),
                                ("4/16+ef", ("4/16+ef", 0)),
                                ("4+adapters8", ("4", 8))):
        rep = rows[label]["exchange"]
        want = jmeasure("mnist-cnn", 4, "ring", bits=bits, adapter_rank=rank)
        assert rep["full_gather_bytes_per_node"] == \
            want["full_gather_bytes_per_node"], label
        for ex in ("ppermute", "packed"):
            assert rep["exchanges"][ex]["collective_bytes_per_node"] == \
                want["exchanges"][ex]["collective_bytes_per_node"], (label,
                                                                      ex)
        for ex, entry in rep["exchanges"].items():
            assert entry["round_ms"] > 0, (label, ex)
            # no kernel launches off the card, in the timed rounds either
            assert entry["timed_launches"] == {}, (label, ex)
        assert rep["full_gather_launches"] == {}, label
        codec = rows[label]["codec"]
        assert codec["per_leaf_ms"] > 0 and codec["packed_ms"] > 0
    assert rows["16"]["ppermute_vs_full_gather"] == 0.5   # degree 2 of 4
    assert rows["4+adapters8"]["ppermute_vs_int16"] < 0.05


def test_exchange_entry_times_the_slowest_rank():
    """A round lasts as long as its slowest rank; ``round_ms`` is the
    median of those rounds, and the timed rounds' launches are summed
    over the ranks beside the warm-up's."""
    from repro_torch.launch.wire import _exchange_entry
    records = [{"pod": {}, "inner": {}, "launches": {"rowabs": 1},
                "round_ms": [1.0, 5.0, 2.0], "timed_launches": {"rowabs": 3}},
               {"pod": {}, "inner": {}, "launches": {"rowabs": 1},
                "round_ms": [3.0, 1.0, 2.5], "timed_launches": {"rowabs": 3}}]
    entry = _exchange_entry(records, n_nodes=2, inner=1)
    assert entry["round_ms"] == 3.0              # median of 3, 5 and 2.5
    assert entry["launches"] == {"rowabs": 2}
    assert entry["timed_launches"] == {"rowabs": 6}
    untimed = [{k: v for k, v in r.items()
                if k not in ("round_ms", "timed_launches")} for r in records]
    assert "round_ms" not in _exchange_entry(untimed, n_nodes=2, inner=1)


def _jax_flags() -> dict:
    fn = next(n for n in ast.walk(ast.parse(JAX_SRC))
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for call in ast.walk(fn):
        if isinstance(call, ast.Call) and getattr(
                call.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in call.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw \
                else (False if "action" in kw else None)
            flags[call.args[0].value] = default
    return flags


def test_every_jax_flag_with_its_default():
    want = _jax_flags()
    assert len(want) == 13
    got = {a.option_strings[0]: a.default for a in S.parser()._actions
           if a.option_strings and a.option_strings[0] != "-h"}
    assert set(got) == set(want) | {"--device"}
    for flag, default in want.items():
        if flag == "--out":
            assert (default, got[flag]) == ("BENCH_round_step.json",
                                            "BENCH_torch_round_step.json")
            continue
        assert got[flag] == default, flag
    assert got["--device"] is None


@pytest.mark.parametrize("argv", [
    ["--out", "BENCH_round_step.json"],
    ["--wire", "--out", "BENCH_wire_exchange.json"],
    ["--wire", "--out", "BENCH_round_step.json"],
    ["--out", "reports/BENCH_wire_exchange.json"],
])
def test_jax_report_names_are_refused(argv, capsys):
    with pytest.raises(SystemExit):
        S.main(argv + ["--device", "cpu"])
    assert "JAX package's report" in capsys.readouterr().err


def test_no_card_and_no_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.main(["--nodes", "2", "--out", str(tmp_path / "rs.json")])
