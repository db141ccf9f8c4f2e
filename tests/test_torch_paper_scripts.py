"""The port's paper scripts (``benchmarks/torch_{table2_comm,table3_time,
fig2_f1,run}.py``) held against the JAX package's on the CPU.

* Table II at mnist-cnn, N = 4, 2 rounds equals the committed
  ``reports/table2_comm.json`` exactly; ``logical_wire`` equals JAX's on
  the three paper datasets at bits 16 / 8 / 4 / 4/16 and on the
  adapter-rank wire (accountant only);
* fig2's wire-spec helpers and its job list (row names and every
  ``FederationConfig`` a row runs, for the flag sets of ``FIG2_FLAGS``)
  equal JAX's; the scripts' node splits equal JAX's ``partition``;
* one ``torch_fig2_f1.run`` (2 nodes, 1 round, ProFe at ``16`` and
  ``4/16+ef``) against JAX's ``fig2_f1.run`` at the same arguments on a
  float32 mnist-cnn cut to channels (4, 8) and 16-dim prototypes, the
  port from JAX's carried initial weights: bytes exactly and, as
  ``tests/test_torch_examples_ablations.py`` holds its rows from carried
  weights, every F1 (node mean and per node) exactly;
* Table III's ``overlap="none"`` F1 and final state equal the sequential
  driver's bit for bit, the report's keys are the committed JAX
  report's, and ``--stale-floor`` merges into the port's own ``--out``,
  reading no other file;
* ``chip_smoke.py``'s ``PAPER_BYTES`` and ``PAPER_PPERMUTE`` equal the
  JAX package's accountant and committed report; ``torch_run.py``
  renders ``roofline`` from the sweep's reports (skipped without them)
  and drives the three scripts' ``main(argv)``.
"""
import builtins
import dataclasses
import functools
import json
import math
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import fig2_f1 as jfig2  # noqa: E402
from benchmarks import table2_comm as jtable2  # noqa: E402
from benchmarks import torch_fig2_f1 as fig2  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from benchmarks import torch_table2_comm as table2  # noqa: E402
from benchmarks import torch_table3_time as table3  # noqa: E402
from repro.config import base as jbase  # noqa: E402
from repro.core import federation as JF  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim import plane as jplane  # noqa: E402
from repro_torch.config import base as tbase  # noqa: E402
from repro_torch.core import federation as TF  # noqa: E402
from repro_torch.core import profe as tprofe  # noqa: E402

torch.set_num_threads(2)

DATASETS = ("mnist-cnn", "cifar10-resnet18", "cifar100-resnet32")
WIRES = {"16": {}, "8": {}, "4": {}, "4/16": {},
         "16/adapters8": {"adapter_rank": 8},
         "16/adapters8+grams": {"adapter_rank": 8, "adapter_grams": True}}
FIG2_FLAGS = {"bits+ef": ["--bits", "16", "4", "4/16", "--ef"],
              "proto-pass": ["--proto-pass", "both"],
              "proto-ema": ["--proto-ema", "0.5"],
              "adapter-rank": ["--adapter-rank", "8"]}
SPLITS = ("iid", "noniid40", "dirichlet")
JAX_TABLE2 = json.loads((ROOT / "reports" / "table2_comm.json").read_text())
JAX_TABLE3 = json.loads((ROOT / "reports" / "table3_time.json").read_text())


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- Table II -------------------------------------------------------------------

def test_table2_equals_the_jax_report():
    rows = table2.measure("mnist-cnn", nodes=4, rounds=2, device="cpu")
    want = JAX_TABLE2["mnist-cnn"]
    assert list(rows) == table2.ALGOS == jtable2.ALGOS
    for algo in table2.ALGOS:
        for key in ("sent_gb", "received_gb", "pct_vs_fedavg"):
            assert rows[algo][key] == want[algo][key], (algo, key)
    assert table2.PAPER_ROUNDS == jtable2.PAPER_ROUNDS


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("dataset", DATASETS)
def test_logical_wire_equals_jax(dataset, wire):
    bits, kw = wire.split("/adapters")[0], WIRES[wire]
    got = table2.logical_wire(dataset, 4, "full", bits=bits, **kw)
    want = jtable2.logical_wire(dataset, 4, "full", bits=bits, **kw)
    assert got == want


def test_exchange_labels_cover_the_audits_exchanges():
    """Every exchange the audit runs is labelled; only ``ppermute`` is
    presented as the JAX package's bytes."""
    import inspect

    from repro_torch.launch.wire import measure_exchange_bytes
    default = inspect.signature(measure_exchange_bytes) \
        .parameters["exchanges"].default
    assert set(table2.EXCHANGE_COUNTS) == set(default)
    assert [ex for ex, what in table2.EXCHANGE_COUNTS.items()
            if "the port's count" not in what] == ["ppermute"]


# -- Fig. 2: the wire-spec helpers and the job list --------------------------------

@pytest.mark.parametrize("spec", ["16", "8", "4", "4/16", "4+ef", "4/16+ef",
                                  "4/16,adapters=8,grams=16", "4/8+ef"])
def test_fig2_wire_helpers_equal_jax(spec):
    assert fig2._bits_fed_kwargs(spec) == jfig2._bits_fed_kwargs(spec)
    assert fig2._sub_int16(spec) == jfig2._sub_int16(spec)


@pytest.mark.parametrize("spec", ["4/16,model=8", "4/16,bogus=8"])
def test_fig2_spec_typo_raises_as_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jfig2._bits_fed_kwargs(spec)
    with pytest.raises(ValueError) as terr:
        fig2._bits_fed_kwargs(spec)
    assert str(terr.value) == str(jerr.value)


def _stub_result():
    return types.SimpleNamespace(
        f1_per_round=[0.5], elapsed_s=0.0,
        extras={"avg_sent_gb": 0.0, "f1_std_per_round": [0.0]})


def _fig2_jobs(monkeypatch, tmp_path, flags):
    """Both packages' ``main`` on ``flags`` (one split) with their
    ``run_federation`` recorded: (the report's row names, each run's
    ``FederationConfig`` fields and keywords), per package."""
    calls = {"jax": [], "port": []}

    def recorder(who):
        def run_federation(cfg, fed, train, node_data, test_d, **kw):
            kw.pop("device", None)
            calls[who].append((cfg.name, dataclasses.asdict(fed),
                               dataclasses.asdict(train), kw,
                               [len(n["label"]) for n in node_data]))
            return _stub_result()
        return run_federation
    monkeypatch.setattr(jfig2, "run_federation", recorder("jax"))
    monkeypatch.setattr(fig2, "run_federation", recorder("port"))
    argv = flags + ["--splits", "iid"]
    monkeypatch.setattr(sys, "argv", ["fig2_f1", *argv, "--out",
                                      str(tmp_path / "jax.json")])
    jfig2.main()
    fig2.main(argv + ["--out", str(tmp_path / "port.json"),
                      "--device", "cpu"])
    rows = {who: json.loads((tmp_path / f"{who}.json").read_text())
            for who in ("jax", "port")}
    return rows, calls


@pytest.mark.parametrize("flags", list(FIG2_FLAGS))
def test_fig2_jobs_equal_jax(monkeypatch, tmp_path, flags):
    rows, calls = _fig2_jobs(monkeypatch, tmp_path, FIG2_FLAGS[flags])
    assert list(rows["port"]) == list(rows["jax"])
    for key in rows["jax"]:
        assert list(rows["port"][key]) == list(rows["jax"][key])
        for name, row in rows["jax"][key].items():
            assert rows["port"][key][name].keys() == row.keys(), name
    assert calls["port"] == calls["jax"]
    assert all(c[3] == {"verbose": False, "eval_all_nodes": True}
               for c in calls["port"])
    names = list(rows["port"]["mnist-cnn/iid"])
    assert {"bits+ef": "profe@4+ef", "proto-pass": "profe@16+fused",
            "proto-ema": "fedproto+ema",
            "adapter-rank": "profe"}[flags] in names


@pytest.mark.parametrize("split", SPLITS)
def test_node_splits_equal_jax(split):
    """The scripts' federation (``data.image_federation``) is JAX's
    ``make_image_dataset`` → ``train_test_split`` → ``partition``."""
    from repro.data import make_image_dataset, partition, train_test_split
    from repro_torch.config import get_config
    from repro_torch.data import image_federation
    cfg = get_config("mnist-cnn")
    for nodes, n in ((4, 2400), (3, 900)):
        data = make_image_dataset(0, n, cfg.input_hw, cfg.num_classes)
        train_d, test_d = train_test_split(data, 0.1, 0)
        parts = partition(train_d["label"], nodes, split, 0)
        got, got_test = image_federation(cfg, n, nodes, split, 0)
        assert len(got) == nodes
        for part, node in zip(parts, got):
            for k, v in train_d.items():
                assert np.array_equal(node[k], v[part]), (nodes, k)
        for k, v in test_d.items():
            assert np.array_equal(got_test[k], v), k


# -- Fig. 2: one run against JAX's from carried weights ------------------------------

def _jcfg():
    return jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32")


def _carried(jcfg, jfed, jtrain):
    """JAX's own initial states for ``jfed``, carried over as the
    port's."""
    scfg = jmodel.derive_student(jcfg)
    plane = JF._plane_mode(jfed, jtrain, "profe", scfg)
    opt_t = jmake_optimizer(jtrain.optimizer, jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    opt_s = jplane.make_plane_optimizer(
        jtrain.optimizer, jtrain.learning_rate, grad_clip=jtrain.grad_clip,
        weight_decay=jtrain.weight_decay)
    assert plane
    states = JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t,
                             jcfg.num_classes, plane=plane)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return [tprofe.node_state_from_numpy(
        tree(jplane.as_tree(s.student)), tree(s.teacher), tree(s.opt_s),
        tree(s.opt_t), np.asarray(s.global_protos),
        np.asarray(s.proto_mask), int(s.round_idx), plane=plane,
        device="cpu") for s in states]


@functools.lru_cache(maxsize=None)
def _fig2_pair():
    jcfg = _jcfg()
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    kw = dict(nodes=2, rounds=1, epochs=1, n_samples=300, algos=["profe"],
              bits=("16", "4/16+ef"))
    real_run = TF.run_federation

    def carried_run(cfg, fed, train, node_data, test_d, **kw_):
        jfed = jbase.FederationConfig(**dataclasses.asdict(fed))
        jtrain = jbase.TrainConfig(**dataclasses.asdict(train))
        return real_run(cfg, fed, train, node_data, test_d,
                        initial_states=_carried(jcfg, jfed, jtrain), **kw_)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jfig2, "get_config", lambda name: jcfg)
        m.setattr(fig2, "get_config", lambda name: tcfg)
        m.setattr(fig2, "run_federation", carried_run)
        want = jfig2.run("mnist-cnn", "iid", **kw)
        got = fig2.run("mnist-cnn", "iid", device="cpu", **kw)
    return got, want


BYTE_KEYS = ("avg_sent_gb", "wire_bytes_per_copy",
             "wire_bytes_packed_per_copy", "avg_sent_packed_gb")


@pytest.mark.parametrize("row", ["profe@16", "profe@4/16+ef"])
def test_fig2_run_equals_jax(row):
    got, want = _fig2_pair()
    assert list(got) == list(want) == ["profe@16", "profe@4/16+ef"]
    g, w = got[row], want[row]
    assert g.keys() == w.keys()
    for key in BYTE_KEYS + ("bits", "proto_pass"):
        assert g[key] == w[key], key
    assert len(g["f1_per_round"]) == 1 and \
        all(math.isfinite(f) for f in g["f1_per_round"])
    # from carried weights every F1 is JAX's exactly
    assert g["f1_per_round"] == w["f1_per_round"]
    assert g["f1_per_round_nodes"] == w["f1_per_round_nodes"]
    assert g["f1_std_per_round"] == w["f1_std_per_round"]


def test_fig2_ef_row_has_the_stateless_bytes():
    got, _ = _fig2_pair()
    for key in BYTE_KEYS:
        assert got["profe@16"][key] > got["profe@4/16+ef"][key] > 0


# -- Table III ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _overlap():
    """``measure_overlap`` at 2 nodes, 2 rounds, 300 images, each run's
    unrounded F1 and final state recorded."""
    runs = []
    real = table3.run_federation

    def recording(*a, **kw):
        res = real(*a, **kw)
        runs.append((kw.get("overlap"), list(res.f1_per_round), res.state))
        return res
    with pytest.MonkeyPatch.context() as m:
        m.setattr(table3, "run_federation", recording)
        out = table3.measure_overlap("mnist-cnn", nodes=2, rounds=2,
                                     n_samples=300, device="cpu")
    return out, runs


def _leaves(state):
    from repro_torch.tree import keyed_leaves
    return keyed_leaves(state)


def test_overlap_none_is_sequential_bit_for_bit():
    out, runs = _overlap()
    assert [r[0] for r in runs] == [None, "none", "rounds"]
    (_, f1_seq, st_seq), (_, f1_none, st_none) = runs[:2]
    assert f1_none == f1_seq and all(math.isfinite(f) for f in f1_seq)
    a, b = _leaves(st_seq), _leaves(st_none)
    assert [k for k, _ in a] == [k for k, _ in b] and len(a) > 0
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(a, b))
    assert out["none"]["f1_final_abs_diff"] == 0.0
    assert out["none"]["f1_per_round"] == out["sequential"]["f1_per_round"]


def test_overlap_report_keys_equal_jax():
    out, _ = _overlap()
    want = JAX_TABLE3["mnist-cnn"]["full"]["overlap"]
    assert list(out) == ["sequential", "none", "rounds"]
    for mode, row in out.items():
        assert set(row) == set(want[mode]), mode
        assert len(row["f1_per_round"]) == len(row["round_times_s"]) == 2


def test_table3_rows_keys_equal_jax():
    rows = table3.measure("mnist-cnn", nodes=2, rounds=1, n_samples=300,
                          device="cpu")
    want = JAX_TABLE3["mnist-cnn"]["full"]
    assert list(rows) == table3.ALGOS
    for algo in table3.ALGOS:
        assert set(rows[algo]) == set(want[algo]), algo
    assert rows["fedavg"]["pct_vs_fedavg"] == 0.0
    assert all(math.isfinite(r["pct_vs_fedavg"]) for r in rows.values())


def test_stale_floor_merges_into_the_ports_own_report(monkeypatch,
                                                      tmp_path):
    out = tmp_path / "port_table3.json"
    seq = {"elapsed_s": 1.0, "median_round_s": 0.5,
           "round_times_s": [0.5, 0.5], "f1_per_round": [0.1, 0.2]}
    out.write_text(json.dumps({"mnist-cnn": {"full": {
        "fedavg": {"elapsed_s": 1.0}, "overlap": {"sequential": seq}}}}))
    opened = []
    real_open = builtins.open

    def watched(path, *a, **kw):
        opened.append(Path(path).resolve())
        return real_open(path, *a, **kw)
    monkeypatch.setattr(builtins, "open", watched)
    table3.main(["--stale-floor", "0.5", "--out", str(out),
                 "--device", "cpu"])
    monkeypatch.setattr(builtins, "open", real_open)
    assert set(opened) == {out.resolve()}
    report = json.loads(out.read_text())["mnist-cnn"]["full"]
    assert report["fedavg"] == {"elapsed_s": 1.0}
    assert report["overlap"]["sequential"] == seq
    row = report["overlap"]["rounds+floor"]
    want = JAX_TABLE3["mnist-cnn"]["full"]["overlap"]["rounds+floor"]
    assert set(row) == set(want) and row["stale_self_floor"] == 0.5
    assert row["f1_final_abs_diff"] == round(
        abs(row["f1_per_round"][-1] - 0.2), 4)


@pytest.mark.parametrize("script,name", [
    (table2, "table2_comm.json"), (table3, "table3_time.json"),
    (fig2, "fig2_f1.json"), (fig2, "fig2_f1_bits_ef.json")])
def test_scripts_refuse_a_jax_report(script, name):
    with pytest.raises(SystemExit):
        script.main(["--out", str(ROOT / "reports" / name),
                     "--device", "cpu"])


# -- chip_smoke.py's paper constants -----------------------------------------------

def _jax_bytes(model, algo, nodes, rounds):
    """``(avg_sent_gb, avg_received_gb)`` of a JAX ``run_federation``
    from its own wiring and accountant alone (full graph)."""
    from repro.config import FederationConfig, TrainConfig, get_config
    from repro.core import topology as JT
    from repro.core.comm import ScheduleCommAccountant
    from repro.models import derive_student, init_params
    from repro.optim import make_optimizer
    cfg = get_config(model)
    fed = FederationConfig(num_nodes=nodes, rounds=rounds, algorithm=algo)
    opt = make_optimizer("adamw", 1e-3)
    _, wire_model, share, bits, cfgs = JF._algo_wiring(
        algo, cfg, derive_student(cfg), fed, TrainConfig(), opt, opt,
        jit=False)
    student = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((nodes,) + x.shape, x.dtype),
        jax.eval_shape(lambda: init_params(cfgs[1], jax.random.PRNGKey(0))))
    payload = JF._payload_template(wire_model, share,
                                   types.SimpleNamespace(student=student),
                                   JF._n_proto_classes(cfg),
                                   cfgs[1].proto_dim)
    meter = ScheduleCommAccountant(JT.make_schedule(nodes, "full",
                                                    rounds=rounds,
                                                    seed=fed.seed))
    for r in range(rounds):
        meter.record_round(payload, algo, r, bits)
    return meter.avg_sent_gb(), meter.avg_received_gb()


def test_chip_smoke_paper_bytes_equal_jax():
    smoke = _chip_smoke()
    runs = {f"{s}/{d}/{a}": (d, a, n, r)
            for s, d, n, r in (("table2", "mnist-cnn", 4, 2),
                               ("table2", "cifar100-resnet32", 4, 2),
                               ("fig2", "mnist-cnn", 4, 3))
            for a in table2.ALGOS}
    assert set(smoke.PAPER_BYTES) == set(runs)
    for name, (model, algo, nodes, rounds) in runs.items():
        assert smoke.PAPER_BYTES[name] == _jax_bytes(model, algo, nodes,
                                                     rounds), name
    for algo in table2.ALGOS:
        got = smoke.PAPER_BYTES[f"table2/mnist-cnn/{algo}"]
        want = JAX_TABLE2["mnist-cnn"][algo]
        assert got == (want["sent_gb"], want["received_gb"])


def test_chip_smoke_paper_ppermute_equals_the_jax_report():
    smoke = _chip_smoke()
    wire = JAX_TABLE2["mnist-cnn"]["wire_bits"]
    assert smoke.PAPER_PPERMUTE == {
        b: wire[b]["exchanges"]["ppermute"]["collective_bytes_per_node"]
        for b in smoke.PAPER_PPERMUTE}
    assert smoke.PAPER_PPERMUTE["16"] == 1278180
    assert set(smoke.PAPER_PPERMUTE) == {"16", "4/16"}


# -- torch_run.py --------------------------------------------------------------------

def test_run_refuses_roofline(tmp_path, monkeypatch, capsys):
    # the compile-report sweep is ported: roofline renders its reports
    # where they exist and is skipped where they do not; an unknown name
    # is still refused
    monkeypatch.chdir(tmp_path)
    assert torch_run.main(["--only", "roofline"]) == {}
    assert "roofline_table,skipped" in capsys.readouterr().out
    out = tmp_path / torch_run.ROOFLINE_REPORTS
    out.mkdir(parents=True)
    (out / "a.json").write_text(json.dumps({
        "arch": "yi-6b", "shape": "decode_32k", "mesh": "pod1",
        "status": "ok", "dominant": "memory", "useful_flops_ratio": 0.5,
        "terms_s": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.0},
        "memory_analysis": {"fits_80gb_hbm": True}}))
    reports = torch_run.main(["--only", "roofline"])
    assert "| yi-6b | decode_32k |" in reports["roofline"]["pod1"]
    with pytest.raises(SystemExit) as err:
        torch_run.main(["--only", "bogus"])
    assert err.value.code == 2


def test_run_drives_each_scripts_main(monkeypatch, capsys):
    called = []
    for key, (module, _) in torch_run.SCRIPTS.items():
        mod = sys.modules[f"benchmarks.{module}"]
        monkeypatch.setattr(mod, "main",
                            lambda argv, key=key: called.append((key, argv))
                            or {"report": key})
    reports = torch_run.main(["--full", "--only", "table3", "fig2",
                              "--device", "cpu"])
    assert called == [("fig2", ["--full", "--device", "cpu"]),
                      ("table3", ["--full", "--device", "cpu"])]
    assert reports == {"fig2": {"report": "fig2"},
                       "table3": {"report": "table3"}}
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,seconds,artifact"
    assert [ln.split(",")[0] for ln in lines[1:]] == \
        ["fig2_f1", "table3_time", "total"]
    assert lines[1].endswith(",reports/torch_fig2_f1.json")
