"""The port's mnist-cnn user scripts on the CPU
(``examples/torch_quickstart.py``, ``benchmarks/torch_ablations.py``)
held against the JAX package's at a tiny size; the CIFAR scripts are in
``tests/test_torch_examples_cifar.py``, the mesh demo and the topology
byte-gate suite in ``tests/test_torch_examples_topo.py``.

* ``ABLATIONS`` equals the JAX script's own, ``setting()`` the same data;
* bytes: every quickstart and ablation run's ``avg_sent_gb`` (4 nodes,
  300 images, 1 round) equals the JAX package's ``run_federation`` on
  the same federation exactly, and every F1 is finite; the 32-bit row
  resolves its wire as the JAX package does;
* ``chip_smoke.py``'s ``EXAMPLE_BYTES`` (every run of its examples
  phase, at the scripts' own defaults) equal the JAX package's
  accountant, itself held to its ``run_federation``;
* the ported scripts import neither ``jax`` nor ``repro`` and raise with
  no card.
"""
import ast
import functools
import math
import sys
import types
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "examples"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch_quickstart as quickstart  # noqa: E402
from benchmarks import torch_ablations as ablations  # noqa: E402

NODES, SAMPLES = 4, 300
SCRIPTS = ("examples/torch_quickstart.py",
           "examples/torch_dfl_noniid_cifar.py",
           "examples/torch_topology_sweep.py",
           "examples/torch_mesh_federation_demo.py",
           "benchmarks/torch_ablations.py",
           "benchmarks/torch_dryrun_topo.py",
           "benchmarks/torch_table2_comm.py",
           "benchmarks/torch_table3_time.py",
           "benchmarks/torch_fig2_f1.py",
           "benchmarks/torch_run.py")
# the paper scripts have no run() of the user scripts' form: their
# main(argv) at its defaults resolves the device before any work
PAPER_SCRIPTS = SCRIPTS[-4:]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_scripts_import_neither_jax_nor_repro():
    files = sorted((ROOT / "examples").glob("torch_*.py")) + \
        sorted((ROOT / "benchmarks").glob("torch_*.py"))
    assert {str(f.relative_to(ROOT)) for f in files} >= set(SCRIPTS)
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_raise_without_a_card(script):
    """``run()`` (a paper script's ``main([])``) resolves its device
    first: with no card and no ``device="cpu"`` it raises before any
    work."""
    import importlib
    folder, name = script[:-3].split("/")
    mod = importlib.import_module(
        f"benchmarks.{name}" if folder == "benchmarks" else name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([]) if script in PAPER_SCRIPTS else mod.run()


# -- the tables -----------------------------------------------------------------

def test_ablations_table_and_setting_equal_jax():
    from benchmarks.ablations import ABLATIONS, setting
    assert ablations.ABLATIONS == ABLATIONS
    assert list(ablations.ABLATIONS) == list(ABLATIONS)
    jcfg, jnodes, jtest = setting(n_nodes=3, n=120, split="noniid40")
    tcfg, tnodes, ttest = ablations.setting(n_nodes=3, n=120,
                                            split="noniid40")
    assert tcfg.name == jcfg.name
    for a, b in zip(tnodes + [ttest], jnodes + [jtest]):
        assert set(a) == set(b)
        for k in a:
            assert (a[k] == b[k]).all(), k

# -- bytes against the JAX package's run_federation --------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(algo: str, overrides=()):
    """The JAX package's run_federation on the scripts' mnist-cnn
    federation at the test's size (quickstart's ProFe is the paper
    ablation row)."""
    from benchmarks.ablations import setting

    from repro.config import FederationConfig, TrainConfig
    from repro.core.federation import run_federation
    cfg, node_data, test_d = setting(n_nodes=NODES, n=SAMPLES)
    train = TrainConfig(batch_size=64, learning_rate=1e-3,
                        optimizer="adamw", remat=False)
    fed = FederationConfig(num_nodes=NODES, rounds=1, algorithm=algo,
                           split="iid", **dict(overrides))
    return run_federation(cfg, fed, train, node_data, test_d)


@functools.lru_cache(maxsize=None)
def _port_ablations():
    return ablations.run(rounds=1, n_nodes=NODES, n=SAMPLES, device="cpu")


def test_quickstart_bytes_equal_jax():
    out = quickstart.run(rounds=1, samples=SAMPLES, device="cpu")
    assert sum(out["node_sizes"]) == 270
    for algo in quickstart.ALGORITHMS:
        got = out[algo]
        assert len(got["f1"]) == 1 and math.isfinite(got["f1"][0])
        assert got["avg_sent_gb"] == \
            _jax_run(algo).extras["avg_sent_gb"], algo
    assert out["reduction"] == pytest.approx(
        1 - _jax_run("profe").extras["avg_sent_gb"]
        / _jax_run("fedavg").extras["avg_sent_gb"])
    # quickstart's ProFe is the paper row of the ablations at this size
    assert out["profe"]["avg_sent_gb"] == \
        _port_ablations()["paper (16-bit, decay, protos)"]["avg_sent_gb"]


@pytest.mark.parametrize("name", list(ablations.ABLATIONS))
def test_ablation_bytes_equal_jax(name):
    row = _port_ablations()[name]
    want = _jax_run("profe", tuple(sorted(
        ablations.ABLATIONS[name].items())))
    assert row["avg_sent_gb"] == want.extras["avg_sent_gb"]
    assert row["mb_per_node"] == row["avg_sent_gb"] * 1e3
    assert len(row["f1_curve"]) == 1 and math.isfinite(row["f1"])


def test_32bit_ablation_resolves_as_jax():
    """``quantize_bits=32`` is the uniform 32-bit codec in both packages
    (``wirespec.resolve_bits``), not the raw fp32 wire: its codes are
    twice the 16-bit row's, the counts and scales the same."""
    from repro import wirespec as JW
    from repro_torch import wirespec as TW
    for bits in (32, TW.WireSpec.from_bits(32)):
        assert TW.resolve_bits(bits) == 32
    assert JW.resolve_bits(JW.WireSpec.from_bits(32)) == 32
    assert TW.WireSpec.from_bits(32).describe() == \
        JW.WireSpec.from_bits(32).describe() == "int32"
    rows = _port_ablations()
    b16 = rows["paper (16-bit, decay, protos)"]["avg_sent_gb"]
    assert b16 < rows["32-bit wire"]["avg_sent_gb"] < 2 * b16


# -- chip_smoke.py's EXAMPLE_BYTES -----------------------------------------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_sent_gb(model, algo, nodes, topology, rounds, **fed_kw):
    """``avg_sent_gb`` of a JAX ``run_federation`` from its own wiring and
    accountant alone: ``_algo_wiring``'s payload template (shape
    skeletons) metered every round on the run's schedule."""
    import jax

    from repro.config import FederationConfig, TrainConfig, get_config
    from repro.core import federation as JF
    from repro.core import topology as JT
    from repro.core.comm import ScheduleCommAccountant
    from repro.models import derive_student, init_params
    from repro.optim import make_optimizer
    cfg = get_config(model)
    fed = FederationConfig(num_nodes=nodes, rounds=rounds, algorithm=algo,
                           topology=topology, **fed_kw)
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
    meter = ScheduleCommAccountant(JT.make_schedule(nodes, topology,
                                                    rounds=rounds,
                                                    seed=fed.seed))
    for r in range(rounds):
        meter.record_round(payload, algo, r, bits)
    return meter.avg_sent_gb()


def test_jax_sent_gb_is_run_federations():
    """The accountant helper gives what the JAX run reports."""
    for algo, ov in (("profe", ()), ("fedavg", ()),
                     ("profe", (("quantize_bits", 32),))):
        assert jax_sent_gb("mnist-cnn", algo, NODES, "full", 1,
                           **dict(ov)) == \
            _jax_run(algo, ov).extras["avg_sent_gb"]


def _example_runs():
    """Every run the examples phase holds: name -> (model, algorithm,
    nodes, topology, rounds, FederationConfig overrides), at the JAX
    scripts' defaults."""
    runs = {f"quickstart/{a}": ("mnist-cnn", a, 4, "full", 3, {})
            for a in ("profe", "fedavg")}
    runs.update({f"dfl/{a}": ("cifar10-resnet18", a, 3, "full", 2,
                              {"split": "noniid40"})
                 for a in ("profe", "fedproto", "fedavg")})
    runs.update({f"sweep/{t}": ("cifar10-resnet18", "profe", 4, t, 2, {})
                 for t in ("full", "ring", "dynamic:ring,star",
                           "random-k2")})
    runs.update({f"ablations/{n}": ("mnist-cnn", "profe", 4, "full", 3, ov)
                 for n, ov in ablations.ABLATIONS.items()})
    return runs


def test_chip_smoke_example_bytes_equal_jax():
    smoke = _chip_smoke()
    runs = _example_runs()
    assert set(smoke.EXAMPLE_BYTES) == set(runs)
    for name, (model, algo, nodes, topology, rounds, ov) in runs.items():
        assert smoke.EXAMPLE_BYTES[name] == jax_sent_gb(
            model, algo, nodes, topology, rounds, **ov), name
    assert set(smoke.EXAMPLES) == {"quickstart", "dfl", "sweep",
                                   "mesh-demo", "ablations"}
    assert smoke.TOPO_CMD[:2] == ("-m", "benchmarks.torch_dryrun_topo")
