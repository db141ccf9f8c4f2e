"""The port's CIFAR user scripts on the CPU
(``examples/torch_dfl_noniid_cifar.py``,
``examples/torch_topology_sweep.py``) held against the JAX package's at
a tiny size (cifar10-resnet18 at full width, a few hundred images, 1
round).

* the non-iid driver: the nodes' sample counts and classes are the JAX
  split's; ProFe's, FedProto's and FedAvg's ``avg_sent_gb`` equal the
  JAX package's accountant on the same federation (a JAX CIFAR run
  costs minutes of XLA compiling on the CPU), the accountant held to
  JAX's ``run_federation`` for FedProto here and for ProFe and FedAvg
  in ``tests/test_torch_examples.py``; every F1 is finite;
* the topology sweep: each topology's bytes equal the JAX accountant's on
  its schedule, a two-phase schedule skips the physical bytes, and the
  ring's physical ``ppermute`` bytes (spawned ranks) equal the audit's
  prediction; each script's CLI hands its flags to ``run``.
"""
import math
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "examples"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch_dfl_noniid_cifar as dfl  # noqa: E402
import torch_topology_sweep as sweep  # noqa: E402
from test_torch_examples import jax_sent_gb  # noqa: E402

MODEL = "cifar10-resnet18"
DFL = dict(split="noniid40", nodes=2, rounds=1, samples=100)
SWEEP = dict(topologies=("ring", "dynamic:ring,star"), bits=("4/16+ef",),
             nodes=4, rounds=1, samples=160)


def test_dfl_noniid_bytes_and_split_equal_jax():
    from repro.config import get_config
    from repro.data import make_image_dataset, partition, train_test_split
    out = dfl.run(device="cpu", **DFL)
    cfg = get_config(MODEL)
    data = make_image_dataset(0, DFL["samples"], cfg.input_hw,
                              cfg.num_classes)
    train_d, test_d = train_test_split(data, 0.1, 0)
    parts = partition(train_d["label"], DFL["nodes"], DFL["split"], 0)
    assert out["nodes"] == [
        {"samples": len(p),
         "classes": sorted(set(train_d["label"][p].tolist()))}
        for p in parts]
    for algo in dfl.ALGORITHMS:
        got = out[algo]
        assert len(got["f1"]) == 1 and math.isfinite(got["f1"][0]), algo
        assert got["avg_sent_gb"] == jax_sent_gb(
            MODEL, algo, DFL["nodes"], "full", DFL["rounds"],
            split=DFL["split"]), algo


def test_fedproto_bytes_equal_jax_run_federation():
    """FedProto (prototypes only on the wire) through both packages'
    ``run_federation`` on the quickstart's mnist-cnn federation (4 nodes,
    300 images, 1 round): the port's bytes, JAX's and JAX's accountant
    agree exactly."""
    from benchmarks.ablations import setting as jax_setting
    from benchmarks.torch_ablations import setting

    from repro.config import FederationConfig as JFed
    from repro.config import TrainConfig as JTrain
    from repro.core.federation import run_federation as jax_run
    from repro_torch.config import FederationConfig, TrainConfig
    from repro_torch.core.federation import run_federation
    kw = dict(num_nodes=4, rounds=1, algorithm="fedproto")
    tkw = dict(batch_size=64, optimizer="adamw", remat=False)
    got = run_federation(*_fed_args(setting, FederationConfig(**kw),
                                    TrainConfig(**tkw)), device="cpu")
    want = jax_run(*_fed_args(jax_setting, JFed(**kw), JTrain(**tkw)))
    assert math.isfinite(got.f1_per_round[0])
    assert got.extras["avg_sent_gb"] == want.extras["avg_sent_gb"] == \
        jax_sent_gb("mnist-cnn", "fedproto", 4, "full", 1)


def _fed_args(setting, fed, train):
    cfg, node_data, test_d = setting(n_nodes=4, n=300)
    return cfg, fed, train, node_data, test_d


def test_dfl_refuses_an_unknown_split():
    with pytest.raises(ValueError, match="split must be one of"):
        dfl.run(split="noniid10", device="cpu")


def test_topology_sweep_bytes_equal_jax_and_the_audit():
    from repro_torch.wirespec import WireSpec
    out = sweep.run(device="cpu", **SWEEP)
    spec = WireSpec.parse(SWEEP["bits"][0])
    runs = {e["topology"]: e for e in out["runs"]}
    assert list(runs) == list(SWEEP["topologies"])
    for topo, entry in runs.items():
        assert entry["bits"] == spec.describe()
        assert len(entry["f1"]) == 1 and math.isfinite(entry["f1"][0])
        assert entry["avg_sent_gb"] == jax_sent_gb(
            MODEL, "profe", SWEEP["nodes"], topo, SWEEP["rounds"],
            quantize_bits=spec.student_bits,
            proto_quantize_bits=spec.proto_bits,
            error_feedback=spec.error_feedback), topo
    ring, dyn = runs["ring"], runs["dynamic:ring,star"]
    assert dyn["phases"] == 2 and "physical" not in dyn
    assert ring["phases"] == 1 and ring["edges"] == [8]
    rep = ring["physical"]
    perm = rep["exchanges"]["ppermute"]
    assert perm["collective_bytes_per_node"] == \
        rep["packed_pred_bytes_per_node"] == 2 * rep["packed_copy_bytes"]
    # a regular graph: the logical bytes a node a round are the run's
    assert rep["logical_bytes_per_node"] * SWEEP["rounds"] / 1e9 == \
        ring["avg_sent_gb"]


@pytest.mark.parametrize("script,argv,want", [
    (dfl, [], ("noniid40", 3, 2, 1200)),
    (dfl, ["--split", "dirichlet", "--nodes", "2", "--rounds", "1",
           "--samples", "90"], ("dirichlet", 2, 1, 90)),
    (sweep, [], (list(sweep.TOPOLOGIES), ["16"], 4, 2, 1200)),
    (sweep, ["--topologies", "ring", "--bits", "4/16+ef", "8",
             "--nodes", "3", "--no-physical"],
     (["ring"], ["4/16+ef", "8"], 3, 2, 1200)),
])
def test_cli_hands_its_flags_to_run(monkeypatch, script, argv, want):
    """The JAX scripts' flags and defaults, plus ``--device``."""
    seen = []
    monkeypatch.setattr(script, "run",
                        lambda *a, **kw: seen.append((a, kw)) or {})
    script.main(argv + ["--device", "cpu"])
    (args, kw), = seen
    assert args == want
    assert kw["device"] == "cpu" and kw["verbose"] is True
    if script is sweep:
        assert kw["physical"] is ("--no-physical" not in argv)
