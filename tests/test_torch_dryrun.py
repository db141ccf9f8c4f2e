"""The port's wire audit (``repro_torch.launch.wire``,
``python -m repro_torch.launch.dryrun --topology``) held against the JAX
package's (``repro.launch.wire.measure_exchange_bytes``, which reads the
bytes out of the compiled HLO of its mesh round on 8 virtual CPU
devices) on mnist-cnn, 4 nodes on a ring, one and two ranks a node.

What is compared, and how:

* every prediction key of the report (degree, logical and packed
  bytes, the copy at the spec and at int16, the sidecar), exactly;
* ``ppermute``'s collective bytes a node exactly: 852,120 (16-bit) and
  217,752 (``4/16``) at one rank a node, the pod permute's 852,128 at
  two; ``packed`` and the ``full-gather`` reference at one rank a node
  exactly (1,704,240 at 16-bit: an all-gather counts its gathered
  output);
* ``gather`` and the replicated two-rank ``packed`` against the port's
  own count from the shapes, JAX's number printed beside it (see
  :func:`test_gather_and_replicated_packed_bytes` for why they differ);
* each ``check_*`` gate of the port against JAX's on the same report
  dicts, and on doctored dicts that must raise alike; ``topology_report``
  against JAX's where JAX's gates fail; the CLI end to end on ``4x2``.

The port's ranks are spawned once a measurement (``--device cpu``), so
this file keeps to the few reports it needs, each made once.
"""
import copy
import functools
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ARCH, NODES, TOPO = "mnist-cnn", 4, "ring"
PRED_KEYS = ("degree", "logical_bytes_per_node", "packed_pred_bytes_per_node",
             "packed_copy_bytes", "packed_copy_bytes_int16",
             "packed_sidecar_bytes_per_copy")
ALL = ("gather", "packed", "ppermute")
# name -> (bits, inner, exchanges, adapter rank)
REPORTS = {
    "16": ("16", 1, ALL, 0),
    "4/16": ("4/16", 1, ("packed", "ppermute"), 0),
    "4/16+ef": ("4/16+ef", 1, ("packed", "ppermute"), 0),
    "16/4x2": ("16", 2, ALL, 0),
    "4/16/4x2": ("4/16", 2, ("packed", "ppermute"), 0),
    "adapters8": ("16", 1, ("ppermute",), 8),
}


@functools.lru_cache(maxsize=None)
def port_report(name: str):
    from repro_torch.launch.wire import measure_exchange_bytes
    bits, inner, exchanges, rank = REPORTS[name]
    return measure_exchange_bytes(ARCH, NODES, TOPO, bits=bits,
                                  exchanges=exchanges, inner=inner,
                                  adapter_rank=rank, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_report(name: str):
    from repro.launch.wire import measure_exchange_bytes
    bits, inner, exchanges, rank = REPORTS[name]
    return measure_exchange_bytes(ARCH, NODES, TOPO, bits=bits,
                                  exchanges=exchanges, inner=inner,
                                  adapter_rank=rank)


@pytest.mark.parametrize("name", list(REPORTS))
def test_predictions_match_jax(name):
    got, want = port_report(name), jax_report(name)
    for key in PRED_KEYS:
        assert got[key] == want[key], (name, key)
    assert set(got["exchanges"]) == set(want["exchanges"])


def test_ppermute_bytes_match_jax():
    """The permute's bytes a node, one and two ranks a node."""
    for name, want in (("16", 852120.0), ("4/16", 217752.0),
                       ("4/16+ef", 217752.0), ("adapters8", 98480.0)):
        got = port_report(name)["exchanges"]["ppermute"]
        jax_ = jax_report(name)["exchanges"]["ppermute"]
        assert got["collective_bytes_per_node"] == \
            jax_["collective_bytes_per_node"] == want, name
        assert got["by_kind"] == {"collective-permute": want}, name
        assert got["collective_bytes_per_node"] == \
            port_report(name)["packed_pred_bytes_per_node"]
    for name, want in (("16/4x2", 852128.0), ("4/16/4x2", 220320.0)):
        got = port_report(name)["exchanges"]["ppermute"]
        jax_ = jax_report(name)["exchanges"]["ppermute"]
        assert got["pod_by_kind_per_node"] == {"collective-permute": want}
        assert jax_["pod_by_kind_per_node"]["collective-permute"] == want
        # the port's pod bytes are the permute alone (the dataset sizes
        # are every rank's input, not gathered)
        assert got["collective_bytes_per_node"] == want
        assert set(got["by_axis"]) == {"pod", "data"}
        assert got["by_axis"]["pod"] == {"collective-permute": NODES * want}


def test_packed_and_full_gather_match_jax():
    """One rank a node: the packed all-gather and the full-graph
    reference, counted as their gathered output."""
    for name, want in (("16", 1704240.0), ("4/16", 435504.0),
                       ("4/16+ef", 435504.0)):
        got, jax_ = port_report(name), jax_report(name)
        assert got["exchanges"]["packed"]["collective_bytes_per_node"] == \
            jax_["exchanges"]["packed"]["collective_bytes_per_node"] == want
        assert got["full_gather_bytes_per_node"] == \
            jax_["full_gather_bytes_per_node"] == want
    # the adapter wire has no full-graph reference: both record an error
    assert port_report("adapters8")["full_gather_bytes_per_node"] is None
    assert jax_report("adapters8")["full_gather_bytes_per_node"] is None


def test_gather_and_replicated_packed_bytes(capsys):
    """The port's own counts where the packages move different tensors.

    * ``gather``: the port gathers each leaf's int16 codes, its fp32
      scale, the prototypes' codes and scale and the counts, each over
      the 4 ranks; JAX's compiled gather moves 3,352,000 B a node (its
      reference path gathers wider tensors), which the port does not
      try to match.
    * two ranks a node, ``packed`` and ``full-gather``: each rank runs
      the one-rank-a-node all-gather of the whole copy on its pod group
      (replicated), 2 × 4 × ``packed_copy_bytes``; JAX's multi-axis
      packed path gathers the container-width codes row-sharded, whose
      bytes its audit does not gate (3,408,480 at 16-bit, the same
      number; at ``4/16`` the port moves the spec's bytes and JAX the
      container's)."""
    from repro_torch.core.comm import packed_copy_bytes
    from repro_torch.launch.wire import accountant_payload, student_setup
    from repro_torch.tree import tree_leaves
    from repro_torch.wirespec import WireSpec
    _, scfg, struct, ncls = student_setup(ARCH)
    n_w = sum(int(np.prod(s.shape)) for s in tree_leaves(struct))
    n_leaves = len(tree_leaves(struct))
    per_rank = (n_w + ncls * scfg.proto_dim) * 2 + (n_leaves + 1) * 4 + \
        ncls * 4
    got = port_report("16")["exchanges"]["gather"]
    assert got["collective_bytes_per_node"] == NODES * per_rank
    for name, bits in (("16/4x2", "16"), ("4/16/4x2", "4/16")):
        copy1 = packed_copy_bytes(accountant_payload(
            struct, ncls, scfg.proto_dim), WireSpec.parse(bits))
        rep = port_report(name)
        assert rep["exchanges"]["packed"]["collective_bytes_per_node"] == \
            rep["full_gather_bytes_per_node"] == 2 * NODES * copy1
        print(f"{name}: packed a node, port {2 * NODES * copy1} B, JAX "
              f"{jax_report(name)['exchanges']['packed']}")
    print(f"gather a node: port {NODES * per_rank} B, JAX "
          f"{jax_report('16')['exchanges']['gather']}")
    assert "JAX" in capsys.readouterr().out


def _checks():
    from repro.launch import wire as JW
    from repro_torch.launch import wire as TW
    return JW, TW


def _same(fn_name, args, kwargs):
    """The port's gate and JAX's on deep copies of the same dicts: the
    same verdict, or the same AssertionError."""
    JW, TW = _checks()
    outs = []
    for mod in (TW, JW):
        a = copy.deepcopy(args)
        try:
            outs.append(("ok", getattr(mod, fn_name)(*a, **kwargs)))
        except AssertionError as e:
            outs.append(("raise", str(e)))
    assert outs[0] == outs[1], outs
    return outs[0][0]


def _doctored(rep, path, value):
    out = copy.deepcopy(rep)
    d = out
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value
    return out


def test_check_topology_bytes_like_jax():
    r16, r42 = port_report("16"), port_report("16/4x2")
    cases = [((r16,), dict(exchange="ppermute")),
             ((r16,), dict(exchange="ppermute", gather_frac=0.5)),
             ((r16,), dict(exchange="ppermute", gather_frac=0.6)),
             ((r42,), dict(exchange="ppermute", gather_frac=0.5,
                           exact=True)),
             ((r16,), dict(exchange="packed")),
             ((_doctored(r16, ("exchanges", "ppermute",
                               "collective_bytes_per_node"), 1.2e6),),
              dict(exchange="ppermute")),
             ((_doctored(r42, ("exchanges", "ppermute",
                               "pod_by_kind_per_node"),
                         {"collective-permute": 852127.0}),),
              dict(exchange="ppermute", exact=True)),
             ((_doctored(r16, ("exchanges", "ppermute"),
                         {"error": "ValueError: x"}),),
              dict(exchange="ppermute")),
             ((_doctored(r16, ("full_gather_bytes_per_node",), None),),
              dict(exchange="ppermute", gather_frac=0.6))]
    got = [_same("check_topology_bytes", a, k) for a, k in cases]
    assert got == ["ok", "raise", "ok", "ok", "raise", "raise", "raise",
                   "raise", "raise"]


def test_check_bits_ef_adapter_like_jax():
    r16, r4, ref = port_report("16"), port_report("4/16"), \
        port_report("4/16+ef")
    rad = port_report("adapters8")
    cases = [
        ("check_bits_reduction", (r4, r16), {}),
        ("check_bits_reduction",
         (_doctored(r4, ("exchanges", "ppermute",
                         "collective_bytes_per_node"), 300000.0), r16), {}),
        ("check_bits_reduction", (_doctored(
            r4, ("exchanges", "ppermute"), {"error": "x"}), r16), {}),
        ("check_ef_zero_overhead", (ref, r4), dict(exchange="packed")),
        ("check_ef_zero_overhead", (ref, r4), {}),
        ("check_ef_zero_overhead",
         (_doctored(ref, ("exchanges", "ppermute",
                          "collective_bytes_per_node"), 217753.0), r4), {}),
        ("check_adapter_reduction", (rad, r16), {}),
        ("check_adapter_reduction", (rad, r16), dict(frac=0.1)),
        ("check_adapter_reduction", (rad, r16), dict(frac=None)),
        ("check_adapter_reduction", (r16, r16), {}),
        ("check_adapter_reduction", (rad, rad), {}),
    ]
    got = [_same(fn, a, k) for fn, a, k in cases]
    assert got == ["ok", "raise", "raise", "ok", "ok", "raise", "ok",
                   "raise", "ok", "raise", "raise"]


def test_topology_report_fails_where_jax_fails(monkeypatch):
    """At one rank a node a 4-node ring's permute moves half the full
    gather, not less: both packages' 0.5x gate fails, alike.  The port's
    report is the cached measurement (``measure_exchange_rows``
    patched)."""
    from repro.launch.dryrun import topology_report as jax_topology
    from repro_torch.launch import dryrun as TD
    from repro_torch.launch import wire as TW
    monkeypatch.setattr(TW, "measure_exchange_rows",
                        lambda *a, **k: [copy.deepcopy(port_report("16"))])
    with pytest.raises(AssertionError) as got:
        TD.topology_report(ARCH, TOPO, "4", bits="16", device="cpu")
    with pytest.raises(AssertionError) as want:
        jax_topology(ARCH, TOPO, "4", bits="16")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="multi-axis pods"):
        TD.topology_report(ARCH, TOPO, "4x2", adapters=8, device="cpu")


def test_dryrun_cli_on_4x2(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch mnist-cnn --topology
    ring --pods 4x2 --bits 4/16 --ef --device cpu``: exit 0, the pod
    permute bytes equal to the prediction (220,320), error feedback at
    zero overhead, the int16 reference's ratio; without ``--topology``
    exit 2."""
    from repro_torch.launch import dryrun as TD
    out = tmp_path / "report.json"
    rc = TD.main(["--arch", ARCH, "--topology", TOPO, "--pods", "4x2",
                  "--bits", "4/16", "--ef", "--device", "cpu", "--json",
                  str(out)])
    report = json.loads(out.read_text())
    assert rc == 0, report.get("error")
    assert report["status"] == "ok"
    assert report["packed_pred_bytes_per_node"] == 220320
    checks = {c.get("check", "topology") + "/" + c["exchange"]: c
              for c in report["checks"]}
    assert checks["topology/ppermute"]["permute_bytes_per_node"] == 220320
    assert checks["ef_zero_overhead/ppermute"]["bytes_ef"] == 220320
    assert set(checks) == {"ef_zero_overhead/packed",
                           "ef_zero_overhead/ppermute", "topology/ppermute",
                           "bits_reduction/ppermute"}
    assert TD.main(["--arch", ARCH]) == 2
    assert "--topology" in capsys.readouterr().err
