"""The port's multi-node exchange against the JAX package's rounds on
``fed_mesh(4)``: FedAvg, ProFe with a per-leaf student tree, the per-leaf
reference exchange, and an LM student's plane (mamba2-130m); the port's
rounds on 4 gloo ranks, spawned once for this file; and
``chip_smoke.py``'s mesh paths.

The helpers and the tolerances, with their reasons, are in
``tests/torch_mesh_rest_helpers.py``.
"""
import numpy as np
import pytest
import torch

from torch_mesh_rest_helpers import (FEDAVG, N, PROFE, _adjacency, _chip_smoke,
                                     _close, _fedavg_bytes, _jax_profe,
                                     _jax_student, _jax_template, _jflat,
                                     _profe_bytes, _protos_np, _specs,
                                     _student_np, spawn_ranks)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    return spawn_ranks(tmp_path_factory, ("fedavg", "profe"))


@pytest.mark.parametrize("name", list(FEDAVG))
def test_fedavg_round_matches_jax(rank_results, name):
    import jax
    from repro.core import mesh_federation as JM
    from repro.launch.wire import fed_mesh
    exchange, topo, kind = FEDAVG[name]
    mesh = fed_mesh(N)
    tree = _student_np("tree", 0)
    fn = jax.jit(JM.make_fedavg_round(mesh, _specs(tree),
                                      adjacency=_adjacency(topo),
                                      exchange=exchange))
    with mesh:
        want = _jflat(fn(_jax_student(kind, tree),
                         np.asarray(_protos_np(0)["sizes"])))
    for rank, res in enumerate(rank_results):
        (got,) = res[name]
        where = f"{name} rank {rank}"
        assert got["bytes"] == _fedavg_bytes(exchange, topo, kind), where
        assert kind == "plane" or got["tree"], where
        assert len(got["out"]) == len(want)
        for g, w in zip(got["out"], want):
            _close(g, w[rank:rank + 1], where)
    if topo != "none":
        assert not torch.equal(rank_results[0][name][0]["out"][0],
                               rank_results[2][name][0]["out"][0])


@pytest.mark.parametrize("name", list(PROFE))
def test_profe_round_matches_jax(rank_results, name):
    exchange, topo, wire, kind, overlap, rounds = PROFE[name]
    want = _jax_profe(PROFE[name])
    for rank, res in enumerate(rank_results):
        got = res[name]
        assert len(got) == rounds
        for rnd, (g, w) in enumerate(zip(got, want)):
            where = f"{name} rank {rank} round {rnd}"
            if exchange != "gather":
                for key in ("codes", "scales", "wire"):
                    np.testing.assert_array_equal(
                        g[key].numpy(), w[key][rank:rank + 1],
                        err_msg=f"{where}: {key}")
            assert g["bytes"] == _profe_bytes(PROFE[name]), where
            assert len(g["student"]) == len(w["student"])
            for a, b in zip(g["student"], w["student"]):
                _close(a, b[rank:rank + 1], where)
            pw = w["protos"] if topo == "none" else w["protos"][rank:rank + 1]
            mw = w["mask"] if topo == "none" else w["mask"][rank:rank + 1]
            _close(g["protos"], pw, where)
            np.testing.assert_array_equal(g["mask"].numpy(), mw,
                                          err_msg=where)
            if "+ef" in wire:
                np.testing.assert_array_equal(
                    g["res_protos"].numpy(), w["res_protos"][rank:rank + 1],
                    err_msg=where)
                for a, b in zip(g["res_student"], w["res_student"]):
                    np.testing.assert_array_equal(a.numpy(),
                                                  b[rank:rank + 1],
                                                  err_msg=where)
                assert g["seq"].tolist() == [w["seq"]] == [rnd + 1]


def test_chip_smoke_mesh_paths_bytes_match_jax():
    """The bytes a rank hands to collectives a round on each of
    ``chip_smoke.py``'s mesh paths: the copies it sends times the JAX
    package's ``packed_copy_bytes`` of its payload template at N = 8
    (FedAvg's on the fp32 wire), or on ``gather`` the int16 codes of the
    student's leaves and the prototypes, a scale each and the counts;
    and the LM path's plane shape and bytes from the JAX package's
    mamba2-130m student."""
    import jax
    import numpy as np
    from repro.core import comm as jcomm
    from repro.optim.plane import plane_from_tree
    smoke = _chip_smoke()
    n = smoke.MESH_NODES
    for name, (topo, exchange, wire, _, _, want, _) in \
            smoke.MESH_PATHS.items():
        spec = smoke.parse_wire(wire)
        fed_kw = dict(smoke.MESH_FED.get(name, {}))
        algo = fed_kw.pop("algorithm", "profe")
        fed_kw.update(smoke.wire_fields(spec))
        pay, bits, st = _jax_template("mnist-cnn", n, algo, **fed_kw)
        copies = 2 if exchange == "ppermute" else 1
        if exchange == "gather":
            leaves = jax.tree_util.tree_leaves(st)
            got = sum(2 * int(np.prod(x.shape)) + 4 for x in leaves) + \
                2 * int(np.prod(pay["protos"].shape)) + 4 + \
                4 * int(np.prod(pay["counts"].shape))
        else:
            got = copies * jcomm.packed_copy_bytes(pay, bits)
        assert got == want, name
    arch = smoke.LM_PATHS["lm/mamba2-130m"][0]
    pay, bits, st = _jax_template(arch, smoke.MESH_LM_RANKS,
                                  quantize_bits=16)
    assert smoke.MESH_LM_BYTES == 2 * jcomm.packed_copy_bytes(pay, bits) \
        == 2 * smoke.LM_PATHS["lm/mamba2-130m"][7][1]
    plane = jax.eval_shape(lambda: plane_from_tree(jax.tree_util.tree_map(
        lambda x: jax.numpy.zeros(x.shape[1:], x.dtype), st)))
    assert smoke.MESH_LM_PLANE == (1,) + tuple(plane.buf.shape)
