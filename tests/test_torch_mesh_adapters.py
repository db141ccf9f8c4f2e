"""The port's adapter-rank round on the multi-node exchange against the JAX
package's on ``fed_mesh(4)`` (the port's rounds on 4 gloo ranks, spawned
once for this file), and one rank holding all 4 nodes against the
port's stacked engine.

The helpers and the tolerances, with their reasons, are in
``tests/torch_mesh_rest_helpers.py``.
"""
import numpy as np
import pytest
import torch

from torch_mesh_rest_helpers import (ADAPTER, C, FACTOR_RTOL, N, RANK_R,
                                     _adapter_payload_like, _adapter_state_np,
                                     _adjacency, _close, _copy_bytes,
                                     _jax_adapter, _jax_student, _jflat,
                                     _leaves, _protos_np, _regmean_cond, _rows,
                                     _student, _student_np, _ulp_atol,
                                     one_rank_group, spawn_ranks)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    return spawn_ranks(tmp_path_factory, ("adapter",))


@pytest.mark.parametrize("name", list(ADAPTER))
def test_adapter_round_matches_jax(rank_results, name):
    import jax
    exchange, wire, grams, kind, overlap = ADAPTER[name]
    got = [res[name][0] for res in rank_results]
    res, codecs = _jax_adapter(ADAPTER[name], [g["payload"] for g in got],
                               [g["residual_in"] for g in got])
    tree = _student_np("adapter", 0)
    inp = _protos_np(0)
    want_s = _jflat(res[0])
    delta = max(float(np.abs(w - _jflat(_jax_student(kind, tree))[k]).max())
                for k, w in enumerate(want_s))
    rtol = FACTOR_RTOL * (_regmean_cond(_adapter_state_np(tree, True),
                                        inp["sizes"], _adjacency("ring"))
                          if grams else 1.0)
    pay_np = {"adapters": _adapter_payload_like(tree, grams)["adapters"],
              "model": {"b": np.zeros((N, 12), np.float32)},
              "protos": inp["protos"], "counts": inp["counts"]}
    if grams:
        pay_np["grams"] = _adapter_payload_like(tree, grams)["grams"]
    per = _copy_bytes(pay_np, wire)
    # gather: the payload's code rows at the container of the spec's
    # widest group (int8 up to 8 bits, int16 above), a fp32 scale a leaf
    # and the counts, from the JAX package's layout of the payload
    from repro.kernels.quantize.ops import packed_wire_rows
    from repro.wirespec import WireSpec as JWireSpec
    rows, n_seg = packed_wire_rows(
        {k: v for k, v in pay_np.items() if k != "counts"})
    gather_bytes = rows * 512 * (1 if JWireSpec.parse(wire).max_bits <= 8
                                 else 2) + 4 * n_seg + 4 * C
    for rank, g in enumerate(got):
        where = f"{name} rank {rank}"
        cw = codecs[rank]
        for key in ("codes", "scales", "wire"):
            np.testing.assert_array_equal(g[key].numpy(), cw[key],
                                          err_msg=f"{where}: {key}")
        if exchange == "gather":
            want_bytes = gather_bytes
        else:
            want_bytes = per * (2 if exchange == "ppermute" else 1)
        assert g["bytes"] == want_bytes, (where, g["bytes"], want_bytes)
        for a, b in zip(g["student"], want_s):
            _close(a, b[rank:rank + 1], where, extra=rtol * delta)
        _close(g["protos"], np.asarray(res[1])[rank:rank + 1], where)
        np.testing.assert_array_equal(g["mask"].numpy(),
                                      np.asarray(res[2])[rank:rank + 1],
                                      err_msg=where)
        for a, b in zip(g["ref"], jax.tree_util.tree_leaves(res[3]["ref"])):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b)[rank:rank + 1],
                                          err_msg=where)
        if "+ef" in wire:
            for a, b in zip(g["residual"], cw["residual"]):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=where)
            assert g["seq"].tolist() == [1]
    assert not torch.equal(got[0]["student"][0], got[2]["student"][0])


@pytest.mark.parametrize("grams", [False, True], ids=["naive", "regmean"])
def test_one_rank_adapter_round_matches_stacked_share_and_merge(
        one_rank_group, grams):
    from repro_torch.core import mesh_federation as M
    from repro_torch.core import topology as T
    from repro_torch.core.federation import _make_round_parts
    from repro_torch.core.profe import NodeState
    from repro_torch.optim.plane import Plane
    from repro_torch.wirespec import WireSpec
    spec = WireSpec.parse("4")
    tree_np = _student_np("adapter", 0)
    plane = _student("plane", _rows(tree_np, slice(0, N)))
    ast_np = _adapter_state_np(tree_np, grams)
    inp = _protos_np(0)
    protos = torch.from_numpy(inp["protos"])
    counts = torch.from_numpy(inp["counts"])
    sched = T.make_schedule(N, "ring")
    fn = M.make_profe_round(one_rank_group, adjacency=sched.adjacency_at(0),
                            exchange="packed", spec=spec,
                            adapter_rank=RANK_R, adapter_grams=grams)
    before = M.COLLECTIVE_BYTES.count
    got = fn(Plane(plane.buf.clone(), plane.meta), protos, counts,
             torch.from_numpy(inp["sizes"]), _rows(ast_np, slice(0, N)))
    sent = M.COLLECTIVE_BYTES.count - before

    _, share_phase, mix_phase = _make_round_parts(
        None, None, C, bits=spec, adapter_rank=RANK_R, adapter_grams=grams)
    st = NodeState(student=Plane(plane.buf.clone(), plane.meta), teacher=None,
                   opt_s={}, opt_t={}, global_protos=None, proto_mask=None,
                   round_idx=None, adapter_state=_rows(ast_np, slice(0, N)))
    st, recv, protos_rx = share_phase(st, protos)
    w_self, w_neigh, include = (torch.from_numpy(x[0]) for x in
                                sched.lower(inp["sizes"]))
    st = mix_phase(st, recv, protos_rx, counts, w_self, w_neigh, include)
    want = st.student.buf.numpy()
    np.testing.assert_allclose(got[0].buf.numpy(), want, rtol=0,
                               atol=_ulp_atol(want))
    assert torch.equal(got[1], st.global_protos)
    assert torch.equal(got[2], st.proto_mask)
    for a, b in zip(_leaves(got[3]), _leaves(st.adapter_state)):
        assert torch.equal(a, b)
    # one rank holding N nodes hands all N copies to the all-gather
    pay_np = {"adapters": _adapter_payload_like(tree_np, grams)["adapters"],
              "model": {"b": np.zeros((N, 12), np.float32)},
              "protos": inp["protos"], "counts": inp["counts"]}
    if grams:
        pay_np["grams"] = _adapter_payload_like(tree_np, grams)["grams"]
    assert sent == N * _copy_bytes(pay_np, "4")
