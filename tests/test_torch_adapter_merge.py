"""The adapter wire's payload and merge in the port against the JAX package
on the CPU: the tree codec bit for bit, share and merge, and the merge's
refusal of a non-plane student.

The helpers and the tolerances, with their reasons, are in
``tests/torch_adapters_helpers.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import round_ops as jround
from repro.kernels.quantize import ops as jqops
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.core import adapters as TA
from repro_torch.core import round_ops as tround
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.optim.plane import as_tree
from repro_torch.tree import keystr, tree_leaves, tree_paths
from repro_torch.wirespec import WireSpec

from torch_adapters_helpers import (N_NODES, _adapter_payload, _close,
                                    _normal, _np, _rng, _stacked_student, _t,
                                    _to)

torch.set_num_threads(2)


@pytest.mark.parametrize("wire,grams", [("4", False), ("4", True),
                                        ("4/16,adapters=8", True),
                                        ("4,adapters=8,grams=16", True)])
def test_tree_codec_matches_jax_bit_for_bit(wire, grams):
    """Codes, scales, segment widths and the reconstruction of the
    adapter payload bit-exact against ``repro``'s packed node codec
    (eager, its plain sweeps) and its leaf-local round trip, uniform and
    with per-group widths; the per-node entry point gives the same view,
    and an error-feedback spec without its residual raises (error
    feedback itself: ``tests/test_torch_tree_ef.py``)."""
    pay = _adapter_payload(9, grams)
    jspec, tspec = JWireSpec.parse(wire), WireSpec.parse(wire)
    bits = tspec.uniform_bits or 16
    jpay = jqops.quantize_tree_packed_nodes(
        _to(pay, jnp.asarray), bits, spec=jspec, use_kernels=False)
    tpay = tqops.quantize_tree_packed_nodes(_to(pay, _t), bits, spec=tspec)
    assert tpay["codes"].dtype == {4: torch.int8, 8: torch.int8,
                                   16: torch.int16}[tspec.max_bits]
    np.testing.assert_array_equal(tpay["codes"].numpy(),
                                  np.asarray(jpay["codes"]))
    np.testing.assert_array_equal(tpay["scales"].numpy(),
                                  np.asarray(jpay["scales"]))
    np.testing.assert_array_equal(tpay["seg_ids"], jpay["seg_ids"])
    np.testing.assert_array_equal(tpay["seg_bits"], jpay["seg_bits"])
    trecv = tqops.dequantize_tree_packed_nodes(tpay)
    jrecv = jqops.quantize_dequantize_tree_packed_nodes(
        _to(pay, jnp.asarray), bits, spec=jspec, use_kernels=False)
    tl = tree_paths(trecv)
    jl = jax.tree_util.tree_flatten_with_path(jrecv)[0]
    assert [keystr(p) for p, _ in tl] == [jax.tree_util.keystr(p)
                                          for p, _ in jl]
    for (_, a), (_, b) in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = tround.quantize_dequantize_per_node(_to(pay, _t), spec=tspec)
    for a, (_, b) in zip(tree_leaves(again), tl):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no residual"):
        tqops.quantize_tree_packed_nodes(
            _to(pay, _t), bits, spec=WireSpec.parse(wire + "+ef"))


@pytest.mark.parametrize("grams", [False, True], ids=["naive", "regmean"])
def test_share_and_merge_match_jax(grams):
    """``adapter_share_nodes`` (factors, the new reference, grams) and
    ``adapter_merge_nodes`` (the merged plane, naive and RegMean) on the
    same stacked student, reference and received view."""
    rng = _rng(10)
    _, tplane, jplane_ = _stacked_student(11)
    tl = TA.adapter_layout(as_tree(tplane), 8, node_axis=True)
    refs = {n: _np(m) + _normal(rng, *m.shape, scale=1e-2)
            for n, m in TA.split_student(tl, as_tree(tplane))[0].items()}
    prev = {}                                 # earlier rounds' grams
    for n, r in refs.items():
        a = _normal(rng, *r.shape[:-2], 8, r.shape[-1], scale=1e-2)
        prev[n] = np.swapaxes(a, -1, -2) @ a
    jst = {"ref": _to(refs, jnp.asarray)}
    tst = {"ref": _to(refs, _t)}
    if grams:
        jst["grams"], tst["grams"] = _to(prev, jnp.asarray), _to(prev, _t)
    jgroups, jnew, _ = jround.adapter_share_nodes(jplane_, jst, rank=8,
                                                  grams=grams)
    tgroups, tnew, _ = tround.adapter_share_nodes(tplane, tst, rank=8,
                                                  grams=grams)
    assert sorted(tgroups) == sorted(jgroups)
    for n in tl.mat_names:
        for key in ("A", "B"):
            _close(tgroups["adapters"][n][key].numpy(),
                   jgroups["adapters"][n][key])
        np.testing.assert_array_equal(tnew["ref"][n].numpy(),
                                      np.asarray(jnew["ref"][n]))
        if grams:
            _close(tgroups["grams"][n].numpy(), jgroups["grams"][n])
    for n, x in tgroups["student"].items():
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(jgroups["student"][n]))

    # the merge, from one received view (JAX's groups through numpy)
    recv = _to({k: v for k, v in jgroups.items()}, np.asarray)
    w_self, w_neigh = tround.gossip_matrix(1.0 - np.eye(N_NODES),
                                           [5, 6, 7, 8])
    jmerged = jround.adapter_merge_nodes(
        jplane_, _to(recv, jnp.asarray), jnp.asarray(w_self),
        jnp.asarray(w_neigh), rank=8, grams=grams)
    before = tplane.buf.numpy().copy()
    tmerged = tround.adapter_merge_nodes(tplane, _to(recv, _t), _t(w_self),
                                         _t(w_neigh), rank=8, grams=grams)
    assert tmerged is tplane                  # merged in place
    # RegMean: the solve's ~1e3 amplification of last-bit gaps, relative
    # to the merge's largest step (as regmean_adjust's rtol=1e-4)
    step = float(np.abs(np.asarray(jmerged.buf) - before).max())
    np.testing.assert_allclose(tplane.buf.numpy(), np.asarray(jmerged.buf),
                               rtol=0, atol=1e-4 * step if grams else 2e-6)
    # the padding lanes stay zero
    real = torch.zeros(tplane.buf.shape[1:], dtype=torch.bool)
    for _, _, shape, row, r_leaf in tplane.meta.recipe:
        real[row:row + r_leaf].view(-1)[:int(np.prod(shape))] = True
    assert not tplane.buf[:, ~real].any()


def test_merge_takes_only_a_plane():
    """The merge writes a stacked student plane in place and returns it;
    a per-leaf student tree (``param_plane="off"``) is merged into a new
    tree through the same ``lowrank_apply`` a matrix leaf, bit-identical
    to the plane's leaf views, and left as it was."""
    _, tplane, _ = _stacked_student(13)
    tree = jax.tree_util.tree_map(lambda x: x.clone(), as_tree(tplane))
    tl = TA.adapter_layout(tree, 8, node_axis=True)
    mats, rest = TA.split_student(tl, tree)
    recv = {"adapters": TA.factorize_deltas(
        tl, mats, {n: m * 0.9 for n, m in mats.items()}), "student": rest}
    w_self, w_neigh = (_t(x) for x in tround.gossip_matrix(
        1.0 - np.eye(N_NODES), [1, 2, 3, 4]))
    before = [x.clone() for x in tree_leaves(tree)]
    merged = tround.adapter_merge_nodes(tree, recv, w_self, w_neigh, rank=8)
    assert merged is not tree
    for a, b in zip(tree_leaves(tree), before):
        assert torch.equal(a, b)
    out = tround.adapter_merge_nodes(tplane, recv, w_self, w_neigh, rank=8)
    assert out is tplane
    for a, b in zip(tree_leaves(merged), tree_leaves(as_tree(tplane))):
        assert torch.equal(a, b)
