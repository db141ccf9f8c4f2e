"""Placement rules: the in-node layouts of a node of several cards, and
the static row order of the row-sharded permute.

**Layouts.**  The JAX package's rules (its ``sharding.py``), one for one:

* ``data`` axis — FSDP for weights (their "reduction" dim) + batch DP;
* ``model`` axis — tensor parallelism: attention head columns, FFN
  hidden, vocab rows of the embedding, the MoE expert dim (when it
  divides);
* never across layers: a stacked period dim is replicated.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
a mesh-axis name, or a tuple of names (the dim split over those axes,
the first the major).  The rules take the mesh's axis sizes as a mapping
(``{"data": 2, "model": 4}``), as the JAX package's take ``mesh.shape``,
so they hold without a process group.  Every rule checks divisibility
and falls back to replication — grok's 8 experts on a 16-way model axis
shard ``d_ff`` instead.  :func:`to_placements` turns a spec into DTensor
placements on a ``DeviceMesh``; :func:`shard_act` constrains an
activation to its kind's spec while a layout is set
(:func:`set_activation_sharding`) and returns its input untouched
otherwise.  The shard-wise ops (:func:`einsum`, :func:`reshape`,
:func:`attention_on_shards`, …) are what the models call where a layout
needs more than DTensor's own sharding propagation: each runs the rank's
local shards with explicit redistributions (torch 2.11's DTensor, the
card's, lacks several of the rules 2.13's has), and is the plain op
outside a layout.

**Row order.**  A node of the multi-node exchange may hold several ranks
(``repro``'s multi-axis pods): each of its M ranks permutes only its own
row block of the node's encoded wire buffer.  Every block must then hold
the same profile of row widths, so that each rank's encoded byte count
is the same static number and the blocks of two nodes line up
(:func:`row_shard_order`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.tree import tree_map, tree_map_with_path

Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def axis_size(mesh_shape: Mapping[str, int], axis) -> int:
    """Ranks along ``axis`` (a name or a tuple of names; an axis the
    mapping lacks has one rank)."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= mesh_shape.get(a, 1)
        return out
    return mesh_shape.get(axis, 1)


def _fits(dim: int, mesh_shape, axis) -> bool:
    n = axis_size(mesh_shape, axis)
    return dim % n == 0 and dim >= n


def dim_axis(dim: int, mesh_shape, axis):
    """``axis`` if it divides ``dim``, else None (replicate); a tuple of
    one axis is that axis, as a ``PartitionSpec`` entry reads."""
    if not _fits(dim, mesh_shape, axis):
        return None
    return axis[0] if isinstance(axis, (tuple, list)) and len(axis) == 1 \
        else axis


def _path_names(path) -> Tuple[str, ...]:
    """A tree path's names as the JAX package's ``_path_names`` gives
    them: a dict key as is, a list index as ``#i``."""
    return tuple(f"#{k}" if isinstance(k, int) else str(k) for k in path)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_COL_PARALLEL_PARENTS = {  # dense layers whose OUTPUT dim gets "model"
    "wq", "wk", "wv", "wi", "wi_gate", "wi_up", "in_proj", "in_rec",
    "in_gate", "w_a", "w_x",
}
_ROW_PARALLEL_PARENTS = {  # dense layers whose INPUT dim gets "model"
    "wo", "out", "out_proj",
}
_REPLICATED_PARENTS = {  # small / host-side layers
    "proto_proj", "fc", "fc1", "fc2", "router",
}


def _param_spec(names: Tuple[str, ...], shape: Tuple[int, ...], mesh_shape,
                data_axis, model_axis) -> Spec:
    """Spec of one leaf; ``shape`` excludes any stacked period dim."""
    parent = names[-2] if len(names) >= 2 else ""
    leafname = names[-1]
    rep = (None,) * len(shape)

    def ax(dim, axis):
        return dim_axis(dim, mesh_shape, axis)
    # embeddings: vocab rows over model, d over data.  In the pure-FSDP
    # layout (model_axis=None) the vocab rows are replicated
    if leafname == "table":
        return (ax(shape[0], model_axis), ax(shape[1], data_axis))
    if len(shape) <= 1:                      # norms, biases, scalars
        return rep
    # conv kernels (paper CNN/ResNet, mamba/rglru depthwise): replicate
    if leafname == "kernel" and parent in ("conv", "conv1", "conv2", "stem",
                                           "proj"):
        return rep
    if len(shape) == 4:                      # any HWIO conv
        return rep
    # MoE expert tensors [E, in, out]
    if len(shape) == 3 and (parent in ("wi_gate", "wi_up", "wo")
                            or leafname in ("wi_gate", "wi_up", "wo")):
        e, d_in, d_out = shape
        if _fits(e, mesh_shape, model_axis):
            return (model_axis, ax(d_in, data_axis), None)
        # experts don't divide: TP over the wide dim instead
        if leafname in ("wi_gate", "wi_up") or parent in ("wi_gate", "wi_up"):
            return (None, ax(d_in, data_axis), ax(d_out, model_axis))
        return (None, ax(d_in, model_axis), ax(d_out, data_axis))
    if len(shape) == 2:
        d_in, d_out = shape
        if parent in _REPLICATED_PARENTS or leafname == "router":
            return (ax(d_in, data_axis), None)
        if parent in _ROW_PARALLEL_PARENTS:
            return (ax(d_in, model_axis), ax(d_out, data_axis))
        # default: column-parallel (covers _COL_PARALLEL_PARENTS)
        return (ax(d_in, data_axis), ax(d_out, model_axis))
    return rep


def param_specs(cfg, params, mesh_shape, *, data_axis="data",
                model_axis="model"):
    """A spec tree like ``params`` (tensors or shape stand-ins).  A leaf
    under the stacked ``scan`` subtree keeps its leading period dim
    replicated."""
    def leaf_spec(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        stacked = "scan" in names
        spec = _param_spec(names, shape[1:] if stacked else shape,
                           mesh_shape, data_axis, model_axis)
        return (None,) + spec if stacked else spec
    return tree_map_with_path(leaf_spec, params)


# ---------------------------------------------------------------------------
# optimizer-state specs
# ---------------------------------------------------------------------------

def opt_state_specs(opt_name: str, pspecs, params):
    """Mirror the parameter specs onto the optimizer state tree of
    ``params``.  An adafactor leaf gets row and column factors where the
    optimizer factors it (``optim.optimizers.factored``; the JAX
    package's rule, two dims or more, but for a stacked leaf of one
    period, ``[1, d]``, which keeps a whole second moment)."""
    if opt_name == "sgd":
        return {"mu": pspecs, "step": ()}
    if opt_name == "adamw":
        return {"mu": pspecs, "nu": pspecs, "step": ()}
    if opt_name == "adafactor":
        from repro_torch.optim.optimizers import factored

        def vspec(p, t):
            if factored(tuple(p.shape)):
                return {"vr": t[:-1], "vc": t[:-2] + t[-1:]}
            return {"v": t}
        return {"v": tree_map(vspec, params, pspecs), "step": ()}
    raise ValueError(opt_name)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(batch, mesh_shape, *, dp_axes):
    """The batch dim over the data-parallel axes."""
    def spec(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        return (dim_axis(shape[0], mesh_shape, dp_axes),) + \
            (None,) * (len(shape) - 1)
    return tree_map(spec, batch)


def cache_specs(cache, mesh_shape, *, data_axis="data", model_axis="model"):
    """Decode-state specs: KV caches ``[.., B, S, KH, HD]`` batch over
    data and ``head_dim`` over model (sharding S would make the write at
    the decode position a write into a sharded dim); mamba2's ssm state
    ``[.., B, H, N, P]`` batch over data, N over model; rglru's ``h``
    ``[.., B, W]`` and conv tails ``[.., B, W-1, C]`` width over model."""
    def leaf_spec(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        stacked = "scan" in names
        body = list(shape[1:] if stacked else shape)
        leafname = names[-1]
        spec: list = [None] * len(body)
        if body:
            spec[0] = dim_axis(body[0], mesh_shape, data_axis)   # batch
        if leafname in ("k", "v") and len(body) == 4:
            spec[3] = dim_axis(body[3], mesh_shape, model_axis)  # head_dim
        elif leafname == "ssm" and len(body) == 4:
            spec[2] = dim_axis(body[2], mesh_shape, model_axis)  # state N
        elif leafname == "h" and len(body) == 2:
            spec[1] = dim_axis(body[1], mesh_shape, model_axis)
        elif leafname == "conv" and len(body) == 3:
            spec[2] = dim_axis(body[2], mesh_shape, model_axis)
        return ((None,) if stacked else ()) + tuple(spec)
    return tree_map_with_path(leaf_spec, cache)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def to_placements(spec: Spec, mesh_dim_names: Sequence[str],
                  mesh_sizes: Optional[Sequence[int]] = None):
    """DTensor placements (one a mesh dim) of ``spec``, the counterpart
    of ``to_named``: a mesh dim that a tensor dim's entry names shards
    that dim (``Shard(d)``), every other replicates, as does a mesh dim
    of one rank (``mesh_sizes``); an axis the mesh lacks (a node mesh
    leaves out an axis of one rank) is skipped.  A dim over ``("data",
    "model")`` is ``Shard(d)`` on both, the first the major, which is
    DTensor's order when the mesh's axes come in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = tuple(a for a in _axes(entry) if a in names and (
            mesh_sizes is None or mesh_sizes[names.index(a)] > 1))
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {d} over {axes} is not in "
                             f"the mesh's axis order {names}")
        for i in pos:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return out


def local_shape(shape, spec: Spec, mesh_shape) -> Tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` under ``spec`` (every
    sharded dim divides, as the rules ensure)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = axis_size(mesh_shape, _axes(entry) or None)
        if dim % n:
            raise ValueError(f"{n} ranks do not divide dim {dim} of "
                             f"{tuple(shape)} ({spec})")
        out.append(dim // n)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` under its spec.
    A ``meta`` tensor becomes a ``meta`` shard of its local shape with no
    communication; any other is cut from the whole tensor (every rank
    holds it, as a test's carried weights do)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    names = mesh.mesh_dim_names
    shape = dict(zip(names, mesh.shape))

    def one(t, spec):
        if t is None or isinstance(t, DTensor):
            return t
        pl = to_placements(spec, names, mesh.shape)
        if t.device.type != "meta":
            return distribute_tensor(t, mesh, pl).requires_grad_(
                t.requires_grad)
        local = torch.empty(local_shape(t.shape, spec, shape),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return tree_map(one, tree, specs)


# ---------------------------------------------------------------------------
# activation sharding (in-model constraints)
# ---------------------------------------------------------------------------
# Sharding propagation alone may go "weights-stationary" on big FSDP+TP
# trees (replicate the token batch, shard only the hidden dims).  The
# model code calls :func:`shard_act` on the residual stream, attention
# heads, FFN hidden and logits; outside a layout it returns its input.

_ACT_CTX: Dict[str, Any] = {"mesh": None, "dp": None, "model": None}

_ACT_KINDS = {
    # logical layout -> per-dim axis roles: "dp" batch, "tp" tensor, "sp"
    # sequence-parallel (the residual stream sharded over the model axis
    # between blocks — TP+SP; redistributing in and out of it is the
    # all-gather / reduce-scatter pair at block boundaries)
    "btd": ("dp", "sp", None),
    "btf": ("dp", None, "tp"),          # ffn hidden
    "bthd": ("dp", None, "tp", None),   # per-head activations
    "btv": ("dp", None, "vocab"),       # logits: vocab on model, always
    "bd": ("dp", "tp"),
    "egcd": ("tp", "dp", None, None),   # moe dispatched tokens
    "gtd": ("dp", None, None),          # moe grouped tokens
    "gtec": ("dp", None, "tp", None),   # moe dispatch/combine tensors
}


def set_activation_sharding(mesh, *, dp_axes=("data",), model_axis="model"):
    """Constrain activations on ``mesh`` (a ``DeviceMesh``, or a mapping
    of axis sizes for :func:`act_spec` alone); ``model_axis=None``
    disables the TP constraints (the pure-FSDP layout)."""
    _ACT_CTX.update(mesh=mesh, dp=tuple(dp_axes), model=model_axis)


def clear_activation_sharding():
    _ACT_CTX.update(mesh=None, dp=None, model=None)


def _mesh_shape(mesh) -> Mapping[str, int]:
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def act_spec(shape, kind: str, mesh_shape, dp, model) -> Spec:
    """The spec :func:`shard_act` gives an activation of ``shape``."""
    roles = _ACT_KINDS[kind]
    # MoE fallback: when the expert dim doesn't divide the model axis
    # (grok: 8 experts / 16-way), move tensor parallelism to the trailing
    # feature/capacity dim instead of replicating the dispatch tensors
    if kind == "egcd" and not _fits(shape[-4], mesh_shape, model):
        # capacity rows are a pure batch dim for the expert FFN -> shard
        # them over model ("expert data parallelism" when E < axis size)
        roles = (None, "dp", "tp", None)
    if kind == "gtec" and not _fits(shape[-2], mesh_shape, model):
        roles = ("dp", None, None, "tp")
    spec = []
    for dim, role in zip(shape[len(shape) - len(roles):], roles):
        if role == "dp":
            spec.append(dim_axis(dim, mesh_shape, dp))
        elif role in ("tp", "sp", "vocab"):
            spec.append(dim_axis(dim, mesh_shape, model))
        else:
            spec.append(None)
    # rank mismatch (extra leading dims): leave them free
    return (None,) * (len(shape) - len(roles)) + tuple(spec)


def shard_act(x, kind: str):
    """``x`` constrained to the activation ``kind``'s spec under the
    layout set by :func:`set_activation_sharding` (a redistribution of
    the DTensor ``x``); ``x`` itself outside a layout."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"shard_act({kind!r}) under a layout needs a DTensor,"
                        f" got {type(x).__name__}")
    spec = act_spec(tuple(x.shape), kind, _mesh_shape(mesh), _ACT_CTX["dp"],
                    _ACT_CTX["model"])
    pl = to_placements(spec, mesh.mesh_dim_names, mesh.shape)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


# ---------------------------------------------------------------------------
# shard-wise ops: what the models call where a layout needs more than
# DTensor's own propagation (each is the plain op outside a layout)
# ---------------------------------------------------------------------------

def _is_dtensor(x) -> bool:
    """``x`` a DTensor while a layout is set."""
    if _ACT_CTX["mesh"] is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def on_shards(x) -> bool:
    """``x`` a DTensor of a layout's program (run its rank's shards)."""
    return _is_dtensor(x)


def place_like(x, like):
    """``x`` in ``like``'s placements (a DTensor under a layout); ``x``
    itself otherwise."""
    if not _is_dtensor(x) or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def _moved_bytes(t, current, target, mesh, i) -> int:
    """Bytes ``t``'s rank hands a collective to go from ``current`` to
    ``target`` on mesh dim ``i`` (a slice of a replicated dim is free)."""
    if current == target or (not current.is_shard() and
                             not current.is_partial() and target.is_shard()):
        return 0
    local = t._local_tensor.numel() * t.element_size()
    return local * (mesh.size(i) if current.is_shard() and
                    not target.is_shard() else 1)


def einsum(eq: str, *operands):
    """``torch.einsum(eq, *operands)``.  Under a layout, with DTensor
    operands, each rank contracts its own shards: per mesh dim the index
    sharded there (an operand's, or none) is the one whose placement
    moves the fewest bytes — operands that carry it shard it, the others
    are whole on that mesh dim — and the result is sharded on it, or a
    partial sum where it is contracted (priced as the rank's share of
    the result, which a later reduction moves).  (DTensor's own einsum flattens
    the operands into a batched product, which torch 2.11 cannot do for a
    dim sharded inside a flattened group.)"""
    import torch
    if not any(_is_dtensor(o) for o in operands):
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = next(o for o in operands if _is_dtensor(o)).device_mesh
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    ops = [o if _is_dtensor(o) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for o in operands]
    size = {c: n for letters, o in zip(ins, ops)
            for c, n in zip(letters, o.shape)}
    out_bytes = ops[0].element_size()
    for c in out:
        out_bytes *= size[c]
    shards = {c: 1 for c in size}
    targets = [[None] * mesh.ndim for _ in ops]
    grads = [[None] * mesh.ndim for _ in ops]
    out_pl = []
    for i in range(mesh.ndim):
        cands = [None] + [letters[p.dim] for letters, o in zip(ins, ops)
                          for p in (o.placements[i],) if p.is_shard()]
        best = None
        for c in dict.fromkeys(cands):
            if c is not None and size[c] % (shards[c] * mesh.size(i)):
                continue
            tg = [Shard(letters.index(c)) if c is not None and c in letters
                  else Replicate()
                  for letters in ins]
            cost = sum(_moved_bytes(o, o.placements[i], t, mesh, i)
                       for o, t in zip(ops, tg))
            if c is not None and c not in out:
                # a partial sum is reduced later: its rank's share
                cost += out_bytes // mesh.size(i)
            if best is None or cost < best[0]:
                best = (cost, c, tg)
        _, c, tg = best
        for k, t in enumerate(tg):
            targets[k][i] = t
            # an operand whole on a mesh dim whose ranks split another
            # index gets a partial sum of its gradient there
            grads[k][i] = Partial() if c is not None and \
                not t.is_shard() else t
        if c is None:
            out_pl.append(Replicate())
        else:
            shards[c] *= mesh.size(i)
            out_pl.append(Shard(out.index(c)) if c in out else Partial())
    local = torch.einsum(eq, *[o.redistribute(mesh, t).to_local(
        grad_placements=g) for o, t, g in zip(ops, targets, grads)])
    # every sharded index divides evenly: DTensor infers the global
    # shape and strides (the local result may be a permuted view)
    return DTensor.from_local(local, mesh, out_pl, run_check=False)


def matmul(x, w):
    """``x @ w`` (w 2-d); under a layout :func:`einsum`'s contraction of
    each rank's shards."""
    if not (_is_dtensor(x) or _is_dtensor(w)):
        return x @ w
    lead = "abcdefgh"[:x.dim() - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w)


def replicate(x):
    """``x`` whole on every rank (a partial sum reduced) under a layout;
    ``x`` itself otherwise."""
    if not _is_dtensor(x) or all(p.is_replicate() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def whole_dims(x, dims):
    """``x`` with its ``dims`` whole on every rank (and no partial sum)
    under a layout; ``x`` itself otherwise."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.dim() for d in dims}
    pl = [Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims)
          else p for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``; under a layout each rank's running sum of
    its shards along a whole ``dim`` (torch 2.11's DTensor has no
    strategy for the flip its backward runs)."""
    import torch
    if not _is_dtensor(x):
        return torch.cumsum(x, dim)
    from torch.distributed.tensor import DTensor
    x = whole_dims(x, (dim,))
    return DTensor.from_local(torch.cumsum(x.to_local(), dim),
                              x.device_mesh, x.placements, run_check=False)


def conv_on_shards(fn, params, u):
    """``fn(params, u)``, a causal depthwise conv along u's sequence (u
    ``[B, S, C]``, ``params`` its ``kernel`` ``[W, C]`` and ``bias``
    ``[C]``), on each rank's shards: the sequence whole, the batch and
    channels as u's are split, the taps sliced to the rank's channels
    (torch 2.11's DTensor cannot plan the pad's redistribution on a
    2-d mesh).  The taps' gradient is a partial sum over the batch's
    ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    u = whole_dims(u, (1,))
    mesh = u.device_mesh
    local = {}
    for name, t in params.items():
        cdim = t.dim() - 1
        pl = [Shard(cdim) if p.is_shard() and p.dim == 2 else Replicate()
              for p in u.placements]
        grads = [Partial() if p.is_shard() and p.dim == 0 else q
                 for p, q in zip(u.placements, pl)]
        local[name] = t.redistribute(mesh, pl).to_local(
            grad_placements=grads)
    return DTensor.from_local(fn(local, u.to_local()), mesh, u.placements,
                              run_check=False)


def embed_on_shards(table, tokens):
    """``table[tokens]`` on each rank's shards of ``tokens``, the table
    gathered whole (its FSDP and vocab shards): torch 2.11's DTensor
    cannot place the gradient's ``index_put``.  Each rank's gradient of
    the table is a partial sum over the ranks that split the tokens,
    reduce-scattered back to the table's shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if not _is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in tokens.placements])
    return DTensor.from_local(whole[tokens.to_local()], mesh,
                              tokens.placements, run_check=False)


def gqa_on_shards(scores_fn, context_fn, q, k, v, mask):
    """Grouped-query attention (``scores_fn`` / ``context_fn`` of
    ``models/attention``) on each rank's shards, placed as k is: its
    batch, its kv heads or its head_dim (a decode cache's), q alike
    (its heads in kv-head groups), any other dim whole.  Scores over a
    head_dim shard are partial sums, all-reduced before the softmax (as
    XLA partitions the contraction).  Returns the context ``[B, S, NQ,
    HD]`` placed as q."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = k.device_mesh
    b, s, nq, hd = q.shape
    pl, spl, hd_dims = [], [], []
    for i, p in enumerate(k.placements):
        if p.is_shard() and p.dim in (0, 2, 3):
            pl.append(Shard(p.dim))
            # scores [B, NKV, G, S, T]: batch and kv heads keep their
            # shards, a head_dim shard leaves a partial sum
            spl.append(Partial() if p.dim == 3 else
                       Shard(0) if p.dim == 0 else Shard(1))
            if p.dim == 3:
                hd_dims.append(i)
        else:
            pl.append(Replicate())
            spl.append(Replicate())
    q_l = q.redistribute(mesh, pl).to_local()
    k_l = k.redistribute(mesh, pl).to_local()
    v_l = v.redistribute(mesh, pl).to_local()
    scores = scores_fn(q_l, k_l, hd ** -0.5)
    if hd_dims:
        full = [Replicate() if p.is_partial() else p for p in spl]
        scores = DTensor.from_local(scores, mesh, spl, run_check=False) \
            .redistribute(mesh, full).to_local()
    ctx = context_fn(scores, v_l, mask, q.dtype)
    ctx = ctx.reshape(ctx.shape[:2] + (-1, ctx.shape[-1]))
    return DTensor.from_local(ctx, mesh, pl, run_check=False)


def broadcast_like(x, like):
    """``x`` (broadcastable to ``like``) as it is; under a layout
    expanded to ``like``'s shape in ``like``'s placements, so that the
    product of two broadcast factors lands on ``like``'s shards (DTensor
    may otherwise shard the stacked period dim where its size divides a
    mesh axis, and gather it back)."""
    if not _is_dtensor(x):
        return x
    return place_like(x.expand(like.shape), like)


def _linear_coordinate(mesh, dims) -> int:
    """This rank's index among the ranks of ``mesh``'s ``dims`` (the
    first the major)."""
    coord = mesh.get_coordinate()
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + coord[d]
    return idx


def attention_on_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (q ``[B, S, NQ, HD]``, k / v ``[B, T, NKV,
    HD]``, a result like q) run by each rank on its own shards: the batch
    as q's batch is sharded, the query heads as q's heads are; the
    key/value heads alike where they divide, else (fewer kv heads than
    head shards: MQA, narrow GQA) replicated and each rank takes the one
    its query heads read, whose gradient is then a partial sum over those
    ranks.  Sequence and head_dim are whole on every rank.  Where the
    head shards neither divide the kv heads nor are divided by them, the
    heads are replicated.  GSPMD partitions blockwise attention's loops
    so (batch and heads are independent in it); DTensor would propagate
    through each block pair's ops instead."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    nq, nkv = q.shape[2], k.shape[2]
    heads = [i for i, p in enumerate(q.placements)
             if p.is_shard() and p.dim == 2]
    n = 1
    for i in heads:
        n *= mesh.size(i)
    slice_kv = n > 1 and nkv % n != 0 and n % nkv == 0
    if n > 1 and nkv % n and not slice_kv:
        heads = []
    qpl, kvpl, kv_grad = [], [], []
    for i, p in enumerate(q.placements):
        if p.is_shard() and p.dim == 0:
            qpl.append(Shard(0))
            kvpl.append(Shard(0))
            kv_grad.append(Shard(0))
        elif i in heads:
            qpl.append(Shard(2))
            kvpl.append(Replicate() if slice_kv else Shard(2))
            kv_grad.append(Partial() if slice_kv else Shard(2))
        else:
            qpl.append(Replicate())
            kvpl.append(Replicate())
            kv_grad.append(Replicate())
    q_l = q.redistribute(mesh, qpl).to_local()
    k_l = k.redistribute(mesh, kvpl).to_local(grad_placements=kv_grad)
    v_l = v.redistribute(mesh, kvpl).to_local(grad_placements=kv_grad)
    if slice_kv:
        kvi = _linear_coordinate(mesh, heads) * (nq // n) // (nq // nkv)
        k_l, v_l = k_l[:, :, kvi:kvi + 1], v_l[:, :, kvi:kvi + 1]
    out = fn(q_l, k_l, v_l, **kw)
    return DTensor.from_local(out, mesh, qpl, run_check=False)


def factory_like(factory, shape, like, dims):
    """``factory(shape)`` (a ``torch.zeros`` / ``torch.full`` of its own
    dtype and device).  Under a layout, with ``like`` a DTensor, the
    tensor is made as its placements say: dim i of ``shape`` follows dim
    ``dims[i]`` of ``like`` (None: replicated), and each rank makes its
    own shard only (a plain tensor of the global shape would be every
    rank's whole copy)."""
    if not _is_dtensor(like):
        return factory(shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    pl = [Shard(dims.index(p.dim)) if p.is_shard() and p.dim in dims
          else Replicate() for p in like.placements]
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    t = factory(tuple(local))
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _view_groups(old, new):
    """The dims of a reshape from ``old`` to ``new`` in groups of equal
    product (``[(old dims, new dims)]``), as a view maps them."""
    groups, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        a, b, oi, nj = old[i], new[j], [i], [j]
        i, j = i + 1, j + 1
        while a != b and (i < len(old) or j < len(new)):
            if (a < b and i < len(old)) or j == len(new):
                a, oi = a * old[i], oi + [i]
                i += 1
            else:
                b, nj = b * new[j], nj + [j]
                j += 1
        groups.append((oi, nj))
    return groups


def _grad_placed(y):
    """``y`` whose gradient comes back in ``y``'s own placements (a
    partial sum's gradient replicated)."""
    import torch
    from torch.distributed.tensor import Replicate

    class GradPlaced(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.placements = [Replicate() if p.is_partial() else p
                              for p in x.placements]
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            if tuple(g.placements) == tuple(ctx.placements):
                return g
            return g.redistribute(g.device_mesh, ctx.placements)
    return GradPlaced.apply(y) if y.requires_grad else y


def reshape(x, shape):
    """``x.reshape(shape)``.  Under a layout a DTensor is placed first so
    that DTensor can reshape it — in each group of dims the reshape
    merges or splits, only the first may be sharded, by a count that
    divides the first dim it becomes (GSPMD reshards likewise) — and its
    gradient comes back in the result's placements, so that the backward
    reshape holds too."""
    from torch.distributed.tensor import Replicate
    if not _is_dtensor(x):
        return x.reshape(shape)
    shape = _resolve(x.shape, shape)
    pl = list(x.placements)
    for oi, nj in _view_groups(list(x.shape), list(shape)):
        for d in oi:
            for i, p in enumerate(pl):
                if not (p.is_shard() and p.dim == d):
                    continue
                n = x.device_mesh.size(i)
                if d != oi[0] or shape[nj[0]] % n:
                    pl[i] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return _grad_placed(x.reshape(shape))


def _resolve(old, shape):
    """``shape`` with a ``-1`` resolved against ``old``'s size."""
    shape = list(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            known *= s if s != -1 else 1
        total = 1
        for s in old:
            total *= s
        shape[shape.index(-1)] = total // known
    return shape


# ---------------------------------------------------------------------------
# the row-sharded permute's row order
# ---------------------------------------------------------------------------

def row_shard_order(row_bits, inner: int):
    """Static row permutation that splits a packed wire buffer's rows
    over ``inner`` ranks with an identical per-width row profile on
    every rank.

    ``row_bits`` is the wire width of each row (``seg_bits[seg_ids]``,
    length R).  Rank k takes the k-th equal slice of every width group,
    the groups in ascending width (the encode order).  A group whose row
    count ``inner`` does not divide is padded: ``order`` grows indices
    ``R, R+1, …``, assigned in turn over the groups in ascending width,
    which the caller materializes as appended all-zero rows before
    taking ``buf[:, order]``.  Zero codes encode to zero bytes at the
    group's width and dequantize to zero, so the mix is unchanged; the
    pad rows are wire bytes, which ``packed_copy_bytes(…, inner=…)``
    counts.

    Returns ``(order, inv_order, local_bits)``: ``buf[:, order]`` (after
    the ``len(order) - R`` zero rows are appended) is the buffer in
    shard order, ``mixed[:, inv_order]`` (length R) restores the rows
    and drops the pad rows, and each rank encodes its block against
    ``local_bits``."""
    bits = np.asarray(row_bits)
    r_orig = bits.shape[0]
    if inner <= 1:
        r = np.arange(r_orig)
        return r, r, bits
    groups = []
    next_pad = r_orig
    for b in sorted(set(int(b) for b in bits)):
        rows = np.nonzero(bits == b)[0]
        pad = (-len(rows)) % inner
        if pad:
            rows = np.concatenate([rows,
                                   np.arange(next_pad, next_pad + pad)])
            next_pad += pad
        groups.append((b, rows))
    order = np.concatenate([
        rows[k * (len(rows) // inner):(k + 1) * (len(rows) // inner)]
        for k in range(inner) for _b, rows in groups])
    local_bits = np.concatenate([
        np.full(len(rows) // inner, b, bits.dtype) for b, rows in groups])
    return order, np.argsort(order)[:r_orig], local_bits
