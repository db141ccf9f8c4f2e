"""Parameter trees: the port's stand-in for ``jax.tree_util``.

Parameters, gradients and optimizer moments are nested ``dict``s,
``list``s and ``tuple``s of tensors (a ResNet's ``"stages"`` is a list
of lists of block dicts).  Leaves are visited in JAX's flatten order —
dict keys sorted, lists and tuples in order — so the flat parameter
plane and the wire payload lay leaves out exactly as the JAX package
does.  Leaves may also be :class:`ShapeDtypeStruct`
skeletons (shape and numpy dtype only): the byte accountants read sizes
and types and never touch data.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Tuple)

import numpy as np
import torch


class ShapeDtypeStruct(NamedTuple):
    """Shape/dtype skeleton of one array (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def tree_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in flatten order: dict keys sorted, plain
    lists and tuples in order."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif type(tree) in (list, tuple):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, sub in items:
        out.extend(tree_paths(sub, prefix + (k,)))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure, visiting
    leaves in flatten order; dicts, lists and tuples keep their type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(tree_map(fn, sub, *(r[i] for r in rest))
                          for i, sub in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """:func:`tree_map` over one tree, ``fn(path, leaf)`` with each
    leaf's path as :func:`tree_paths` gives it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(tree_map_with_path(fn, sub, prefix + (i,))
                          for i, sub in enumerate(tree))
    return fn(prefix, tree)


def keystr(path) -> str:
    """A path as ``jax.tree_util.keystr`` renders it: ``['fc1']['kernel']``,
    ``['stages'][0][0]['conv1']['kernel']`` (a dict key by its ``repr``,
    a list index bare)."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)


def tree_empties(tree, prefix: Tuple = ()) -> Tuple[Tuple[Tuple, type], ...]:
    """``((path, type), ...)`` of the empty dicts, lists and tuples in
    ``tree``: what :func:`tree_paths` drops (they hold no leaf) and
    :func:`tree_from_paths` needs back to rebuild the tree whole, as a
    JAX treedef keeps them (an LM stack's ``"rem": []``)."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif type(tree) in (list, tuple):
        items = list(enumerate(tree))
    else:
        return ()
    if not items:
        return ((prefix, type(tree)),)
    out: Tuple = ()
    for k, sub in items:
        out += tree_empties(sub, prefix + (k,))
    return out


def tree_from_paths(items, empties=()):
    """Inverse of :func:`tree_paths`: an int path key is a list index
    (JAX's flatten visits list elements in order), any other key a dict
    key.  ``empties`` (:func:`tree_empties` of the tree flattened) puts
    its empty subtrees back, each a fresh container, so dict keys stay
    in flatten order."""
    if empties:
        items = sorted(list(items) + [(p, kind()) for p, kind in empties],
                       key=lambda item: item[0])
    root = [None]
    for path, leaf in items:
        parent, key = root, 0
        for k in path:
            node = parent[key]
            if node is None:
                node = parent[key] = [] if isinstance(k, int) else {}
            if isinstance(node, list):
                node.extend([None] * (k + 1 - len(node)))
            else:
                node.setdefault(k, None)
            parent, key = node, k
        parent[key] = leaf
    return root[0]


# -- states: NamedTuples of trees, walked leaf by leaf with keys ---------------
# A state (a NodeState, a CodecState) nests NamedTuples around parameter
# trees.  Its leaves carry ``repro``'s checkpoint keys: each path's parts
# ``/``-joined, a dict key as itself, a sequence item as ``#i``, a
# NamedTuple field as ``.name``; a ``None`` holds nothing.  A NamedTuple
# registered with :func:`register_buffer_node` (the parameter plane) is
# one leaf, its buffer field, keyed by that field's name; the rest of it
# is static and comes back from the tree rebuilt into.

KEY_SEP = "/"
_BUFFER_NODES: Dict[type, str] = {}


def register_buffer_node(cls: type, field: str) -> None:
    """Walk instances of the NamedTuple ``cls`` as one leaf: ``field``."""
    _BUFFER_NODES[cls] = field


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def keyed_leaves(tree, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[str, Any]]:
    """A state's ``[(key, leaf)]`` in flatten order (dict keys sorted)."""
    if tree is None:
        return []
    field = _BUFFER_NODES.get(type(tree))
    if field is not None:
        return [(KEY_SEP.join(prefix + (field,)), getattr(tree, field))]
    if _is_namedtuple(tree):
        kids = ((f".{name}", getattr(tree, name)) for name in tree._fields)
    elif isinstance(tree, dict):
        kids = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        kids = ((f"#{i}", x) for i, x in enumerate(tree))
    else:
        return [(KEY_SEP.join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for part, sub in kids:
        out.extend(keyed_leaves(sub, prefix + (part,)))
    return out


def rebuild(like, leaves: Iterator):
    """``like`` with every leaf of :func:`keyed_leaves` replaced by
    ``next(leaves)``, in that order."""
    if like is None:
        return None
    field = _BUFFER_NODES.get(type(like))
    if field is not None:
        return like._replace(**{field: next(leaves)})
    if _is_namedtuple(like):
        return type(like)(*(rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(rebuild(x, leaves) for x in like)
    return next(leaves)


def is_float(x) -> bool:
    """Floating dtype, for tensors and for ShapeDtypeStruct skeletons."""
    d = x.dtype
    if isinstance(d, torch.dtype):
        return d.is_floating_point
    return bool(np.issubdtype(np.dtype(d), np.floating))


def itemsize(x) -> int:
    d = x.dtype
    return d.itemsize if isinstance(d, torch.dtype) else np.dtype(d).itemsize


def numel(x) -> int:
    n = 1
    for s in x.shape:
        n *= int(s)
    return n
