"""Op-level counts of a torch program: the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``.

Where the JAX package reads FLOPs and bytes off the compiled HLO, the
port traces the eager program itself: :class:`OpCounter` is a
``TorchDispatchMode`` over any callable, normally run on ``meta``
tensors (nothing is computed or allocated; the counterpart of
``jax.eval_shape`` and of lowering without running), and counts per
device:

* **FLOPs** — ``torch.utils.flop_counter``'s formulas (2·M·N·K for every
  ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``, an ``einsum`` reaching one
  of them; the convolutions forward and backward), split by the dtype
  of the product's inputs, because the card prices them apart (TF32 is
  off, so an fp32 product runs at the fp32 rate);
* **bytes** — each op's tensor inputs, each read once, and its outputs,
  each written once (a view, an alias and an ``empty`` move none; the
  destination of ``copy_`` / ``fill_`` / ``zero_`` and an ``out=`` buffer
  are written, not read): the eager program's counterpart of HLO's
  top-level operands and results;
* **the peak of live temporaries** — every storage the program
  allocates is live from the op that makes it until its last tensor
  dies (autograd's saved tensors included), and the peak is the largest
  sum at any op;
* a breakdown by op name (calls, FLOPs, bytes);
* **collectives** — each ``_c10d_functional`` op, by kind, in the JAX
  package's convention (its ``launch/roofline.py``): an all-gather counts
  its output, an all-reduce twice its operand, a reduce-scatter, an
  all-to-all and a permute their operand.

Under an in-node layout the program's tensors are DTensors
(``repro_torch.sharding``): the counter leaves each op on DTensors to
DTensor's own dispatch and counts what that runs on this rank — the
local shards' ops and the collectives of its redistributions — so every
count above is one rank's.

Counts split by part: the program's ``torch.profiler.record_function``
spans named in :data:`PARTS` (the train program's ``teacher`` and
``student``), and :data:`MICROBATCH` (one microbatch's work); the same
spans a profiler trace shows.  The memory peak is also kept apart by
moment: inside ``models/blockwise.blockwise_attention``, in one of its
(q-block, kv-block) pairs (``_attend_pair``) or not, which the counter
sees as those functions start and return (``sys.monitoring``), and
autograd's backward of what ran there.

Repeated work — the stack's period loop, blockwise attention's
(q-block, kv-block) pairs, the microbatch loop — costs trace time in
proportion to its trip count, so :func:`fit_counts` counts exactly at
small trip counts and evaluates the exact polynomial in each count at
the real ones (forward, backward and ``torch.utils.checkpoint``'s
recompute alike, with no hook in the model code), after checking the fit
against one more traced instance.  The model's results are never
touched: counting only observes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import weakref
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16",
                torch.float32: "fp32", torch.float64: "fp64"}
# ops that allocate without touching memory
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}
# in-place ops whose destination is written without being read
_PURE_WRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "bernoulli_", "exponential_", "random_"}
# collective kinds (the JAX package's names) of the functional
# collectives; an op of their namespaces not named here moves nothing
# (``wait_tensor``, ``_wrap_tensor_autograd``)
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "permute_tensor": "collective-permute",
                # DTensor's shard-to-shard move (an all-to-all of the
                # operand on the card's mesh)
                "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_kind(func) -> Optional[str]:
    """The collective kind of a functional collective op, else None."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func.overloadpacket.__name__
    for suffix in ("_out", "_"):
        if name not in _COLLECTIVES and name.endswith(suffix):
            name = name[:-len(suffix)]
    return _COLLECTIVES.get(name)


_DTENSOR: List[Any] = []


def _is_dtensor_type(t) -> bool:
    if not _DTENSOR:
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        _DTENSOR.extend((DTensor, FakeTensor))
    return issubclass(t, _DTENSOR[0])


def _is_fake(ts) -> bool:
    """Any of ``ts`` a FakeTensor: DTensor's sharding propagation runs an
    op on fake tensors at the global shapes to learn its output's shape;
    the program never makes one, so such an op is not the rank's work."""
    return bool(_DTENSOR) and any(isinstance(t, _DTENSOR[1]) for t in ts)


def _propagation_codes() -> tuple:
    """The code of DTensor's uncached sharding propagation: it runs ops
    of its own (a strategy's decomposition on meta tensors, an op on fake
    tensors for its output's shape), once a process for each op schema,
    which are no rank's work.  Empty where DTensor is not loaded yet (no
    program of DTensors has run)."""
    mod = sys.modules.get("torch.distributed.tensor._sharding_prop")
    if mod is None:
        return ()
    cls = mod.ShardingPropagator
    codes = tuple(getattr(cls, n).__code__ for n in (
        "propagate_op_sharding_non_cached",
        "_propagate_tensor_meta_non_cached") if hasattr(cls, n))
    if not codes:
        raise RuntimeError("this torch's DTensor has no uncached sharding "
                           "propagation the counter knows")
    return codes


def _local(t):
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for t in x if isinstance(t, torch.Tensor)]
    return []


def _key(args) -> tuple:
    """The memo key of an op's arguments: tensors by shape, strides,
    dtype and offset, every other argument by value."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append((a.shape, a.stride(), a.dtype, a.storage_offset()))
        elif isinstance(a, (list, tuple)):
            out.append(_key(a))
        else:
            out.append(a)
    return tuple(out)


@dataclasses.dataclass
class OpCount:
    """One program's counts (per device).  ``flops`` by the products'
    input dtype (``"bf16"``, ``"fp32"``, ...); ``by_op`` maps an op's name
    to ``{"calls", "flops", "bytes"}``; ``temp_peak_bytes`` is the peak of
    the storages the program allocates (its fresh outputs included);
    ``argument_bytes`` the storages of its arguments, ``output_bytes`` the
    tensors it returns, ``alias_bytes`` those of them that are argument
    storages (state updated in place, a cache written in place).

    ``parts`` holds the same counts by the part an op ran in (``""``
    outside any), and ``memory`` the argument, output and alias bytes by
    part; ``peaks`` maps ``"<part>|pair"`` / ``"<part>|attention"`` /
    ``"<part>|other"`` (where the program was at the moment: in that
    part; inside blockwise attention, in one of its block pairs or not;
    or outside) to the live bytes at that moment's peak, by the part that
    allocated them.  ``coll`` holds the collective bytes by kind and
    ``coll_counts`` their calls."""
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    calls: float = 0.0
    by_op: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    temp_peak_bytes: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    parts: Dict[str, "OpCount"] = dataclasses.field(default_factory=dict)
    memory: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peaks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def add(self, name: str, flops: float, fdtype, nbytes: float,
            calls: float = 1) -> None:
        self.calls += calls
        self.bytes += nbytes
        e = self.by_op.setdefault(name, {"calls": 0, "flops": 0,
                                         "bytes": 0})
        e["calls"] += calls
        e["bytes"] += nbytes
        if flops:
            if fdtype is not None:
                self.flops[fdtype] = self.flops.get(fdtype, 0) + flops
            e["flops"] += flops

    def add_collective(self, kind: str, nbytes: float, calls: float) -> None:
        self.coll[kind] = self.coll.get(kind, 0) + nbytes
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + calls

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll.values()))

    def quantities(self) -> Dict[Tuple[str, ...], float]:
        """Every count by part as one flat dict (the fit's vector)."""
        q: Dict[Tuple[str, ...], float] = {}
        for p, c in self.parts.items():
            q[(p, "bytes")] = c.bytes
            q[(p, "calls")] = c.calls
            for k, v in c.flops.items():
                q[(p, "flops", k)] = v
            for name, d in c.by_op.items():
                for k, v in d.items():
                    q[(p, "op", name, k)] = v
            for k, v in c.coll.items():
                q[(p, "coll", k)] = v
            for k, v in c.coll_counts.items():
                q[(p, "coll_calls", k)] = v
        for p, d in self.memory.items():
            for k, v in d.items():
                q[(p, "memory", k)] = v
        return q

    @classmethod
    def from_quantities(cls, q: Dict[Tuple[str, ...], float]) -> "OpCount":
        """The counts of ``q`` (by part) and their totals."""
        c = cls()
        for key, v in q.items():
            p, kind = key[0], key[1]
            if kind == "memory":
                c.memory.setdefault(p, {})[key[2]] = v
                setattr(c, key[2], getattr(c, key[2]) + v)
                continue
            pc = c.parts.setdefault(p, cls())
            for t in (pc, c):
                if kind == "bytes":
                    t.bytes += v
                elif kind == "calls":
                    t.calls += v
                elif kind == "flops":
                    t.flops[key[2]] = t.flops.get(key[2], 0) + v
                elif kind == "coll":
                    t.coll[key[2]] = t.coll.get(key[2], 0) + v
                elif kind == "coll_calls":
                    t.coll_counts[key[2]] = t.coll_counts.get(key[2], 0) + v
                else:
                    e = t.by_op.setdefault(key[2], {"calls": 0, "flops": 0,
                                                    "bytes": 0})
                    e[key[3]] += v
        return c


class OpCounter(TorchDispatchMode):
    """Counts every aten op run under it (see the module docstring).

    Ops with identical inputs (shapes, strides, dtypes, offsets, the
    other arguments) repeat in every layer and every block pair; the
    second time such an op is met on ``meta`` tensors its outputs are
    remade from the first's (a fresh ``empty_strided``, an
    ``as_strided`` view of the same input, or the input written in
    place) instead of running the op's Python meta function again, and
    its counts are the first's."""

    _memo: Dict[Any, Any] = {}

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        # with ``device``, an op none of whose tensors is there is not the
        # program's (DTensor's own bookkeeping on the mesh's CPU tensors)
        self.device = device
        self.count = OpCount()
        self.tag = ""
        self._spans: List[str] = []
        self.attention = 0
        self.propagating = 0
        self.in_pair = False
        self._marked = False
        self._rows: Dict[Tuple[str, str], List[Any]] = {}
        self._peak_total: Dict[str, int] = {}
        self._live: Dict[int, Tuple[int, str]] = {}
        self._live_by: Dict[str, int] = {}
        self._live_bytes = 0
        self._refs: List[Any] = []

    def __enter__(self):
        from repro_torch.models import blockwise
        mon = sys.monitoring
        self._tool = next((i for i in range(6) if mon.get_tool(i) is None),
                          None)
        if self._tool is None:
            raise RuntimeError("no free sys.monitoring tool id")
        mon.use_tool_id(self._tool, "repro_torch.op_analysis")
        self._attention_code = blockwise.blockwise_attention.__code__
        self._pair_code = blockwise._attend_pair.__code__
        self._prop_codes = _propagation_codes()
        ev = mon.events
        mon.register_callback(self._tool, ev.PY_START, self._started)
        mon.register_callback(self._tool, ev.PY_RETURN, self._returned)
        # checkpoint's recompute stops early by raising through the
        # attention it ran: an unwind ends a call as a return does
        mon.register_callback(self._tool, ev.PY_UNWIND, self._returned)
        mon.set_events(self._tool, ev.PY_UNWIND)
        for code in self._codes():
            mon.set_local_events(self._tool, code,
                                 ev.PY_START | ev.PY_RETURN)
        return super().__enter__()

    def _codes(self):
        return (self._attention_code, self._pair_code) + self._prop_codes

    def __exit__(self, *exc):
        mon = sys.monitoring
        ev = mon.events
        for code in self._codes():
            mon.set_local_events(self._tool, code, 0)
        mon.set_events(self._tool, 0)
        for e in (ev.PY_START, ev.PY_RETURN, ev.PY_UNWIND):
            mon.register_callback(self._tool, e, None)
        mon.free_tool_id(self._tool)
        return super().__exit__(*exc)

    def _started(self, code, offset) -> None:
        if code is self._pair_code:
            self.in_pair = True
        elif code is self._attention_code:
            self.attention += 1
        else:
            self.propagating += 1

    def _returned(self, code, offset, value) -> None:
        if code is self._pair_code:
            self.in_pair = False
        elif code is self._attention_code:
            self.attention -= 1
        elif code in self._prop_codes:
            self.propagating -= 1

    def _span(self, func, args, kwargs):
        """A ``record_function`` span opens or closes: the part an op
        counts toward is the innermost open span named in :data:`PARTS`
        (``""`` outside any), with :data:`MICRO` appended inside a
        :data:`MICROBATCH` span."""
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__ == "_record_function_enter_new":
            self._spans.append(args[0])
        elif self._spans:
            self._spans.pop()
        part = next((n for n in reversed(self._spans) if n in PARTS), "")
        self.tag = part + MICRO if MICROBATCH in self._spans else part
        return out

    def _free(self, key: int) -> None:
        n, part = self._live.pop(key, (0, ""))
        self._live_bytes -= n
        self._live_by[part] = self._live_by.get(part, 0) - n

    def _track(self, outs, in_storages) -> None:
        for o in outs:
            st = o.untyped_storage()
            k = st._cdata
            if k in in_storages or k in self._live:
                continue
            n = st.nbytes()
            self._live[k] = (n, self.tag)
            self._live_by[self.tag] = self._live_by.get(self.tag, 0) + n
            self._live_bytes += n
            self._refs.append(weakref.ref(st, lambda _, k=k: self._free(k)))
        key = self.tag + "|" + self._moment()
        if self._live_bytes > self._peak_total.get(key, -1):
            self._peak_total[key] = self._live_bytes
            self.count.peaks[key] = {p: float(n) for p, n in
                                     self._live_by.items() if n}

    def _moment(self) -> str:
        """Where the program is: ``pair`` / ``attention`` inside blockwise
        attention (in one of its block pairs or not) or in the backward
        of an op that ran there, ``other`` elsewhere."""
        if self.attention:
            return "pair" if self.in_pair else "attention"
        if not self._marked:
            return "other"
        node = torch._C._current_autograd_node()
        if node is None:
            return "other"
        return node.metadata.get(_MOMENT, "other")

    def _mark(self, ins) -> None:
        """Tag the autograd nodes of an attention op's inputs with the
        moment, so that their backward counts as the same moment."""
        where = "pair" if self.in_pair else "attention"
        for t in ins:
            fn = t.grad_fn
            if fn is not None and _MOMENT not in fn.metadata:
                fn.metadata[_MOMENT] = where
                self._marked = True

    def _record(self, name: str, flops: float, fdtype, nbytes: int,
                coll=None) -> None:
        row = self._rows.get((self.tag, name))
        if row is None:
            row = self._rows[self.tag, name] = [0, 0, 0, {}, None]
        row[0] += 1
        row[2] += nbytes
        if flops:
            row[1] += flops
            row[3][fdtype] = row[3].get(fdtype, 0) + flops
        if coll is not None:
            kind, cb = coll
            row[4] = (kind, (row[4] or (kind, 0))[1] + cb)

    def finish(self) -> OpCount:
        """The counts by part, and their totals."""
        c = self.count
        c.temp_peak_bytes = float(max(self._peak_total.values(), default=0))
        for (tag, name), (calls, flops, nbytes, by_dtype, coll) in \
                self._rows.items():
            pc = c.parts.get(tag)
            if pc is None:
                pc = c.parts[tag] = OpCount()
            pc.add(name, flops, None, nbytes, calls)
            c.add(name, flops, None, nbytes, calls)
            for d, f in by_dtype.items():
                pc.flops[d] = pc.flops.get(d, 0) + f
                c.flops[d] = c.flops.get(d, 0) + f
            if coll is not None:
                pc.add_collective(coll[0], coll[1], calls)
                c.add_collective(coll[0], coll[1], calls)
        return c

    def _measure(self, func, args, kwargs, out, ins, outs, in_storages):
        """(flops, flop dtype, bytes, collective) of one op's run; the
        collective ``(kind, bytes)`` or None."""
        name = func.overloadpacket.__name__
        kind = collective_kind(func)
        coll = None
        if kind is None and func.namespace in _COLLECTIVE_NAMESPACES:
            return 0, None, 0, None          # a wait or a wrapper
        if kind is not None:
            operand = sum(_nbytes(t) for t in ins)
            coll = (kind, sum(_nbytes(o) for o in outs)
                    if kind == "all-gather" else
                    2 * operand if kind == "all-reduce" else operand)
        fresh = any(o.untyped_storage()._cdata not in in_storages
                    for o in outs)
        if (not fresh and not func._schema.is_mutable) or name in _EMPTY:
            return 0, None, 0, coll
        skip = set()
        if name in _PURE_WRITE and args and isinstance(args[0],
                                                       torch.Tensor):
            skip.add(id(args[0]))
        for arg in func._schema.arguments:
            if arg.is_out and arg.name in kwargs:
                skip.update(id(t) for t in _tensors(kwargs[arg.name]))
        seen = {}
        for t in ins:
            if id(t) not in skip:
                seen[id(t)] = t
        nbytes = sum(_nbytes(t) for t in seen.values()) + \
            sum(_nbytes(o) for o in outs)
        flops, fdtype = 0, None
        f = flop_registry.get(func.overloadpacket)
        if f is not None:
            flops = int(f(*args, **kwargs, out_val=out))
            fdtype = dtype_name(ins[0].dtype)
        return flops, fdtype, nbytes, coll

    @staticmethod
    def _specs(out, outs, ins, before):
        """How to remake ``out`` from the inputs on a memo hit: each
        output fresh (0, shape, stride, dtype), a view of input i (1, i,
        shape, stride, offset) or input i itself, its layout unchanged
        (2, i); None where it cannot be remade."""
        if isinstance(out, torch.Tensor):
            container = None
        elif isinstance(out, (tuple, list)) and len(outs) == len(out):
            container = type(out)
        else:
            return None
        specs = []
        for o in outs:
            if o.device.type != "meta":
                return None
            k = o.untyped_storage()._cdata
            src = next((i for i, t in enumerate(ins)
                        if t.untyped_storage()._cdata == k), None)
            if src is None:
                specs.append((0, o.shape, o.stride(), o.dtype))
            elif o is ins[src]:
                if before[src] != (o.shape, o.stride(), o.storage_offset()):
                    return None
                specs.append((2, src))
            else:
                specs.append((1, src, o.shape, o.stride(),
                              o.storage_offset()))
        return container, specs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":
            return self._span(func, args, kwargs)
        if self.propagating:
            return func(*args, **kwargs)
        if types and any(_is_dtensor_type(t) for t in types):
            # DTensor's dispatch runs this rank's ops, which come back
            # here; autograd records the op itself, whose backward is
            # of the moment the op ran in
            if self.attention:
                self._mark([t for a in args for t in _tensors(a)])
            return NotImplemented
        ins: List[torch.Tensor] = []
        key: List[Any] = [func]
        meta = True
        for a in args:
            if isinstance(a, torch.Tensor):
                ins.append(a)
                meta = meta and a.is_meta
                key.append((a.shape, a.stride(), a.dtype,
                            a.storage_offset()))
            elif isinstance(a, (list, tuple)):
                for t in a:
                    if isinstance(t, torch.Tensor):
                        ins.append(t)
                        meta = meta and t.is_meta
                key.append(_key(a))
            else:
                key.append(a)
        if kwargs:
            for a in kwargs.values():
                for t in _tensors(a):
                    ins.append(t)
                    meta = meta and t.is_meta
            key.append(_key(tuple(kwargs.items())))
        if _is_fake(ins) or (self.device is not None and ins and all(
                t.device.type != self.device for t in ins)):
            return func(*args, **kwargs)
        hit = None
        if meta and ins:
            try:
                key = tuple(key)
                hit = self._memo.get(key)
            except TypeError:
                key = None
        else:
            key = None
        if hit is not None:
            (container, specs), measured, name = hit
            outs, fresh = [], []
            for spec in specs:
                if spec[0] == 0:
                    o = torch.empty_strided(spec[1], spec[2], dtype=spec[3],
                                            device="meta")
                    fresh.append(o)
                elif spec[0] == 1:
                    o = ins[spec[1]].as_strided(spec[2], spec[3], spec[4])
                else:
                    o = ins[spec[1]]
                outs.append(o)
            out = outs[0] if container is None else container(outs)
            if self.attention:
                self._mark(ins)
            if fresh:
                self._track(fresh, ())
            self._record(name, *measured)
            return out
        name = func.overloadpacket.__name__
        in_storages = {t.untyped_storage()._cdata for t in ins}
        before = [(t.shape, t.stride(), t.storage_offset())
                  for t in ins] if key is not None else None
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not ins and (_is_fake(outs) or self.device is not None and all(
                o.device.type != self.device for o in outs)):
            return out
        measured = self._measure(func, args, kwargs, out, ins, outs,
                                 in_storages)
        if key is not None and outs:
            specs = self._specs(out, outs, ins, before)
            if specs is not None:
                self._memo[key] = (specs, measured, name)
        if self.attention:
            self._mark(ins)
        self._track(outs, in_storages)
        self._record(name, *measured)
        return out


# the record_function spans a count splits by: a part each, and one
# microbatch's work (counted toward its part's MICRO twin, which a fit
# scales by the real number of microbatches over the traced)
PARTS = ("teacher", "student")
MICROBATCH = "microbatch"
MICRO = "@microbatch"
_MOMENT = "op_analysis.moment"       # an autograd node's metadata key


def _has_dtensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return hasattr(x, "_local_tensor")
    if hasattr(x, "_asdict") or isinstance(x, (list, tuple)):
        return any(_has_dtensor(e) for e in x)
    if isinstance(x, dict):
        return any(_has_dtensor(e) for e in x.values())
    return False


def _flat_tensors(x) -> List[torch.Tensor]:
    """The tensors of a tree (a DTensor's local shard in its place)."""
    if isinstance(x, torch.Tensor):
        return [_local(x)]
    if hasattr(x, "_asdict"):       # a NamedTuple state
        x = list(x)
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _flat_tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _flat_tensors(e)]
    if hasattr(x, "buf"):           # a Plane
        return [x.buf]
    return []


def count_ops(fn: Callable, *args, arg_parts: Optional[Dict[str, Any]]
              = None, **kwargs) -> OpCount:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter` and return
    its counts, with the memory of its arguments and outputs.
    ``arg_parts`` maps a part to the argument subtrees that belong to it
    (the rest of the arguments belong to ``""``); an output belongs to
    the part of the argument it aliases, or of the op that made it."""
    owner: Dict[int, str] = {}
    for p, sub in (arg_parts or {}).items():
        for t in _flat_tensors(sub):
            owner[t.untyped_storage()._cdata] = p
    arg_t = _flat_tensors((args, kwargs))
    arg_st: Dict[int, int] = {}
    for t in arg_t:
        st = t.untyped_storage()
        arg_st[st._cdata] = st.nbytes()
    # the argument storages are held for the whole run: one the program
    # drops (a state entry replaced) must not lend its address to a new
    # storage, which would read as an alias
    held = [t.untyped_storage() for t in arg_t]
    # no cyclic collection while counting: a storage dies when its last
    # reference does, at the same op in every trace (and the collector's
    # passes over a large autograd graph cost more than the count).  A
    # module first imported mid-trace (torch._dynamo, by the first call of
    # a function it wraps) leaves a cycle through the program's frames,
    # which would then hold their tensors to the end: import it first
    import torch._dynamo  # noqa: F401
    collecting = gc.isenabled()
    gc.disable()
    try:
        return _count(fn, args, kwargs, arg_st, owner)
    finally:
        del held
        if collecting:
            gc.enable()


def _count(fn, args, kwargs, arg_st, owner) -> OpCount:
    # one rank's program of DTensors on meta: only meta tensors are its
    device = "meta" if _has_dtensor((args, kwargs)) and all(
        t.is_meta for t in _flat_tensors((args, kwargs))) else None
    with OpCounter(device) as counter:
        out = fn(*args, **kwargs)
        c = counter.count
        mem: Dict[str, Dict[str, float]] = {}

        def add(p, k, n):
            d = mem.setdefault(p, {"argument_bytes": 0.0,
                                   "output_bytes": 0.0, "alias_bytes": 0.0})
            d[k] += n
        for k, n in arg_st.items():
            add(owner.get(k, ""), "argument_bytes", n)
        seen = set()
        for t in _flat_tensors(out):
            st = t.untyped_storage()
            k = st._cdata
            if k in seen:
                continue
            seen.add(k)
            if k in arg_st:
                p = owner.get(k, "")
                add(p, "alias_bytes", st.nbytes())
            else:
                p = counter._live.get(k, (0, ""))[1]
            add(p, "output_bytes", st.nbytes())
        counter.finish()
        c.memory = mem
        for d in mem.values():
            for k, v in d.items():
                setattr(c, k, getattr(c, k) + v)
        del out
    return c


# ---------------------------------------------------------------------------
# the trip-count fit
# ---------------------------------------------------------------------------

class FitError(AssertionError):
    """The fitted polynomial missed the held-out trace."""


def _monomial(point: Dict[str, int], mono: Dict[str, int]) -> Fraction:
    v = Fraction(1)
    for var, deg in mono.items():
        v *= Fraction(point[var]) ** deg
    return v


def _reduce(basis: List[Tuple[int, List[Fraction]]],
            row: List[Fraction]) -> Optional[Tuple[int, List[Fraction]]]:
    """``row`` reduced against the echelon ``basis`` ((pivot, row) pairs);
    None where it depends on them."""
    row = list(row)
    for piv, b in basis:
        if row[piv] != 0:
            f = row[piv] / b[piv]
            row = [x - f * y for x, y in zip(row, b)]
    piv = next((i for i, x in enumerate(row) if x != 0), None)
    return None if piv is None else (piv, row)


def independent(points: Sequence[Dict[str, int]],
                monomials: Sequence[Dict[str, int]]) -> List[int]:
    """Indices of the first points (in order) whose monomial rows are
    linearly independent, as many as there are monomials or fewer."""
    basis: List[Tuple[int, List[Fraction]]] = []
    chosen = []
    for i, p in enumerate(points):
        red = _reduce(basis, [_monomial(p, m) for m in monomials])
        if red is not None:
            basis.append(red)
            chosen.append(i)
            if len(chosen) == len(monomials):
                break
    return chosen


def design(candidates: Dict[str, Sequence[int]],
           monomials: Sequence[Dict[str, int]],
           cost: Callable[[Dict[str, int]], float],
           beyond: Sequence[str] = ()
           ) -> Tuple[List[Dict[str, int]], Dict[str, int]]:
    """The cheapest sample points (by ``cost``) of the grid of
    ``candidates`` that determine ``monomials``, and the held-out point:
    every variable at its second candidate, but those named in ``beyond``
    at the first candidate no sample takes (where there is one), so that
    the check sees them beyond the samples."""
    import itertools
    names = sorted(candidates)
    grid = [dict(zip(names, vals)) for vals in
            itertools.product(*(candidates[n] for n in names))]
    grid.sort(key=lambda p: (cost(p), tuple(p[n] for n in names)))
    chosen = independent(grid, monomials)
    if len(chosen) < len(monomials):
        raise ValueError(f"the grid {candidates} does not determine "
                         f"{list(monomials)}")
    samples = [grid[i] for i in chosen]
    held = {}
    for n, vals in candidates.items():
        unused = [v for v in vals if all(p[n] != v for p in samples)]
        held[n] = unused[0] if unused and n in beyond else \
            vals[min(1, len(vals) - 1)]
    if held in samples:
        raise ValueError(f"no held-out point outside the samples {samples}")
    return samples, held


def _solve(points, monomials, values) -> List[List[Fraction]]:
    """Coefficients (one list per monomial) of the exact polynomials
    through ``values`` (one list of quantities per point)."""
    n = len(monomials)
    a = [[_monomial(p, m) for m in monomials] + list(v)
         for p, v in zip(points, values)]
    for i in range(n):
        piv = next((r for r in range(i, n) if a[r][i] != 0), None)
        if piv is None:
            raise ValueError("the sample points do not determine the "
                             "monomials")
        a[i], a[piv] = a[piv], a[i]
        inv = 1 / a[i][i]
        a[i] = [x * inv for x in a[i]]
        for r in range(n):
            if r != i and a[r][i] != 0:
                f = a[r][i]
                a[r] = [x - f * y for x, y in zip(a[r], a[i])]
    return [row[n:] for row in a]


def _evaluate(coef, monomials, point) -> List[Fraction]:
    x = [_monomial(point, m) for m in monomials]
    return [sum((xi * coef[i][j] for i, xi in enumerate(x)), Fraction(0))
            for j in range(len(coef[0]))]


@dataclasses.dataclass
class Fit:
    """The result of :func:`fit_counts`: the counts at the real trip
    counts, the traces' points and how the memory peak was found."""
    count: OpCount
    samples: List[Dict[str, int]]
    held_out: Dict[str, int]
    real: Dict[str, Dict[str, int]]
    temp_peak_method: str
    # the FLOPs and bytes at the real trip counts by the fit's monomial
    # that carries them ("1", "X", "X^2", "X*j", ...)
    terms: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"samples": self.samples, "held_out": self.held_out,
                "real": self.real, "traces": len(self.samples) + 1,
                "held_out_check": "exact",
                "temp_peak_method": self.temp_peak_method,
                "terms": self.terms}


def _monomial_name(mono: Dict[str, int]) -> str:
    return "*".join(v if d == 1 else f"{v}^{d}"
                    for v, d in sorted(mono.items())) or "1"


def fit_counts(trace: Callable[[Dict[str, int]], OpCount],
               monomials: Sequence[Dict[str, int]],
               samples: Sequence[Dict[str, int]],
               held_out: Dict[str, int],
               real: Dict[str, Dict[str, int]],
               peak_monomials: Optional[Sequence[Dict[str, int]]] = None,
               part_vars: Optional[Dict[str, Sequence[str]]] = None,
               microbatches: Fraction = Fraction(1)) -> Fit:
    """Fit every count of ``trace(point)`` as an exact polynomial in the
    trip counts: ``monomials`` (one ``{variable: degree}`` dict each, ``{}``
    the constant) from one trace at each of ``samples`` (as many as
    monomials), then trace ``held_out`` and raise :class:`FitError`
    unless the polynomial gives all of its counts (FLOPs, bytes and
    calls, by op, by part; argument, output and alias bytes by part)
    exactly.  Each part's counts are taken at its own real point,
    ``real[part]`` (``real[""]`` for a part not listed): the traces may
    move several stacks with one variable and tell them apart by part.
    ``part_vars`` names the variables a part may depend on; a fitted
    term of any other raises :class:`FitError`.  The counts of a part's
    :data:`MICRO` twin (one microbatch's work, all alike) are scaled by
    ``microbatches``, the real microbatches over the traced.

    The memory peak is not a sum.  Each of the trace's peak moments
    (``OpCount.peaks``: by part, inside attention or not) is fitted by
    the part that allocated its bytes, in ``peak_monomials`` (default
    ``monomials``; negative degrees allowed) over the samples that
    determine them, each allocating part at its own real point; a moment
    whose fit misses the held-out trace's exactly is the largest that
    any trace showed, a lower bound (``temp_peak_method`` says which).
    The peak is the largest moment."""
    if len(samples) != len(monomials):
        raise ValueError(f"{len(samples)} samples for {len(monomials)} "
                         f"monomials")
    counts = [trace(p) for p in samples]
    check = trace(held_out)
    keys = sorted({k for c in counts + [check] for k in c.quantities()})

    def vector(c):
        q = c.quantities()
        return [Fraction(int(q.get(k, 0))) for k in keys]

    coef = _solve(samples, monomials, [vector(c) for c in counts])
    pred, got = _evaluate(coef, monomials, held_out), vector(check)
    for name, p, g in zip(keys, pred, got):
        if p != g:
            raise FitError(f"the trip-count fit gives {name} = {float(p)} "
                           f"at {held_out}, the trace {float(g)}")
    for j, name in enumerate(keys):
        allowed = (part_vars or {}).get(name[0].replace(MICRO, ""))
        if allowed is None:
            continue
        for i, m in enumerate(monomials):
            if coef[i][j] != 0 and set(m) - set(allowed):
                raise FitError(f"{name} depends on {m}, outside "
                               f"{list(allowed)}")

    def real_of(p):
        p = p[:-len(MICRO)] if p.endswith(MICRO) else p
        return real.get(p, real[""])
    q = {}
    terms: Dict[str, Dict[str, float]] = {"flops": {}, "bytes": {}}
    for j, name in enumerate(keys):
        x = [_monomial(real_of(name[0]), m) for m in monomials]
        scale = Fraction(microbatches) if name[0].endswith(MICRO) else 1
        v = sum((xi * coef[i][j] for i, xi in enumerate(x)),
                Fraction(0)) * scale
        if v:
            q[name] = float(v)
        if name[1] in terms:
            t = terms[name[1]]
            for i, m in enumerate(monomials):
                if coef[i][j] and x[i]:
                    k = _monomial_name(m)
                    t[k] = t.get(k, 0.0) + float(x[i] * coef[i][j] * scale)
    count = OpCount.from_quantities(q)

    pm = list(peak_monomials if peak_monomials is not None else monomials)
    use = independent(samples, pm)
    moments = sorted({k for c in counts + [check] for k in c.peaks})
    methods = set()
    for moment in moments:
        alloc = sorted({a for c in counts + [check]
                        for a in c.peaks.get(moment, {})})
        total = Fraction(0)
        ok = len(use) == len(pm)
        for a in alloc:
            vals = [Fraction(int(c.peaks.get(moment, {}).get(a, 0)))
                    for c in counts]
            want = int(check.peaks.get(moment, {}).get(a, 0))
            if not ok:
                break
            pc = _solve([samples[i] for i in use], pm,
                        [[vals[i]] for i in use])
            if _evaluate(pc, pm, held_out)[0] != want:
                ok = False
                break
            total += _evaluate(pc, pm, real_of(a))[0]
        if not ok:
            total = max(Fraction(int(sum(c.peaks.get(moment, {}).values())))
                        for c in counts + [check])
        methods.add("fit" if ok else "largest trace (a lower bound)")
        count.peaks[moment] = {"bytes": float(total),
                               "method": "fit" if ok else "largest trace"}
        count.temp_peak_bytes = max(count.temp_peak_bytes, float(total))
    method = "fit" if methods <= {"fit"} else \
        "largest trace (a lower bound)" if methods == {
            "largest trace (a lower bound)"} else \
        "fit, some moments the largest trace (a lower bound)"
    return Fit(count, list(samples), dict(held_out),
               {p: dict(v) for p, v in real.items()}, method, terms)


@contextlib.contextmanager
def no_memo():
    """Forget the op memo (tests time a trace from a cold start)."""
    saved = dict(OpCounter._memo)
    OpCounter._memo.clear()
    try:
        yield
    finally:
        OpCounter._memo.update(saved)
