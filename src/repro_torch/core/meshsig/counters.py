"""The counter record a mesh signature is fitted from, and the port's
counter source that fills it (the counterpart of
``repro.core.meshsig.hlo_counters``).

A profiling run of a sharded program yields, per device: its FLOPs, its
HBM bytes, and every collective it executes with the collective's kind,
result bytes, group size, execution count and per-device link bytes.
:class:`ProgramCounters` holds those fields and
:func:`~repro_torch.core.meshsig.fit.profile_from_analysis` reads them;
:func:`collective_link_bytes` turns a collective's result bytes into the
bytes each device moves over links.

The reference fills its record by parsing the compiled, partitioned HLO
of a step.  The port has no HLO: its layers call their collectives
themselves (``parallel.context``).  :func:`count_program` runs one
rank's program instead, in one process: on ``meta`` tensors under a
layout-only ``Mesh`` (``mode="simulate"``: every collective is recorded
and runs nothing, so a rank of a 512-rank mesh needs no peers), or on
real tensors with its collectives run (``mode="observe"``).  A dispatch
mode of its own sees every ATen op the rank runs and keeps three
tallies:

* ``flops``: ``2 m n k`` for ``mm``, ``addmm``, ``bmm`` and ``baddbmm``
  (their ``out_dtype`` overloads too), ``mv`` and ``dot``; two per
  multiply-add of ``convolution`` and each gradient
  ``convolution_backward`` computes; and each kernel wrapper's own count
  (``parallel.context.kernel_work``: K1's 4 dh a visible pair forward
  and 2.5 times that backward, K2's bound's operations).  Elementwise
  work is not counted, as the reference's dot-only count does not.
* ``hbm_bytes``: a fusion-idealised model, the rule of the reference's
  ``_op_bytes_model``:

  ==========================================  ===============================
  op                                          bytes
  ==========================================  ===============================
  views, allocations, pointwise ops, fills,   0 (fused into their neighbours)
  dtype casts and device moves (``_to_copy``)
  materialised slices and gathers             2 x the result (read, write)
  (``index_select``, ``gather``, ``index``,
  ``embedding``, ...)
  slice updates (``index_put_``,              2 x the update
  ``scatter_``, ``index_add_``, ...)
  products, reductions, copies (``clone``,    operands + result
  ``copy_``), concatenations and any other
  op; every collective; the two kernels
  (their own bytes)
  ==========================================  ===============================

  An operand counts the elements of its view (a broadcast operand its
  broadcast size).
* ``hbm_bytes_raw``: every op's operands and result, views and
  allocations aside (the upper bound the reference also keeps).

A ``meta`` op is a shape function, and a rank repeats the same ones
many times (every layer, every micro-batch), so in ``"simulate"`` mode
the outputs of an op that allocates fresh results are memoised by the
op and its inputs' shapes, strides and dtypes and remade with
``empty_strided``.

The rank's memory is read from its storages' lifetimes: the bytes of
every storage the run allocates are live from the op that makes them
until the storage is freed (a weak reference's callback), and the peak
of that sum is the run's temporaries' peak.  An op's internal scratch is
not seen.  ``memory`` holds ``argument_size_in_bytes`` (the storages the
arguments reach: parameters, optimizer state, cache, batch),
``output_size_in_bytes`` (the storages the result reaches that the run
allocated) and ``temp_size_in_bytes`` (that peak; the outputs among
it), so a rank's peak is its arguments plus its temporaries' peak.
"""

from __future__ import annotations

import math
import time
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.parallel import context as ctx


@dataclass
class CollectiveOp:
    kind: str
    bytes: float  # result bytes x executions
    group: int
    count: float  # executions (trip-multiplied)
    link_bytes: float  # per-device link traffic estimate
    axes: tuple[str, ...] = ()  # the mesh axes it spans, in mesh order (port runs)


@dataclass
class ProgramCounters:
    """One profiling run's counters: the fields the signature fit reads
    (the reference's ``HloAnalysis`` without its parser's bookkeeping),
    and from :func:`count_program` the upper-bound bytes, each kernel's
    calls, operations and bytes, the memory sizes and the seconds the
    profile took."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list[CollectiveOp] = field(default_factory=list)
    hbm_bytes_raw: float = 0.0
    kernels: dict[str, dict] = field(default_factory=dict)
    memory: dict[str, int] = field(default_factory=dict)
    seconds: float = 0.0

    def collective_summary(self) -> dict:
        """Executions, result bytes and link bytes per collective kind,
        and the link bytes of all of them."""
        per_kind: dict[str, dict] = {}
        total_link = 0.0
        for c in self.collectives:
            s = per_kind.setdefault(
                c.kind, {"count": 0.0, "bytes": 0.0, "link_bytes": 0.0}
            )
            s["count"] += c.count
            s["bytes"] += c.bytes
            s["link_bytes"] += c.link_bytes
            total_link += c.link_bytes
        return {"per_kind": per_kind, "link_bytes_total": total_link}


def collective_link_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Per-device link bytes of one ring collective over ``group``
    devices whose result holds ``result_bytes`` (an all-gather's result
    is the gathered size, a reduce-scatter's the shard)."""
    k = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (k - 1) / k
    if kind == "all-gather":
        return result_bytes * (k - 1) / k
    if kind == "reduce-scatter":
        return result_bytes * (k - 1)
    if kind == "all-to-all":
        return result_bytes * (k - 1) / k
    return result_bytes  # collective-permute


# ---------------------------------------------------------------------------
# The counter source
# ---------------------------------------------------------------------------

_FREE_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh", "resize_", "set_",
               "as_strided_", "squeeze_", "unsqueeze_", "transpose_", "t_"}
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
           "empty_permuted"}
# writes or casts an elementwise result, fused on a TPU (no pointwise tag)
_FREE_WRITES = {"_to_copy", "fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like",
                "full", "full_like", "new_zeros", "new_ones", "new_full", "arange",
                "scalar_tensor", "randn", "rand", "randint", "normal_", "uniform_",
                "random_", "bernoulli_", "masked_fill_", "masked_fill", "tril", "triu"}
_COPIES = {"clone", "copy_", "contiguous", "_copy_from", "_copy_from_and_resize"}
_GATHERS = {"index_select", "gather", "index", "embedding", "take", "take_along_dim",
            "masked_select", "narrow_copy", "slice_copy", "select_copy"}
_UPDATES = {"index_put_", "index_put", "_index_put_impl_", "scatter_", "scatter",
            "scatter_add_", "scatter_add", "scatter_reduce_", "scatter_reduce", "index_add_",
            "index_add", "index_copy_", "index_copy", "index_fill_", "index_fill",
            "slice_scatter", "select_scatter", "masked_scatter_", "masked_scatter"}
_SKIPPED_NAMESPACES = {"c10d", "_c10d_functional", "c10d_functional"}


def _flat_tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat_tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat_tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args, out) -> float:
    """Multiply-adds times two of one product op (0 for any other op)."""
    if name == "mm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "baddbmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2.0 * args[0].numel()
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    if name == "convolution":
        x, w, transposed = args[0], args[1], args[6]
        taps = math.prod(w.shape[2:])
        return 2.0 * (x.numel() if transposed else out.numel()) * w.shape[1] * taps
    if name == "convolution_backward":
        grad_out, w, transposed, mask = args[0], args[2], args[7], args[10]
        taps = math.prod(w.shape[2:])
        per = 2.0 * (args[1].numel() if transposed else grad_out.numel()) * w.shape[1] * taps
        return per * (int(mask[0]) + int(mask[1]))
    return 0.0


def _model_bytes(name: str, func, ins: list, outs: list) -> float:
    """The fusion-idealised bytes of one op (the module's table)."""
    if func.is_view or name in _FREE_VIEWS or name in _ALLOCS or name in _FREE_WRITES:
        return 0.0
    if name in _COPIES:  # copy_ reads its source alone
        read = ins[1:] if name.endswith("_") else ins
        return float(sum(map(_nbytes, read)) + sum(map(_nbytes, outs)))
    if torch.Tag.pointwise in func.tags:
        return 0.0
    if name in _GATHERS:
        return 2.0 * sum(map(_nbytes, outs))
    if name in _UPDATES:
        base = ins[0]
        values = [t for t in ins[1:] if t.dtype == base.dtype and t.dim() > 0]
        if values:
            return 2.0 * max(map(_nbytes, values))
        index = max((t.numel() for t in ins[1:]), default=0)
        return 2.0 * index * base.element_size()
    return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))


_UNKEYED = object()
_ATOMS = (bool, int, float, str, torch.dtype, torch.device, torch.memory_format, torch.layout)


def _meta_key(x):
    """A hashable key of an op argument's metadata (``_UNKEYED`` where
    there is none)."""
    if isinstance(x, torch.Tensor):
        return (x.is_meta, x.dtype, x.shape, x.stride())
    if isinstance(x, (list, tuple)):
        out = []
        for y in x:
            k = _meta_key(y)
            if k is _UNKEYED:
                return _UNKEYED
            out.append(k)
        return tuple(out)
    if x is None or isinstance(x, _ATOMS):
        return x
    if isinstance(x, torch.Generator):
        return "generator"
    return _UNKEYED


def _spec(out):
    """How to remake ``out`` (a meta tensor or a tuple or list of them),
    or ``None``."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype) if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)) and out:
        specs = [_spec(t) for t in out]
        return None if any(x is None for x in specs) else (type(out), specs)
    return None


def _remake(spec):
    if isinstance(spec[0], torch.Size):
        return torch.empty_strided(spec[0], spec[1], dtype=spec[2], device="meta")
    kind, specs = spec
    return kind([_remake(x) for x in specs])


def _storages(tree, into: dict) -> dict:
    """``{storage key: bytes}`` of every tensor ``tree`` reaches (nested
    lists, tuples, dicts, named tuples and modules' parameters and
    buffers)."""
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            _storages(t, into)
    elif isinstance(tree, torch.Tensor):
        st = tree.untyped_storage()
        into[st._cdata] = st.nbytes()
    elif isinstance(tree, dict):
        for v in tree.values():
            _storages(v, into)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _storages(v, into)
    return into


class _Tally(TorchDispatchMode):
    """Counts every ATen op it sees (outside a kernel wrapper's body) and
    follows the storages the ops allocate."""

    def __init__(self, recording: ctx.Recording, args: dict):
        super().__init__()
        self.recording = recording
        self.flops = self.model = self.raw = 0.0
        self.args = args
        self.live: dict = {}
        self.live_bytes = self.peak = 0
        self.memo: dict | None = {} if recording.simulate else None
        self.fresh: dict = {}  # per op: whether it returns fresh tensors only

    def _run(self, func, args, kwargs):
        """``func``'s result, from the memo where an earlier call on the
        same metadata made fresh meta tensors."""
        if self.memo is None:
            return func(*args, **kwargs)
        fresh = self.fresh.get(func)
        if fresh is None:
            schema = func._schema
            fresh = self.fresh[func] = not schema.is_mutable and all(
                r.alias_info is None for r in schema.returns)
        if not fresh:
            return func(*args, **kwargs)
        key = _meta_key((args, tuple(sorted(kwargs.items()))) if kwargs else args)
        if key is _UNKEYED:
            return func(*args, **kwargs)
        key = (func, key)
        spec = self.memo.get(key)
        if spec is not None:
            return _remake(spec)
        out = func(*args, **kwargs)
        spec = _spec(out)
        if spec is not None:
            self.memo[key] = spec
        return out

    def _free(self, key) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _follow(self, outs: list) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.args or key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        outs = _flat_tensors(out, [])
        if func.namespace not in _SKIPPED_NAMESPACES and not self.recording.in_kernel:
            name = func._opname
            ins = _flat_tensors(args, _flat_tensors(kwargs, []))
            self.flops += _product_flops(name, args, out)
            self.model += _model_bytes(name, func, ins, outs)
            if not (func.is_view or name in _FREE_VIEWS or name in _ALLOCS):
                self.raw += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._follow(outs)
        return out


def _collective_bytes(op: ctx.CollectiveRecord) -> float:
    """Operand plus result bytes of one recorded collective."""
    operand = op.bytes / op.group if op.kind == "all-gather" else op.bytes
    return float(operand + op.bytes)


def count_program(fn, *args, mode: str = "simulate", **kwargs) -> ProgramCounters:
    """The counters of one rank running ``fn(*args, **kwargs)`` under the
    active mesh and rules (e.g. a ``launch.mesh.cell_context``): its
    collectives recorded and, in ``"simulate"`` mode, not run (``meta``
    tensors only; a layout-only mesh suffices), in ``"observe"`` mode
    run.  Every collective is one :class:`CollectiveOp` of count 1, in
    the order the rank called them, with the axes it spans."""
    arg_storages = _storages((args, kwargs), {})
    t0 = time.perf_counter()
    with ctx.record(mode) as rec, _Tally(rec, arg_storages) as tally:
        result = fn(*args, **kwargs)
    outputs = {k: v for k, v in _storages(result, {}).items() if k not in arg_storages}
    del result
    seconds = time.perf_counter() - t0

    counters = ProgramCounters(
        flops=tally.flops, hbm_bytes=tally.model, hbm_bytes_raw=tally.raw, seconds=seconds,
        memory={"argument_size_in_bytes": sum(arg_storages.values()),
                "output_size_in_bytes": sum(outputs.values()),
                "temp_size_in_bytes": tally.peak})
    for op in rec.collectives:
        counters.collectives.append(CollectiveOp(
            kind=op.kind, bytes=float(op.bytes), group=op.group, count=1.0,
            link_bytes=collective_link_bytes(op.kind, op.bytes, op.group), axes=op.axes))
        counters.hbm_bytes += _collective_bytes(op)
        counters.hbm_bytes_raw += _collective_bytes(op)
    for work in rec.kernels:
        k = counters.kernels.setdefault(work.name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        counters.flops += work.flops
        counters.hbm_bytes += work.bytes
        counters.hbm_bytes_raw += work.bytes
    return counters
