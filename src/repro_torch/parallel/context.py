"""Mesh context + logical-axis rules (port of ``repro.parallel.context``).

Models never name physical mesh axes directly; they name *logical* dims,
which this module maps onto whatever mesh is active:

=========  =====================================================
logical    physical axes
=========  =====================================================
"batch"    ("pod", "data") — whichever exist on the active mesh
"fsdp"     "data" (parameter sharding for ZeRO-3 style gathers)
"expert"   "model" (expert-parallel dimension)
"tp"       "model" (tensor-parallel dimension)
"seq"      "model" (sequence sharding for long-context caches)
None       replicated
=========  =====================================================

``"cache_batch"`` and ``"cache_seq"`` lay out a decode cache's rows and
slots; ``launch.mesh.cell_context`` sets them per cell, and a decode
cell whose weights are not replicated maps ``"tp"`` onto ``("model",
"data")`` (2-D tensor parallelism, model major).  A dim cut over ranks
that do not divide it is cut as GSPMD pads it (:func:`tile`).

The reference states a layout with GSPMD constraints (``shard``,
``sharding``) and lets XLA insert the collectives; torch has no
counterpart.  Here every rank holds its own shards
(:mod:`repro_torch.launch.mesh` cuts them) and the layers call the
collectives below themselves.  With no active mesh every helper is the
identity, so model code is mesh-agnostic.

The mesh is :class:`Mesh`, a small class over the default process group:
named axes and their sizes, this rank's place on them (ranks laid out
row-major over the axes, as ``jax.make_mesh`` lays out devices) and one
process group per set of axes that a collective may span.  The mesh and
the rule table are thread-local, as in the reference;
:func:`thread_state` and :func:`use_thread_state` carry them, with the
batch's row axes and the recording, to another moment or thread (a layer
group's recompute in the backward, which a card runs on autograd's
thread).

Every collective but :func:`pmax` (decode's, with no backward) is
differentiable.  Its backward is the adjoint for a
loss that counts once: every rank holds the same loss and calls
``backward`` on it, and a leaf's gradient gathered onto one rank equals
one device's gradient of that loss.  A sum whose result every rank uses
alike takes its cotangent as it is (:func:`psum`, :func:`matmul_psum`;
:func:`pmean` scales it by ``1/n``); a replicated tensor that ranks use
differently (an activation entering a rank-split product, a leaf that
several ranks hold and each uses in part) passes through
:func:`fan_out`, whose backward sums the cotangents (Megatron's "f");
:func:`all_gather` says at each call which of its two adjoints it needs;
:func:`all_to_all`'s backward is the inverse exchange.

A run may be recorded (:func:`record`, the counter source of
``core.meshsig.counters``): every collective a rank calls (an
all-reduce, an all-gather or an all-to-all; a reduce-scatter runs as an
all-reduce and a slice, and is recorded so) appends a
:class:`CollectiveRecord` first, and every kernel wrapper adds its own
work (:func:`kernel_work`).  In ``"observe"`` mode the collective then
runs; in ``"simulate"`` mode it does not: its result buffers, allocated
as they always are, come back as they are, so one process can run a rank
of any mesh on ``meta`` tensors under a layout-only :class:`Mesh`.  A
collective's backward is recorded into the recording its forward ran
under.  With no recording active, a collective or a kernel wrapper only
reads this thread's empty slot.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from dataclasses import dataclass, field
from typing import Iterable, Mapping, NamedTuple

import torch
import torch.distributed as dist

_STATE = threading.local()

_LOGICAL = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "dp_all": ("pod", "data"),
    "tp": ("model",),
    "expert": ("model",),
    "efsdp": ("data",),  # expert-weight FSDP dim (kept under serve remaps)
    "seq": ("model",),
    # Decode-cache dims; the launcher overrides these per (arch, shape).
    "cache_batch": ("data",),
    "cache_seq": ("model",),
}

def _rules() -> dict[str, tuple[str, ...]]:
    """This thread's table, a copy of ``_LOGICAL`` until remapped."""
    rules = getattr(_STATE, "rules", None)
    if rules is None:
        rules = _STATE.rules = dict(_LOGICAL)
    return rules


@contextlib.contextmanager
def use_logical_rules(**overrides: tuple[str, ...]):
    """Temporarily remap logical dims to different physical axes."""
    rules = _rules()
    saved = {k: rules[k] for k in overrides}
    rules.update(overrides)
    try:
        yield
    finally:
        rules.update(saved)


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over ranks laid out row-major: ``rank`` is this process's
    index, ``groups`` maps each set of axes (in mesh order) whose ranks
    span more than one process to this rank's process group over them.
    A mesh without groups describes a layout and can run no collective."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int = 0
    groups: Mapping[tuple[str, ...], object] = field(default_factory=dict)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or len(set(self.axis_names)) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} do not match sizes {self.sizes}")
        if any(s < 1 for s in self.sizes) or not 0 <= self.rank < math.prod(self.sizes):
            raise ValueError(f"rank {self.rank} outside a mesh of sizes {self.sizes}")
        # read on every collective: computed once
        object.__setattr__(self, "_shape", dict(zip(self.axis_names, self.sizes)))
        object.__setattr__(self, "_size", math.prod(self.sizes))
        object.__setattr__(self, "_orders", {})

    @property
    def shape(self) -> dict[str, int]:
        return dict(self._shape)

    @property
    def size(self) -> int:
        return self._size

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """``rank``'s (default: this rank's) index on every axis."""
        rank = self.rank if rank is None else rank
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            rank, out[name] = divmod(rank, size)
        return {a: out[a] for a in self.axis_names}

    def canonical(self, axes: Iterable[str]) -> tuple[str, ...]:
        """``axes`` in mesh order, those the mesh lacks left out."""
        axes = set(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axes_size(self, axes: Iterable[str]) -> int:
        if self._size == 1:
            return 1
        return math.prod(self._shape[a] for a in self.canonical(axes))

    def axis_index(self, axes: Iterable[str], rank: int | None = None) -> int:
        """The row-major index over ``axes`` in the order given
        (``jax.lax.axis_index`` of the tuple)."""
        if self._size == 1:
            return 0
        coords, shape, idx = self.coords(rank), self._shape, 0
        for a in axes:
            if a in shape:
                idx = idx * shape[a] + coords[a]
        return idx

    def gather_order(self, given: tuple[str, ...]) -> list[int]:
        """For each index ``j`` over the axes ``given`` (in the order
        given), the place among this rank's group over them (its ranks in
        mesh order) of the rank of index ``j``; computed once per axes."""
        if given not in self._orders:
            axes = self.canonical(given)
            mine = self.coords()
            members = [q for q in range(self._size)
                       if all(c == mine[a] for a, c in self.coords(q).items() if a not in axes)]
            place = {self.axis_index(given, q): i for i, q in enumerate(members)}
            self._orders[given] = [place[j] for j in range(len(members))]
        return self._orders[given]

    def group(self, axes: Iterable[str]):
        axes = self.canonical(axes)
        if axes not in self.groups:
            raise RuntimeError(f"mesh has no process group over {axes} (a layout-only mesh)")
        return self.groups[axes]


def make_mesh(sizes: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """A :class:`Mesh` over the default process group, whose world size
    must be the product of ``sizes``.  Every rank creates the groups of
    every set of axes, each over every assignment of the other axes, in
    the same order (``dist.new_group`` needs every rank to take part), and
    keeps its own; a set spanning one process gets none, the whole mesh
    the default group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh of sizes {sizes} needs {math.prod(sizes)} ranks, not {world}")
    layout = Mesh(tuple(axis_names), tuple(sizes), rank)
    n = len(sizes)
    groups = {}
    for r in range(1, n + 1):
        for picked in itertools.combinations(range(n), r):
            axes = tuple(axis_names[i] for i in picked)
            if math.prod(sizes[i] for i in picked) == 1:
                continue
            if r == n:
                groups[axes] = dist.group.WORLD
                continue
            others = [i for i in range(n) if i not in picked]
            mine = {axis_names[i]: layout.coords()[axis_names[i]] for i in others}
            for fixed in itertools.product(*(range(sizes[i]) for i in others)):
                fixed = dict(zip((axis_names[i] for i in others), fixed))
                ranks = [q for q in range(world)
                         if all(layout.coords(q)[a] == c for a, c in fixed.items())]
                g = dist.new_group(ranks)
                if fixed == mine:
                    groups[axes] = g
    return Mesh(layout.axis_names, layout.sizes, rank, groups)


def current_mesh() -> Mesh | None:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def physical_axes(logical: str) -> tuple[str, ...]:
    """The mesh axes a logical dim maps to, in the rule's order."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in _rules()[logical] if a in mesh.axis_names)


def resolve(*logical_dims: str | None) -> tuple:
    """Logical dims as physical ones for the active mesh (the reference's
    ``PartitionSpec`` as a tuple): ``None`` replicated, an axis name, or a
    tuple of names; empty with no mesh."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    out = []
    for dim in logical_dims:
        axes = () if dim is None else physical_axes(dim)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def axis_size(logical: str) -> int:
    """Product of the mesh axes a logical dim maps to (1 with no mesh)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.axes_size(physical_axes(logical))


def axis_index(axes: Iterable[str]) -> int:
    """This rank's row-major index over physical ``axes`` (0 with no
    mesh)."""
    mesh = current_mesh()
    return 0 if mesh is None else mesh.axis_index(axes)


def divisible_batch_axes(n: int) -> tuple[str, ...]:
    """The largest prefix of the batch axes whose product divides ``n``
    (empty for n=1: replicate instead of shard)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    shape = mesh.shape
    axes: list[str] = []
    prod = 1
    for a in _rules()["batch"]:
        if a in shape and n % (prod * shape[a]) == 0:
            axes.append(a)
            prod *= shape[a]
    return tuple(axes)


# ---------------------------------------------------------------------------
# Batch rows
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def use_batch_rows(n: int):
    """Inside, a model batch of ``n`` rows lies split over
    :func:`divisible_batch_axes` (``n``) but those a tensor-parallel
    product spans (2-D decode TP: every rank of a product holds the same
    rows), this rank holding its block (:func:`local_rows`); yields those
    axes."""
    prev = batch_axes()
    tp = set(physical_axes("tp"))
    _STATE.batch_axes = tuple(a for a in divisible_batch_axes(n) if a not in tp)
    try:
        yield _STATE.batch_axes
    finally:
        _STATE.batch_axes = prev


def batch_axes() -> tuple[str, ...]:
    """The axes the current batch's rows are split over (none outside
    :func:`use_batch_rows`)."""
    return getattr(_STATE, "batch_axes", ())


class ThreadState(NamedTuple):
    """What this module keeps per thread: the mesh, the logical rules, the
    batch's row axes and the recording."""

    mesh: "Mesh | None"
    rules: dict
    batch_axes: tuple[str, ...]
    recording: "Recording | None"


def thread_state() -> ThreadState:
    """This thread's state as it is now (the rules copied)."""
    return ThreadState(current_mesh(), dict(_rules()), batch_axes(), current_recording())


@contextlib.contextmanager
def use_thread_state(state: ThreadState):
    """Run the block under ``state`` (:func:`thread_state` of another
    moment or thread); the thread's own state comes back after it."""
    prev = {k: getattr(_STATE, k) for k in ThreadState._fields if hasattr(_STATE, k)}
    for k, v in zip(ThreadState._fields, state):
        setattr(_STATE, k, v)
    try:
        yield
    finally:
        for k in ThreadState._fields:
            if k in prev:
                setattr(_STATE, k, prev[k])
            else:
                delattr(_STATE, k)


def local_rows(x: torch.Tensor, axes: tuple[str, ...] | None = None) -> torch.Tensor:
    """This rank's block of ``x``'s rows (dim 0) split over ``axes``
    (default: :func:`batch_axes`)."""
    axes = batch_axes() if axes is None else axes
    mesh = current_mesh()
    if mesh is None or mesh.axes_size(axes) == 1:
        return x
    n = mesh.axes_size(axes)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {axes} ({n} ranks)")
    rows = x.shape[0] // n
    return x.narrow(0, mesh.axis_index(axes) * rows, rows)


def tile(n: int, axes: Iterable[str], rank: int | None = None) -> tuple[int, int]:
    """``(start, size)`` of ``rank``'s (default: this rank's) block of a
    dim of ``n`` cut over ``axes`` (row-major over them in the order
    given), as GSPMD tiles a dim: blocks of ``ceil(n / ranks)``, the last
    ones short or empty where the ranks do not divide ``n``.  ``(0, n)``
    with no mesh or over one rank."""
    mesh = current_mesh()
    if mesh is None or mesh.axes_size(axes) == 1:
        return 0, n
    block = -(-n // mesh.axes_size(axes))
    start = min(n, mesh.axis_index(axes, rank) * block)
    return start, min(block, n - start)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


class CollectiveRecord(NamedTuple):
    """One collective as a rank calls it: ``kind`` (``"all-reduce"``,
    ``"all-gather"`` or ``"all-to-all"``), the reduction of an all-reduce
    (``"sum"`` or ``"max"``; empty otherwise), the axes it spans in mesh
    order, the ranks it spans, its result's bytes on this rank (an
    all-gather's result is the gathered size) and the result's dtype."""

    kind: str
    reduce: str
    axes: tuple[str, ...]
    group: int
    bytes: int
    dtype: str


class KernelWork(NamedTuple):
    """One kernel call's work as its wrapper states it: its name, its
    operations and the bytes it moves (operands read, results written)."""

    name: str
    flops: float
    bytes: float


class Recording:
    """What a recorded run called, in order: its collectives and its
    kernels' work.  ``simulate`` runs no collective (``meta`` tensors
    only).  ``in_kernel`` is positive while a kernel wrapper runs its
    body, whose own operations its :class:`KernelWork` stands for."""

    def __init__(self, mode: str = "observe"):
        if mode not in ("observe", "simulate"):
            raise ValueError(f"a recording observes or simulates, not {mode!r}")
        self.simulate = mode == "simulate"
        self.collectives: list[CollectiveRecord] = []
        self.kernels: list[KernelWork] = []
        self.in_kernel = 0


def current_recording() -> Recording | None:
    return getattr(_STATE, "recording", None)


@contextlib.contextmanager
def recording_as(rec: Recording | None):
    """Make ``rec`` (or none) this thread's recording inside the block."""
    prev = current_recording()
    _STATE.recording = rec
    try:
        yield rec
    finally:
        _STATE.recording = prev


@contextlib.contextmanager
def record(mode: str = "observe"):
    """Record this thread's collectives and kernel work inside the block
    into the yielded :class:`Recording` (``mode`` ``"observe"`` or
    ``"simulate"``)."""
    with recording_as(Recording(mode)) as rec:
        yield rec


def kernel_work(name: str, work):
    """Around a kernel wrapper's body: with a recording active, adds the
    kernel's work (``work()``, its ``(operations, bytes)``) to it and
    marks the body as the kernel's; with none, a ``nullcontext`` and
    ``work`` is not called."""
    rec = current_recording()
    if rec is None:
        return contextlib.nullcontext()
    flops, nbytes = work()
    rec.kernels.append(KernelWork(name, float(flops), float(nbytes)))
    return _in_kernel(rec)


@contextlib.contextmanager
def _in_kernel(rec: Recording):
    rec.in_kernel += 1
    try:
        yield
    finally:
        rec.in_kernel -= 1


def _record_collective(kind: str, result: torch.Tensor, mesh: "Mesh", axes: tuple[str, ...],
           reduce: str = "", parts: int = 1) -> bool:
    """Record a collective about to run (``parts`` results of
    ``result``'s size), if a recording is active; whether it is to run
    (not when simulated)."""
    rec = current_recording()
    if rec is None:
        return True
    if rec.simulate and result.device.type != "meta":
        raise RuntimeError(f"a simulated collective takes meta tensors, not {result.device} ones")
    rec.collectives.append(CollectiveRecord(
        kind, reduce, axes, mesh.axes_size(axes), parts * result.numel() * result.element_size(),
        str(result.dtype).removeprefix("torch.")))
    return not rec.simulate


# ---------------------------------------------------------------------------
# Collectives (identity with no mesh, or over axes of one rank)
# ---------------------------------------------------------------------------


def _span(axes: Iterable[str]):
    """``(mesh, axes in mesh order, ranks spanned)`` for a collective."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return mesh, (), 1
    axes = mesh.canonical(axes)
    return mesh, axes, mesh.axes_size(axes)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _sum(x: torch.Tensor, mesh: Mesh, axes: tuple[str, ...], *, owned: bool) -> torch.Tensor:
    """``x`` summed over ``axes`` in float32 and rounded once to its dtype;
    an ``owned`` contiguous float32 ``x`` is summed in place."""
    wide = x.float()
    if wide is x and not owned:
        wide = wide.clone()
    wide = wide.contiguous()
    if _record_collective("all-reduce", wide, mesh, axes, "sum"):
        dist.all_reduce(wide, group=mesh.group(axes))
    return wide.to(x.dtype)


def _parts(x: torch.Tensor, mesh: Mesh, given: tuple[str, ...]) -> list[torch.Tensor]:
    """Every rank's ``x`` over the axes ``given``, in the order of
    :meth:`Mesh.axis_index` over them as given."""
    axes = mesh.canonical(given)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axes_size(axes))]
    if _record_collective("all-gather", x, mesh, axes, parts=len(parts)):
        dist.all_gather(parts, x, group=mesh.group(axes))
    # the group's ranks come in mesh order; put them in the given order
    return [parts[i] for i in mesh.gather_order(tuple(given))]


def _scatter_sum(g: torch.Tensor, mesh: Mesh, given: tuple[str, ...], dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``g`` summed over ``given`` (a
    reduce-scatter, as an all-reduce and a slice: gloo has no
    reduce-scatter), copied out so the whole sum is freed."""
    n = mesh.axes_size(given)
    size = g.shape[dim] // n
    total = _sum(g, mesh, mesh.canonical(given), owned=False)
    return total.narrow(dim, mesh.axis_index(given) * size, size).clone()


class _Psum(torch.autograd.Function):
    """The sum of the ranks' ``x``; used alike on every rank, so its
    cotangent is every rank's and passes through."""

    @staticmethod
    def forward(ctx_, x, mesh, axes):
        return _sum(x, mesh, axes, owned=False)

    @staticmethod
    def backward(ctx_, g):
        return g, None, None


class _FanOut(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents of the ranks
    whose key is this rank's."""

    @staticmethod
    def forward(ctx_, x, mesh, given, keys):
        ctx_.mesh, ctx_.given, ctx_.keys = mesh, given, keys
        ctx_.recording = current_recording()
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        mesh, given, keys = ctx_.mesh, ctx_.given, ctx_.keys
        with recording_as(ctx_.recording):
            if len(set(keys)) == 1:
                return _sum(g, mesh, mesh.canonical(given), owned=False), None, None, None
            mine = keys[mesh.axis_index(given)]
            held = [p for p, k in zip(_parts(g, mesh, given), keys) if k == mine]
        out = held[0].float()
        for p in held[1:]:
            out = out + p.float()
        return out.to(g.dtype), None, None, None


class _AllGather(torch.autograd.Function):
    """Concatenation of the ranks' ``x`` along ``dim``; the backward takes
    this rank's block of the cotangent, summed over the ranks first where
    ``adjoint`` is ``"sum"``."""

    @staticmethod
    def forward(ctx_, x, mesh, given, dim, adjoint):
        ctx_.mesh, ctx_.given, ctx_.dim, ctx_.adjoint = mesh, given, dim, adjoint
        ctx_.recording = current_recording()
        return torch.cat(_parts(x, mesh, given), dim=dim)

    @staticmethod
    def backward(ctx_, g):
        mesh, given, dim = ctx_.mesh, ctx_.given, ctx_.dim
        if ctx_.adjoint == "sum":
            with recording_as(ctx_.recording):
                return _scatter_sum(g, mesh, given, dim), None, None, None, None
        size = g.shape[dim] // mesh.axes_size(given)
        return g.narrow(dim, mesh.axis_index(given) * size, size), None, None, None, None


class _AllToAll(torch.autograd.Function):
    """The block exchange; the inverse exchange is the same one."""

    @staticmethod
    def forward(ctx_, x, mesh, axes):
        ctx_.mesh, ctx_.axes = mesh, axes
        ctx_.recording = current_recording()
        return _exchange(x, mesh, axes)

    @staticmethod
    def backward(ctx_, g):
        with recording_as(ctx_.recording):
            return _exchange(g, ctx_.mesh, ctx_.axes), None, None


def _exchange(x: torch.Tensor, mesh: Mesh, axes: tuple[str, ...]) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    if _record_collective("all-to-all", out, mesh, axes):
        dist.all_to_all_single(out, x, group=mesh.group(axes))
    return out


def psum(x: torch.Tensor, axes: Iterable[str]) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, added in float32 and rounded once
    to ``x``'s dtype; outside autograd a contiguous float32 ``x`` is summed
    in place (callers pass partial results they own).  The result is for
    uses alike on every rank: its backward passes the cotangent through
    (a result that ranks use differently goes through :func:`fan_out`)."""
    mesh, axes, n = _span(axes)
    if n == 1:
        return x
    if _needs_grad(x):
        return _Psum.apply(x, mesh, axes)
    return _sum(x, mesh, axes, owned=True)


def fan_out(x: torch.Tensor, axes: Iterable[str], keys: Iterable | None = None) -> torch.Tensor:
    """``x`` itself, replicated over ``axes`` and about to be used
    differently on each rank (an activation entering a rank-split product,
    a leaf several ranks hold): the backward sums the cotangents over
    ``axes`` (Megatron's "f").  With ``keys`` (one per index over ``axes``
    as given) it sums only those of the ranks whose key is this rank's,
    the ranks holding the same indices of a leaf.  Outside autograd, or
    where every key differs, it is ``x``."""
    given = tuple(axes)
    mesh, _, n = _span(given)
    if n == 1 or not _needs_grad(x):
        return x
    keys = (0,) * n if keys is None else tuple(keys)
    if len(keys) != n:
        raise ValueError(f"{len(keys)} keys for {n} ranks over {given}")
    if len(set(keys)) == n:
        return x
    return _FanOut.apply(x, mesh, given, keys)


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``b`` 2-d, or both 3-d) in float32, unrounded.  On the
    card a bf16 or f16 product stays a half-precision GEMM that writes
    float32 (cuBLAS sums the products in float32 either way), so no
    float32 copy of the weights is made; elsewhere, and where autograd
    needs the product's gradient, the operands are widened first.  A
    ``meta`` product takes the card's branch, so a counted ``meta`` run
    (``core.meshsig.counters``) sees the card's operations."""
    if a.device.type in ("cuda", "meta") and a.dtype in (torch.bfloat16, torch.float16) and not (
            _needs_grad(a) or _needs_grad(b)):
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return out.view(*a.shape[:-1], b.shape[-1])
        if a.dim() == b.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def matmul_psum(a: torch.Tensor, b: torch.Tensor, axes: Iterable[str]) -> torch.Tensor:
    """``a @ b`` whose contraction dim is split over ``axes`` (each rank
    holds its columns of ``a`` and rows of ``b``): the partial products
    are summed in float32 (:func:`product_f32`), added over the ranks in
    float32 and rounded once to ``a``'s dtype, as one device's product
    rounds, so the result does not depend on how many ranks split the
    sum.  Over one rank, plain ``a @ b``.  Its backward is
    :func:`psum`'s."""
    mesh, axes, n = _span(axes)
    if n == 1:
        return a @ b
    return psum(product_f32(a, b), axes).to(a.dtype)


def pmean(x: torch.Tensor, axes: Iterable[str]) -> torch.Tensor:
    """The mean over ``axes`` (:func:`psum` over ``n``): its backward
    scales the cotangent by ``1/n``."""
    mesh, axes, n = _span(axes)
    return x if n == 1 else psum(x, axes) / n


def pmax(x: torch.Tensor, axes: Iterable[str]) -> torch.Tensor:
    """The elementwise maximum over ``axes`` (a decode softmax's row
    maximum over the cache's sequence shards).  It has no backward:
    raises ``ValueError`` for an input that requires a gradient."""
    mesh, axes, n = _span(axes)
    if n == 1:
        return x
    if _needs_grad(x):
        raise ValueError("pmax has no backward (it serves decode only)")
    out = x.clone(memory_format=torch.contiguous_format)
    if _record_collective("all-reduce", out, mesh, axes, "max"):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return out


def all_gather(x: torch.Tensor, axes: Iterable[str], dim: int, *, adjoint: str) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` concatenated along ``dim`` in the
    order of :meth:`Mesh.axis_index` over ``axes`` as given (the
    reference's tiled ``all_gather``).  ``adjoint`` names the backward the
    call site needs: ``"slice"`` where every rank then computes the same
    thing on the result (this rank's block of the cotangent), ``"sum"``
    where ranks use it on different rows (the cotangents summed over the
    ranks, then this rank's block: a reduce-scatter, as an FSDP weight
    gather needs)."""
    if adjoint not in ("slice", "sum"):
        raise ValueError(f"all_gather's adjoint is 'slice' or 'sum', not {adjoint!r}")
    given = tuple(axes)
    mesh, _, n = _span(given)
    if n == 1:
        return x
    dim = dim % x.dim()
    if _needs_grad(x):
        return _AllGather.apply(x, mesh, given, dim, adjoint)
    return torch.cat(_parts(x, mesh, given), dim=dim)


def all_to_all(x: torch.Tensor, axes: Iterable[str]) -> torch.Tensor:
    """``x`` (n, ...): block ``j`` goes to the rank of index ``j`` over
    ``axes``; returns (n, ...) whose block ``i`` came from rank ``i``.  Its
    backward is the inverse exchange, which is the same one."""
    mesh, axes, n = _span(axes)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {n} ranks of {x.shape[0]} blocks")
    if _needs_grad(x):
        return _AllToAll.apply(x, mesh, axes)
    return _exchange(x, mesh, axes)
