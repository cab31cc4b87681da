"""Cost of a step from the aten ops it dispatches (counterpart of
``repro.roofline.hlo_parser`` and ``hlo_cost``, which walk XLA's HLO text;
PyTorch has none, so the port counts the ops as they run).

:func:`counting` enters a ``FakeTensorMode`` and an :class:`OpCounter` (a
``TorchDispatchMode``) together: every tensor made inside is fake, so a
full-width model costs shapes, not memory, and, since a fake tensor reports
the CPU, every kernel wrapper takes its plain version. No kernel runs or is
needed. Values are not computed, so a count says nothing of the outputs.

Cost rules (the reference's, for eager PyTorch on one card):

  * dot FLOPs come from ``torch.utils.flop_counter``'s registry (``2·M·N·K``
    for a product, batch dims in the output); an op tagged pointwise but
    for copies and casts counts one FLOP an output element, a reduction
    (``sum``, ``amax``, ...) one an input element;
  * bytes are the eager HBM model: each op reads its tensor inputs once and
    writes its outputs once. Views (``view``, ``reshape`` of a contiguous
    tensor, ``transpose``, ``slice``, ``expand``) and allocations without
    values (``empty``) cost nothing. A write into a slice of a larger
    buffer (``copy_`` into a view, ``index_put_``, ``index_copy_``,
    ``scatter_``: the decode cache's update) charges the slice read and
    written, and the indices, not the whole buffer: the reference's
    dynamic-update-slice rule;
  * a functional collective adds its bytes to ``coll`` by kind (its full,
    gathered shape for all-gather and all-reduce, the larger side for
    reduce-scatter and all-to-all).

Kernel regions: :func:`region` tags the plain versions of the hand-written
kernels (``kernels.ops`` enters one around attention, decode attention and
the two scans, as the reference's ``flashable_*`` scopes tag its XLA
paths); bytes counted inside one add to ``flash_bytes`` as well, and so do
the bytes of the backward ops of the autograd nodes a region created.

Loops: :func:`scan` is the loop of the scans' plain versions. Under a
counter it traces one trip and counts it ``n`` times, as the reference's
``known_trip_count`` multiplies a ``while`` body, so a count at S = 32,768
takes as long as one at S = 1; trips compose through nesting. The
counter also keeps ``flat``, the same count with every loop body once (the
comparable of ``torch.utils.flop_counter.FlopCounterMode`` on the same run,
which sees one trip).

``peak_bytes`` is the most tensor bytes alive at once in the counted run
(an allocation lives until its last reference goes), the eager caching
allocator's floor.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes, _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# torch.distributed's functional collectives by op name
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
_aten = torch.ops.aten
# ops that move no bytes: aliases and allocations without values
_FREE = {_aten._unsafe_view, _aten.lift_fresh, _aten.detach, _aten.alias,
         _aten.empty, _aten.empty_strided, _aten.empty_like,
         _aten.new_empty, _aten.new_empty_strided, _aten._local_scalar_dense}
# in-place writes of a slice: (the values argument's index, the indices')
_SLICE_WRITES = {_aten.index_put_: (2, 1), _aten._index_put_impl_: (2, 1),
                 _aten.index_copy_: (3, 2), _aten.scatter_: (3, 2)}
_WRITE_ONLY = {_aten.fill_, _aten.zero_, _aten.normal_, _aten.uniform_}
# copies and casts: bytes, no FLOP (some carry the pointwise tag)
_MOVES = {_aten.clone, _aten._to_copy, _aten.copy_, _aten.copy}
# reductions: one FLOP an input element
_REDUCTIONS = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max,
               _aten.min, _aten.prod, _aten.var, _aten.var_mean, _aten.std,
               _aten.std_mean, _aten.norm, _aten.linalg_vector_norm,
               _aten.logsumexp, _aten.argmax, _aten.argmin, _aten.any,
               _aten.all}


@dataclass
class Cost:
    dot_flops: float = 0.0
    ew_flops: float = 0.0
    hbm_bytes: float = 0.0
    flash_bytes: float = 0.0   # subset of hbm_bytes inside kernel regions
    coll: dict = field(default_factory=lambda: {k: 0.0 for k in _COLL_KINDS})

    def add(self, other: "Cost", mult: float = 1.0):
        self.dot_flops += other.dot_flops * mult
        self.ew_flops += other.ew_flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.flash_bytes += other.flash_bytes * mult
        for k in _COLL_KINDS:
            self.coll[k] += other.coll[k] * mult

    @property
    def flops(self) -> float:
        return self.dot_flops + self.ew_flops

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def to_dict(self) -> dict:
        return {"dot_flops": self.dot_flops, "ew_flops": self.ew_flops,
                "flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "coll_bytes": self.coll_bytes, "coll": dict(self.coll)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _seq_nr() -> int | None:
    """The autograd sequence number the next node of this thread takes, or
    None with grad off (no node is made)."""
    if not torch.is_grad_enabled():
        return None
    with _disable_current_modes():
        return torch.zeros((), requires_grad=True).clone().grad_fn._sequence_nr()


def _writes_self(func) -> bool:
    """An in-place op: its first argument is written (``add_``, ``mul_``)."""
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None \
        and args[0].alias_info.is_write


def op_cost(func, args, kwargs, out) -> Cost:
    """The cost of one aten op (the rules of the module's docstring)."""
    c = Cost()
    if func.namespace == "_c10d_functional":
        kind = _COLLECTIVES.get(func._opname)
        if kind is not None:
            out_b = sum(_nbytes(t) for t in _tensors(out))
            byts = out_b
            if kind in ("reduce-scatter", "all-to-all"):
                byts = max(byts, sum(_nbytes(t) for t in _tensors(args)))
            c.coll[kind] += byts
            c.hbm_bytes += out_b
        return c
    if func.namespace != "aten" or func.is_view \
            or func.overloadpacket in _FREE:
        return c
    packet = func.overloadpacket
    ins = _tensors((args, kwargs))
    if packet in flop_registry:
        c.dot_flops = float(flop_registry[packet](*args, **kwargs,
                                                  out_val=out))
    elif packet in _MOVES:
        pass
    elif torch.Tag.pointwise in func.tags:
        c.ew_flops = float(sum(t.numel() for t in _tensors(out)))
    elif packet in _REDUCTIONS and ins:
        c.ew_flops = float(ins[0].numel())
    if packet in _SLICE_WRITES:
        vi, ii = _SLICE_WRITES[packet]
        vals = args[vi] if len(args) > vi else None
        idx = _tensors(args[ii] if len(args) > ii else ())
        written = (_nbytes(vals) if isinstance(vals, torch.Tensor)
                   else sum(t.numel() for t in idx) * args[0].element_size())
        c.hbm_bytes = 2.0 * written + sum(_nbytes(t) for t in idx)
    elif packet is _aten.copy_:
        c.hbm_bytes = float(_nbytes(args[0]) + _nbytes(args[1]))
    elif packet in _WRITE_ONLY:
        c.hbm_bytes = float(_nbytes(args[0]))
    else:
        outs = _tensors(out)
        if _writes_self(func):
            outs = []            # self is read among the inputs, written back
            c.hbm_bytes = float(_nbytes(args[0]))
        c.hbm_bytes += float(sum(_nbytes(t) for t in ins)
                             + sum(_nbytes(t) for t in outs))
    return c


class OpCounter(TorchDispatchMode):
    """Adds up :func:`op_cost` of every op dispatched below it: ``cost``
    with loop trips multiplied, ``flat`` with each loop body once, and the
    peak of live tensor bytes (``peak_bytes``)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.flat = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._mult = 1.0
        self._regions = 0
        # (first, last) autograd sequence numbers of the nodes made inside a
        # trip of n (mult n) or a region (mult 1, tagged): their backward
        # ops are counted as the forward ones were
        self._spans: list[tuple[int, int, float, bool]] = []

    @contextlib.contextmanager
    def _span(self, mult: float, tagged: bool):
        first = _seq_nr()
        self._mult *= mult
        self._regions += tagged
        try:
            yield
        finally:
            self._mult /= mult
            self._regions -= tagged
            last = _seq_nr()
            if first is not None and last is not None and last > first + 1:
                self._spans.append((first, last, mult, tagged))

    def reset(self) -> None:
        """Zero the counts (the live tensors stay counted): what ran so far
        was set-up, not the step."""
        self.cost, self.flat = Cost(), Cost()

    def trips(self, n: int):
        """Count what runs inside ``n`` times (one traced trip of a loop)."""
        return self._span(float(n), False)

    def region(self):
        """Tag what runs inside as a kernel region (``flash_bytes``)."""
        return self._span(1.0, True)

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _track(self, func, out) -> None:
        if func.is_view or any(r.alias_info is not None
                               for r in func._schema.returns):
            return               # an alias of an input: no new memory
        for t in _tensors(out):
            n = _nbytes(t)
            self.live_bytes += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        self._track(func, out)
        c = op_cost(func, args, kwargs, out)
        mult, tagged = self._mult, self._regions > 0
        node = torch._C._current_autograd_node()   # in a backward, if any
        if node is not None and mult == 1.0 and not tagged:
            # a backward op: as its forward node was counted (a recompute
            # of a rematerialised layer runs in its live spans instead)
            seq = node._sequence_nr()
            for first, last, m, t in self._spans:
                if first < seq < last:
                    mult *= m
                    tagged |= t
        if tagged:
            c.flash_bytes = c.hbm_bytes
        self.cost.add(c, mult)
        self.flat.add(c)
        return out


def active_counter() -> OpCounter | None:
    """The innermost :class:`OpCounter` on the dispatch mode stack."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


@contextlib.contextmanager
def region():
    """A kernel region (no-op without a counter)."""
    counter = active_counter()
    if counter is None:
        yield
    else:
        with counter.region():
            yield


def scan(body, carry, n: int, dim: int = 1):
    """``for t in range(n): carry, y = body(t, carry)``; returns (carry, the
    y stacked along ``dim``, or None where ``body`` gives None). Under a
    counter one trip runs, counted n times, and the stacked output is an
    unfilled tensor of its shape (the values of fake tensors are not
    computed anyway)."""
    counter = active_counter()
    if counter is None:
        ys = []
        for t in range(n):
            carry, y = body(t, carry)
            ys.append(y)
        return carry, (None if ys and ys[0] is None
                       else torch.stack(ys, dim=dim))
    with counter.trips(n):
        carry, y = body(0, carry)
        one = None if y is None else torch.stack([y], dim=dim)
    if one is None:
        return carry, None
    shape = list(one.shape)
    shape[dim] = n
    return carry, one.new_empty(shape)


@contextlib.contextmanager
def counting(flop_counter: FlopCounterMode | None = None):
    """Fake tensors and an :class:`OpCounter` (under ``flop_counter`` too,
    when given, which then sees the same run): yields the counter."""
    with FakeTensorMode(), OpCounter() as counter, \
            (flop_counter or contextlib.nullcontext()):
        yield counter
