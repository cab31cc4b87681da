"""Logical-axis sharding on ``torch.distributed`` DeviceMesh and DTensor
(counterpart of ``repro.distributed.sharding``).

Model code annotates tensors with *logical* axes ("batch", "embed",
"heads", ...). A rule table maps logical axes to mesh axes; the active
(mesh, rules) pair lives in a context, so the same model code runs
unsharded on one device and sharded on a mesh.

Indivisible dims are handled by *dropping* the offending mesh axis (8 KV
heads cannot shard over a 16-way model axis: replicated), and a mesh axis
is never used twice in one spec (the first logical axis wins).

How the reference's JAX terms map onto torch:

  * a ``PartitionSpec`` is :func:`spec_for`'s plain tuple, one entry a
    tensor dim (``None``, a mesh axis name, or a tuple of names), trailing
    ``None`` entries dropped: ``tuple(PS(...))`` of the reference's spec;
  * a ``NamedSharding`` is :class:`NamedSharding` (mesh and spec), whose
    :meth:`~NamedSharding.placements` are DTensor's: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` uses, ``Replicate()`` on the others. A
    dim split over two mesh axes (``batch -> ("pod", "data")``) takes
    ``Shard(d)`` on both, and DTensor splits it over them in mesh order,
    which is the spec's order for every rule of :data:`TRAIN_RULES` and
    :data:`SERVE_RULES`; a spec that names them against mesh order
    (``seq_data_cache``'s ``("model", "data")``) gets the same blocks on
    other ranks, which changes no shape and no byte count;
  * ``with_sharding_constraint`` is ``DTensor.redistribute`` (:func:`shard`);
  * GSPMD's propagation is DTensor's per-op sharding propagation. Plain
    tensors met inside :func:`use_sharding` on a mesh of more than one
    device count as replicated (``implicit_replication``).

On a mesh of one device (one card) :func:`shard` returns its argument and
:func:`lay_out` leaves tensors plain, so the kernels' wrappers see the
tensors they always saw. A mesh is anything with a ``shape`` mapping from
axis name to size (a DeviceMesh's is derived from its ``mesh_dim_names``),
so :func:`spec_for` runs on shape-only meshes too. Nothing here creates a
process group: :mod:`repro_torch.launch.mesh` does, when asked.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Sequence

import torch

# logical axis -> mesh axis (or tuple of mesh axes)
Rules = dict[str, str | tuple[str, ...] | None]

TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "embed": "data",          # FSDP dimension for 2-D weight sharding
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "lora": "model",
    "inner": "model",         # SSM/RWKV inner feature dim
    "kv_seq": None,
    "seq": None,
    "seq_block": "model",     # sequence-parallel saved layer boundaries
    "attn_q": "model",        # fallback: shard q rows when heads can't
}

SERVE_RULES: Rules = {
    "batch": ("pod", "data"),
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "lora": "model",
    "inner": "model",
    "kv_seq": "model",        # sequence-sharded KV caches (distributed LSE)
    "seq": None,
    "seq_block": None,
    "attn_q": "model",
}

_CTX: contextvars.ContextVar[tuple[Any, Rules] | None] = \
    contextvars.ContextVar("sharding_ctx", default=None)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of ``mesh``: a DeviceMesh's ``mesh_dim_names``
    with its sizes, or a shape-only mesh's ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def dtensor_type() -> type:
    """DTensor's class (a class nothing is an instance of where
    ``torch.distributed`` is not built)."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return type("NoDTensor", (), {})
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, dtensor_type())


def is_distributed(mesh) -> bool:
    """A DeviceMesh of more than one device: tensors on it are DTensors."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh) and mesh.size() > 1


@contextlib.contextmanager
def use_sharding(mesh, rules: Rules | None):
    """Make (mesh, rules) the active sharding for the block; ``mesh=None``
    clears it. On a mesh of more than one device plain tensors count as
    replicated inside (``implicit_replication``)."""
    tok = _CTX.set((mesh, rules) if mesh is not None else None)
    try:
        if mesh is not None and is_distributed(mesh):
            from torch.distributed.tensor.experimental import (
                implicit_replication,
            )
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.reset(tok)


def active() -> tuple[Any, Rules] | None:
    return _CTX.get()


def sharded_context() -> bool:
    """A sharding context on a mesh of more than one device is active."""
    ctx = _CTX.get()
    return ctx is not None and is_distributed(ctx[0])


def _mesh_axes_for(logical: str | None, rules: Rules):
    if logical is None:
        return ()
    m = rules.get(logical, None)
    if m is None:
        return ()
    return (m,) if isinstance(m, str) else tuple(m)


def spec_for(axes: Sequence[str | None], shape: Sequence[int] | None,
             mesh, rules: Rules) -> tuple:
    """The spec of a tensor of ``shape`` whose dims have the logical
    ``axes``, dropping indivisible and duplicate mesh axes: a tuple with
    one entry a dim (``None``, a mesh axis, or a tuple of them), trailing
    ``None`` entries dropped."""
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries: list = []
    for i, logical in enumerate(axes):
        mesh_axes: list[str] = []
        for ax in _mesh_axes_for(logical, rules):
            if ax in used or ax not in sizes:
                continue
            size = math.prod([sizes[a] for a in mesh_axes + [ax]])
            if shape is not None and shape[i] % size != 0:
                continue
            mesh_axes.append(ax)
            used.add(ax)
        entries.append(tuple(mesh_axes) if len(mesh_axes) > 1
                       else (mesh_axes[0] if mesh_axes else None))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: tuple, ndim: int, mesh) -> tuple:
    """DTensor placements of ``spec`` on the DeviceMesh ``mesh`` (one a
    mesh dim, in ``mesh_dim_names`` order) for a tensor of ``ndim`` dims."""
    from torch.distributed.tensor import Replicate, Shard
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: tuple

    def placements(self, ndim: int) -> tuple:
        return placements(self.spec, ndim, self.mesh)


def _as_dtensor(x: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``pls``, and its gradient too: the
    counterpart of ``with_sharding_constraint``, whose transpose constrains
    the cotangent to the same sharding. DTensor's own ``redistribute``
    sends the gradient back in the input's placements, which torch
    versions choose differently (a residual's gradient left partial over
    the model axis, so that the next product gathers its weight)."""

    @staticmethod
    def forward(ctx, x, pls):
        ctx.pls = pls
        return x.redistribute(x.device_mesh, pls)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.pls), None


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain ``x`` (and, under autograd, its gradient) to the sharding
    implied by logical ``axes``: ``x`` itself outside a context or on a
    mesh of one device, else a DTensor redistributed to :func:`spec_for`'s
    layout (a plain tensor counts as replicated first)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    if not is_distributed(mesh):
        return x
    spec = spec_for(axes, x.shape, mesh, rules)
    return _Constrain.apply(_as_dtensor(x, mesh),
                            placements(spec, x.ndim, mesh))


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x`` with its last dim reshaped to ``sizes`` (heads, head width).
    On a mesh, DTensor cannot split a dim sharded n ways into a leading
    factor n does not divide (8 kv heads of 128 from a 1,024-wide
    projection sharded 16 ways), which GSPMD reshards by itself: such a
    split is gathered first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(x, DTensor):
        last = x.ndim - 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim == last
              and sizes[0] % x.device_mesh.size(i) else p
              for i, p in enumerate(x.placements)]
        if tuple(pl) != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], *sizes)


class _SplittableGrad(torch.autograd.Function):
    """Identity forward; the backward gathers the gradient's last dim where
    its mesh split does not divide ``n``, so that the backward of the head
    merge before it (a split of that dim into ``n`` heads) can run."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, ctx.n, g.shape[-1] // ctx.n).flatten(-2), None


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n, d) with its last two dims merged, (..., n * d); on a
    mesh, its gradient comes back splittable into the n heads again
    (:func:`split_last`'s rule)."""
    from torch.distributed.tensor import DTensor
    n = x.shape[-2]
    y = x.reshape(*x.shape[:-2], -1)
    if isinstance(y, DTensor) and torch.is_grad_enabled() and y.requires_grad:
        y = _SplittableGrad.apply(y, n)
    return y


def is_axes(t) -> bool:
    """A logical-axes tuple (a leaf of an axes tree)."""
    return isinstance(t, tuple) and all(a is None or isinstance(a, str)
                                        for a in t)


def map_trees(fn, tree, *others, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples and
    NamedTuples) and the matching leaves of ``others``; ``is_leaf`` stops
    the descent early."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: map_trees(fn, v, *(o[k] for o in others), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_trees(fn, v, *(o[i] for o in others),
                                      is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_trees(fn, v, *(o[i] for o in others),
                                    is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def tree_shardings(axes_tree, shape_tree, mesh, rules: Rules):
    """:class:`NamedSharding` for a whole parameter or cache tree.

    ``axes_tree`` holds logical-axes tuples; ``shape_tree`` anything with
    ``.shape`` leaves (meta or fake tensors are fine)."""
    return map_trees(
        lambda axes, s: NamedSharding(
            mesh, spec_for(axes, tuple(s.shape), mesh, rules)),
        axes_tree, shape_tree, is_leaf=is_axes)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def lay_out(tensor: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """A global tensor laid out by ``sharding``: a DTensor (each rank keeps
    its shard, ``distribute_tensor``) on a mesh of more than one device,
    the tensor itself on a mesh of one."""
    if not is_distributed(sharding.mesh):
        return tensor
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = sharding.placements(tensor.ndim)
    if isinstance(tensor, DTensor):
        return tensor.redistribute(sharding.mesh, pl)
    return distribute_tensor(tensor, sharding.mesh, pl)


def empty_laid_out(shape, dtype: torch.dtype,
                   sharding: NamedSharding) -> torch.Tensor:
    """An unfilled tensor of global ``shape`` laid out by ``sharding``,
    made as the rank's shard alone (``DTensor.from_local``): under a
    ``FakeTensorMode`` nothing of the global tensor is ever allocated,
    which is how the dry run holds a full-width model on one host. A
    plain tensor on a mesh of one device."""
    if not is_distributed(sharding.mesh):
        return torch.empty(shape, dtype=dtype)
    from torch.distributed.tensor import DTensor
    pl = sharding.placements(len(shape))
    local_shape, _ = local_box(shape, sharding.mesh, pl)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype),
                              sharding.mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def lay_out_tree(tree, shardings):
    """:func:`lay_out` over a tree of tensors and its matching tree of
    :class:`NamedSharding` (non-tensor leaves, a count, stay)."""
    return map_trees(
        lambda t, s: lay_out(t, s) if isinstance(t, torch.Tensor) else t,
        tree, shardings, is_leaf=lambda t: isinstance(t, torch.Tensor))


def local_box(shape, mesh, pls) -> tuple[list[int], list[int]]:
    """(local shape, global offset) of this rank's shard of a tensor of
    global ``shape`` under placements ``pls`` on ``mesh``: each sharded
    dim split evenly over its mesh dims in mesh order (the layouts of
    :func:`spec_for`, which keeps only axes that divide). Plain
    arithmetic on the rank's mesh coordinate, so it runs under a
    ``FakeTensorMode`` too."""
    from torch.distributed.tensor import Shard
    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            d, n = p.dim, mesh.size(i)
            if local[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"evenly over mesh dim {i} ({n})")
            local[d] //= n
            offset[d] += coord[i] * local[d]
    return local, offset


def write_at(cache: torch.Tensor, new: torch.Tensor, slot,
             ragged: bool) -> bool:
    """``cache[:, slot] = new`` in place on a DTensor cache (B, L, ...) at
    the int ``slot``. DTensor cannot redistribute the target of an in-place
    op, so each rank writes the positions its own shard holds, ``new``
    first laid out as the cache on every dim but L (the counterpart of a
    dynamic-update-slice on a sharded dim). Returns False, writing nothing,
    for a plain tensor: the caller writes it. A ragged write (a slot a
    row: the serving engine's, which runs on one device) raises."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(cache):
        return False
    if ragged:
        raise NotImplementedError("ragged cache writes on a mesh")
    mesh, pl = cache.device_mesh, cache.placements
    new_pl = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1
              else Replicate() for p in pl]
    new = _as_dtensor(new, mesh).redistribute(mesh, new_pl).to_local()
    shape, offset = local_box(cache.shape, mesh, pl)
    lo, n = offset[1], shape[1]
    if lo <= slot < lo + n:
        cache.to_local()[:, slot - lo] = new
    return True


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial placements (pending sums, a lookup's
    masked partial) reduced to replicated; anything else as it is."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def pick_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` row by row for a DTensor ``x`` (..., V) and integer
    ``idx`` (...) (a vocab-parallel gather): each rank picks from the block
    of V it holds, zeros where the index lies outside it, and the result is
    a partial sum over the mesh dims that split V. Local ops only, which
    every torch version's DTensor takes (its gather on a split dim, and
    comparisons of DTensors, it does not take in all of them)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    x = reduce_partial(x)
    uneven = [Replicate() if isinstance(p, Shard)
              and x.shape[p.dim] % mesh.size(i) else p
              for i, p in enumerate(x.placements)]
    if tuple(uneven) != tuple(x.placements):    # DTensor's own uneven split
        x = x.redistribute(mesh, uneven)
    pl, last = x.placements, x.ndim - 1
    idx = _as_dtensor(idx, mesh).redistribute(
        mesh, [p if isinstance(p, Shard) and p.dim != last else Replicate()
               for p in pl]).to_local().long()
    shape, offset = local_box(x.shape, mesh, pl)
    lo, n = offset[last], shape[last]
    got = torch.gather(x.to_local(), -1,
                       (idx - lo).clamp(0, n - 1)[..., None])[..., 0]
    got = torch.where((idx >= lo) & (idx < lo + n), got,
                      torch.zeros_like(got))
    out_shape = tuple(x.shape[:-1])
    stride = [1] * len(out_shape)
    for d in range(len(out_shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * out_shape[d + 1]
    return DTensor.from_local(
        got, mesh, [Partial() if isinstance(p, Shard) and p.dim == last
                    else p for p in pl],
        run_check=False, shape=torch.Size(out_shape), stride=tuple(stride))


def full(x: torch.Tensor) -> torch.Tensor:
    """The global value of a DTensor on every rank, or ``x`` itself."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x
