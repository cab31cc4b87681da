"""AdamW with global-norm clipping and a warmup + cosine schedule
(counterpart of ``repro.train.optimizer``).

The optimizer state (m, v) mirrors the parameter tree in float32. The
reference's ``adamw_update`` returns new trees; here :func:`adamw_update`
writes the parameters and the moments in place (out of place, a
full-width run would hold two copies of the float32 state on the card)
and returns a new :class:`OptState` whose ``count`` is one higher. The
arithmetic is float32 throughout, the step's scalars (learning rate and
bias corrections) as the reference computes them in float32; decoupled
weight decay applies to the leaves of ``ndim >= 2`` only, as the
reference's tree has them: it stacks each per-layer leaf over the layers,
so there every leaf of a model's per-layer parts (``blocks``, ``enc``,
``dec``: norm scales and biases too) has ``ndim >= 2`` and decays
(:func:`decayed`). A leaf of more than :data:`UPDATE_CHUNK` elements is
updated a slice at a time (:func:`pieces`): the update is elementwise, so
each element comes out bit for bit as the whole leaf's would, and its
float32 temporaries are a slice's, not the leaf's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models.layers import map_tree, tree_leaves
from repro_torch.models.model import STACKED


# the elements of a leaf that AdamW updates at a time: a slice's float32
# temporaries (m / b1c, v / b2c, the update) are 256 MiB each, where
# qwen1.5-110b's embedding and head of 1.25 B elements each made 4.98 GB
# temporaries, and a one-layer step ran out of memory on an 80 GB card
UPDATE_CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    count: int


def init_opt_state(params) -> OptState:
    """Zero float32 moments shaped (and, on a mesh, laid out) like
    ``params``, count 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return OptState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                    count=0)


def schedule(hp: AdamWConfig, step) -> float:
    """Learning rate at ``step``: linear warmup over ``warmup_steps``, then a
    cosine from ``lr`` down to ``lr * min_lr_ratio`` at ``total_steps``,
    computed in float32 as the reference's."""
    f32 = np.float32
    step = f32(step)
    warm = step / f32(max(hp.warmup_steps, 1))
    prog = np.clip((step - f32(hp.warmup_steps))
                   / f32(max(hp.total_steps - hp.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(hp.min_lr_ratio) + f32(1 - hp.min_lr_ratio) * f32(0.5) * (
        f32(1) + np.cos(f32(np.pi) * prog, dtype=f32))
    return float(f32(hp.lr) * (warm if step < hp.warmup_steps else cos))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_leaves(tree)))


def decayed(params) -> list[bool]:
    """For each leaf of ``params``, in order, whether weight decay applies:
    ``ndim >= 2``, or a leaf of a model tree's per-layer part
    (:data:`~repro_torch.models.model.STACKED`), which the reference holds
    stacked over the layers."""
    if not isinstance(params, dict):
        return [t.ndim >= 2 for t in tree_leaves(params)]
    return [flag for name, sub in params.items()
            for flag in ([True] * len(tree_leaves(sub)) if name in STACKED
                         else decayed(sub))]


@torch.no_grad()
def adamw_update(grads, opt: OptState, params, hp: AdamWConfig,
                 gnorm: torch.Tensor | None = None):
    """One AdamW step, in place on ``params``, ``opt.m`` and ``opt.v`` (and
    on ``grads``, which it scales): returns (params, OptState with count + 1,
    grad_norm). ``gnorm`` is :func:`global_norm` of ``grads`` when the
    caller has it already."""
    count = opt.count + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(hp.clip_norm / (gnorm + 1e-9), max=1.0)
    f32 = np.float32
    lr = schedule(hp, count)
    b1c = float(f32(1) - f32(hp.b1) ** f32(count))
    b2c = float(f32(1) - f32(hp.b2) ** f32(count))
    for leaves, decay in zip(zip(tree_leaves(params), tree_leaves(grads),
                                 tree_leaves(opt.m), tree_leaves(opt.v)),
                             decayed(params)):
        for p, g, m, v in pieces(*leaves):
            g = g.float().mul_(scale)
            m.mul_(hp.b1).add_(g, alpha=1 - hp.b1)
            v.mul_(hp.b2).addcmul_(g, g, value=1 - hp.b2)
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(hp.eps))
            if decay:            # decoupled weight decay on matrices only
                upd.add_(p.float(), alpha=hp.weight_decay)
            p.sub_(upd.mul_(lr))
    return params, OptState(opt.m, opt.v, count), gnorm


def pieces(*leaves) -> list[tuple]:
    """``leaves`` (a parameter, its gradient and moments) as slices of
    :data:`UPDATE_CHUNK` elements of each, views in place, where they are
    plain contiguous tensors of more elements than that; else the leaves
    whole, in one piece (a DTensor's or a fake tensor's update is not
    sliced). Every slice starts at a multiple of UPDATE_CHUNK elements, so
    a kernel meets each element at the same alignment as in the whole."""
    n = leaves[0].numel()
    if n <= UPDATE_CHUNK or not all(
            type(t) is torch.Tensor and t.is_contiguous() for t in leaves):
        return [leaves]
    flat = [t.view(-1) for t in leaves]
    return [tuple(f[i:i + UPDATE_CHUNK] for f in flat)
            for i in range(0, n, UPDATE_CHUNK)]
