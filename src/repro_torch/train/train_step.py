"""The train step: loss, gradients through autograd, AdamW under explicit
shardings (counterpart of ``repro.train.train_step``).

:func:`make_train_step` returns a :class:`TrainStep`. Called as the
reference's step, ``step(params, opt, batch) -> (params, opt, metrics)``,
it updates in place. The trainer calls its two halves instead,
:meth:`TrainStep.grads` and then :meth:`TrainStep.update` only when the
loss passes its spike guard, so that a dropped step leaves the state
untouched without a second copy of it. Gradients are taken with
``torch.autograd.grad`` of ``model.loss`` with respect to every
parameter leaf (float32 masters); a leaf the loss does not reach gets
zeros, as JAX gives it.

Shardings: :func:`make_train_shardings` gives :class:`TrainShardings`,
the :class:`~repro_torch.distributed.sharding.NamedSharding` of every
parameter, optimizer moment and batch leaf on a DeviceMesh under the train
rules. A step made with ``sh`` runs the loss, the gradients and the update
under ``use_sharding(sh.mesh, sh.rules)``, on parameters and batches laid
out by them (DTensors on a mesh of more than one device; plain tensors on
a mesh of one); :func:`placed_train_step` lays out each batch first, the
counterpart of the reference's ``jit_train_step`` (its in/out shardings;
there is no jit, and the state is updated in place as donation does).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import map_tree, tree_leaves
from repro_torch.train.optimizer import (
    AdamWConfig, OptState, adamw_update, global_norm,
)


@dataclass(frozen=True)
class TrainShardings:
    params: Any
    opt: Any
    batch: Any
    mesh: Any
    rules: shd.Rules


def batch_shardings(model, specs: dict, mesh, rules: shd.Rules) -> dict:
    """A batch's leaves sharded over their leading (batch) dim only."""
    def one(name, s):
        axes = ("batch",) + (None,) * (len(s.shape) - 1)
        return shd.NamedSharding(mesh, shd.spec_for(axes, tuple(s.shape),
                                                    mesh, rules))
    return {k: one(k, v) for k, v in specs.items()}


def make_train_shardings(model, mesh, rules: shd.Rules | None = None,
                         batch_specs: dict | None = None) -> TrainShardings:
    """Shardings of the float32 masters, the moments (as the masters; the
    count replicated) and, given ``batch_specs``, the batch."""
    rules = rules or shd.TRAIN_RULES
    psh = shd.tree_shardings(model.param_axes(), model.abstract_params(),
                             mesh, rules)
    osh = OptState(m=psh, v=psh, count=shd.replicated(mesh))
    bsh = (batch_shardings(model, batch_specs, mesh, rules)
           if batch_specs else None)
    return TrainShardings(psh, osh, bsh, mesh, rules)


class TrainStep:
    """Loss + gradients + AdamW for ``model`` under ``hp``; ``grad_accum >
    1`` splits the batch's rows into that many microbatches and averages
    their losses and gradients (each microbatch's activations are freed
    before the next)."""

    def __init__(self, model, hp: AdamWConfig, grad_accum: int = 1,
                 sh: TrainShardings | None = None):
        self.model = model
        self.hp = hp
        self.grad_accum = grad_accum
        self.sh = sh

    def _context(self):
        if self.sh is None:
            return contextlib.nullcontext()
        return shd.use_sharding(self.sh.mesh, self.sh.rules)

    def _one(self, params, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = self.model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, grads)]

    def grads(self, params, batch: dict):
        """(loss, gradient tree shaped like ``params``) for ``batch``."""
        with self._context():
            return self._grads(params, batch)

    def _grads(self, params, batch: dict):
        if self.grad_accum == 1:
            loss, flat = self._one(params, batch)
        else:
            n = self.grad_accum
            loss, flat = None, None
            for i in range(n):
                micro = {k: t.reshape(n, -1, *t.shape[1:])[i]
                         for k, t in batch.items()}
                l, g = self._one(params, micro)
                if flat is None:
                    loss, flat = l, g
                else:
                    loss = loss + l
                    for a, b in zip(flat, g):
                        a.add_(b)
            loss = loss / n
            for a in flat:
                a.div_(n)
        it = iter(flat)
        return loss, map_tree(lambda _: next(it), params)

    def update(self, params, opt: OptState, grads,
               gnorm: torch.Tensor | None = None):
        """AdamW in place: (params, opt with count + 1, grad_norm)."""
        with self._context():
            return adamw_update(grads, opt, params, self.hp, gnorm)

    def __call__(self, params, opt: OptState, batch: dict):
        loss, grads = self.grads(params, batch)
        with self._context():
            gnorm = global_norm(grads)
        params, opt, gnorm = self.update(params, opt, grads, gnorm)
        return params, opt, {"loss": loss, "grad_norm": gnorm,
                             "step": opt.count}


def make_train_step(model, hp: AdamWConfig, sh: TrainShardings | None = None,
                    *, grad_accum: int = 1) -> TrainStep:
    """``step(params, opt, batch) -> (params, opt, metrics)``, in place;
    under ``sh``'s mesh and rules when given."""
    return TrainStep(model, hp, grad_accum, sh)


def placed_train_step(model, hp: AdamWConfig, sh: TrainShardings):
    """The counterpart of the reference's ``jit_train_step``: the step of
    ``sh`` with each batch laid out by ``sh.batch`` (the parameters and
    the optimizer state are laid out once, by ``sh.params`` and
    ``sh.opt``, and updated in place), the loss and grad norm returned
    replicated."""
    step = make_train_step(model, hp, sh)

    def train_step(params, opt: OptState, batch: dict):
        batch = {k: shd.lay_out(t, sh.batch[k]) for k, t in batch.items()}
        params, opt, metrics = step(params, opt, batch)
        return params, opt, {k: shd.full(v) if isinstance(v, torch.Tensor)
                             else v for k, v in metrics.items()}
    return train_step
