"""The train step: loss, gradients through autograd, AdamW (counterpart of
``repro.train.train_step``, without its shardings: the mesh and
``TrainShardings`` wait for the port of ``repro.distributed``).

:func:`make_train_step` returns a :class:`TrainStep`. Called as the
reference's step, ``step(params, opt, batch) -> (params, opt, metrics)``,
it updates in place. The trainer calls its two halves instead,
:meth:`TrainStep.grads` and then :meth:`TrainStep.update` only when the
loss passes its spike guard, so that a dropped step leaves the state
untouched without a second copy of it. Gradients are taken with
``torch.autograd.grad`` of ``model.loss`` with respect to every
parameter leaf (float32 masters); a leaf the loss does not reach gets
zeros, as JAX gives it.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import map_tree, tree_leaves
from repro_torch.train.optimizer import (
    AdamWConfig, OptState, adamw_update, global_norm,
)


class TrainStep:
    """Loss + gradients + AdamW for ``model`` under ``hp``; ``grad_accum >
    1`` splits the batch's rows into that many microbatches and averages
    their losses and gradients (each microbatch's activations are freed
    before the next)."""

    def __init__(self, model, hp: AdamWConfig, grad_accum: int = 1):
        self.model = model
        self.hp = hp
        self.grad_accum = grad_accum

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
        return adamw_update(grads, opt, params, self.hp, gnorm)

    def __call__(self, params, opt: OptState, batch: dict):
        loss, grads = self.grads(params, batch)
        params, opt, gnorm = self.update(params, opt, grads,
                                         global_norm(grads))
        return params, opt, {"loss": loss, "grad_norm": gnorm,
                             "step": opt.count}


def make_train_step(model, hp: AdamWConfig, *,
                    grad_accum: int = 1) -> TrainStep:
    """``step(params, opt, batch) -> (params, opt, metrics)``, in place."""
    return TrainStep(model, hp, grad_accum)
