"""TaxMeter: AI-tax instrumentation for one accelerated step (counterpart of
``repro.core.taxmeter``).

The paper's tax categories, applied to a device-resident step: host
pre-processing, host->device transfer, device compute (the only "AI"
part), device->host transfer, and post-processing. Wraps any step
function; produces the same breakdown structure as the cluster sim so
both substrates are comparable in one table.

The reference's ``jax.device_put`` + ``block_until_ready`` become
``.to(device)`` over the payload's leaves and a ``torch.cuda.synchronize``
on a CUDA device; its ``jax.device_get`` becomes ``.cpu()``. A CUDA
``device`` without a card raises (:func:`repro_torch.resolve_device`):
nothing carries on on the CPU unless the caller asks for it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.events import EventLog, categorize, five_way_fractions


def taxed_stage_category(stage: str) -> str:
    """TaxedStep stage name -> five-way bucket.

    The step's own stages are suffix-typed (``<name>/pre``,
    ``<name>/h2d``, ``<name>/compute``, ``<name>/d2h``,
    ``<name>/post``); queue waits logged alongside (``wait``/``reject``
    or a ``/wait`` suffix) land in ``queue``. Resolution happens through
    the ONE canonical table + suffix rules in ``repro_torch.core.events``
    (:func:`repro_torch.core.events.categorize`), so this map can never
    drift from ``facerec.stage_category``.
    """
    return categorize(stage)


def _map_leaves(fn, x):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _map_leaves(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_leaves(fn, v) for v in x)
    return fn(x)


def _leaves(x) -> list:
    out = []
    _map_leaves(out.append, x)
    return out


@dataclass
class TaxedStep:
    log: EventLog
    name: str = "step"
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(leaf))
        return t.to(self.device)

    def run(self, request_id: int, *, pre=None, compute=None, post=None,
            payload=None):
        """Executes pre -> h2d -> compute (synchronized) -> d2h -> post.

        ``payload`` (after ``pre``) is a tree of numpy arrays or tensors;
        ``compute`` gets it on the step's device and returns a tree of
        tensors, which come back as CPU tensors."""
        t = time.perf_counter
        x = payload
        if pre is not None:
            t0 = t()
            x = pre(x)
            self.log.log(request_id, f"{self.name}/pre", t0, t(),
                         _nbytes(x))
        t0 = t()
        x_dev = _map_leaves(self._upload, x) if x is not None else None
        self._sync()
        self.log.log_transfer(request_id, "h2d", _nbytes(x), self.name,
                              t0, t(), stage=f"{self.name}/h2d")
        t0 = t()
        y = compute(x_dev) if x_dev is not None else compute()
        self._sync()
        self.log.log(request_id, f"{self.name}/compute", t0, t())
        t0 = t()
        y_host = _map_leaves(lambda a: a.cpu(), y)
        self.log.log_transfer(request_id, "d2h", _nbytes(y_host), self.name,
                              t0, t(), stage=f"{self.name}/d2h")
        if post is not None:
            t0 = t()
            y_host = post(y_host)
            self.log.log(request_id, f"{self.name}/post", t0, t())
        return y_host

    def breakdown(self) -> dict:
        per = self.log.breakdown()
        fr = five_way_fractions(per, taxed_stage_category)
        compute = sum(v for k, v in per.items() if k.endswith("/compute"))
        transfer = sum(v for k, v in per.items()
                       if k.endswith(("/h2d", "/d2h")))
        total = sum(per.values())
        return {"per_stage": per,
                "ai_fraction": compute / total if total else 0.0,
                "tax_fraction": 1 - (compute / total if total else 0.0),
                "transfer_fraction": transfer / total if total else 0.0,
                "fractions": fr,
                "pre_fraction": fr["pre"],
                "post_fraction": fr["post"],
                "transfer_bytes": self.log.transfer_bytes()}


def _nbytes(x) -> int:
    """Bytes of a tree's leaves: tensors and numpy arrays alike (anything
    else as numpy reads it)."""
    if x is None:
        return 0
    return int(sum(leaf.element_size() * leaf.numel()
                   if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf).nbytes for leaf in _leaves(x)))
