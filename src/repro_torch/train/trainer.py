"""Fault-tolerant training loop (counterpart of ``repro.train.trainer``).

As the reference's:
  * checkpoint/restart: periodic asynchronous checkpoints; on start,
    resume from the latest one (:meth:`Trainer.restore_or_init`);
  * a watchdog thread that records steps exceeding ``hang_timeout``;
  * data replay: the loader is seeked to the restored step;
  * a loss-spike guard: a step whose loss is not finite or exceeds
    ``spike_factor`` times the median of the last 32 accepted losses is
    dropped, the state left as it was;
  * a metric history, one record a step.

The reference's step returns new trees and the guard may drop them; here
the step's halves run apart (:class:`~repro_torch.train.train_step.TrainStep`):
loss and gradients, the guard, then the in-place AdamW update only for an
accepted step, so the history, the state and the checkpoints come out as
the reference's. A step that the last periodic checkpoint already wrote
is not written again at the end. ``TrainerConfig(ckpt_dir=None)`` runs
without checkpoints, neither resuming nor writing (a state larger than
the disk can take: llama3-8b's float32 masters and moments at 15 layers
are ~52 GB).
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.distributed import sharding as shd
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import global_norm, init_opt_state


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    hang_timeout: float = 300.0
    spike_factor: float = 8.0        # skip update if loss > spike * median
    log_every: int = 10


class Watchdog:
    """Heartbeat monitor: records gaps between beats over ``timeout``."""

    def __init__(self, timeout: float):
        self.timeout = timeout
        self.last_beat = time.monotonic()
        self.hangs: list[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self.last_beat = time.monotonic()

    def _run(self):
        while not self._stop.wait(min(self.timeout / 4, 5.0)):
            gap = time.monotonic() - self.last_beat
            if gap > self.timeout:
                self.hangs.append(gap)
                # a float slot: a stale read only delays the next report
                self.last_beat = time.monotonic()  # lint: waive race-check -- heartbeat timestamp; atomic slot swap, staleness only delays the next hang report

    def stop(self):
        self._stop.set()


class Trainer:
    """Runs ``train_step`` (a :class:`~repro_torch.train.train_step.TrainStep`)
    over ``loader`` for ``tc.steps`` steps. ``init_params_fn`` makes the
    initial float32 master parameters (default: ``model.init(seed=0,
    masters=True)``). With ``shardings`` (a :class:`~repro_torch.train.
    train_step.TrainShardings`) the initial state is laid out on its mesh
    and a restore lays the checkpoint out onto it (elastic re-shard)."""

    def __init__(self, model, train_step, loader, tc: TrainerConfig,
                 shardings=None, init_params_fn=None):
        self.model = model
        self.train_step = train_step
        self.loader = loader
        self.tc = tc
        self.shardings = shardings
        self.init_params_fn = init_params_fn or (
            lambda: model.init(seed=0, masters=True))
        self.ckpt = (None if tc.ckpt_dir is None
                     else Checkpointer(tc.ckpt_dir, keep=tc.keep))
        self.history: list[dict] = []

    def restore_or_init(self):
        """Returns (params, opt_state, start_step)."""
        params = self.init_params_fn()
        sh = None
        if self.shardings is not None:
            params = shd.lay_out_tree(params, self.shardings.params)
            sh = {"params": self.shardings.params, "opt": self.shardings.opt}
        opt = init_opt_state(params)
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return params, opt, 0
        state, step = self.ckpt.restore({"params": params, "opt": opt},
                                        shardings=sh)
        return state["params"], state["opt"], step

    def run(self):
        params, opt, start = self.restore_or_init()
        self.loader.seek(start)
        dog = Watchdog(self.tc.hang_timeout).start()
        losses: list[float] = []
        saved = None
        try:
            for step in range(start, self.tc.steps):
                batch = self.loader.next_batch()
                t0 = time.perf_counter()
                loss_t, grads = self.train_step.grads(params, batch)
                gnorm = global_norm(grads)
                loss = float(loss_t)
                dog.beat()
                # loss-spike guard: drop the update, keep the old state
                med = float(np.median(losses[-32:])) if losses else loss
                skipped = not (np.isfinite(loss) and
                               loss <= self.tc.spike_factor * max(med, 1e-9))
                if not skipped:
                    params, opt, _ = self.train_step.update(params, opt,
                                                            grads, gnorm)
                    losses.append(loss)
                del grads
                rec = {"step": step + 1, "loss": loss,
                       "grad_norm": float(gnorm),
                       "dt": time.perf_counter() - t0, "skipped": skipped}
                self.history.append(rec)
                if (step + 1) % self.tc.log_every == 0:
                    print(f"step {rec['step']:6d} loss {rec['loss']:.4f} "
                          f"gnorm {rec['grad_norm']:.3f} "
                          f"dt {rec['dt'] * 1e3:.0f}ms"
                          + (" [skipped]" if skipped else ""))
                if self.ckpt and (step + 1) % self.tc.ckpt_every == 0:
                    self.ckpt.save(step + 1, {"params": params, "opt": opt})
                    saved = step + 1
            if self.ckpt and saved != self.tc.steps:
                self.ckpt.save(self.tc.steps, {"params": params, "opt": opt},
                               blocking=True)
        finally:
            dog.stop()
            if self.ckpt:
                self.ckpt.wait()
        return params, opt, self.history
