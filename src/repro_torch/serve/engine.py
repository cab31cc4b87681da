"""Batched serving engine: continuous-batching decode over a batched
decode cache (counterpart of ``repro.serve.engine``).

The reference's production concerns, with its schedulers and ledger:
  * request queue with admission to fixed batch slots (the pipeline's
    :class:`~repro_torch.core.batching.Batcher`), ``max_queue`` admission
    control and the duck-typed ``degrade`` ladder;
  * continuous batching (``scheduler="continuous"``, the default): ONE
    batched decode cache with one row per slot (attention's KV cache of
    ``cache_len`` entries, or RWKV's fixed-size state, which ignores the
    per-slot lengths) plus a host-side per-slot occupancy vector, ONE
    ragged decode step per tick over all slots (through the decode-attention
    or the scan kernel on the card), and prefill-on-admit into freed slots
    while the others keep decoding. An idle slot's rows hold whatever its
    last decode left until an admission overwrites every leaf of the row;
  * the pre-batching baseline (``scheduler="slot"``): one decode call per
    slot per token;
  * per-request AI-tax events (queue wait, prefill, decode; batched decode
    spans amortized per slot) in an EventLog, with every device->host
    fetch both counted (``d2h_syncs``/``d2h_bytes``) and logged as a
    transfer event, so the ledger accounts every boundary byte.

Where the reference waits with ``jax.block_until_ready``, the port copies
the result to the host (``.cpu()``), and every taxed span closes after the
value is on the host. The tick's (2, B) int32 upload of feedback tokens
and lengths stays one host->device copy. A prefill cache is written into
its slot in place, at a host-side index, so admission uploads nothing
(the reference uploads the slot index, 4 bytes). Logit rows fetched on
the unfused path keep the model's dtype on the wire (bf16 at full width);
the ledger books those bytes, and the host widens the row to float32 for
its argmax (first index of the maximum, as ``np.argmax``).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.batching import Batcher
from repro_torch.core.events import EventLog
from repro_torch.core.metrics import LatencyStats, SLOReport, TailSLO


def _step_fused(model, params, cache, tokens):
    logits, cache = model.decode_step(params, cache, tokens)
    return torch.argmax(logits.reshape(-1)).to(torch.int32), cache


def _step_plain(model, params, cache, tokens):
    return model.decode_step(params, cache, tokens)


def _step_batched_fused(model, params, blocks, packed):
    # packed (2, B) int32: row 0 the feedback tokens, row 1 per-slot
    # kv_len — one h2d upload per tick instead of two
    logits, blocks = model.decode_step_ragged(params, blocks,
                                              packed[0][:, None], packed[1])
    return torch.argmax(logits, dim=-1).to(torch.int32), blocks


def _step_batched_plain(model, params, blocks, packed):
    return model.decode_step_ragged(params, blocks, packed[0][:, None],
                                    packed[1])


def _host_argmax(row: torch.Tensor):
    """argmax of a host logits tensor, widened to float32 (numpy has no
    bfloat16): first index of the maximum along the last axis."""
    return np.argmax(row.float().numpy(), axis=-1)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) integer token ids
    max_tokens: int = 16          # bound on generated tokens (prefill incl.)
    t_submit: float = 0.0
    t_first: float = 0.0          # first token ready (TTFT = t_first - t_submit)
    tokens: list = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model, params, *, batch_slots: int = 4,
                 cache_len: int = 128, fast_path: bool = True,
                 max_queue: int | None = None, degrade=None,
                 scheduler: str = "continuous"):
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = batch_slots
        self.cache_len = cache_len
        self.log = EventLog()
        if scheduler not in ("continuous", "slot"):
            raise ValueError(f"scheduler must be continuous/slot: {scheduler!r}")
        if model.cfg.encdec and scheduler == "continuous":
            # as the reference: an encoder-decoder cache is a lock-step
            # scalar-cur_len tree, the ragged batched layout decoder-only.
            # Its prefill then needs "frames", which no request carries:
            # it raises KeyError('frames') in both packages
            scheduler = "slot"
        self.scheduler = scheduler
        # graceful degradation (duck-typed DegradePolicy): under queue
        # pressure, admitted requests get max_tokens clamped by the
        # current level's service_factor, with a zero-span "degrade" event
        self.degrade = degrade
        self._deg_depth = 0
        self.degrade_timeline: list[tuple[float, int, str]] = []
        # admission bound: submissions beyond max_queue pending requests
        # are rejected at the door (zero-span "reject" events); None =
        # accept everything and let queue wait absorb the pressure
        self.max_queue = max_queue
        self.rejected = 0
        self._admit_lock = threading.Lock()   # atomic check-then-put
        self._pending: queue.Queue = queue.Queue()
        self.admission = Batcher(self._pending, batch_size=batch_slots,
                                 timeout_s=0.0)
        self.active: list[Request | None] = [None] * batch_slots
        # ground truth of device->host fetches: every blocking read
        # increments these, and the transfer ledger must book the same
        self.d2h_syncs = 0
        self.d2h_bytes = 0
        # continuous-batching state, host-resident: per-slot occupancy and
        # the token each slot feeds back next tick
        self._kv_len = np.zeros(batch_slots, np.int32)
        self._last_tok = np.zeros(batch_slots, np.int32)
        self._blocks = None          # batched decode cache, one row per slot
        # fast_path: greedy selection on the device, one int32 per slot
        # crosses per step; otherwise the full logit rows come back and
        # the host takes the argmax
        self.fast_path = fast_path
        self._decode = _step_fused if fast_path else _step_plain
        self._decode_batch = (_step_batched_fused if fast_path
                              else _step_batched_plain)

    def submit(self, req: Request) -> bool:
        """Queue a request; False when admission control sheds it."""
        req.t_submit = time.perf_counter()
        with self._admit_lock:
            if (self.max_queue is not None
                    and self._pending.qsize() >= self.max_queue):
                self.rejected += 1
                reject = True
            else:
                self._pending.put(req)
                reject = False
        if reject:
            self.log.log(req.rid, "reject", req.t_submit, req.t_submit,
                         int(req.prompt.nbytes))
        return not reject

    @property
    def queue_depth(self) -> int:
        return self._pending.qsize()

    # -- degradation ladder -------------------------------------------------
    def _degrade_tick(self) -> None:
        """Re-evaluate the ladder on the per-slot backlog (no breakers
        here, so the open-fraction input is 0)."""
        if self.degrade is None:
            return
        depth = self.degrade.decide(
            self.queue_depth / max(self.slots, 1), 0.0, self._deg_depth)
        if depth != self._deg_depth:
            self._deg_depth = depth
            self.degrade_timeline.append(
                (time.perf_counter(), depth,
                 self.degrade.level(depth).name))

    def _degrade_clamp(self, req: Request) -> None:
        if self.degrade is None or self._deg_depth <= 0:
            return
        lvl = self.degrade.level(self._deg_depth)
        cap = max(1, int(req.max_tokens * lvl.service_factor))
        if cap < req.max_tokens:
            req.max_tokens = cap
            t = time.perf_counter()
            self.log.log(req.rid, "degrade", t, t,
                         accuracy_proxy=lvl.accuracy_proxy, level=lvl.name)

    # -- single-sequence prefill per admit ----------------------------------
    def _prefill_one(self, req: Request):
        t0 = time.perf_counter()
        tokens = torch.from_numpy(
            np.asarray(req.prompt, np.int32)[None, :]).to(self.device)
        self.log.log_transfer(req.rid, "h2d", int(tokens.nbytes), "prefill")
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           cache_len=self.cache_len)
        if self.fast_path:
            # argmax on the device; only the winning index crosses
            idx = torch.argmax(logits[0]).to(torch.int32)
            nxt = int(idx.cpu())
            self.log.log(req.rid, "prefill", t0, time.perf_counter(),
                         int(req.prompt.nbytes))
            nbytes = int(idx.nbytes)
        else:
            row = logits[0].cpu()
            self.log.log(req.rid, "prefill", t0, time.perf_counter(),
                         int(req.prompt.nbytes))
            nbytes = int(row.nbytes)
            nxt = int(_host_argmax(row))
        self.d2h_syncs += 1
        self.d2h_bytes += nbytes
        self.log.log_transfer(req.rid, "d2h", nbytes, "prefill")
        req.tokens.append(nxt)
        req.t_first = time.perf_counter()
        return cache, nxt

    def _finished_early(self, req: Request, finished: list) -> bool:
        """Post-prefill finish check: the generated-token bound counts the
        prefill's token, so ``max_tokens=1`` finishes here and never
        decodes; a prompt already at cache capacity never decodes into a
        full cache."""
        if (len(req.tokens) >= req.max_tokens
                or len(req.prompt) >= self.cache_len - 1):
            req.done = True
            finished.append(req)
            return True
        return False

    # -- schedulers ---------------------------------------------------------
    @torch.inference_mode()
    def run(self, max_steps: int = 512) -> list[Request]:
        """Processes the queue to completion (or step limit)."""
        if self.scheduler == "continuous":
            return self._run_continuous(max_steps)
        return self._run_slot(max_steps)

    def _admit_free_slots(self, finished: list) -> list[tuple[int, dict]]:
        """Drain the submission queue into free slots; returns the slots
        admitted this tick (prefill done, first token emitted)."""
        free = [i for i in range(self.slots) if self.active[i] is None]
        admitted = []
        if not free:
            return admitted
        for i, req in zip(free, self.admission.poll(len(free))):
            self.log.log(req.rid, "wait", req.t_submit, time.perf_counter())
            self._degrade_clamp(req)
            cache, _ = self._prefill_one(req)
            if self._finished_early(req, finished):
                continue
            self.active[i] = req
            admitted.append((i, cache))
        return admitted

    def _run_continuous(self, max_steps: int) -> list[Request]:
        """One ragged decode step per tick over all slots; admissions
        prefill into freed slots between ticks."""
        finished: list[Request] = []
        steps = 0
        while (any(self.active) or not self._pending.empty()) \
                and steps < max_steps:
            self._degrade_tick()
            for i, cache in self._admit_free_slots(finished):
                req = self.active[i]
                if self._blocks is None:
                    self._blocks = self.model.init_cache(
                        self.slots, self.cache_len)["blocks"]
                # in-place row copy on the device: resident rows untouched
                self.model.insert_prefill(self._blocks, cache["blocks"], i)
                self._kv_len[i] = len(req.prompt)
                self._last_tok[i] = req.tokens[-1]
            idx = [i for i in range(self.slots)
                   if self.active[i] is not None]
            if idx:
                rids = [self.active[i].rid for i in idx]
                t0 = time.perf_counter()
                packed = torch.from_numpy(
                    np.stack([self._last_tok, self._kv_len])).to(self.device)
                out, self._blocks = self._decode_batch(
                    self.model, self.params, self._blocks, packed)
                out_host = out.cpu()              # the ONE d2h per tick
                t1 = time.perf_counter()
                self.d2h_syncs += 1
                self.d2h_bytes += int(out_host.nbytes)
                self.log.log_batch_span(rids, "decode", t0, t1)
                # boundary bytes, padding (idle lanes) included: the whole
                # slot vector crosses in one batched transfer
                self.log.log_batch_transfers(
                    rids, "decode", h2d=int(packed.nbytes),
                    d2h=int(out_host.nbytes), t=t0)
                nxt = (out_host.numpy() if self.fast_path
                       else _host_argmax(out_host))
                for i in idx:
                    req = self.active[i]
                    tok_i = int(nxt[i])
                    req.tokens.append(tok_i)
                    self._last_tok[i] = tok_i
                    self._kv_len[i] += 1
                    if (len(req.tokens) >= req.max_tokens
                            or self._kv_len[i] >= self.cache_len - 1):
                        # leave at a token boundary: the slot's rows stay
                        # in the cache until a new admission overwrites them
                        req.done = True
                        finished.append(req)
                        self.active[i] = None
                        self._kv_len[i] = 0
                        self._last_tok[i] = 0
            steps += 1
        return finished

    def _run_slot(self, max_steps: int) -> list[Request]:
        """Baseline scheduler: one decode call per slot per token. Cache
        occupancy is tracked on the host; the device is read only for
        token values, and every such read is on the ledger."""
        finished: list[Request] = []
        caches: list = [None] * self.slots
        occ = [0] * self.slots
        steps = 0
        while (any(self.active) or not self._pending.empty()) \
                and steps < max_steps:
            self._degrade_tick()
            for i, cache in self._admit_free_slots(finished):
                caches[i] = cache
                occ[i] = len(self.active[i].prompt)
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                t0 = time.perf_counter()
                tok = torch.tensor([[req.tokens[-1]]], dtype=torch.int32,
                                   device=self.device)
                self.log.log_transfer(req.rid, "h2d", int(tok.nbytes),
                                      "decode")
                if self.fast_path:
                    nxt_dev, caches[i] = self._decode(self.model, self.params,
                                                      caches[i], tok)
                    nxt = int(nxt_dev.cpu())
                    self.log.log(req.rid, "decode", t0, time.perf_counter())
                    nbytes = int(nxt_dev.nbytes)
                else:
                    logits, caches[i] = self._decode(self.model, self.params,
                                                     caches[i], tok)
                    row = logits[0].cpu()
                    self.log.log(req.rid, "decode", t0, time.perf_counter())
                    nbytes = int(row.nbytes)
                    nxt = int(_host_argmax(row))
                self.d2h_syncs += 1
                self.d2h_bytes += nbytes
                self.log.log_transfer(req.rid, "d2h", nbytes, "decode")
                req.tokens.append(nxt)
                occ[i] += 1
                if len(req.tokens) >= req.max_tokens \
                        or occ[i] >= self.cache_len - 1:
                    req.done = True
                    finished.append(req)
                    self.active[i] = None
                    caches[i] = None
                    occ[i] = 0
            steps += 1
        return finished

    def tax_report(self) -> dict:
        return self.log.ai_tax(ai_stages={"prefill", "decode"})

    def ttft_samples(self) -> list[float]:
        """Per-request time-to-first-token (submit -> prefill token), for
        every request that produced one."""
        seen = {}
        for ev in self.log.events:
            if ev.stage == "prefill":
                seen[ev.request_id] = ev.t_end
        subs = {}
        for ev in self.log.events:
            if ev.stage == "wait":
                subs[ev.request_id] = ev.t_start
        return [t - subs[rid] for rid, t in seen.items() if rid in subs]

    def latency_report(self, slo: TailSLO | None = None,
                       ) -> tuple[LatencyStats, SLOReport | None]:
        """Per-request e2e (submit -> last decode) tail percentiles; rejected
        requests count toward the SLO drop fraction, not the latencies."""
        e2e = self.log.end_to_end(stages=["wait", "prefill", "decode"])
        stats = LatencyStats.from_samples(e2e)
        offered = stats.n + self.rejected
        drop_fraction = self.rejected / offered if offered else 0.0
        return stats, (slo.check(stats, drop_fraction)
                       if slo is not None else None)
