"""Event-level instrumentation (the paper's measurement technique, §4.1).

Application progress is a sequence of "events" — high-level steps a request
passes through (ingestion, detection, broker wait, identification...). Each
event records wall-time span, payload size and metadata; aggregation
produces the paper's Fig-6-style latency breakdowns and Fig-8-style cycle
breakdowns without perturbing the application (logging is O(1) appends).

The port's own copy of ``repro.core.events`` (no JAX there, but the port
imports nothing of ``repro``); the stage table and the five-way rules are
the reference's, so the two packages attribute every span alike.
"""
from __future__ import annotations

import json
import math
import time
from collections import defaultdict
from dataclasses import dataclass, field


FIVE_WAY = ("pre", "ai", "post", "transfer", "queue")

# Canonical stage -> bucket table, a copy of the reference's. Every
# categorizer in the port resolves through :func:`categorize`
# (``facerec.stage_category``, ``taxmeter.taxed_stage_category``, the
# preprocess stage's log guard) — a stage name that is neither listed
# here nor matched by the prefix/suffix conventions below cannot silently
# leak into the residual "pre" bucket.
STAGE_CATEGORIES = {
    "ingest": "pre",
    "detect": "ai", "identify": "ai",
    "prefill": "ai", "decode": "ai",        # serving-engine AI stages
    "wait": "queue", "wait_frames": "queue", "reject": "queue",
    "requeue": "queue",   # fault rebalance: in-flight work re-enqueued
    # reliability layer (retry/hedge/deadline lifecycle): duplicated or
    # abandoned attempts are time the request spent fighting the
    # infrastructure, not being processed — queue tax. ``degrade`` marks
    # a request served in a reduced-accuracy mode; the saved work was
    # post-processing (NMS re-rank / resolution), so the marker lands in
    # the post bucket.
    "retry": "queue", "hedge": "queue", "hedge_cancel": "queue",
    "hedge_waste": "queue", "deadline_miss": "queue",
    "degrade": "post",
    # trace replay: zero-duration window marker on the trace's time
    # axis (the digital-twin comparison grid); contributes no time, the
    # bucket only keeps the canonical-table lint airtight
    "heartbeat": "queue",
    "transfer": "transfer",
}

# prefix-typed stages (the preprocess stage self-classifies its spans)
STAGE_PREFIXES = {"pre_": "pre", "post_": "post"}

# suffix-typed stages (TaxedStep's ``<name>/<phase>`` convention)
STAGE_SUFFIXES = {"/pre": "pre", "/post": "post", "/compute": "ai",
                  "/h2d": "transfer", "/d2h": "transfer",
                  "/wait": "queue"}


def categorize(stage: str, default: str | None = "pre") -> str | None:
    """Canonical stage name -> {pre, ai, post, transfer, queue}.

    Resolution order: exact :data:`STAGE_CATEGORIES` entry, then the
    suffix convention (TaxedStep's ``<name>/<phase>``), then the prefix
    convention (``pre_*``/``post_*``), then any stage containing
    ``wait`` lands in ``queue``. Anything else gets ``default`` — the
    paper's residual-tax convention is ``"pre"`` (work around the AI
    that isn't a queue or a crossing is pre/post-processing); pass
    ``default=None`` to get ``None`` back instead, which is how the
    tax-stage lint detects stage names that do not resolve through the
    canonical table at all.
    """
    if stage in STAGE_CATEGORIES:
        return STAGE_CATEGORIES[stage]
    for suffix, cat in STAGE_SUFFIXES.items():
        if stage.endswith(suffix):
            return cat
    for prefix, cat in STAGE_PREFIXES.items():
        if stage.startswith(prefix):
            return cat
    if "wait" in stage:
        return "queue"
    return default


def five_way_fractions(per_stage: dict[str, float], category_of,
                       ) -> dict[str, float]:
    """Attribute a per-stage time breakdown into the five tax buckets.

    ``category_of`` maps a stage name to one of :data:`FIVE_WAY`
    (e.g. :func:`repro_torch.core.facerec.stage_category`, or
    :func:`repro_torch.core.taxmeter.taxed_stage_category` for TaxedStep
    logs). Every stage lands in exactly one bucket, so the returned
    fractions sum to 1 whenever any time was recorded — the paper's
    "every microsecond is somebody's tax" discipline. Shared by the
    live pipeline, the DES breakdown (``fig06``) and the TaxedStep
    harness, so the figures and the runtime can never drift onto
    different stage lists.
    """
    totals = dict.fromkeys(FIVE_WAY, 0.0)
    for stage, t in per_stage.items():
        cat = category_of(stage)
        if cat not in totals:
            raise ValueError(f"category {cat!r} for stage {stage!r} not in "
                             f"{FIVE_WAY}")
        totals[cat] += t
    grand = sum(totals.values())
    if not grand:
        return totals
    return {k: v / grand for k, v in totals.items()}


@dataclass
class Event:
    request_id: int
    stage: str
    t_start: float
    t_end: float
    payload_bytes: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


class EventLog:
    """Append-only event store + aggregations."""

    def __init__(self):
        self.events: list[Event] = []

    def log(self, request_id: int, stage: str, t_start: float, t_end: float,
            payload_bytes: int = 0, **meta) -> Event:
        ev = Event(request_id, stage, t_start, t_end, payload_bytes, meta)
        self.events.append(ev)
        return ev

    def log_transfer(self, request_id: int, direction: str, nbytes: int,
                     boundary: str, t_start: float | None = None,
                     t_end: float | None = None,
                     stage: str = "transfer") -> Event:
        """A host<->device boundary crossing (the paper's transfer tax).

        ``direction`` is ``"h2d"`` or ``"d2h"``; ``boundary`` names the
        crossing (e.g. ``"crop_resize"``, ``"identify_fused"``) so
        per-boundary byte accounting survives aggregation. Transfers
        that happen inside a jitted program aren't separately timeable
        — callers may log them as zero-duration point events; the bytes
        are the quantity of record (`transfer_bytes()`), while timed
        crossings (e.g. TaxedStep's explicit device_put/get) carry real
        spans and show up in the time split too.
        """
        t0 = time.perf_counter() if t_start is None else t_start
        return self.log(request_id, stage, t0, t0 if t_end is None else t_end,
                        payload_bytes=nbytes, kind="transfer",
                        direction=direction, boundary=boundary)

    def log_batch_span(self, rids, stage: str, t_start: float, t_end: float,
                       payload_bytes: int = 0, split_payload: bool = False,
                       **meta) -> None:
        """Amortize one batched span into per-request events.

        The batch's wall span is partitioned into ``len(rids)`` equal
        slices (``duration = span / B``), each tagged
        ``batch_size=B`` — the discipline docs/ai_tax_accounting.md
        describes, shared by the pipeline's AI stages, the preprocess
        stage, and the benchmarks. ``payload_bytes`` is per-item by
        default; with ``split_payload`` it is a batch total, divided
        across items with the remainder on the first so the batch sum
        stays exact.
        """
        B = max(len(rids), 1)
        dt = (t_end - t_start) / B
        for i, rid in enumerate(rids):
            per = (payload_bytes // B + (payload_bytes % B if i == 0 else 0)
                   if split_payload else payload_bytes)
            self.log(rid, stage, t_start + i * dt, t_start + (i + 1) * dt,
                     payload_bytes=per, batch_size=B, **meta)

    def log_batch_transfers(self, rids, boundary: str, h2d: int, d2h: int,
                            t: float | None = None) -> None:
        """Per-item transfer events for one batched boundary crossing.

        The batch's boundary bytes (padding included — padded rows
        cross too) are split across its items, remainder on the first,
        so per-request accounting and batch totals both stay exact.
        Shared by the streaming pipeline's AI stages and the
        preprocess stage's device placement.
        """
        t = time.perf_counter() if t is None else t
        B = max(len(rids), 1)
        for j, rid in enumerate(rids):
            extra_up, extra_dn = (h2d % B, d2h % B) if j == 0 else (0, 0)
            self.log_transfer(rid, "h2d", h2d // B + extra_up, boundary, t)
            self.log_transfer(rid, "d2h", d2h // B + extra_dn, boundary, t)

    def transfer_bytes(self, boundary: str | None = None) -> dict[str, int]:
        """Total transferred bytes by direction (optionally one boundary)."""
        out = {"h2d": 0, "d2h": 0}
        for ev in self.events:
            if ev.meta.get("kind") != "transfer":
                continue
            if boundary is not None and ev.meta.get("boundary") != boundary:
                continue
            out[ev.meta.get("direction", "h2d")] = \
                out.get(ev.meta.get("direction", "h2d"), 0) + ev.payload_bytes
        out["total"] = sum(out.values())
        return out

    # ---- aggregations -----------------------------------------------------

    def stage_latencies(self) -> dict[str, list[float]]:
        out: dict[str, list[float]] = defaultdict(list)
        for ev in self.events:
            out[ev.stage].append(ev.duration)
        return dict(out)

    def breakdown(self, percentile: float | None = None) -> dict[str, float]:
        """Mean (or percentile) latency per stage."""
        out = {}
        for stage, ds in self.stage_latencies().items():
            ds = sorted(ds)
            if percentile is None:
                out[stage] = sum(ds) / len(ds)
            else:
                out[stage] = ds[min(len(ds) - 1,
                                    int(math.ceil(percentile * len(ds))) - 1)]
        return out

    def end_to_end(self, stages: list[str] | None = None) -> list[float]:
        """Per-request total latency (first start -> last end)."""
        spans: dict[int, list[Event]] = defaultdict(list)
        for ev in self.events:
            if stages is None or ev.stage in stages:
                spans[ev.request_id].append(ev)
        return [max(e.t_end for e in evs) - min(e.t_start for e in evs)
                for evs in spans.values() if evs]

    def tail(self, q: float = 0.99) -> float:
        return self.percentiles((q,))[q]

    def percentiles(self, qs=(0.5, 0.95, 0.99),
                    stages: list[str] | None = None) -> dict[float, float]:
        """Per-request e2e latency percentiles (tail-SLO quantities).

        Delegates to :func:`repro_torch.core.metrics.percentile`, the
        nearest-rank convention of ``repro.core.metrics``.
        """
        from repro_torch.core.metrics import percentile
        e2e = self.end_to_end(stages)
        return {q: percentile(e2e, q) for q in qs}

    def mean_e2e(self) -> float:
        e2e = self.end_to_end()
        return sum(e2e) / len(e2e) if e2e else 0.0

    def _kind_aware(self, category_of):
        """Wrap a stage->bucket map with the authoritative-kind rule:
        stages whose events carry ``kind="transfer"`` meta are forced
        into the ``transfer`` bucket regardless of name."""
        transfer_set = {ev.stage for ev in self.events
                        if ev.meta.get("kind") == "transfer"}
        return lambda s: "transfer" if s in transfer_set else category_of(s)

    def five_way(self, category_of) -> dict[str, float]:
        """Five-way mean-latency attribution: {pre, ai, post, transfer,
        queue}, summing to 1 (see :func:`five_way_fractions`)."""
        return five_way_fractions(self.breakdown(),
                                  self._kind_aware(category_of))

    def five_way_seconds(self, category_of) -> dict[str, float]:
        """Total busy seconds per five-way bucket (sums, not means).

        The same attribution as :meth:`five_way` over summed event
        durations — what the offload benchmarks scale under emulated
        acceleration. One implementation of the kind-override rule for
        both aggregations, so they cannot drift.
        """
        cat = self._kind_aware(category_of)
        out = dict.fromkeys(FIVE_WAY, 0.0)
        for ev in self.events:
            out[cat(ev.stage)] += ev.duration
        return out

    def windowed_five_way(self, category_of, window_s: float,
                          fractions: bool = True) -> dict[int, dict]:
        """Per-tumbling-window five-way attribution, keyed by window.

        Events land in window ``int(t_end // window_s)`` (the heartbeat
        grid the digital-twin comparison runs on — same t=0 alignment
        as ``metrics.windowed_percentile``). With ``fractions=True``
        each window's buckets sum to 1 when any time was recorded
        (all-zero otherwise, e.g. a window holding only zero-duration
        markers); with ``fractions=False`` raw busy seconds per bucket
        are returned — what the flash-crowd signature check thresholds.
        """
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        cat = self._kind_aware(category_of)
        acc: dict[int, dict] = {}
        for ev in self.events:
            d = acc.setdefault(int(ev.t_end // window_s),
                               dict.fromkeys(FIVE_WAY, 0.0))
            d[cat(ev.stage)] += ev.duration
        if not fractions:
            return dict(sorted(acc.items()))
        out = {}
        for w, d in sorted(acc.items()):
            grand = sum(d.values())
            out[w] = ({k: v / grand for k, v in d.items()} if grand
                      else d)
        return out

    def ai_tax(self, ai_stages: set[str],
               category_of=None) -> dict[str, float]:
        """Fraction of total time in AI vs supporting stages (the AI tax).

        The tax side is further split: stages whose events carry
        ``kind="transfer"`` meta (host<->device crossings) are reported
        as ``transfer_fraction`` (a subset of ``tax_fraction``), and
        the boundary bytes they moved as ``transfer_bytes`` — so the
        breakdown reads AI vs pre/post-processing vs data movement.

        With ``category_of`` (a stage-name -> :data:`FIVE_WAY` bucket
        map), the report gains the full five-way attribution:
        ``fractions`` (summing to 1) plus ``pre_fraction`` /
        ``post_fraction`` — the pre/post-processing tax split the
        offload benchmarks sweep.
        """
        by_stage = self.breakdown()
        transfer_set = {ev.stage for ev in self.events
                        if ev.meta.get("kind") == "transfer"}
        ai = sum(v for s, v in by_stage.items() if s in ai_stages)
        transfer = sum(v for s, v in by_stage.items() if s in transfer_set)
        total = sum(by_stage.values())
        out = {"ai_fraction": ai / total if total else 0.0,
               "tax_fraction": 1.0 - (ai / total if total else 0.0),
               "transfer_fraction": transfer / total if total else 0.0,
               "transfer_bytes": self.transfer_bytes(),
               "total_latency": total,
               "per_stage": by_stage}
        if category_of is not None:
            fr = self.five_way(category_of)
            out["fractions"] = fr
            out["pre_fraction"] = fr["pre"]
            out["post_fraction"] = fr["post"]
        return out


    def throughput(self) -> float:
        """Completed requests per second over the observed span."""
        if not self.events:
            return 0.0
        t0 = min(e.t_start for e in self.events)
        t1 = max(e.t_end for e in self.events)
        n = len({e.request_id for e in self.events})
        return n / (t1 - t0) if t1 > t0 else 0.0

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps({
                    "request_id": ev.request_id, "stage": ev.stage,
                    "t_start": ev.t_start, "t_end": ev.t_end,
                    "payload_bytes": ev.payload_bytes, **ev.meta}) + "\n")


class Timer:
    """Context manager that logs an event on exit (live pipelines)."""

    def __init__(self, log: EventLog, request_id: int, stage: str,
                 payload_bytes: int = 0, clock=time.perf_counter, **meta):
        self.log, self.request_id, self.stage = log, request_id, stage
        self.payload_bytes, self.meta, self.clock = payload_bytes, meta, clock

    def __enter__(self):
        self.t0 = self.clock()
        return self

    def __exit__(self, *exc):
        self.log.log(self.request_id, self.stage, self.t0, self.clock(),
                     self.payload_bytes, **self.meta)
        return False
