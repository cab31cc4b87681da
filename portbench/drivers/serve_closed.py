"""Closed-loop serving through the port's continuous-batching engine.

``clients`` clients each hold one request at a time on ``slots`` slots of
``repro_torch.serve.engine.ServingEngine`` (cache ``cache_len``): when a
request finishes, its client sends the next at once (no think time), and
the request is due at the moment its predecessor's last token landed. The
engine is driven one tick at a time, ``run(max_steps=1)``: a tick admits
what is queued into free slots (a prefill each, ``Model.prefill`` and
``Model.insert_prefill``) and then decodes one token on every busy slot
(``Model.decode_step_ragged``). The engine's own spans (its ``EventLog``)
time each prefill and tick; a token lands at the end of the span that
produced it.

Set-up: weights drawn on the card, a prefill at the mix's longest and
shortest prompt, then every client's first request admitted and one tick,
so the window starts with all slots full. Measured over the whole
window: the rate, tokens landed in the window over its length (a closed
loop keeps every slot busy, so it is the saturated system's); the 95th
percentile of the time to first token of every request whose first token
landed in the window, from when it was due; the 95th percentile of every
gap between consecutive tokens of a request, both in the window. The
cell's ``end_to_end`` entries say which of them its result line gives;
the traced run hands all three to the per-layer readers.

``correct``: once the window has closed and the program is freed, a
sample of the requests finished in the window, drawn from the seed with
the longest among them, until ``check_tokens`` served tokens; the
reference runs over each prompt with its served tokens, and each served
token's gap below the reference's best logit is taken. The cell's limits
(``portbench/limits/<workload>.json``) hold the widest gap
(``widest_gap``) or, where routing makes the widest gap swing as far as
the control's (jamba's top-2 of 16), the mean gap (``mean_gap``).
"""
from __future__ import annotations

import time

import numpy as np

from benchkit import checks, configs, traffic, weights
from benchkit.harness import Check, Outcome
from benchkit.stats import percentile
from benchkit.trace import Trace, clock_offset_ns
from benchkit.window import Ctx

# the traced part of a --trace 1 window, from its start: reading a
# profile costs ~10 us a device activity, and a tick launches thousands
TRACE_SECONDS = 10.0
WARM_ID = 1 << 40


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def window_metrics(times: dict, due: dict, t_start: float,
                   t_close: float) -> tuple[dict, dict]:
    """The end-to-end metrics of a window [t_start, t_close] from each
    request's token times (``times``: rid -> the times its tokens landed)
    and the times its requests were due (``due``): (metrics, counts)."""
    def inside(t):
        return t_start <= t <= t_close
    n_tokens = sum(1 for ts in times.values() for t in ts if inside(t))
    ttft = [ts[0] - due[r] for r, ts in times.items() if ts and inside(ts[0])]
    itl = [b - a for ts in times.values() for a, b in zip(ts, ts[1:])
           if inside(a) and inside(b)]
    window_s = t_close - t_start
    metrics = {"output_tokens_per_s": n_tokens / window_s,
               "ttft_p95_ms": percentile(ttft, 95) * 1e3 if ttft else None,
               "itl_p95_ms": percentile(itl, 95) * 1e3 if itl else None}
    return metrics, {"ttft_n": len(ttft), "itl_n": len(itl),
                     "tokens": n_tokens, "window_s": window_s}


def run(run) -> Outcome:
    import torch
    from repro_torch.models.model import Model
    from repro_torch.models.layers import DTYPES
    from repro_torch.serve.engine import Request, ServingEngine

    cfg, tr, dev = run.config, run.traffic, run.device
    pc = configs.port_config(cfg, smoke=run.smoke)
    model = Model(pc, dev)
    params = weights.port_tree(cfg, run.seed, DTYPES[cfg["dtype"]], dev,
                               final_norm_dtype=torch.float32)
    checks.same_shapes(model, params)
    clients = traffic.serve_requests(tr, cfg["vocab_size"], run.seed)
    per = tr["requests_per_client"]
    engine = ServingEngine(model, params, batch_slots=tr["slots"],
                           cache_len=tr["cache_len"])

    # warm-up: the longest and the shortest prompt, through a tick or two
    ids = np.concatenate([p for c in clients for p, _ in c[:2]])
    for j, n in enumerate((tr["prompt"]["max"], tr["prompt"]["min"])):
        engine.submit(Request(rid=WARM_ID + j,
                              prompt=np.resize(ids, n).astype(np.int32),
                              max_tokens=2))
    engine.run()

    live, due, times, client_of, prompt_len = {}, {}, {}, {}, {}
    nxt = [0] * len(clients)

    def submit(c, t_due):
        k = nxt[c]
        nxt[c] += 1
        prompt, n_out = clients[c][k % per]
        rid = c * 1_000_000 + k
        req = Request(rid=rid, prompt=prompt, max_tokens=n_out)
        live[rid], due[rid], times[rid] = req, t_due, []
        client_of[rid], prompt_len[rid] = c, len(prompt)
        engine.submit(req)

    prefills, ticks, spans, finished = [], [], [], []

    def tick():
        """One engine tick; books its spans, tokens and finishes."""
        n0 = len(engine.log.events)
        done = engine.run(max_steps=1)
        new = engine.log.events[n0:]
        for e in new:
            if e.stage == "prefill":
                req = live[e.request_id]
                prefills.append((prompt_len[e.request_id], e.t_start,
                                 e.t_end))
                spans.append(("engine.prefill", e.t_start, e.t_end))
                times[e.request_id].append(req.t_first)
        dec = [e for e in new if e.stage == "decode"]
        if dec:
            t0, t1 = min(e.t_start for e in dec), max(e.t_end for e in dec)
            rows = [e.request_id for e in dec]
            ticks.append((t0, t1, [prompt_len[r] + len(live[r].tokens) - 1
                                   for r in rows]))
            spans.append(("engine.decode", t0, t1))
            for r in rows:
                times[r].append(t1)
        for req in done:
            t_last = times[req.rid][-1]
            finished.append((req.rid, list(req.tokens), t_last))
            del live[req.rid]
            submit(client_of[req.rid], t_last)

    t_setup = time.perf_counter()
    for c in range(len(clients)):
        submit(c, t_setup)
    tick()
    _sync(dev)

    prof = None
    if run.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if dev == "cuda" else \
            [ProfilerActivity.CPU]
        prof = profile(activities=acts)
        prof.start()
    offset = clock_offset_ns()
    setup_s = time.perf_counter() - run.t0
    t_start = time.perf_counter()
    t_end = t_start + run.seconds
    t_trace = t_start + min(run.seconds, TRACE_SECONDS)
    traced = None
    while time.perf_counter() < t_end:
        tick()
        if prof is not None and traced is None \
                and time.perf_counter() >= t_trace:
            _sync(dev)
            traced = (t_start, time.perf_counter())
            prof.stop()
    t_close = time.perf_counter()
    if prof is not None and traced is None:
        _sync(dev)
        traced = (t_start, time.perf_counter())
        prof.stop()

    e2e, counts = window_metrics(times, due, t_start, t_close)
    e2e["setup_s"] = setup_s
    done_in = [f for f in finished if t_start <= f[2] <= t_close]

    ctx = None
    if prof is not None:
        a, b = traced
        ctx = Ctx(cfg, tr, traced, Trace.from_profiler(prof, offset, a, b),
                  spans=[s for s in spans if a <= s[1] and s[2] <= b],
                  prefills=[p for p in prefills if a <= p[1] and p[2] <= b],
                  ticks=[t for t in ticks if a <= t[0] and t[1] <= b],
                  host={k: e2e[k] for k in ("output_tokens_per_s",
                                            "ttft_p95_ms", "itl_p95_ms")})
        del prof

    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    reqs = {rid: prompt_len[rid] for rid, _, _ in done_in}
    prompts = {rid: clients[client_of[rid]][rid % 1_000_000 % per][0]
               for rid in reqs}
    del engine, params, model, live
    checks.free(dev)
    sample = checks.serve_sample(done_in, run.seed, tr["check_tokens"],
                                 reqs)
    nums, ref_logits, served = checks.serve_gaps(
        cfg, run.seed, sample, prompts, dev, DTYPES[cfg["dtype"]])
    return Outcome(e2e=e2e,
                   checks=[Check(k, nums[k], lim)
                           for k, lim in run.limits.items()],
                   attempted=len(done_in), failed=0,
                   memory_peak_bytes=peak, ctx=ctx,
                   extra={**counts,
                          "sample": sample, "prompts": prompts,
                          "ref_logits": ref_logits, "served": served})
