"""Training steps through the port's ``TrainStep``.

Set-up builds one ``repro_torch.train.train_step.TrainStep`` with its
model, float32 masters drawn on the card from the seed and AdamW's zero
moments, draws ``batches`` batches of ``batch`` x ``seq_len`` + 1 token
ids on the card (every row differs), and drives that same object through
its first ``check_steps`` steps with the window's own call,
``step(params, opt, batch)``. The window then calls it on the next batches
until ``--seconds`` have passed and the card has finished; the end-to-end
metric is the tokens of every step over the window's seconds.

A traced run makes the call's two halves itself, as ``TrainStep.__call__``
makes them (``grads``, then ``global_norm`` and ``update``), with CUDA
events around the second half (``update_ms``).

``correct`` (limits in ``portbench/limits/<workload>.json``): the
reference (:mod:`reference.train`) follows the first steps from the same
masters and batches, once the window has closed and the program is freed.
``loss_gap``: the worst step's |loss - reference| over the reference's.
``grad_gap``: the worst leaf's gap between the norm of the first step's
gradient as AdamW took it (clipped; read from the first moment after step
1, m / (1 - b1)) and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. ``change_gap``: the same for the
norm of each leaf's change over the first steps, leaving out the leaves
whose reference gradient is under a thousandth of the median leaf's
(they move by round-off alone).
"""
from __future__ import annotations

import statistics
import time

from benchkit import checks, configs, traffic, weights
from benchkit.harness import Check, Outcome
from benchkit.trace import Trace, clock_offset_ns
from benchkit.window import Ctx

TRACE_SECONDS = 10.0
# a leaf whose reference gradient is under this share of the median leaf's
# moves under AdamW by round-off alone and is left out of change_gap
STILL_LEAF = 1e-3


def flat_leaves(params) -> dict:
    """The port's parameter tree as {dotted name: tensor}."""
    out = {}
    for k in ("embed", "ln_f"):
        for n, t in params[k].items():
            out[f"{k}.{n}"] = t
    for i, layer in enumerate(params["blocks"]):
        def walk(node, pre):
            for n, t in node.items():
                if isinstance(t, dict):
                    walk(t, f"{pre}{n}.")
                else:
                    out[f"blocks.{i}.{pre}{n}"] = t
        walk(layer, "")
    return out


def run(run) -> Outcome:
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import (
        AdamWConfig, global_norm, init_opt_state,
    )
    from repro_torch.train.train_step import make_train_step
    from reference.train import change_norms, train_reference

    cfg, tr, dev = run.config, run.traffic, run.device
    pc = configs.port_config(cfg, smoke=run.smoke)
    model = Model(pc, dev)
    params = weights.port_tree(cfg, run.seed, torch.float32, dev)
    checks.same_shapes(model, params)
    opt = init_opt_state(params)
    hp = AdamWConfig(lr=tr["lr"], b1=tr["b1"], b2=tr["b2"], eps=tr["eps"],
                     weight_decay=tr["weight_decay"],
                     clip_norm=tr["clip_norm"],
                     warmup_steps=tr["warmup_steps"],
                     total_steps=tr["total_steps"],
                     min_lr_ratio=tr["min_lr_ratio"])
    step = make_train_step(model, hp)
    data = traffic.train_tokens(tr, cfg["vocab_size"], run.seed, dev)
    nb = data.shape[0]

    def batch(i):
        rows = data[i % nb]
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    n_check = tr["check_steps"]
    losses, grad = [], None
    for i in range(n_check):
        params, opt, m = step(params, opt, batch(i))
        losses.append(m["loss"])
        if i == 0:
            grad = {k: (t / (1 - tr["b1"])).norm()
                    for k, t in flat_leaves(opt.m).items()}
    losses = [float(x) for x in losses]
    grad = {k: float(v) for k, v in grad.items()}
    change = change_norms(cfg, run.seed, flat_leaves(params), dev)
    k = n_check
    if dev == "cuda":
        torch.cuda.synchronize()

    prof, traced = None, None
    spans, steps, upd_events = [], [], []
    if run.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA] if dev == "cuda"
                       else [ProfilerActivity.CPU])
        prof.start()
    offset = clock_offset_ns()
    setup_s = time.perf_counter() - run.t0
    t_start = time.perf_counter()
    t_end = t_start + run.seconds
    t_trace = t_start + min(run.seconds, TRACE_SECONDS)
    window_losses = []
    while time.perf_counter() < t_end:
        if run.trace:
            a = time.perf_counter()
            loss, grads = step.grads(params, batch(k))
            b = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if dev == "cuda" else None
            if ev:
                ev[0].record()
            gnorm = global_norm(grads)
            params, opt, _ = step.update(params, opt, grads, gnorm)
            if ev:
                ev[1].record()
            c = time.perf_counter()
            del grads
            if traced is None:
                spans += [("step.grads", a, b), ("step.update", b, c)]
                steps.append((a, c))
                upd_events.append(ev)
        else:
            params, opt, m = step(params, opt, batch(k))
            loss = m["loss"]
        window_losses.append(loss)
        k += 1
        if prof is not None and traced is None \
                and time.perf_counter() >= t_trace:
            if dev == "cuda":
                torch.cuda.synchronize()
            traced = (t_start, time.perf_counter())
            prof.stop()
    if dev == "cuda":
        torch.cuda.synchronize()
    t_close = time.perf_counter()
    if prof is not None and traced is None:
        traced = (t_start, t_close)
        prof.stop()
    n_steps = len(window_losses)
    window_s = t_close - t_start
    finite = torch.isfinite(torch.stack(window_losses)).tolist()
    e2e = {"train_tokens_per_s":
           n_steps * tr["batch"] * tr["seq_len"] / window_s,
           "setup_s": setup_s}

    ctx = None
    if prof is not None:
        a, b = traced
        ctx = Ctx(cfg, tr, traced, Trace.from_profiler(prof, offset, a, b),
                  spans=[s for s in spans if s[2] <= b],
                  steps=[s for s in steps if s[1] <= b],
                  update_ms=[e[0].elapsed_time(e[1]) for e, s in
                             zip(upd_events, steps) if e and s[1] <= b])
        del prof

    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    first = data[:n_check].clone()
    del params, opt, step, model, data, window_losses
    checks.free(dev)
    ref = train_reference(cfg, tr, run.seed, first, dev)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses,
                                                       ref["losses"]))
    grad_gap, grad_leaf = checks.leaf_gap(grad, ref["grad"], list(grad))
    med = statistics.median(ref["raw_grad"].values())
    moving = [k for k in change if ref["raw_grad"][k] >= STILL_LEAF * med]
    change_gap, change_leaf = checks.leaf_gap(change, ref["change"], moving)
    lim = run.limits
    return Outcome(
        e2e=e2e,
        checks=[Check("loss_gap", loss_gap, lim["loss_gap"]),
                Check("grad_gap", grad_gap, lim["grad_gap"]),
                Check("change_gap", change_gap, lim["change_gap"])],
        attempted=n_steps, failed=finite.count(False),
        memory_peak_bytes=peak, ctx=ctx,
        extra={"losses": losses, "ref_losses": ref["losses"],
               "grad_leaf": grad_leaf, "change_leaf": change_leaf,
               "left_out": sorted(set(change) - set(moving)),
               "steps": n_steps, "window_s": window_s, "grad": grad,
               "change": change, "ref": ref, "moving": moving,
               "batches": first})
