"""The comparisons that decide ``correct``, run once the window has closed
and the program is freed."""
from __future__ import annotations

import gc
import math
import statistics

import numpy as np


def same_shapes(model, params) -> None:
    """Raise where the drawn tree differs from the port's parameter
    metadata (a leaf missing, extra, or of another shape)."""
    meta = model.param_meta()

    def walk(m, p, path):
        if isinstance(m, dict):
            if not isinstance(p, dict) or set(m) != set(p):
                raise ValueError(f"{path}: keys {sorted(m)} vs "
                                 f"{sorted(p) if isinstance(p, dict) else p}")
            for k in m:
                walk(m[k], p[k], f"{path}.{k}")
        elif isinstance(m, list):
            if len(m) != len(p):
                raise ValueError(f"{path}: {len(m)} layers vs {len(p)}")
            for i, (a, b) in enumerate(zip(m, p)):
                walk(a, b, f"{path}[{i}]")
        elif tuple(m.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {m.shape} vs {tuple(p.shape)}")
    walk(meta, params, "params")


def free(device) -> None:
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---- serving ---------------------------------------------------------------

def serve_sample(done: list, seed: int, want_tokens: int,
                 prompt_len: dict) -> list:
    """Requests (rid, tokens, t) finished in the window, in an order drawn
    from the seed with the longest (prompt and served tokens) first, taken
    until ``want_tokens`` served tokens."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (
        prompt_len[done[i][0]] + len(done[i][1]), done[i][0]))
    rng = np.random.default_rng([int(seed), 0xC4EC])
    order = [longest] + [int(i) for i in rng.permutation(len(done))
                         if i != longest]
    out, n = [], 0
    for i in order:
        if n >= want_tokens:
            break
        out.append(done[i])
        n += len(done[i][1])
    return out


def gap_numbers(gaps: list[list[float]]) -> dict[str, float]:
    """The numbers a serving cell's limits may hold, from each served
    token's gap below the reference's best (``served_gaps``): the widest
    gap, and the mean gap over every served token of the sample. Both are
    inf where the sample is empty: a window that finished nothing has
    nothing right."""
    flat = [g for gs in gaps for g in gs]
    if not flat:
        return {"widest_gap": math.inf, "mean_gap": math.inf}
    return {"widest_gap": max(flat), "mean_gap": sum(flat) / len(flat)}


def serve_gaps(cfg: dict, seed: int, sample: list, prompts: dict, device,
               wdtype) -> tuple[dict, list, list]:
    """(``gap_numbers`` of the sample; the reference's logits; the served
    tokens)."""
    import torch
    from reference.lm import serve_logits, served_gaps
    if not sample:
        return gap_numbers([]), [], []
    seqs, lens, served = [], [], []
    for rid, toks, _ in sample:
        p = np.asarray(prompts[rid], np.int64)
        seqs.append(torch.from_numpy(np.concatenate(
            [p, np.asarray(toks[:-1], np.int64)])))
        lens.append(len(p))
        served.append(list(toks))
    logits = serve_logits(cfg, seed, seqs, lens, wdtype, device)
    return gap_numbers(served_gaps(logits, served)), logits, served


# ---- training --------------------------------------------------------------

def leaf_gap(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """The worst leaf's |prog - ref| over max(ref, the median leaf's ref),
    and its name."""
    med = statistics.median(ref[k] for k in keys)
    worst, name = 0.0, ""
    for k in keys:
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        if g > worst or not name:
            worst, name = g, k
    return worst, name
