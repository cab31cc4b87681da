"""The one generator of traffic: a traffic file's parameters in, requests
or training batches out, all from the seed.

Lengths are drawn as quantiles, not at random, and in rounds: the k-th
requests of the ``clients`` clients take the distribution's ``clients``
quantiles at (i + 1/2) / clients, clipped to the file's bounds, shuffled
among the clients in each round (prompt and output lengths each on their
own) by a generator that is the same for every seed. The seed draws the
token ids and which client takes which of those sequences of lengths.
So every seed asks for the same sizes round by round; which of them a
window completes still moves a little with the seed, since requests that
finish in one tick are admitted again in slot order.

Distributions (``dist``): ``lognormal`` (``median``, ``sigma``),
``loguniform`` and ``uniform`` (between ``min`` and ``max``); every one
clipped to [``min``, ``max``] and rounded to whole tokens.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """The n lengths of ``spec`` at quantiles (i + 1/2) / n, ascending."""
    lo, hi = spec["min"], spec["max"]
    qs = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(q) for q in qs])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    elif dist == "loguniform":
        x = np.exp(math.log(lo) + qs * (math.log(hi) - math.log(lo)))
    elif dist == "uniform":
        x = lo + qs * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


# the order of the lengths within each round, the same for every seed
SCHEDULE_SEED = 0x5C4ED


def serve_requests(traffic: dict, vocab: int, seed: int) -> list[list]:
    """Each client's requests in order, [(prompt int32 array, output
    tokens)], ``requests_per_client`` of them: round k gives the clients
    the ``clients`` quantile lengths of both mixes, each shuffled by the
    fixed schedule; the seed assigns the clients their sequences and draws
    uniform token ids."""
    clients, per = traffic["clients"], traffic["requests_per_client"]
    sched = np.random.default_rng(SCHEDULE_SEED)
    p_q = quantile_lengths(traffic["prompt"], clients)
    o_q = quantile_lengths(traffic["output"], clients)
    prompts = np.stack([sched.permutation(p_q) for _ in range(per)], axis=1)
    outputs = np.stack([sched.permutation(o_q) for _ in range(per)], axis=1)
    rng = np.random.default_rng([int(seed), 0x7EA])
    order = rng.permutation(clients)
    prompts, outputs = prompts[order], outputs[order]
    ids = rng.integers(0, vocab, size=int(prompts.sum()), dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(prompts.ravel())])
    return [[(ids[starts[c * per + k]:starts[c * per + k + 1]],
              int(outputs[c, k])) for k in range(per)]
            for c in range(clients)]


def train_tokens(traffic: dict, vocab: int, seed: int, device):
    """(batches, batch, seq_len + 1) uniform token ids on ``device``, drawn
    there in one call from the seed: every row differs."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 2_654_435_761 + 97) % (1 << 63))
    shape = (traffic["batches"], traffic["batch"], traffic["seq_len"] + 1)
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int64)
