"""Token data pipeline: deterministic, seekable, host-sharded (counterpart
of ``repro.data.tokens``).

The source is the reference's deterministic Markov-chain stream, drawn with
the same numpy generators, so both packages see the same rows for the same
seed and step: each row ``base + r`` of a step is its own
``default_rng(seed)`` draw, ``base = step * batch + host_index *
local_batch``. The loader is seekable by step (the trainer seeks after a
restore), materializes only its host's rows, and produces the next-token
labels itself. Batches are torch tensors on the loader's device (the card
unless the caller passes ``device="cpu"``), laid out by ``sharding`` (a
:class:`~repro_torch.distributed.sharding.NamedSharding`) when one is given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding as shd


class SyntheticLM:
    """Deterministic structured token stream: a random Markov chain."""

    def __init__(self, vocab_size: int, seed: int = 0, order_states: int = 64):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.n_states = order_states
        # sparse-ish transition: each state strongly prefers a few tokens
        probs = rng.dirichlet(np.full(min(vocab_size, 32), 0.3),
                              size=order_states)
        toks = rng.integers(0, vocab_size,
                            size=(order_states, probs.shape[1]))
        self.state_tokens = toks
        self.state_probs = probs / probs.sum(-1, keepdims=True)
        self.state_next = rng.integers(0, order_states,
                                       size=(order_states, probs.shape[1]))

    def sequence(self, seq_len: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        s = int(rng.integers(self.n_states))
        out = np.empty(seq_len + 1, np.int32)
        for i in range(seq_len + 1):
            j = rng.choice(self.state_probs.shape[1], p=self.state_probs[s])
            out[i] = self.state_tokens[s, j]
            s = self.state_next[s, j]
        return out


class TokenLoader:
    """Seekable batch loader with host-sharded materialization: batches
    {"tokens", "labels"} of (batch / host_count, seq_len) int32 tensors on
    ``device``."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 sharding=None, device="cuda"):
        assert batch % host_count == 0
        self.src = SyntheticLM(vocab_size, seed)
        self.batch = batch
        self.local_batch = batch // host_count
        self.seq_len = seq_len
        self.host_index = host_index
        self.host_count = host_count
        self.sharding = sharding
        self.device = resolve_device(device)
        self._step = 0

    def seek(self, step: int) -> None:
        self._step = step

    def next_batch(self) -> dict:
        rows = []
        base = self._step * self.batch + self.host_index * self.local_batch
        for r in range(self.local_batch):
            rows.append(self.src.sequence(self.seq_len, seed=base + r))
        self._step += 1
        arr = torch.from_numpy(np.stack(rows))
        out = {"tokens": arr[:, :-1].contiguous().to(self.device),
               "labels": arr[:, 1:].contiguous().to(self.device)}
        if self.sharding is not None:
            out = {k: shd.lay_out(t, self.sharding) for k, t in out.items()}
        return out
