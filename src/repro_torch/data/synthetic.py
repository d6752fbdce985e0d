"""Deterministic synthetic LM data: a zipf-unigram + bigram-chain mixture
(port of ``repro/data/synthetic.py``, numpy only).

The reference builds the dense V x V transition table and its cumulative
sums in float64 up front: 2 * 8 * V^2 bytes, 40 GB at olmo-1b's vocabulary
of 50304 and 69 GB at rwkv6-7b's 65536.  Here a token's row is computed
when a draw first needs it, with the reference's arithmetic, and kept in
a bounded cache:

* the bigram logits of rows [s, s + ROW_BLOCK) come from one
  ``u[s:s+ROW_BLOCK] @ v`` product.  A float64 product of one row takes
  another BLAS path than the dense table's and differs from it in the
  last bits (every row, at vocab 512 and 4096); a block of ROW_BLOCK
  rows, aligned so that every block has that many, gives each row the
  dense product's bits;
* then, per row, ``* 2 + log(base)``, the max, exp, normalisation and
  cumsum, each of which gives a row the bits it has in the table.

A draw is the first index whose cumulative probability exceeds the
uniform (``searchsorted``), which is the reference's ``(u < row).argmax``
without its (B, V) comparison, and is 0 where no index does, as
``argmax`` of an all-False row is.  So batches are bitwise the
reference's.
"""
from __future__ import annotations

import collections
import threading

import numpy as np

__all__ = ["SyntheticLM"]

ROW_BLOCK = 8                     # rows of one bigram-logit product
CACHE_BYTES = 1 << 30             # bound of the cumulative-row cache


class SyntheticLM:
    def __init__(self, vocab: int, seed: int = 0, bigram_rank: int = 8,
                 zipf_a: float = 1.2):
        if vocab < ROW_BLOCK:
            raise ValueError(f"vocab {vocab} < ROW_BLOCK {ROW_BLOCK}")
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # low-rank bigram logits -> deterministic transition structure
        self.u = rng.normal(0, 1.0, (vocab, bigram_rank))
        self.v = rng.normal(0, 1.0, (bigram_rank, vocab))
        base = 1.0 / np.arange(1, vocab + 1) ** zipf_a
        self.log_base = np.log(base)
        self.max_rows = max(1, CACHE_BYTES // (8 * vocab))
        self._cum: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = self.misses = 0

    def trans_row(self, token: int) -> np.ndarray:
        """The float64 transition row of ``token``."""
        start = min(token - token % ROW_BLOCK, self.vocab - ROW_BLOCK)
        dots = (self.u[start:start + ROW_BLOCK] @ self.v)[token - start]
        logits = dots * 2.0 + self.log_base
        e = np.exp(logits - logits.max())
        return e / e.sum()

    def cum_row(self, token: int) -> np.ndarray:
        """The cumulative transition row of ``token`` (cached)."""
        with self._lock:
            row = self._cum.get(token)
            if row is not None:
                self._cum.move_to_end(token)
                self.hits += 1
                return row
            self.misses += 1
        row = np.cumsum(self.trans_row(token))
        with self._lock:
            self._cum[token] = row
            while len(self._cum) > self.max_rows:
                self._cum.popitem(last=False)
        return row

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def sample(self, batch: int, seq: int, *, step: int, host: int = 0,
               n_hosts: int = 1) -> np.ndarray:
        """Deterministic (step, host)-keyed batch of token ids (B, S+1)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([step, host, n_hosts, 0xD5C1]))
        out = np.empty((batch, seq + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            for b in range(batch):
                row = self.cum_row(int(out[b, t]))
                j = int(np.searchsorted(row, u[b, t], side="right"))
                out[b, t + 1] = j if j < self.vocab else 0
        return out

    def batch(self, batch: int, seq: int, *, step: int, host: int = 0,
              n_hosts: int = 1) -> dict:
        toks = self.sample(batch, seq, step=step, host=host, n_hosts=n_hosts)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def unigram_entropy(self) -> float:
        """Entropy of the mean transition row, the reference's
        ``trans.mean(0)`` summed block by block in row order."""
        total = np.zeros(self.vocab)
        for token in range(self.vocab):
            total += self.trans_row(token)
        p = total / self.vocab
        return float(-(p * np.log(p + 1e-12)).sum())
