"""The one generator of training batches, driven by a traffic file.

A traffic file (``bench/traffic/<mix>.json``) fixes the batch in
sequences and positions and the law of the token ids; this module draws
batch ``i`` of a run from ``(seed, i)`` alone, on the host, as numpy:

- ``"law": "zipf"``: token ranks k = 1..V with probability proportional
  to 1 / k^exponent (1.0: the usual fit to natural-language token
  frequencies), mapped to ids through a permutation of the vocabulary
  drawn from the seed, so the frequent ids differ from run to run while
  every run does the same amount of work;
- ``"labels": "next_token"``: each row is S + 1 draws, the tokens its first
  S and the labels its last S.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class Batches:
    """Batch ``i`` of a run: ``{"tokens", "labels"}``, (B, S) int64."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        law = traffic["tokens"]
        if law["law"] != "zipf" or traffic.get("labels", "next_token") != "next_token":
            raise ValueError(f"unknown token law {law!r}")
        self.B, self.S = int(traffic["batch"]), int(traffic["seq_len"])
        self.seed = int(seed) % (1 << 64)
        w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** float(law["exponent"])
        self.cdf = np.cumsum(w) / w.sum()
        self.ids = np.random.default_rng([self.seed, 0x70C5]).permutation(vocab)

    def __call__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, 1, int(i)])
        ranks = np.searchsorted(self.cdf, rng.random((self.B, self.S + 1)), side="right")
        seq = self.ids[np.minimum(ranks, len(self.ids) - 1)]
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
