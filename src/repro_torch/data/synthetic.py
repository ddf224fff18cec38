"""Seeded synthetic datasets, vertically partitioned across two parties.

``repro/data/synthetic.py`` (the tabular streams and the LLM token
streams), copied so that the port imports nothing of the JAX package: it
is numpy, so one seed gives the identical stream on both sides.

The real Criteo / Avazu / D3 datasets are not available offline; we keep the
*field layout* of the paper's Table 1 (26/13, 14/8, 25/18 categorical fields
for parties A/B) and plant a random teacher model so that the learning
problem has signal — convergence-curve comparisons between protocols remain
meaningful because all protocols see the identical stream.

Alignment (paper §2.1): instances are generated pre-aligned (PSI is assumed
done, as in the paper) and both parties sample mini-batches with the same
seed, so batch ``i`` is the same instance rows at both parties.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class TabularSpec:
    name: str
    fields_a: int
    fields_b: int
    vocab: int = 1024          # per-field hash vocabulary
    n_train: int = 16384
    n_test: int = 4096
    label_noise: float = 0.05  # teacher flip probability


CRITEO = TabularSpec("criteo", fields_a=26, fields_b=13)
AVAZU = TabularSpec("avazu", fields_a=14, fields_b=8)
D3 = TabularSpec("d3", fields_a=25, fields_b=18)
TABULAR_SPECS = {s.name: s for s in (CRITEO, AVAZU, D3)}


def make_tabular(spec: TabularSpec, seed: int = 0
                 ) -> Dict[str, Dict[str, np.ndarray]]:
    """-> {"train": {x_a (N,Fa) i32, x_b (N,Fb) i32, y (N,) f32}, "test": ...}.

    Labels come from a planted teacher: per-(field, value) random effects,
    y = Bernoulli(sigmoid(sum of effects / sqrt(F))) with a small flip rate.
    """
    rng = np.random.default_rng(seed)
    F = spec.fields_a + spec.fields_b
    teacher = rng.normal(0.0, 1.0, size=(F, spec.vocab)).astype(np.float32)

    def gen(n: int):
        x = rng.integers(0, spec.vocab, size=(n, F), dtype=np.int32)
        logit = teacher[np.arange(F)[None, :], x].sum(axis=1) / np.sqrt(F)
        p = 1.0 / (1.0 + np.exp(-2.0 * logit))
        y = (rng.random(n) < p).astype(np.float32)
        flip = rng.random(n) < spec.label_noise
        y = np.where(flip, 1.0 - y, y)
        return {"x_a": x[:, :spec.fields_a],
                "x_b": x[:, spec.fields_a:],
                "y": y.astype(np.float32)}

    return {"train": gen(spec.n_train), "test": gen(spec.n_test)}


def aligned_batches(data: Dict[str, np.ndarray], batch_size: int,
                    seed: int = 0, drop_last: bool = True
                    ) -> Iterator[Tuple[int, Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]]:
    """Yield (batch_idx, batch_a, batch_b) forever, reshuffling per epoch.

    Both parties use the same seed -> identical permutations (paper §2.1).
    The whole-dataset shuffle also randomizes the order of instances inside
    the workset window (paper §3.2 last paragraph).
    """
    n = data["y"].shape[0]
    rng = np.random.default_rng(seed)
    idx = 0
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            rows = perm[s:s + batch_size]
            yield (idx,
                   {"x_a": data["x_a"][rows]},
                   {"x_b": data["x_b"][rows], "y": data["y"][rows]})
            idx += 1


# --------------------------------------------------------------------------
# Token streams for the LLM-backbone VFL runs
# --------------------------------------------------------------------------
def make_token_stream(n: int, seq_len: int, vocab: int, aux_vocab: int,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Aligned (tokens, tokens_a, labels) with a planted bigram structure so
    loss decreases under training."""
    rng = np.random.default_rng(seed)
    # Markov-ish stream: next token correlated with current
    trans = rng.integers(0, vocab, size=(vocab,), dtype=np.int32)
    toks = np.empty((n, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=(n,))
    for t in range(seq_len):
        follow = rng.random((n,)) < 0.7
        toks[:, t + 1] = np.where(follow, trans[toks[:, t]],
                                  rng.integers(0, vocab, size=(n,)))
    tokens = toks[:, :-1]
    labels = toks[:, 1:]
    tokens_a = ((tokens.astype(np.int64) * 2654435761) % aux_vocab
                ).astype(np.int32)
    return {"tokens": tokens, "tokens_a": tokens_a, "labels": labels}


def token_batches(data: Dict[str, np.ndarray], batch_size: int,
                  seed: int = 0):
    """Yield (batch_idx, batch_a, batch_b) forever, reshuffling per epoch;
    both parties see the same rows (the aligned stream)."""
    n = data["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    idx = 0
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            rows = perm[s:s + batch_size]
            yield (idx,
                   {"tokens_a": data["tokens_a"][rows]},
                   {"tokens": data["tokens"][rows],
                    "labels": data["labels"][rows]})
            idx += 1
