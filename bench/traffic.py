"""The one traffic generator: token batches of a CELU training cell, made
from a traffic file's parameters and the seed, on the device.

A traffic file (``bench/traffic/<name>.json``) gives the batch ``B``, the
sequence length ``S`` and the stream's shape: a planted bigram chain
(each next token follows a random transition table with probability
``follow_prob``, else is drawn uniformly; the program's own synthetic
stream, ``data/synthetic.py``), next-token labels, and Party A's aligned
token stream (each token hashed into the auxiliary vocabulary).  A run
draws ``n_batches`` distinct batches once, in set-up, and round ``i``
takes batch ``i mod n_batches``: every seed gets the same sizes, and only
the token ids differ.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

HASH_MUL = 2654435761


def make_batches(traffic: dict, vocab: int, aux_vocab: int, seed: int,
                 device) -> List[Tuple[dict, dict]]:
    """-> [(batch_a, batch_b)] * n_batches: batch_a {"tokens_a"}, batch_b
    {"tokens", "labels"}, (B, S) int64 on ``device``."""
    B, S, n = traffic["batch"], traffic["seq_len"], traffic["n_batches"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 64))
    rows = n * B
    trans = torch.randint(0, vocab, (vocab,), generator=gen, device=device)
    follow = torch.rand((rows, S), generator=gen, device=device) \
        < traffic["follow_prob"]
    fresh = torch.randint(0, vocab, (rows, S + 1), generator=gen,
                          device=device)
    toks = torch.empty((rows, S + 1), dtype=torch.int64, device=device)
    toks[:, 0] = fresh[:, 0]
    for t in range(S):
        toks[:, t + 1] = torch.where(follow[:, t], trans[toks[:, t]],
                                     fresh[:, t + 1])
    tokens, labels = toks[:, :-1], toks[:, 1:]
    tokens_a = (tokens * HASH_MUL) % aux_vocab
    out = []
    for i in range(n):
        sl = slice(i * B, (i + 1) * B)
        out.append(({"tokens_a": tokens_a[sl].contiguous()},
                    {"tokens": tokens[sl].contiguous(),
                     "labels": labels[sl].contiguous()}))
    return out


def batch(batches: List[Tuple[dict, dict]], i: int
          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    return batches[i % len(batches)]
