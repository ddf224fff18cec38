"""Open-loop synthetic load generator for the serving engine (a copy of
``repro/serve/loadgen.py``: numpy, so one seed gives the reference's
traffic).

Open loop means arrivals are INDEPENDENT of service: requests land on a
seeded Poisson clock (exponential inter-arrivals at ``rate`` req/s)
whether or not the engine keeps up, so queueing delay shows up in the
latency percentiles instead of being hidden by back-pressure — the
standard methodology for serving benchmarks.  Prompts are uniform token
ids at exactly ``prompt_len`` (one compiled admit for every request);
generation lengths draw uniformly from [1, max_new_tokens] so the lane
array actually churns (admit/evict mid-flight), which is the behavior
the continuous-batching claim is about.

Everything derives from ``seed`` — a load is a pure function of its
spec, so benchmark runs and tests replay identical traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..configs.base import ArchConfig
from .engine import Request


@dataclass(frozen=True)
class LoadSpec:
    """Synthetic open-loop load: ``n_requests`` arrivals at ``rate``
    req/s (virtual seconds), prompts of ``prompt_len`` tokens, per-request
    generation length uniform in [``min_new_tokens``, ``max_new_tokens``].
    ``rate <= 0`` drops all arrivals to t=0 (a closed burst — the
    throughput-measurement mode)."""
    n_requests: int = 32
    rate: float = 50.0
    prompt_len: int = 16
    max_new_tokens: int = 16
    min_new_tokens: int = 1
    seed: int = 0


def synth_requests(spec: LoadSpec, cfg: ArchConfig) -> List[Request]:
    """-> the seeded request list (sorted by arrival, req_id = arrival
    order)."""
    if spec.min_new_tokens < 1 or spec.max_new_tokens < spec.min_new_tokens:
        raise ValueError("need 1 <= min_new_tokens <= max_new_tokens")
    rng = np.random.default_rng(spec.seed)
    if spec.rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / spec.rate,
                                             spec.n_requests))
    else:
        arrivals = np.zeros(spec.n_requests)
    prompts = rng.integers(0, cfg.vocab_size,
                           (spec.n_requests, spec.prompt_len), dtype=np.int32)
    prompts_a = rng.integers(0, cfg.aux_vocab_size,
                             (spec.n_requests, spec.prompt_len),
                             dtype=np.int32)
    gen = rng.integers(spec.min_new_tokens, spec.max_new_tokens + 1,
                       spec.n_requests)
    return [Request(req_id=i, prompt=prompts[i], prompt_a=prompts_a[i],
                    max_new_tokens=int(gen[i]), arrival=float(arrivals[i]))
            for i in range(spec.n_requests)]
