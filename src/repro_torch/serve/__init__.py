"""Split-model serving (port of ``repro.serve``): the continuous-batching
engine with per-request decode state over the party boundary
(``engine.ServeEngine``), the workset ring as the cross-party decode
activation cache, the compressed uplink with exact per-request byte
accounting, and the open-loop synthetic load generator (``loadgen``).
"""
from .engine import (Completion, Request, ServeConfig, ServeEngine,
                     make_naive_fns, naive_generate)
from .loadgen import LoadSpec, synth_requests

__all__ = ["Completion", "Request", "ServeConfig", "ServeEngine",
           "make_naive_fns", "naive_generate", "LoadSpec",
           "synth_requests"]
