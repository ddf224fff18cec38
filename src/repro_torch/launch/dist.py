"""Start a world of ranks on one machine and collect their results.

The port's counterpart of the reference's forced host device count
(``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in a fresh
process): :func:`run_ranks` spawns ``world_size`` processes
(``torch.multiprocessing``), joins them in one process group through a
``file://`` store under a temporary directory (no TCP port to clash with
another world on the machine), runs ``fn(rank, world_size, *args)`` in
each and returns each rank's result, in rank order.

The backend is the caller's: ``"gloo"`` for ranks on the CPU, or for
ranks that share one card and stage their tensors through the host
(``engine.PodTransport(staged=True)``); ``"nccl"`` for ranks on cards of
their own.  Nothing falls back from one to the other.

A rank never builds the CUDA kernels: the caller builds them first
(``kernels._cuda.build()``), and a rank that finds no library raises.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               store: str, out_dir: str, timeout_s: float, args) -> None:
    from ..kernels import _cuda
    _cuda.BUILD = False
    torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    dist.init_process_group(
        backend, init_method=store, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *, backend: str, args=(),
              timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    of one ``backend`` process group -> their results (CPU objects that
    ``torch.save`` takes), in rank order.  ``fn`` must be importable by
    name (a module-level function).  A rank that raises stops the world
    and the error is raised here; ``timeout_s`` bounds each collective."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, args=(fn, world_size, backend, store, tmp,
                                   timeout_s, tuple(args)),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
