"""The round's injected randomness: uniform sources and keys.

The reference draws every stochastic-rounding uniform from a fixed
``jax.random`` chain:

  * the wire: ``split(fold_in(PRNGKey(17), comm_rounds), 2K)[j]`` for
    send ``j`` (2i up, 2i + 1 down for feature party i), then
    ``fold_in(·, 1)`` per encode and ``fold_in(·, i)`` per codec stage;
    the DP noise of a send is ``jax.random.normal`` of the send's key on
    the plain wire and of ``fold_in(·, 2)`` after a lossy codec
    (``core/privacy.py`` turns the uniforms into normals);
  * the workset inserts: ``fold_in(fold_in(PRNGKey(0xCE1), comm_rounds),
    party)`` (feature parties 0..K-1, Party B K), then
    ``fold_in(·, leaf_index)`` over the entry's leaves in JAX's flattening
    order (dict keys sorted); an insert given no key (the serving
    engine's) derives it from the table clock, ``fold_in(PRNGKey(0xCE1),
    time)``, then folds the leaf index;
  * the serving engine: ``fold_in(PRNGKey(seed), n)`` for the engine's
    n-th admit or decode step (the prefill uplink; ``fold_in(·, 1)`` for
    the downlink), and ``split(·, C)[lane]`` of it for each lane's decode
    uplink;
  * the uniform workset draws: ``fold_in(fold_in(fold_in(PRNGKey(29),
    comm_rounds), j), party)`` for local step ``j`` of a scan (feature
    parties 0..K-1, Party B K); a scan charged a per-slot staleness ``s``
    (the pipelined scheduler's dynamic path) starts from
    ``fold_in(PRNGKey(29), s)`` instead;
  * the int8 AdaGrad state's requantisation:
    ``fold_in(fold_in(PRNGKey(0xAD49), t), leaf_index)``, with ``t`` the
    optimizer state's update counter and the leaf index in JAX's
    flattening order of the party's parameters.

PyTorch cannot reproduce those bits, so the port takes the uniforms from a
*uniform source*: a callable ``source(tag, shape)`` that returns a
``shape`` float32 tensor in [0, 1) on the round's device.  The tag names
the draw in the reference's terms — ``("wire", round, 2K, j, *folds)``,
``("insert", round, party, *folds)`` (``("insert", time, *folds)`` from
the clock), ``("draw", round, j, party)`` (``("draw_s", s, round, j,
party)`` on the dynamic path), ``("optim", t, *folds)``, ``("seed",
seed, n, *folds)`` or
``("lanes", seed, n, C, *folds)`` — so a parity test can hand in a source
that computes the reference's uniforms from it.  A ``"lanes"`` draw is
one batched draw for all C lanes: its shape leads with C, and row c is
the draw of ``split(fold_in(PRNGKey(seed), n), C)[c]`` folded by
``folds``.  The default source ignores the tag and draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch


class GeneratorUniforms:
    """The default source: a ``torch.Generator`` seeded from ``seed``.

    Draws happen on ``draw_device`` (default: ``device``) and land on
    ``device``; drawing on the CPU for a CUDA round gives the card the
    uniforms a CPU run with the same seed sees."""

    def __init__(self, seed: int, device, draw_device=None):
        self.device = torch.device(device)
        self.draw_device = self.device if draw_device is None \
            else torch.device(draw_device)
        self.gen = torch.Generator(device=self.draw_device)
        self.gen.manual_seed(int(seed))

    def __call__(self, tag: Tuple, shape) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.gen,
                       dtype=torch.float32, device=self.draw_device)
        return u.to(self.device)


class UniformKey(NamedTuple):
    """A position in the reference's key chain: the counterpart of a
    ``jax.random`` key that a codec folds and draws from."""
    source: Callable
    tag: Tuple

    def fold(self, i: int) -> "UniformKey":
        return UniformKey(self.source, self.tag + (int(i),))

    def uniform(self, shape) -> torch.Tensor:
        return self.source(self.tag, tuple(int(s) for s in shape))


def wire_key(source, round_: int, n_sends: int, send: int) -> UniformKey:
    """Key of wire send ``send`` of the ``n_sends`` (= 2K) of a round."""
    return UniformKey(source, ("wire", round_, n_sends, send))


def insert_key(source, round_: int, party: int) -> UniformKey:
    """Key of ``party``'s workset insert in a round (Party B is K)."""
    return UniformKey(source, ("insert", round_, party))


def draw_key(source, round_: int, step: int, party: int,
             staleness=None) -> UniformKey:
    """Key of ``party``'s uniform workset draw at local step ``step`` of
    the scan at ``round_`` (Party B is K).  ``staleness`` is the per-slot
    staleness of a scan on the pipelined scheduler's dynamic path (host
    int), None on the static path: the two chains differ."""
    if staleness is None:
        return UniformKey(source, ("draw", round_, step, party))
    return UniformKey(source, ("draw_s", int(staleness), round_, step,
                               party))


def optim_key(source, t: int) -> UniformKey:
    """Key of update ``t`` of an int8 AdaGrad state; fold in the leaf
    index.  Party A's and Party B's states share the chain."""
    return UniformKey(source, ("optim", t))


def clock_key(source, time: int) -> UniformKey:
    """Key of a workset insert that was given none: the table clock's,
    ``fold_in(PRNGKey(0xCE1), time)``; fold in the leaf index."""
    return UniformKey(source, ("insert", time))


def seed_key(source, seed: int, n: int) -> UniformKey:
    """``fold_in(PRNGKey(seed), n)``: the serving engine's n-th key."""
    return UniformKey(source, ("seed", seed, n))


def lanes_key(source, seed: int, n: int, lanes: int) -> UniformKey:
    """All of ``split(fold_in(PRNGKey(seed), n), lanes)`` at once: a draw
    of shape (lanes, *shape) whose row c is lane c's."""
    return UniformKey(source, ("lanes", seed, n, lanes))
