"""Continuous-batching split-model serving over the party boundary.

Port of ``repro/serve/engine.py``.  The decode loop is the paper's
exchange pattern, one token at a time: Party A's tower produces the cut
activation ``z`` for the new position, ``z`` crosses the WAN (the serving
uplink), Party B fuses it and emits the next token (the downlink).

  * **Continuous batching.**  A fixed-capacity lane array: every lane
    holds one in-flight request's decode state (KV caches, position,
    last token, tokens remaining); requests admit into free lanes and
    leave as they finish.  The reference ``vmap``s a one-row decode over
    the lanes; here the lanes are the batch dimension, each with its own
    position, so each lane writes its own KV ring slot ``pos % cap`` and
    keeps its own ``slot_pos`` row.  Lane state lives on the device and
    is written with index writes; positions are never read back.
  * **Cross-party decode activation cache.**  The per-step ``z`` rows land
    in a :mod:`repro_torch.core.workset` ring (the lane is the ring's
    batch dim), stored through the training codecs (fp32 / bf16 / int8 /
    int4) and read back through K6 (int8) or K11 (int4): Party B fuses
    the cached activation, so with ``refresh_every > 1`` stale ring rows
    stand in for wire exchanges as the paper's cached local updates do.
  * **Compressed serving wire.**  Each lane's uplink ``z`` row is encoded
    on its own (int8 stochastic rounding by default, K3), so per-request
    byte accounting is exact: ``wire_bytes((d,))`` per decode token,
    ``wire_bytes((S, d))`` per prefill.  The downlink is one token id
    (4 bytes), identity by contract.

The engine serves the dense family, whose split is token-aligned
(``fusion="add"``).  The other families, among them the cross-attention
ones (vlm / audio) that exchange their memory once at prefill, come with
slice 7c of the port (ROADMAP.md).

Randomness: the rounding uniforms come from a uniform source
(``core/uniforms.py``) under tags naming the reference's chain, the
engine's n-th admit or step keyed by ``fold_in(PRNGKey(seed), n)`` and
each lane's uplink by ``split(·, C)[lane]`` of it; the ring inserts
derive their key from the ring's clock.  Admissions are FIFO into the
lowest free lane, so two runs over the same requests give identical
tokens and ledgers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, CELUConfig
from ..core import workset as WS
from ..core.compression import StochasticQuantCodec
from ..core.engine import make_transport
from ..core.uniforms import (GeneratorUniforms, clock_key, lanes_key,
                             seed_key)
from ..kernels import ops as kops
from ..models import vfl
from ..models.backbone import tree_map
from ..models.initializers import PARAM_DTYPE


# --------------------------------------------------------------------------
# Config / request / completion records
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs.  ``compression`` is the UPLINK codec spec (the
    downlink token id always rides the identity codec); ``cache_dtype``
    picks the decode activation ring's at-rest storage; ``refresh_every``
    R sends ``z`` up every R-th decode step and serves Party B from the
    stale ring row in between."""
    capacity: int = 8              # concurrent decode lanes
    prompt_len: int = 16           # fixed prompt length
    max_new_tokens: int = 16       # per-request ceiling (sizes KV rings)
    compression: str = "int8"      # uplink codec spec; "" = fp32 wire
    cache_dtype: str = "int8"      # activation ring storage codec
    ring_slots: int = 4            # W slots in the activation ring
    refresh_every: int = 1         # uplink cadence (1 = every step)
    seed: int = 0


@dataclass(frozen=True)
class Request:
    """One serving request: ``prompt`` / ``prompt_a`` are exactly
    ``ServeConfig.prompt_len`` tokens; ``arrival`` is the open-loop
    virtual arrival time in seconds."""
    req_id: int
    prompt: np.ndarray
    prompt_a: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0


@dataclass
class Completion:
    """Per-request ledger: generated tokens, exact wire bytes, and the
    virtual-clock timeline (arrival -> admit -> per-token -> done)."""
    req_id: int
    tokens: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    wire_up_bytes: int = 0
    wire_down_bytes: int = 0
    arrival: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0
    token_times: List[float] = field(default_factory=list)


# --------------------------------------------------------------------------
# Step functions
# --------------------------------------------------------------------------
def _ring_read(buf, width: int):
    """Slot gather + decode of the activation ring's ``z`` store -> (C, d)
    fp32 rows.  The quantised stores go through K6 / K11 (no
    full-precision ring copy is made)."""
    def read(slot):
        if isinstance(buf, WS.Quant4Leaf):
            return kops.fused_gather_dequant_q4(slot, buf.q, buf.scale,
                                                width)
        if isinstance(buf, WS.QuantLeaf):
            return kops.fused_gather_dequant_q8(slot, buf.q, buf.scale)
        idx = slot.reshape(1).long()
        if isinstance(buf, WS.CastLeaf):
            return buf.v.index_select(0, idx)[0].float()
        return buf.index_select(0, idx)[0]
    return read


def _send_rows(tp, key, rows, direction: str):
    """Each row of ``rows`` (C, n) through ``direction`` of the wire on its
    own, as the reference's per-lane sends do; ``key`` is a
    ``lanes_key``."""
    codec = getattr(tp, "codecs", {}).get(direction)
    if codec is None or getattr(codec, "exact", False):
        return tp.send(key, rows, None, direction)[0]
    y = codec.roundtrip_rows(key.fold(1), tp._wire_cast(rows))
    return y.to(rows.dtype)


def _check_wire(tp) -> None:
    """The engine sends lane rows in one batch: it takes the plain wire,
    the identity codec or a stochastic-rounding quantiser uplink, and an
    exact downlink."""
    codecs = getattr(tp, "codecs", None)
    if codecs is None:
        return
    up, down = codecs["up"], codecs["down"]
    if not (getattr(up, "exact", False)
            or isinstance(up, StochasticQuantCodec)):
        raise NotImplementedError(
            f"serving uplink codec {type(up).__name__}: the port's engine "
            f"sends lane rows through the identity, int8 or int4 codec")
    if not getattr(down, "exact", False):
        raise ValueError("the serving downlink carries token ids: it "
                         "rides the identity codec")


def _put_lane(full, one, lane: int):
    """Write a one-row stage-stacked cache leaf (L, 1, ...) into lane
    ``lane`` of the engine's (L, C, ...) leaf, in place."""
    full[:, lane].copy_(one[:, 0])


def make_admit_fn(cfg: ArchConfig, scfg: ServeConfig, tp):
    """-> ``admit(params, state, lane, tokens, tokens_a, n_new, key)``:
    one-row prefill of both parties (the prompt's ``z`` crosses the
    uplink once), the first greedy token down, then the request's decode
    state written into lane ``lane`` (a host int) in place.  ``key`` is
    the admit's ``seed_key``.  -> (state, first token (0-d int32))."""
    total_len = scfg.prompt_len + scfg.max_new_tokens

    def admit(params, state, lane, tokens, tokens_a, n_new, key):
        batch = {"tokens": tokens, "tokens_a": tokens_a}
        z, cache_a = vfl.prefill_a(params["a"], cfg, batch, total_len)
        y, _ = tp.send(key, z[0], None, "up")           # (S, d) crossing
        logits, cache_b = vfl.prefill_b(params["b"], cfg, y[None], batch,
                                        total_len)
        tok = torch.argmax(logits[0, -1], -1).to(torch.int32)
        down, _ = tp.send(key.fold(1), tok.float()[None], None, "down")
        tok_a = torch.remainder(down[0].to(torch.int32), cfg.aux_vocab_size)

        put = lambda full, one: _put_lane(full, one, lane)  # noqa: E731
        tree_map(put, state["cache_a"], cache_a)
        tree_map(put, state["cache_b"], cache_b)
        _ring_clear_lane(state["ws"], lane)
        state["active"][lane] = n_new > 1
        state["pos"][lane] = scfg.prompt_len
        state["token"][lane] = tok
        state["token_a"][lane] = tok_a
        state["remaining"][lane] = n_new - 1
        return state, tok

    return admit


def make_step_fn(cfg: ArchConfig, scfg: ServeConfig, tp, exchange: bool):
    """-> ``step(params, state, n, clock, source)``: one decode token for
    every lane.  ``exchange=True``: each lane's fresh ``z`` row crosses
    the uplink and is inserted into the activation ring;
    ``exchange=False``: Party A still advances its KV cache, but nothing
    crosses and Party B is served from the newest cached ring row.  ``n``
    is the step's key counter, ``clock`` the ring's insert count (host
    ints), ``source`` the uniform source.

    -> (state, tokens (C,), produced (C,) bool): ``produced`` flags the
    lanes whose token this step is real (active at entry)."""
    C = scfg.capacity
    d = cfg.d_model

    def step(params, state, n, clock, source):
        produced = state["active"]
        pos = state["pos"]
        z, _ = vfl.decode_step_a(params["a"], cfg, state["cache_a"],
                                 state["token_a"][:, None], pos)
        ws = state["ws"]
        if exchange:
            key = lanes_key(source, scfg.seed, n, C)
            y_rows = _send_rows(tp, key, z[:, 0], "up")
            WS.workset_insert(ws, {"z": y_rows}, batch_idx=clock,
                              key=clock_key(source, clock))
        slot = torch.remainder(ws["time"] - 1, scfg.ring_slots)
        z_used = _ring_read(ws["buf"]["z"], d)(slot)     # (C, d) fp32
        # the ring decodes to fp32; the model computes in PARAM_DTYPE
        # (bf16 -> fp32 -> bf16 is lossless, so the fp32 ring is exact)
        logits, _ = vfl.decode_step_b(
            params["b"], cfg, state["cache_b"], state["token"][:, None],
            z_used[:, None].to(PARAM_DTYPE), pos)
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)
        down = _send_rows(tp, None, tok.float()[:, None], "down")
        tok_a = torch.remainder(down[:, 0].to(torch.int32),
                                cfg.aux_vocab_size)

        remaining = state["remaining"] - produced.to(torch.int32)
        state["active"] = produced & (remaining > 0)
        state["pos"] = pos + 1
        state["token"], state["token_a"] = tok, tok_a
        state["remaining"] = remaining
        return state, tok, produced

    return step


def _ring_clear_lane(ws: Dict[str, Any], lane: int):
    """Zero lane ``lane``'s column across every ring slot, in place (scales
    -> 0 so quantised stores decode to exact zeros): a freshly admitted
    request must never read the previous occupant's cached activations."""
    buf = ws["buf"]["z"]
    if isinstance(buf, WS.Quant4Leaf):
        buf.q[:, lane] = 0x88
        buf.scale[:, lane] = 0.0
    elif isinstance(buf, WS.QuantLeaf):
        buf.q[:, lane] = 0
        buf.scale[:, lane] = 0.0
    elif isinstance(buf, WS.CastLeaf):
        buf.v[:, lane] = 0
    else:
        buf[:, lane] = 0.0
    return ws


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------
class ServeEngine:
    """Continuous-batching serving engine (see module docstring).

    ``params`` is ``vfl.init_all``'s {"a", "b"} tree, on the device the
    engine runs on; ``transport`` overrides the wire (by default it is
    built from ``scfg.compression`` with an identity downlink);
    ``uniforms`` is the rounding uniforms' source (default: a
    ``torch.Generator`` on the device seeded with ``scfg.seed``)."""

    def __init__(self, params, cfg: ArchConfig, scfg: ServeConfig,
                 transport=None, uniforms=None):
        if scfg.ring_slots < 1 or scfg.refresh_every < 1:
            raise ValueError("ring_slots and refresh_every must be >= 1")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.device = params["b"]["embed"].device
        self.celu = CELUConfig(compression=self._wire_spec())
        self.tp = transport if transport is not None else \
            make_transport(self.celu)
        _check_wire(self.tp)
        self.uniforms = uniforms if uniforms is not None else \
            GeneratorUniforms(scfg.seed, self.device)
        self._admit = make_admit_fn(cfg, scfg, self.tp)
        self._step = {ex: make_step_fn(cfg, scfg, self.tp, ex)
                      for ex in (True, False)}
        self._n = 0           # key counter: one per admit and per step
        self._clock = 0       # ring inserts so far (ws["time"], on host)
        self.state = self._init_state()
        # exact per-message wire bytes (the transport's own accounting)
        S, d = scfg.prompt_len, cfg.d_model
        self.prefill_up_bytes = int(self.tp.uplink_bytes((S, d)))
        self.step_up_bytes = int(self.tp.uplink_bytes((d,)))
        self.token_down_bytes = int(self.tp.downlink_bytes((1,)))
        self.ring_bytes = WS.workset_nbytes(self.state["ws"])

    def _wire_spec(self) -> str:
        spec = self.scfg.compression
        if not spec:
            return ""
        # the downlink carries one token id: identity by contract
        return spec if "/" in spec else f"{spec}/identity"

    def _init_state(self) -> Dict[str, Any]:
        cfg, scfg = self.cfg, self.scfg
        C, dev = scfg.capacity, self.device
        caches = vfl.make_serve_cache(cfg, C,
                                      scfg.prompt_len + scfg.max_new_tokens,
                                      dev)

        def i32():
            return torch.zeros(C, dtype=torch.int32, device=dev)
        return {
            "cache_a": caches["a"],
            "cache_b": {"b": caches["b"], "top": caches["top"]},
            "ws": WS.workset_init(
                scfg.ring_slots,
                {"z": torch.zeros((C, cfg.d_model), dtype=torch.float32,
                                  device=dev)},
                cache_dtype=scfg.cache_dtype),
            "active": torch.zeros(C, dtype=torch.bool, device=dev),
            "pos": i32(), "token": i32(), "token_a": i32(),
            "remaining": i32(),
        }

    def _next_n(self) -> int:
        self._n += 1
        return self._n

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32)).to(
            self.device)[None]

    def warm(self):
        """Run one admit into lane 0 and one step of each kind on a
        scratch copy of the state, with a scratch uniform source: the
        kernels get built and the run that follows is charged none of
        it."""
        S = self.scfg.prompt_len
        scratch = self._init_state()
        src = GeneratorUniforms(self.scfg.seed, self.device)
        zeros = self._tokens(np.zeros(S, np.int32))
        scratch, _ = self._admit(self.params, scratch, 0, zeros, zeros, 2,
                                 seed_key(src, self.scfg.seed, 0))
        for clock, ex in enumerate((True, False)):
            scratch, tok, _ = self._step[ex](self.params, scratch, 0,
                                             clock, src)
        tok.cpu()
        return self

    # ----------------------------------------------------------------
    def run(self, requests: Sequence[Request], clock: Optional[Any] = None
            ) -> Tuple[List[Completion], Dict[str, Any]]:
        """Serve ``requests`` to completion.  Open loop: a request is
        admissible once the virtual clock (wall time actually spent
        stepping, fast-forwarded over idle gaps) passes its ``arrival``.
        Returns (completions sorted by req_id, stats) where stats carries
        the per-decode-step walls and the total virtual duration."""
        timer = time.perf_counter if clock is None else clock
        pending = list(sorted(requests, key=lambda r: (r.arrival,
                                                       r.req_id)))
        lanes: List[Optional[Completion]] = [None] * self.scfg.capacity
        done: List[Completion] = []
        vnow = 0.0
        step_walls: List[float] = []
        phase = 0
        force_exchange = False
        R = self.scfg.refresh_every

        def occupied():
            return [i for i, c in enumerate(lanes) if c is not None]

        while pending or occupied():
            # -- admit FIFO into the lowest free lanes ----------------
            admitted = False
            for lane in range(self.scfg.capacity):
                if lanes[lane] is not None or not pending:
                    continue
                if pending[0].arrival > vnow:
                    break
                req = pending.pop(0)
                t0 = timer()
                self.state, tok = self._admit(
                    self.params, self.state, lane, self._tokens(req.prompt),
                    self._tokens(req.prompt_a), int(req.max_new_tokens),
                    seed_key(self.uniforms, self.scfg.seed, self._next_n()))
                tok = int(tok)
                vnow += timer() - t0
                comp = Completion(req.req_id, arrival=req.arrival,
                                  admitted_at=vnow)
                comp.tokens = np.array([tok], np.int32)
                comp.token_times.append(vnow)
                comp.wire_up_bytes += self.prefill_up_bytes
                comp.wire_down_bytes += self.token_down_bytes
                if req.max_new_tokens <= 1:
                    comp.finished_at = vnow
                    done.append(comp)          # lane freed immediately
                else:
                    lanes[lane] = comp
                admitted = True
            if admitted:
                # a fresh lane's ring column is zeroed: the next step
                # must re-exchange so nobody fuses against zeros
                force_exchange = True

            if not occupied():
                if pending:                    # idle: fast-forward
                    vnow = max(vnow, pending[0].arrival)
                    continue
                break

            # -- one decode step for every lane -----------------------
            exchange = force_exchange or R == 1 or phase % R == 0
            t0 = timer()
            self.state, tok, produced = self._step[exchange](
                self.params, self.state, self._next_n(), self._clock,
                self.uniforms)
            host = torch.stack([tok, produced.to(torch.int32),
                                self.state["remaining"]]).cpu().numpy()
            tok_np, prod_np, rem_np = host
            dt = timer() - t0
            vnow += dt
            step_walls.append(dt)
            phase += 1
            force_exchange = False
            self._clock += int(exchange)

            for lane in occupied():
                if not prod_np[lane]:
                    continue
                comp = lanes[lane]
                comp.tokens = np.append(comp.tokens, tok_np[lane]).astype(
                    np.int32)
                comp.token_times.append(vnow)
                if exchange:
                    comp.wire_up_bytes += self.step_up_bytes
                comp.wire_down_bytes += self.token_down_bytes
                if rem_np[lane] <= 0:          # evict: lane is free
                    comp.finished_at = vnow
                    done.append(comp)
                    lanes[lane] = None

        done.sort(key=lambda c: c.req_id)
        stats = {
            "virtual_duration_s": vnow,
            "decode_steps": len(step_walls),
            "step_walls": step_walls,
            "n_requests": len(done),
            "total_tokens": int(sum(len(c.tokens) for c in done)),
            "wire_up_bytes": int(sum(c.wire_up_bytes for c in done)),
            "wire_down_bytes": int(sum(c.wire_down_bytes for c in done)),
        }
        return done, stats


# --------------------------------------------------------------------------
# Sequential per-request baseline / oracle
# --------------------------------------------------------------------------
def make_naive_fns(cfg: ArchConfig, total_len: int):
    """The (prefill, decode_step) pair :func:`naive_generate` runs (the
    reference jits them once; eager PyTorch has nothing to build)."""
    def prefill(params, batch):
        return vfl.prefill(params, cfg, batch, total_len)

    def decode(params, caches, step_batch, pos):
        return vfl.decode_step(params, cfg, caches, step_batch, pos)
    return prefill, decode


def naive_generate(params, cfg: ArchConfig, batch: Dict[str, Any],
                   max_new_tokens: int, total_len: int = 0, fns=None):
    """Greedy decode through the monolithic ``vfl.prefill`` /
    ``vfl.decode_step``: the sequential baseline and the oracle the
    engine must match (same aux rule: ``token_a = token % aux_vocab``).
    -> (B, max_new_tokens) int32 tokens."""
    S = batch["tokens"].shape[1]
    total_len = total_len or S + max_new_tokens
    prefill, decode = fns if fns is not None else \
        make_naive_fns(cfg, total_len)
    logits, caches = prefill(params, batch)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    out = [tok]
    for i in range(max_new_tokens - 1):
        sb = {"token": tok[:, None],
              "token_a": torch.remainder(tok, cfg.aux_vocab_size)[:, None]}
        logits, caches = decode(params, caches, sb, S + i)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
