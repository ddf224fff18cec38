"""Pluggable wire codecs for the compressed K-party transport
(Compressed-VFL, Castiglia et al.: top-k sparsification and low-bit
quantisation of the exchanged cut tensors preserve convergence when
combined with the engine's local steps).

Port of ``repro/core/compression.py``.  A codec maps a float tensor of any
shape to a *payload* (a dict of wire tensors) and back:

    encode(key, x)        -> payload
    decode(payload, like) -> tensor with ``like``'s shape and dtype
    wire_bytes(shape, dtype) -> int: EXACTLY ``payload_nbytes`` of the
        payload of an input of that shape (tests pin this), so the
        transport's byte accounting is honest.
    lossless              -> bool: lossless codecs skip error feedback.

``key`` is a :class:`repro_torch.core.uniforms.UniformKey`, the port's
counterpart of a ``jax.random`` key: codecs fold it as the reference folds
its key and draw their stochastic-rounding uniforms from it.

Codecs: :class:`IdentityCodec` (the wire as it is);
:class:`StochasticQuantCodec` (int8 / int4 with one fp32 absmax scale per
128 values and stochastic rounding through K3, int4 codes nibble-packed);
:class:`TopKCodec` (the k largest magnitudes, ties to the lower index,
int16 indices while they fit, optionally with a value codec);
:class:`ChainCodec` (each stage encodes what the earlier ones left).
Error feedback lives in the transport (``engine.CompressedWANTransport``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .workset import pack_nibbles, tree_leaves, unpack_nibbles

TILE = 128          # values per fp32 quantisation scale
INT16_MAX = 2 ** 15 - 1


class Like(NamedTuple):
    """Shape and dtype to decode to (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _nelem(shape) -> int:
    return int(math.prod(int(s) for s in shape))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def payload_nbytes(payload) -> int:
    """Actual wire size of an encoded payload (what wire_bytes must
    match)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(payload))


class IdentityCodec:
    """The wire as it is (accounting follows the given dtype: the
    transport passes its wire dtype, so this reproduces the plain wire's
    bytes)."""

    lossless = True
    exact = True      # decode(encode(x)) is x bitwise: skippable on send

    def encode(self, key, x):
        return {"x": x}

    def decode(self, payload, like):
        return payload["x"]

    def wire_bytes(self, shape, dtype) -> int:
        return _nelem(shape) * _itemsize(dtype)


class StochasticQuantCodec:
    """int8 / int4 stochastic-rounding quantisation, one fp32 absmax scale
    per ``tile`` consecutive values (the flattened tensor is zero-padded to
    whole tiles; padding decodes to exact zeros).  Every encode runs K3,
    for any number of tiles."""

    lossless = False
    exact = False

    def __init__(self, bits: int = 8, tile: int = TILE):
        assert bits in (4, 8), bits
        assert tile % 2 == 0, tile
        self.bits = bits
        self.tile = tile
        self.levels = (1 << (bits - 1)) - 1      # 127 / 7

    def _tiles(self, n: int) -> int:
        return -(-n // self.tile)

    def _quantize(self, key, x2d):
        """(T, tile) -> (codes int8, scales f32) through K3."""
        u = key.uniform(x2d.shape).to(x2d.device)
        return kops.quantize_stochastic(x2d, u, self.levels)

    def encode(self, key, x):
        n = x.numel()
        T = self._tiles(n)
        flat = x.reshape(-1).float()
        x2d = F.pad(flat, (0, T * self.tile - n)).reshape(T, self.tile)
        q, scale = self._quantize(key, x2d)
        if self.bits == 4:
            q = pack_nibbles(q)
        return {"q": q, "scale": scale}

    def roundtrip_rows(self, key, x):
        """Each row of ``x`` (C, n) encoded and decoded on its own, as
        ``decode(encode(k_c, x[c]))`` would, in one K3 launch: row c's
        uniforms are row c of one (C, T, tile) draw from ``key`` (a
        ``uniforms.lanes_key``, folded as one row's key would be).  The
        int4 pack and unpack leave the codes as they are, so they are
        skipped.  -> (C, n) fp32."""
        C, n = x.shape
        T = self._tiles(n)
        x2d = F.pad(x.float(), (0, T * self.tile - n)).reshape(
            C * T, self.tile)
        u = key.uniform((C, T, self.tile)).to(x.device)
        q, scale = kops.quantize_stochastic(
            x2d, u.reshape(C * T, self.tile), self.levels)
        y = q.float() * scale[:, None]
        return y.reshape(C, T * self.tile)[:, :n]

    def decode(self, payload, like):
        q, scale = payload["q"], payload["scale"]
        if self.bits == 4:
            q = unpack_nibbles(q)
        x2d = q.float() * scale[:, None]
        n = _nelem(like.shape)
        return x2d.reshape(-1)[:n].reshape(like.shape).to(like.dtype)

    def wire_bytes(self, shape, dtype) -> int:
        T = self._tiles(_nelem(shape))
        code_bytes = self.tile if self.bits == 8 else self.tile // 2
        return T * code_bytes + T * 4            # codes + fp32 scales


class PlateauRatioSchedule:
    """Adaptive top-k keep-ratio: loosen sparsity as the loss plateaus.

    A host-side control plane between rounds: when ``patience``
    consecutive observations fail to improve the best loss seen by
    ``min_delta``, the keep-ratio steps up the ``ratios`` ladder.
    Monotone: sparsity only loosens.  Non-finite observations are ignored
    (no stall tick, no step).  Error-feedback residuals are dense fp32
    whatever the ratio, so they carry across a change."""

    def __init__(self, ratios: Sequence[float] = (0.0625, 0.125, 0.25, 0.5),
                 patience: int = 3, min_delta: float = 1e-3):
        rs = tuple(float(r) for r in ratios)
        assert rs == tuple(sorted(rs)) and rs, "ratios must ascend"
        self.ratios = rs
        self.patience = patience
        self.min_delta = min_delta
        self.idx = 0
        self.best = float("inf")
        self.stall = 0

    @property
    def ratio(self) -> float:
        return self.ratios[self.idx]

    def update(self, loss) -> Optional[float]:
        """Observe one smoothed loss; return the NEW ratio when the
        plateau rule fires (else None)."""
        loss = float(loss)
        if not math.isfinite(loss):
            return None
        if loss < self.best - self.min_delta:
            self.best = loss
            self.stall = 0
            return None
        self.stall += 1
        if self.stall >= self.patience and self.idx + 1 < len(self.ratios):
            self.idx += 1
            self.stall = 0
            self.best = min(self.best, loss)
            return self.ratio
        return None


class TopKCodec:
    """Keep the k = ceil(ratio * n) largest-magnitude values; the rest
    decode to zero.  ``value_codec`` compresses the kept values (top-k
    indices + int8 values is Compressed-VFL's sketch).
    ``ratio_schedule`` (a :class:`PlateauRatioSchedule`) is the adaptive
    hook that :meth:`scheduled` consults between rounds."""

    lossless = False
    exact = False

    def __init__(self, ratio: float = 0.25,
                 value_codec: Optional[object] = None,
                 ratio_schedule: Optional[PlateauRatioSchedule] = None):
        assert 0.0 < ratio <= 1.0, ratio
        self.ratio = ratio
        self.value_codec = value_codec or IdentityCodec()
        self.ratio_schedule = ratio_schedule
        if ratio_schedule is not None and ratio_schedule.ratio != ratio:
            # sync the ladder to the codec's starting ratio, else a fired
            # step could tighten the wire
            if ratio not in ratio_schedule.ratios:
                raise ValueError(
                    f"codec ratio {ratio} not on the schedule ladder "
                    f"{ratio_schedule.ratios}")
            ratio_schedule.idx = ratio_schedule.ratios.index(ratio)

    def with_ratio(self, ratio: float) -> "TopKCodec":
        """Same codec (and schedule hook) at another keep-ratio."""
        return TopKCodec(ratio, value_codec=self.value_codec,
                         ratio_schedule=self.ratio_schedule)

    def scheduled(self, loss) -> "TopKCodec":
        """Offer one loss observation to the ratio schedule; -> ``self``
        or a re-ratioed clone."""
        if self.ratio_schedule is None:
            return self
        r = self.ratio_schedule.update(loss)
        if r is None or r == self.ratio:
            return self
        return self.with_ratio(r)

    def k_of(self, n: int) -> int:
        return max(1, int(math.ceil(n * self.ratio)))

    @staticmethod
    def _idx_dtype(n: int):
        return torch.int16 if n - 1 <= INT16_MAX else torch.int32

    def encode(self, key, x):
        flat = x.reshape(-1).float()
        n = flat.shape[0]
        k = self.k_of(n)
        # a stable descending sort, not torch.topk: equal magnitudes keep
        # the lower index first, as jax.lax.top_k orders them, so the kept
        # values (and the tiles a value codec groups them into) match
        idx = torch.sort(flat.abs(), descending=True, stable=True)[1][:k]
        vals = flat[idx]
        vp = self.value_codec.encode(key.fold(1), vals)
        return {"idx": idx.to(self._idx_dtype(n)), "val": vp}

    def decode(self, payload, like):
        n = _nelem(like.shape)
        k = self.k_of(n)
        vals = self.value_codec.decode(payload["val"],
                                       Like((k,), torch.float32))
        flat = torch.zeros(n, dtype=torch.float32, device=vals.device)
        flat[payload["idx"].long()] = vals
        return flat.reshape(like.shape).to(like.dtype)

    def wire_bytes(self, shape, dtype) -> int:
        n = _nelem(shape)
        k = self.k_of(n)
        idx_bytes = _itemsize(self._idx_dtype(n))
        return k * idx_bytes + self.value_codec.wire_bytes((k,),
                                                           torch.float32)


class ChainCodec:
    """Residual chaining: ``encode`` runs the stages left to right, each on
    the running reconstruction error; ``decode`` sums the stages."""

    # lossless chains (one ending in identity) reconstruct only to fp32
    # rounding: the transport must still run encode/decode for them
    exact = False

    def __init__(self, stages: Sequence[object]):
        assert stages, "empty chain"
        self.stages = list(stages)

    @property
    def lossless(self) -> bool:
        # any lossless stage carries the entire remaining residual
        return any(s.lossless for s in self.stages)

    def encode(self, key, x):
        e = x.float()
        payloads = []
        for i, c in enumerate(self.stages):
            p = c.encode(key.fold(i), e)
            e = e - c.decode(p, e)
            payloads.append(p)
        return {"stages": payloads}

    def decode(self, payload, like):
        f32 = Like(tuple(like.shape), torch.float32)
        out = None
        for c, p in zip(self.stages, payload["stages"]):
            y = c.decode(p, f32)
            out = y if out is None else out + y
        return out.to(like.dtype)

    def wire_bytes(self, shape, dtype) -> int:
        return sum(c.wire_bytes(shape, dtype) for c in self.stages)


# --------------------------------------------------------------------------
# Named specs (the ``--compression`` axis / CELUConfig.compression values)
# --------------------------------------------------------------------------
def make_codec(name: str):
    """One codec by name: identity | int8 | int4 | int4x2 | topk |
    topk_int8 | topk_int4."""
    if name == "identity":
        return IdentityCodec()
    if name == "int8":
        return StochasticQuantCodec(8)
    if name == "int4":
        return StochasticQuantCodec(4)
    if name == "int4x2":
        return ChainCodec([StochasticQuantCodec(4), StochasticQuantCodec(4)])
    if name == "topk":
        return TopKCodec(0.25)
    if name == "topk_int8":
        return TopKCodec(0.25, value_codec=StochasticQuantCodec(8))
    if name == "topk_int4":
        return TopKCodec(0.25, value_codec=StochasticQuantCodec(4))
    raise ValueError(f"unknown codec {name!r}")


# Asymmetric up/down presets: sparse sketches uplink (Z_i), dense low-bit
# downlink (∇Z_i: top-k on derivatives interacts badly with Algorithm 2's
# cosine staleness measure, so the downlink stays dense).
_PAIRS = {
    "int8_topk": ("topk_int8", "int8"),
    "int4_topk": ("topk_int4", "int4"),
}

CODEC_SPECS = ("identity", "int8", "int4", "int4x2", "topk", "topk_int8",
               "topk_int4") + tuple(_PAIRS)


def make_codec_pair(spec: str) -> Tuple[object, object]:
    """Codec spec -> (uplink codec, downlink codec).  ``"up/down"`` picks
    each direction; a name of ``_PAIRS`` is an asymmetric preset; any
    single codec name serves both directions."""
    if "/" in spec:
        up, down = spec.split("/", 1)
        return make_codec(up), make_codec(down)
    if spec in _PAIRS:
        up, down = _PAIRS[spec]
        return make_codec(up), make_codec(down)
    return make_codec(spec), make_codec(spec)
