"""Configuration dataclasses: copies of ``repro/configs/base.py``'s
``validate_pipeline_depth``, ``CELUConfig``, the chaos engine's
``DropoutSpan`` and ``FaultPlan``, the LLM architecture configs
(``ArchConfig`` with its family extras ``MoEConfig``, ``SSMConfig``,
``XLSTMConfig``, the party split ``VFLConfig``), ``ShapeConfig`` with
the dry-run's four shapes (:data:`SHAPES`) and
:data:`LONG_CONTEXT_WINDOW`.  The
port keeps its own so that it imports nothing of the JAX package; field
meanings and defaults are the reference's."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def validate_pipeline_depth(depth: int, W: int) -> None:
    """A depth-D exchange queue retires the oldest D workset ring slots
    early, so D must stay < W or every draw is a bubble."""
    if depth < 0:
        raise ValueError(f"pipeline_depth must be >= 0, got {depth}")
    if depth and depth >= max(W, 1):
        raise ValueError(
            f"pipeline_depth ({depth}) must be < W "
            f"({W}): a depth-D queue retires the oldest D ring "
            f"slots early, so D >= W leaves no valid workset draws")


@dataclass(frozen=True)
class CELUConfig:
    """Hyper-parameters of the paper's technique (Section 3 notation).
    Field meanings and defaults are those of the reference."""
    R: int = 5               # max local updates per cached batch
    W: int = 5               # workset table capacity (mini-batches)
    xi_degrees: float = 60.0  # weighting threshold ξ (cos ξ floor)
    weighting: bool = True
    # round_robin | consecutive (FedBCD) | uniform (random over alive slots)
    sampling: str = "round_robin"
    wire_dtype: str = "float32"   # float32 | bfloat16
    dp_sigma: float = 0.0
    dp_clip: float = 1.0
    compression: str = ""
    cache_dtype: str = "float32"
    # route the local updates through the fused ring-sample kernel (K1);
    # False materialises the sampled entry and runs K2
    cache_fused: bool = True
    pipeline_depth: int = 0
    pipeline_lr_damping: float = 0.25

    def __post_init__(self):
        validate_pipeline_depth(self.pipeline_depth, self.W)
        if self.pipeline_lr_damping < 0.0:
            raise ValueError(
                f"pipeline_lr_damping must be >= 0, got "
                f"{self.pipeline_lr_damping}")


@dataclass(frozen=True)
class DropoutSpan:
    """One party's outage: ``party`` ("a0".."a{K-1}" or "b") is down for
    ``rounds`` consecutive scheduler rounds starting at ``start`` (and
    rejoins at ``start + rounds``)."""
    party: str
    start: int
    rounds: int

    def __post_init__(self):
        if not (self.party == "b" or (self.party.startswith("a")
                                      and self.party[1:].isdigit())):
            raise ValueError(
                f"DropoutSpan.party must be 'a<i>' or 'b', got "
                f"{self.party!r}")
        if self.start < 0 or self.rounds <= 0:
            raise ValueError(
                f"DropoutSpan needs start >= 0 and rounds >= 1, got "
                f"start={self.start} rounds={self.rounds}")

    def covers(self, round_idx: int) -> bool:
        return self.start <= round_idx < self.start + self.rounds


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic, seeded fault schedule of the chaos engine
    (``core.faults.ChaosEngine``): every fate is a function of ``(seed,
    round_idx)`` alone, so a run and its resumed continuation see the
    same faults.

    A dropped exchange attempt (probability ``drop_prob``) is retried up
    to ``max_retries`` times with exponential backoff from
    ``retry_backoff_s`` before the round's exchange is abandoned; a
    delivered one arrives late with probability ``straggler_prob``, by a
    delay uniform on [1, ``straggler_rounds``].  ``party_clocks`` are
    per-feature-party WAN links as ``(up_bandwidth_Bps,
    down_bandwidth_Bps, latency_s)`` tuples (``launch.wan.clocks_from_plan``
    turns them into clocks); the slowest party paces each exchange."""
    seed: int = 0
    drop_prob: float = 0.0
    max_retries: int = 2
    retry_backoff_s: float = 0.5
    straggler_prob: float = 0.0
    straggler_rounds: int = 2
    dropouts: Tuple[DropoutSpan, ...] = ()
    party_clocks: Optional[Tuple[Tuple[float, float, float], ...]] = None

    def __post_init__(self):
        if not (0.0 <= self.drop_prob < 1.0):
            raise ValueError(f"drop_prob must be in [0, 1), got "
                             f"{self.drop_prob}")
        if not (0.0 <= self.straggler_prob <= 1.0):
            raise ValueError(f"straggler_prob must be in [0, 1], got "
                             f"{self.straggler_prob}")
        if self.max_retries < 0 or self.straggler_rounds < 1:
            raise ValueError(
                f"need max_retries >= 0 and straggler_rounds >= 1, got "
                f"{self.max_retries} / {self.straggler_rounds}")
        if self.retry_backoff_s < 0.0:
            raise ValueError(f"retry_backoff_s must be >= 0, got "
                             f"{self.retry_backoff_s}")
        object.__setattr__(self, "dropouts", tuple(self.dropouts))
        if self.party_clocks is not None:
            object.__setattr__(
                self, "party_clocks",
                tuple(tuple(float(v) for v in c)
                      for c in self.party_clocks))
            for c in self.party_clocks:
                if len(c) != 3 or c[0] <= 0 or c[1] <= 0 or c[2] < 0:
                    raise ValueError(
                        f"party_clocks entries are (up_Bps, down_Bps, "
                        f"latency_s) with positive bandwidths, got {c}")

    def down_parties(self, round_idx: int) -> Tuple[str, ...]:
        """Parties down at ``round_idx`` (sorted, deduplicated)."""
        return tuple(sorted({d.party for d in self.dropouts
                             if d.covers(round_idx)}))


# --------------------------------------------------------------------------
# LLM architectures
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0        # shared (always-on) experts, llama4-style
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    sharding: str = "tp"     # ep | tp


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by hybrid archs)."""
    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block layout: sLSTM at layer indices i % slstm_every == 0."""
    slstm_every: int = 4
    conv_dim: int = 4


@dataclass(frozen=True)
class VFLConfig:
    """How the backbone is split across the two parties."""
    layers_a: int            # Party A bottom tower depth
    layers_b: int            # Party B bottom tower depth
    layers_top: int          # Party B top tower depth (+ head)
    fusion: str = "add"      # add | cross_attn
    z_dim: int = 0           # dim of the exchanged Z_A; 0 -> d_model


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    source: str = ""

    # family extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    cross_attn_every: int = 0      # vlm: every k-th layer cross-attends
    enc_layers: int = 0            # audio: encoder depth (Party A tower)
    qkv_bias: bool = False         # qwen-style attention bias

    # attention window; 0 = full causal
    sliding_window: int = 0

    # modality frontends
    n_patches: int = 0             # vlm: patch tokens from the vision stub
    d_frontend: int = 0            # vlm/audio: stub embedding dim
    audio_downsample: int = 4      # audio: frames = seq_len // downsample

    aux_vocab_size: int = 65536    # Party A token stream vocab (text archs)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    vfl: Optional[VFLConfig] = None

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def vfl_split(self) -> VFLConfig:
        if self.vfl is not None:
            return self.vfl
        if self.family == "vlm":
            lt = max(1, self.n_layers // 4)
            return VFLConfig(layers_a=0, layers_b=self.n_layers - lt,
                             layers_top=lt, fusion="cross_attn")
        if self.family == "audio":
            lt = max(1, self.n_layers // 4)
            return VFLConfig(layers_a=self.enc_layers,
                             layers_b=self.n_layers - lt, layers_top=lt,
                             fusion="cross_attn")
        la = max(1, self.n_layers // 4)
        lt = max(1, self.n_layers // 4)
        return VFLConfig(layers_a=la, layers_b=self.n_layers - la - lt,
                         layers_top=lt, fusion="add")

    def with_sliding_window(self, window: int) -> "ArchConfig":
        return dataclasses.replace(self, sliding_window=window)

    def reduced(self) -> "ArchConfig":
        """CPU smoke variant: same family, tiny dims."""
        d = 128
        heads, kv = 4, 2
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            aux_vocab_size=512,
            moe=moe,
            cross_attn_every=2 if self.cross_attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            n_patches=16 if self.n_patches else 0,
            d_frontend=32 if self.d_frontend else 0,
            vfl=VFLConfig(
                layers_a=0 if self.family == "vlm" else 1,
                layers_b=1, layers_top=1,
                fusion=self.vfl_split.fusion),
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# the attention window of every family but ssm at the long_500k decode
# shape (``configs.arch_for_shape``)
LONG_CONTEXT_WINDOW = 8192
