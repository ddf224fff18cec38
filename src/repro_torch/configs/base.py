"""Configuration dataclasses: copies of ``repro/configs/base.py``'s
``validate_pipeline_depth``, ``CELUConfig``, the LLM architecture configs
(``ArchConfig`` with its family extras ``MoEConfig``, ``SSMConfig``,
``XLSTMConfig``, the party split ``VFLConfig``) and ``ShapeConfig``.  The
port keeps its own so that it imports nothing of the JAX package; field
meanings and defaults are the reference's."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


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
