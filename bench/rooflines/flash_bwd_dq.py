"""K10's dq kernel (``csrc/flash_attention_bwd.cu``).  A frozen copy of
``kernels/flash_attention_bwd.py::bwd_costs``: the three products it
computes (s, do·vᵀ, dq) at 2·hd operations a visible pair; q, k, v, do
read and dq written once, the fp32 LSE and D rows read."""

from bench.shares import visible_pairs

PATTERNS = ("flash_bwd_dq_mma", "flash_bwd_dq_f32mma")


def cost(B: int, S: int, H: int, hd: int, itemsize: int, causal: bool):
    n = B * S * H * hd * itemsize
    return (2 * 3 * hd * H * B * visible_pairs(S, causal),
            5 * n + 2 * 4 * B * H * S)
