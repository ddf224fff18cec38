"""K10's dk / dv kernel (``csrc/flash_attention_bwd.cu``).  A frozen copy
of ``kernels/flash_attention_bwd.py::bwd_costs``: the four products it
computes (s, do·vᵀ, dv and dk) at 2·hd operations a visible pair; q, k,
v, do read and dk, dv written once, the fp32 LSE and D rows read."""

from bench.shares import visible_pairs

PATTERNS = ("flash_bwd_dkv_mma", "flash_bwd_dkv_f32mma")


def cost(B: int, S: int, H: int, hd: int, itemsize: int, causal: bool):
    n = B * S * H * hd * itemsize
    return (2 * 4 * hd * H * B * visible_pairs(S, causal),
            6 * n + 2 * 4 * B * H * S)
