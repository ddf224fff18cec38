"""K9 / K9-LSE, the flash-attention forward (``csrc/flash_attention.cu``).
A frozen copy of ``kernels/flash_attention.py::flops`` and ``nbytes``: two
products of 2·hd operations a visible (query, key) pair; q, k, v read and
the output written once, and with the LSE its fp32 row written."""

from bench.shares import visible_pairs

PATTERNS = ("flash_fwd_mma", "flash_fwd_f32mma")


def cost(B: int, S: int, H: int, hd: int, itemsize: int, causal: bool,
         with_lse: bool = True):
    n = B * S * H * hd
    return (4 * hd * H * B * visible_pairs(S, causal),
            4 * n * itemsize + (4 * B * H * S if with_lse else 0))
