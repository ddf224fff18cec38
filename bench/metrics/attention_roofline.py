"""attention_roofline: the flash-attention launches in the profiled rounds
(K9-LSE forward, K10's dk / dv and dq kernels), their least time over
their device time.  Every attention in a round runs at the cell's (B, S,
heads, head size), causal, with the KV heads repeated to the query
heads; a kernel's fp32 variant (Party B's ad-hoc pass runs its top tower
in fp32) moves 4-byte elements and is held to the bf16 peak too.  A cell
whose attention takes the dense path has no launches and reads
nothing."""
from bench import peaks, shares, specs

KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def read(run):
    p, t, g = run.profile, run.traffic, run.geometry
    if p is None:
        return None
    least, events = 0.0, []
    for kernel in KERNELS:
        rf = specs.roofline(kernel)
        for e in p.matching(rf.PATTERNS):
            item = 4 if "f32mma" in e[0] else 2
            least += shares.least_s(*rf.cost(
                t["batch"], t["seq_len"], g["H"], g["hd"], item, True),
                peaks.BF16_FLOPS)
            events.append(e)
    return shares.share_pct(least, events) if events else None
