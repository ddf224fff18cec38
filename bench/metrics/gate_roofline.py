"""gate_roofline: K1's calls in the profiled rounds, their least time
over their device time.  A round makes R calls for Party A (with the
cotangent) and R for Party B (weights only) over the (B, S·d) cut
tensor, read from a ring that holds it in the activations' bf16.  Where
the profile holds another number of calls, the reader cannot tell them
apart and reads nothing."""
from bench import peaks, shares, specs

RING_ITEMSIZE = {"float32": 2, "bfloat16": 2}   # the cut tensor's bf16


def read(run):
    p, t, g = run.profile, run.traffic, run.geometry
    if p is None or t["cache_dtype"] not in RING_ITEMSIZE:
        return None
    rf = specs.roofline("gate")
    calls = len(p.matching(rf.CALL_PATTERNS))
    if calls == 0 or calls != 2 * t["R"] * p.rounds:
        return None
    B, F = t["batch"], t["seq_len"] * g["d"]
    item = RING_ITEMSIZE[t["cache_dtype"]]
    least = sum(shares.least_s(*rf.cost(B, F, item, cot), peaks.FP32_FLOPS)
                for cot in (True, False))
    return shares.share_pct(t["R"] * p.rounds * least,
                            p.matching(rf.PATTERNS))
