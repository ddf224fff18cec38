"""adagrad_roofline: K7's launches in the profiled rounds, their least
time over their device time.  A round updates each party R + 1 times
(its fresh step and R local steps, a bubble's at scale 0), each update
over all the party's tensors (bf16 parameters and gradients, fp32
accumulators; the router's fp32 throughout)."""
from bench import peaks, shares, specs
from bench import weights as Wt


def read(run):
    p, t = run.profile, run.traffic
    if p is None:
        return None
    rf = specs.roofline("adagrad")
    events = p.matching(rf.PATTERNS)
    if not events:
        return None
    least = 0.0
    for party, leaves in Wt.leaf_specs(run.config).items():
        rows = []
        for _, shape, dtype, _ in leaves:
            n = 1
            for s in shape:
                n *= s
            item = 4 if str(dtype) == "torch.float32" else 2
            rows.append((n, item, 4, item))
        least += shares.least_s(*rf.cost(rows), peaks.FP32_FLOPS)
    return shares.share_pct((t["R"] + 1) * p.rounds * least, events)
