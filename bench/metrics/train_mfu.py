"""train_mfu: a round's model FLOPs (``bench/flops.py``) over the window's
mean round time (rounds the profiler does not cover) times the H100's
dense bf16 peak.  fp32 work is held to the bf16 peak too, which can only
understate the share."""
from bench import flops, peaks


def read(run):
    t = run.traffic
    f = flops.round_flops(run.geometry, t["batch"], t["seq_len"], t["R"])
    return 100.0 * f["round"] / (run.round_mean_s * peaks.BF16_FLOPS)
