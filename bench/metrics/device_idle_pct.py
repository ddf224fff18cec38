"""device_idle_pct: the share of a round in which no device activity
(kernel, copy, set) runs: the profiled rounds' device time a round, from
the profiler's trace, over the window's mean round time (host clock,
rounds the profiler does not cover).  The profiled rounds' own wall time
is not the base: the profiler's host work stretches a round whose host
is part of its critical path (granite's by about half)."""


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.rounds / run.round_mean_s)
