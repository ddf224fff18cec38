"""round_ms: the window's wall time over the whole rounds in it (each
round ends in a synchronize; host clock)."""


def read(run):
    return 1e3 * run.window_s / len(run.round_s)
