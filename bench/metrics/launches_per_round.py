"""launches_per_round: kernel launches in the profiled rounds over the
rounds (copies and sets not counted); an exact count."""


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    return len(p.kernels()) / p.rounds
