"""How ``correct`` is decided: the program's first rounds against the plain
reference's, on the same weights and batches.

Five numbers, each against its limit from the cell's file:

* ``loss_gap``: the relative gap between the program's and the
  reference's loss, the widest over the checked rounds;
* ``gate_gap``: each round's mean local-update weight (K1's gate over the
  R draws of both parties, a bubble counting 0), the widest absolute gap
  over the checked rounds;
* ``local_grad_gap``: each party's local updates off live slots (a
  bubble's update is scaled by 0 and left out), each update's norm of
  its gradient over all the party's leaves as the optimizer took it,
  gapped as a leaf's is below (over the party's median update); the
  median update's gap, the larger party's.  Party A's gradient is its
  tower's pull-back of the cached ∇Z times K1's weight, Party B's that
  of its weighted loss at the cached Z;
* ``grad_norm_gap``: each leaf's norm of its party's first gradient, as
  the optimizer took it (√(Σ AdaGrad accumulator) after the party's
  first update); the worst leaf's gap, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_norm_gap``: after the checked rounds, each leaf's
  ||p - p_start||, gapped the same way; the worst leaf's gap, over the
  leaves whose first reference gradient is at least a thousandth of the
  median leaf's (below that, AdaGrad moves a leaf by round-off alone).

``gaps`` also returns the first round's loss gap, the median leaf's
gradient and change gaps and the three worst gradient leaves, which a
calibration prints and a run does not compare.  ``PERF.md`` gives the
readings each limit was set from.

A reading is a dict {"loss": [...], "w_mean": [...], "updates":
[(norm, scale), ...], "grad": {leaf: norm}, "change": {leaf: norm}} (and
each round's share of zero local-update weights, "w_zero", which a
calibration prints).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

NUMBERS = ("loss_gap", "gate_gap", "local_grad_gap", "grad_norm_gap",
           "change_norm_gap")
NEGLIGIBLE = 1e-3


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               leaves: List[str]) -> List[float]:
    med = statistics.median(want[k] for k in leaves)
    return [abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in leaves]


def _local_gap(got: list, want: list, rounds: int) -> float:
    """Each party's local updates off live slots: each update's gap of
    gradient norms over the larger of the reference's norm of it and of
    the party's median update; the median update's gap, the larger
    party's.  ``got``, ``want``: [(norm, scale)] in the round's order (A's
    and B's exchange steps, then A's and B's local updates in turn)."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} updates against {len(want)}")
    per = len(want) // rounds
    pairs = ([], [])
    for i, (g, w) in enumerate(zip(got, want)):
        # a slot is live on both sides or on neither (the ring's clocks);
        # one live on one side only counts
        if i % per >= 2 and (g[1] or w[1]):
            pairs[i % 2].append((g[0], w[0]))
    out = 0.0
    for party in pairs:
        if not party:
            continue
        med = statistics.median(w for _, w in party)
        out = max(out, statistics.median(
            abs(g - w) / max(w, med) if max(w, med) else float(g > 0)
            for g, w in party))
    return out


def gaps(got: dict, want: dict) -> Dict[str, float]:
    if set(got["grad"]) != set(want["grad"]):
        raise ValueError(f"the leaves differ: "
                         f"{sorted(set(got['grad']) ^ set(want['grad']))}")
    loss = [abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"])]
    leaves = sorted(want["grad"])
    med = statistics.median(want["grad"][k] for k in leaves)
    moved = [k for k in leaves if want["grad"][k] >= NEGLIGIBLE * med]
    change = _leaf_gaps(got["change"], want["change"], moved)
    grad = _leaf_gaps(got["grad"], want["grad"], leaves)
    return {"loss_gap": max(loss),
            "gate_gap": max(abs(g - w) for g, w in
                            zip(got["w_mean"], want["w_mean"])),
            "local_grad_gap": _local_gap(got["updates"], want["updates"],
                                         len(want["loss"])),
            "grad_norm_gap": max(grad),
            "change_norm_gap": max(change),
            "loss_gap_first_round": loss[0],
            "change_norm_gap_median_leaf": statistics.median(change),
            "grad_norm_gap_median_leaf": statistics.median(grad),
            "w_mean": list(got["w_mean"]), "w_mean_ref": list(want["w_mean"]),
            "grad_worst_leaves": sorted(zip(grad, leaves))[-3:]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """-> {"correct", "checks": {name: {"value", "limit"}}}: correct when
    every compared number is within its limit; a number the cell's file
    gives no limit for is printed and not compared."""
    checks = {k: {"value": numbers[k], "limit": limits.get(k)}
              for k in NUMBERS}
    ok = all(c["limit"] is None or c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}
