"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program's own trainer from the seed through its first
steps, through the window's own runner and feed; the plain reference
follows the same steps from the same weights and batches. Four numbers
are compared, each with the limit the cell's file states (a number the
file gives no limit is not compared):

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
* ``grad_gap``: the first step's gradient as the optimizer got it (read
  back from its state after that step), by the worst leaf: the gap
  between the two norms of a leaf over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``change_gap``: the parameters' change over the steps, by the worst
  leaf in the same way, leaving out the leaves whose reference gradient
  stays under a thousandth of the median leaf's first one at every step
  (they move under Adam by round-off alone);
* ``late_change_gap``: the change of the late leaves alone, by the worst
  leaf against the larger of its own reference norm and the late leaves'
  median: the weights (two or more dimensions) whose first reference
  gradient is nought (under a thousandth of the median leaf's) and a later
  one is not. A ResNet whose blocks' last BatchNorm scales start at 0 has
  every branch weight late: its backward shows only in the later steps,
  where ``change_gap``'s median and its filter would drown it. Their scales
  and biases are left out here: their later gradients are sums that
  cancel, which rounding to the configurations' bf16 alone moves by a
  tenth or more.

A reading is a dict: ``losses`` (floats), ``grad`` and ``change`` (leaf
name to norm); the reference's also has ``grad_max`` (each leaf's largest
gradient over the steps) and ``matrices`` (the leaves of two or more
dimensions). The norms are taken over the model family's leaf views (a
fused projection split into its parts).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

#: a leaf whose first reference gradient is under this share of the
#: median leaf's is left out of the change
NOUGHT = 1e-3


def _median_nonzero(values: Iterable[float]) -> float:
    vals = [v for v in values if v > 0]
    return statistics.median(vals) if vals else 0.0


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[List[str]] = None) -> float:
    """The worst leaf's ``|prog - ref| / max(ref, median ref)``; a leaf the
    program lacks, or a non-finite norm, reads infinity."""
    leaves = list(ref) if leaves is None else leaves
    med = _median_nonzero(ref[n] for n in leaves)
    worst = 0.0
    for n in leaves:
        p, r = prog.get(n, math.nan), ref[n]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        den = max(r, med)
        if den > 0:
            worst = max(worst, abs(p - r) / den)
        elif p != 0:
            return math.inf
    return worst


def moved_leaves(ref: dict) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    some step at least :data:`NOUGHT` of the median leaf's first one
    (``grad_max``, or the first gradient where a reading lacks it)."""
    med = _median_nonzero(ref["grad"].values())
    most = ref.get("grad_max", ref["grad"])
    return [n for n, g in most.items() if g >= NOUGHT * med]


def late_leaves(ref: dict) -> List[str]:
    """The weights whose first reference gradient is nought and a later
    one is not (see ``late_change_gap``)."""
    med = _median_nonzero(ref["grad"].values())
    return [n for n in ref["matrices"]
            if ref["grad"][n] < NOUGHT * med and ref["grad_max"][n] > 0]


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The four numbers compared, of ``prog``'s readings against
    ``ref``'s."""
    losses = list(zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    else:
        loss_gap = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
                       for p, r in losses)
    return {
        "loss_gap": loss_gap,
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"],
                               moved_leaves(ref)),
        "late_change_gap": leaf_gap(prog["change"], ref["change"],
                                    late_leaves(ref)),
    }


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst over several ranks' readings."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every limited number within its limit, and
    ``{name: {"value", "limit"}}`` for the result line. A number without a
    limit is not compared and not shown."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
