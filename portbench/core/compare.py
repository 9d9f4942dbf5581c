"""The numbers that decide `correct`, each compared with its limit.

Training cells (the first steps of the timed step function against the
reference's own steps from the same weights and times):

  loss_gap    the widest relative gap of a step's loss, over the checked steps;
  grad_gap    the first gradient, as the optimizer got it (Adam's first
              moment after one step over 1 - b1), by the worst leaf: the
              gap between the program's norm of the leaf and the
              reference's, over the larger of the reference's norm of that
              leaf and of the median leaf;
  change_gap  each leaf's change over the checked steps, the same way, over
              the leaves whose reference gradient is at least a thousandth
              of the median leaf's (a leaf whose gradient is nought to
              rounding moves under Adam by round-off alone);
  change1_gap the same of each leaf's change after the first step alone.

A cell holds the numbers its limits file names (PERF.md says why a cell
holds change1_gap in place of change_gap); a run prints every number, the
ones a cell does not hold with no limit.

Serving cells: field_err, the widest gap of a served field from the
reference's, over the reference's largest magnitude, over the sampled
requests.
"""

from __future__ import annotations

import statistics

import torch

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of change_gap.
GRAD_FLOOR = 1e-3


def _norms(pairs) -> dict[str, float]:
    return {path: float(torch.linalg.vector_norm(x.double())) for path, x in pairs}


def worst_leaf_gap(judged, truth, keep=None) -> float:
    """max over the kept leaves of | |a| - |b| | / max(|b|, median |b|)."""
    a, b = _norms(judged), _norms(truth)
    paths = [p for p in b if keep is None or p in keep]
    med = statistics.median(b[p] for p in paths)
    return max(abs(a[p] - b[p]) / max(b[p], med) for p in paths)


def training(judged: dict, truth: dict) -> dict[str, float]:
    """judged and truth: {"losses": [...], "grad1", "change", "change1": [(path, t)]}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(judged["losses"], truth["losses"]))
    g = _norms(truth["grad1"])
    med = statistics.median(g.values())
    moving = {p for p, v in g.items() if v >= GRAD_FLOOR * med}
    return {
        "loss_gap": loss_gap,
        "grad_gap": worst_leaf_gap(judged["grad1"], truth["grad1"]),
        "change_gap": worst_leaf_gap(judged["change"], truth["change"], moving),
        "change1_gap": worst_leaf_gap(judged["change1"], truth["change1"], moving),
    }


def leaf_gaps(judged: dict, truth: dict) -> dict[str, str]:
    """Each leaf's norms, program and reference, of the gradient and of the
    change: what a reading's worst leaf is."""
    out = {}
    for key in ("grad1", "change", "change1"):
        a, b = _norms(judged[key]), _norms(truth[key])
        out.update({f"{key} {p}": f"{a[p]!r} {b[p]!r}" for p in b})
    return out


class FieldGap:
    """field_err accumulated block by block over the sampled fields."""

    def __init__(self):
        self.gap, self.scale = 0.0, 0.0

    def add(self, judged: torch.Tensor, truth: torch.Tensor) -> None:
        self.gap = max(self.gap, float((judged.double() - truth.double()).abs().max()))
        self.scale = max(self.scale, float(truth.double().abs().max()))

    def value(self) -> float:
        return self.gap / self.scale if self.scale > 0 else float("inf")
