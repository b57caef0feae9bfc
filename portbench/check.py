"""The comparison that decides ``correct``: the numbers a run compares with
the plain reference, and their limits.

Serving compares each sampled request's prediction with the reference's
prediction of the same windows:

- ``nmse``: the squared error summed over every compared window, over the
  reference's power summed likewise;
- ``worst_window``: the largest relative L2 error of any one window.

Training compares the three steps that set-up drives the program through
with the reference's three steps from the same weights and draws:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: over the parameters (the leaves), the largest gap between the
  program's and the reference's norm of the first gradient, over the
  reference's norm of that leaf or of the median leaf, the larger;
- ``change``: the same of each leaf's change after the three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others, such as a key projection's bias under the
  softmax, move under Adam by round-off alone).

A number that is not finite, or a shape that differs, reads infinity.
"""

from __future__ import annotations

import math
import statistics

import torch

GRAD_FLOOR = 1e-3  # of the median leaf's gradient norm: below it a leaf moves by round-off


def serve_numbers(got: list, want: list) -> dict:
    """``nmse`` and ``worst_window`` of the programs's predictions ``got``
    against the reference's ``want`` (lists of ``[B, pred_len, C]``)."""
    err = power = 0.0
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            return {"nmse": math.inf, "worst_window": math.inf}
        d = (g.double() - w.double()).flatten(1)
        wf = w.double().flatten(1)
        err += float(torch.sum(d * d))
        power += float(torch.sum(wf * wf))
        rel = torch.linalg.vector_norm(d, dim=1) / torch.linalg.vector_norm(wf, dim=1)
        worst = max(worst, float(rel.max()))
    nmse = err / power if power > 0 else math.inf
    return {"nmse": _finite(nmse), "worst_window": _finite(worst)}


def train_numbers(got: dict, want: dict) -> dict:
    """``loss``, ``grad`` and ``change`` of the program's readings ``got``
    against the reference's ``want`` (each ``{"losses": [...],
    "grad_norms": {leaf: norm}, "change_norms": {leaf: norm}}``)."""
    if len(got["losses"]) != len(want["losses"]):
        return {"loss": math.inf, "grad": math.inf, "change": math.inf}
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    ref_grad = want["grad_norms"]
    median_grad = statistics.median(ref_grad.values())
    grad = max(abs(got["grad_norms"][n] - r) / max(r, median_grad) for n, r in ref_grad.items())
    moved = [n for n, r in ref_grad.items() if r >= GRAD_FLOOR * median_grad]
    median_change = statistics.median(want["change_norms"][n] for n in moved)
    change = max(abs(got["change_norms"][n] - want["change_norms"][n])
                 / max(want["change_norms"][n], median_change) for n in moved)
    return {"loss": _finite(loss), "grad": _finite(grad), "change": _finite(change)}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and ``{name: {"value",
    "limit"}}`` in the order of ``limits``."""
    checks = {name: {"value": numbers[name], "limit": entry["limit"]}
              for name, entry in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
