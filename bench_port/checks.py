"""The numbers that decide ``correct``, each worked out from two readings:
the program's and the plain reference's.

Training (three steps through the window's own call, before it opens):

* ``loss_gap_step1``: the relative gap of the first step's loss. The
  later steps' gaps are kept as readings, not compared: Adam's first
  update moves every element by the learning rate times its gradient's
  sign, and rounding flips the sign of near-zero gradients, so the two
  runs part from the second step on (PERF.md).
* ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient (the program's worked out from Adam's first moment after one
  step) measured against the reference's norm of that leaf or of the
  median leaf, whichever is larger; ``grad_median_gap``, the median
  leaf's, steady from seed to seed where the worst leaf swings.
* ``update_gap``: by the worst leaf, the same of the parameters' change
  over the three steps.
* ``rows_bad``: rows of the three batches that are not distinct rows of
  the corpus's train split, exactly as the benchmark wrote them.

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding) move under Adam by round-off alone: they are
left out of both leaf gaps by that rule, never by name.
"""

from __future__ import annotations

import math

import torch

NEGLIGIBLE = 1e-3           # a leaf's gradient norm against the median leaf's


def norms(tensors):
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def counted_leaves(ref_grads):
    """Leaves whose reference gradient is not nought to rounding."""
    g = norms(ref_grads)
    med = sorted(g.values())[len(g) // 2]
    return sorted(n for n, v in g.items() if v >= NEGLIGIBLE * med)


def leaf_gaps(prog, ref, leaves):
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)} over ``leaves``;
    a leaf the program lacks reads 1."""
    r = norms({n: ref[n] for n in leaves})
    med = sorted(r.values())[len(r) // 2]
    out = {}
    for n in leaves:
        if prog.get(n) is None:
            out[n] = 1.0
            continue
        p = float(torch.linalg.vector_norm(prog[n].double()))
        gap = abs(p - r[n]) / max(r[n], med)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def summary(gaps):
    """The median leaf's gap and the three worst leaves, for the record."""
    ranked = sorted(gaps.items(), key=lambda kv: -kv[1])
    return {"median": sorted(gaps.values())[len(gaps) // 2],
            "worst": [[n, v] for n, v in ranked[:3]]}


def step_loss_gaps(prog, ref):
    """Each step's relative loss gap."""
    if len(prog) != len(ref):
        return [math.inf]
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    return [g if math.isfinite(g) else math.inf for g in gaps]



def judge(values, limits):
    """{name: {"value", "limit"}} and whether every value is within its
    limit (a value of nan or inf is not)."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return checks, ok
