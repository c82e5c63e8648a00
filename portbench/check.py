"""The comparison that decides ``correct``: the program's first training
steps against the reference's on the same batches from the same
parameters.

Five numbers, each held to a limit of the cell's own
(``portbench/limits/<cell>.json``):

* ``first_loss_gap``: the relative gap between the program's and the
  reference's loss at the first step;
* ``loss_gap``: the median over the checked steps of each step's
  relative loss gap. Not the largest: after the first step, Adam's
  updates (about ``lr`` times the sign of each gradient element) turn
  rounding in the elements whose gradient is all but zero into gaps of
  their own, so the largest swings from seed to seed by a hundredfold
  and overlaps the control's; the median stays steady, and a step that
  trains on other rows or at another rate still moves it;
* ``step_gap``: the largest of the steps' relative loss gaps, so that
  one wrong step (a replay step that reads a stale batch or state) shows
  whichever step it is, where the median hides up to half the steps;
* ``grad_gap``: the first step's clipped gradient as Adam got it (the
  program's first moment after one step, over ``1 - beta1``), by leaf:
  the gap between the two sides' norms, over the reference's norm of
  that leaf or of the median leaf, whichever is larger; the worst leaf;
* ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient lies under a
  thousandth of the median leaf's (they move under Adam by round-off
  alone).
"""
from __future__ import annotations

import json
import math
import os
import statistics

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("first_loss_gap", "loss_gap", "step_gap", "grad_gap",
           "change_gap")
# leaves whose first gradient lies under this share of the median leaf's
# are left out of the change
NOUGHT = 1e-3


def load_limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        lim = json.load(f)
    return {k: float(lim[k]) for k in NUMBERS}


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def _median(vals) -> float:
    v = sorted(vals)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The worst leaf's ``|norm(prog) - norm(ref)| / max(norm(ref),
    median leaf norm(ref))`` over ``leaves`` (all by default)."""
    keys = list(ref) if leaves is None else list(leaves)
    if not keys:
        return float("nan")
    rn = _norms({k: ref[k] for k in keys})
    pn = _norms({k: prog[k] for k in keys})
    med = _median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def numbers(prog: dict, ref: dict, params0: dict) -> dict:
    """The five numbers of ``prog`` (a run's ``losses``, ``first_grad``
    and ``params`` after the checked steps) against ``ref``."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different step counts")
    gaps = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
            else float("inf")
            for a, b in zip(prog["losses"], ref["losses"])]
    finite = all(map(math.isfinite, gaps))
    loss_gap = statistics.median(gaps) if finite else float("inf")
    grad_gap = worst_leaf_gap(prog["first_grad"], ref["first_grad"])
    g = _norms(ref["first_grad"])
    med = _median(g.values())
    leaves = [k for k in g if g[k] >= NOUGHT * med]
    d_prog = {k: prog["params"][k].float() - params0[k].float()
              for k in leaves}
    d_ref = {k: ref["params"][k].float() - params0[k].float()
             for k in leaves}
    change_gap = worst_leaf_gap(d_prog, d_ref)
    return {"first_loss_gap": gaps[0], "loss_gap": loss_gap,
            "step_gap": max(gaps), "grad_gap": grad_gap,
            "change_gap": change_gap}


def verdict(nums: dict, limits: dict) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in NUMBERS)
