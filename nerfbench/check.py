"""The numbers that decide ``correct``: each is a gap between what the
program produced on the timed path and what the plain reference computes
from the same inputs, held to the cell's limit (``limits/<cell>.json``).

Training (the first steps of the object the window then drives):

- ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the steps, and
  ``loss1_gap`` the first step's;
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  first step's gradient (the program's worked out from Adam's first moment
  after one step, ``mu / (1 - 0.9)``), over the larger of the reference's
  norm of that leaf and of the median leaf; ``grad_med`` the median leaf's;
  ``grad_diff`` the largest norm of the difference, over the same;
- ``step_gap``, ``step_med`` and ``step_diff``: the same of each leaf's
  change over the steps;
- each of those again over a group of leaves that the configuration names
  (``LEAF_GROUPS``), the median leaf the group's: ``grad_diff.view``;
- ``occ_gap``: the occupancy refresh of the first step, the RMS of the
  probed cells' differences over the standard deviation of the reference's
  values (``occ_gap_rms``: over their RMS); a cell probed on one side and
  not the other makes it infinite.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a frozen extent, a gradient nought to rounding) are left out of the leaf
numbers: Adam moves them by round-off alone.

Frames: ``row_gap``, ``med_gap``, ``rms_gap`` and ``max_gap``
(``frame_numbers``).

A cell's limits file names the numbers its check compares, each with its
limit; the others are read and printed all the same.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import numpy as np
import torch

SMALL_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_table(prog: dict, ref: dict, key: str, prefixes=("",)) -> Dict[str, tuple]:
    """Per kept leaf of the group (paths starting with one of
    ``prefixes``): ``(the gap of the norms, the norm of the difference, each
    over the larger of the reference leaf's norm and the group's median
    leaf's; the reference's norm)``. Kept: the group's leaves whose
    reference gradient is at least ``SMALL_LEAF`` of the group's median
    leaf's."""
    group = [p for p in ref["grad"] if p.startswith(tuple(prefixes))]
    gnorm = {p: _norm(ref["grad"][p]) for p in group}
    med = statistics.median(gnorm.values())
    kept = [p for p in group if gnorm[p] >= SMALL_LEAF * med]
    norms = {p: _norm(ref[key][p]) for p in kept}
    med_k = statistics.median(norms.values())
    return {p: (abs(_norm(prog[key][p]) - norms[p]) / max(norms[p], med_k),
                _norm(prog[key][p] - ref[key][p]) / max(norms[p], med_k), norms[p])
            for p in kept}


def train_numbers(prog: dict, ref: dict, groups: Optional[dict] = None) -> Dict[str, float]:
    """Every training number; a cell's limits file names those compared.
    ``groups`` (a configuration's ``LEAF_GROUPS``: name -> leaf path
    prefixes) adds each leaf number over the group alone, as
    ``<number>.<name>``."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    out = {"loss_gap": max(losses), "loss1_gap": losses[0]}
    for name, prefixes in [("", ("",))] + list((groups or {}).items()):
        tail = f".{name}" if name else ""
        for key in ("grad", "step"):
            table = leaf_table(prog, ref, key, prefixes)
            out[f"{key}_gap{tail}"] = max(v[0] for v in table.values())
            out[f"{key}_med{tail}"] = statistics.median(v[0] for v in table.values())
            out[f"{key}_diff{tail}"] = max(v[1] for v in table.values())
    if ref.get("occ") is not None:
        out["occ_gap"] = occ_gap(prog["occ"], ref["occ"])
        out["occ_gap_rms"] = occ_gap(prog["occ"], ref["occ"], by="rms")
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def occ_gap(prog: torch.Tensor, ref: torch.Tensor, by: str = "std") -> float:
    """The probed cells' RMS difference over the standard deviation of the
    reference's values (the part of sigma that varies from probe to probe)
    or, ``by="rms"``, over their RMS."""
    fin_p, fin_r = torch.isfinite(prog), torch.isfinite(ref)
    if not torch.equal(fin_p, fin_r) or int(fin_r.sum()) < 2:
        return math.inf
    d = (prog[fin_r] - ref[fin_r]).double()
    r = ref[fin_r].double()
    scale = r.std() if by == "std" else r.square().mean().sqrt()
    return float(d.square().mean().sqrt() / scale)


def frame_numbers(frames, refs) -> Dict[str, float]:
    """Over the compared frames (numpy (H, W, 3) each), in pixel units:
    ``row_gap``, the largest over the frames' rows of a row's median
    absolute difference (a row of wrong pixels moves it, a few pixels whose
    fine samples moved to another bin of the coarse weights do not);
    ``med_gap``, the median absolute difference; ``rms_gap`` and
    ``max_gap``."""
    rows, meds, rms, top = [], [], [], []
    for a, b in zip(frames, refs):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        if not np.all(np.isfinite(d)):
            return {k: math.inf for k in ("row_gap", "med_gap", "rms_gap", "max_gap")}
        rows.append(float(np.max(np.median(d.reshape(d.shape[0], -1), axis=1))))
        meds.append(float(np.median(d)))
        rms.append(float(np.sqrt(np.mean(d * d))))
        top.append(float(np.max(d)))
    return {"row_gap": max(rows), "med_gap": max(meds), "rms_gap": max(rms),
            "max_gap": max(top)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared, and none above its limit (NaN fails)."""
    return all(k in numbers and numbers[k] <= limits[k] for k in limits)


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}


def worst(per_rank) -> Dict[str, Optional[float]]:
    """Each number's largest value over the ranks."""
    keys = set().union(*per_rank)
    return {k: max(r.get(k, math.inf) for r in per_rank) for k in keys}
