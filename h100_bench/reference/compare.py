"""The numbers that decide ``correct`` for a training cell.

Three numbers over the first three steps of the timed object, each
against the reference's own three steps from the same inputs:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as the optimizer got it, by the worst
  leaf: the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same measure of the parameters' change over the
  three steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both measures.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
TINY = 1e-3


def _norms(ts: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def counted(ref_grad: Sequence[torch.Tensor]) -> List[bool]:
    n = _norms(ref_grad)
    med = statistics.median(n)
    return [v >= TINY * med for v in n]


def norm_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
             keep: Sequence[bool]) -> float:
    pn, rn = _norms(prog), _norms(ref)
    if not all(math.isfinite(v) for v in pn):
        return math.inf
    kept = [r for r, k in zip(rn, keep) if k]
    med = statistics.median(kept)
    return max(abs(p - r) / max(r, med)
               for p, r, k in zip(pn, rn, keep) if k)


def direction_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                  keep: Sequence[bool]) -> float:
    """1 - cosine of the program's leaf and the reference's, worst leaf."""
    out = 0.0
    for p, r, k in zip(prog, ref, keep):
        if k:
            p, r = p.double().reshape(-1), r.double().reshape(-1)
            cos = float(p @ r / (p.norm() * r.norm()).clamp_min(1e-300))
            out = max(out, 1.0 - cos if math.isfinite(cos) else math.inf)
    return out


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if not all(math.isfinite(v) for v in prog):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def readings(prog_losses, ref_losses, prog_grad, ref_grad, prog_change,
             ref_change) -> Dict[str, float]:
    keep = counted(ref_grad)
    return {"loss_gap": loss_gap(prog_losses, ref_losses),
            "grad_gap": norm_gap(prog_grad, ref_grad, keep),
            "change_gap": norm_gap(prog_change, ref_change, keep),
            "grad_dir": direction_gap(prog_grad, ref_grad, keep),
            "change_dir": direction_gap(prog_change, ref_change, keep),
            "leaves_counted": float(sum(keep)), "leaves": float(len(keep))}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)
