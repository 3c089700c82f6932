"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference works out again.

``rel_gap``: the largest absolute difference over the reference's largest
magnitude (a whole map or tensor at once). ``norm_gap``: for training, the
worst leaf's gap between the program's norm and the reference's, over the
larger of that leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch


def rel_gap(program, reference) -> float:
    p = torch.as_tensor(np.asarray(program) if not torch.is_tensor(program) else program)
    r = torch.as_tensor(np.asarray(reference) if not torch.is_tensor(reference) else reference)
    p, r = p.detach().to("cpu", torch.float64), r.detach().to("cpu", torch.float64)
    if p.shape != r.shape:
        return float("inf")
    scale = float(r.abs().max())
    return float((p - r).abs().max()) / scale if scale > 0 else float((p - r).abs().max())


def worst(gaps: Iterable[float]) -> float:
    gaps = list(gaps)
    return max(gaps) if gaps else float("inf")


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    names = list(reference if keep is None else keep)
    median = float(np.median([reference[n] for n in names]))
    return worst(abs(program[n] - reference[n]) / max(reference[n], median) for n in names)
