"""Multi-scale masked depth losses (counterpart of dvmvs_tpu/utils/losses.py).

Valid pixels are selected with masked sums, so every loss is a fixed-shape
reduction: ground truth 0 marks an invalid pixel. The training drivers use
L1-inv, |1/gt - 1/pred| over valid pixels.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from dvmvs_tpu_torch.ops.sampling import resize_nearest

LOSS_TYPES = ("L1", "L1-inv", "L1-rel", "Huber")
LOSS_KEY = {"L1": "l1", "L1-inv": "l1_inv", "L1-rel": "l1_rel", "Huber": "huber"}


def calculate_loss(groundtruth: torch.Tensor, prediction: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Loss sums for one prediction scale: groundtruth (B, H, W) full-res
    depth (0 = invalid), prediction (B, h, w) at any scale. The ground truth
    is nearest-downsampled to the prediction's scale. Returns scalar sums and
    ``valid_count``."""
    h, w = prediction.shape[-2:]
    gt = resize_nearest(groundtruth, h, w)
    valid = gt != 0
    mask = valid.to(prediction.dtype)
    safe_gt = torch.where(valid, gt, torch.ones_like(gt))
    absdiff = (gt - prediction).abs()
    diff = absdiff * mask
    # torch smooth_l1_loss (beta=1): 0.5 x^2 if |x| < 1 else |x| - 0.5
    huber = torch.where(absdiff < 1.0, 0.5 * absdiff ** 2, absdiff - 0.5) * mask
    l1_inv = (1.0 / safe_gt - 1.0 / prediction).abs() * mask
    return {
        "l1": diff.sum(),
        "huber": huber.sum(),
        "l1_inv": l1_inv.sum(),
        "l1_rel": (diff / safe_gt).sum(),
        "valid_count": mask.sum(),
    }


def multi_scale_loss(predictions: Sequence[torch.Tensor], weights: Sequence[float],
                     groundtruth: torch.Tensor, loss_type: str = "L1-inv", group=None):
    """sum_j w_j * (loss_j / valid_count_j); returns (loss, the last scale's
    terms). With a data-parallel ``group``, valid_count_j is the global
    batch's (all-reduced), so the group's losses sum to the loss of the
    global batch; the returned terms stay this rank's."""
    key = LOSS_KEY[loss_type]
    terms = [calculate_loss(groundtruth, pred) for pred in predictions]
    counts = [t["valid_count"] for t in terms]
    if group is not None:
        import torch.distributed as dist

        summed = torch.stack(counts)
        dist.all_reduce(summed, group=group)
        counts = list(summed)
    total = 0.0
    for w, t, count in zip(weights, terms, counts):
        total = total + w * (t[key] / torch.clamp(count, min=1.0))
    return total, terms[-1]


class LossMeter:
    """Host-side running average."""

    def __init__(self):
        self.count = 0.0
        self.sum = 0.0
        self.avg = 0.0
        self.item_average = 0.0

    def update(self, loss: float, count: float):
        self.sum += loss
        self.count += count
        self.avg = self.sum / self.count
        self.item_average = loss / count

    def __repr__(self):
        return f"{self.item_average:.4f} ({self.avg:.4f})"
