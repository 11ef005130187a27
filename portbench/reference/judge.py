"""The comparisons that decide `correct`, each number beside its limit.

Serving (the readings of every pixel of the checked volumes' gap, by
which the reference's logit of the served label lies below the
reference's best logit):
  mean_gap    the mean gap, the number compared;
  widest_gap  the widest, p999_gap the 99.9th percentile and flip_share
              the share of pixels whose label is not the reference's best,
              read beside it (the widest gap swings from seed to seed by
              as much as a control in the precision below moves it, so it
              cannot hold a limit between the two).

A cell's limits file names the numbers compared; every other reading is
reported and not judged.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

Check = Tuple[str, float, float]


def pixel_gaps(ref_logits: torch.Tensor, labels: torch.Tensor):
    """ref_logits (N, C, H, W), labels (N, H, W): each pixel's gap by which
    the reference's logit of the label lies below its best."""
    best = ref_logits.max(dim=1).values
    return best - ref_logits.gather(1, labels.long()[:, None])[:, 0]


def serve_readings(gaps: torch.Tensor) -> dict:
    """Of every checked pixel's gap: the widest, the mean, the 99.9th
    percentile, and the share of pixels whose label is not the reference's
    best."""
    flat = gaps.float().flatten()
    k = max(1, int(round(0.999 * flat.numel())))
    return {"widest_gap": float(flat.max()), "mean_gap": float(flat.mean()),
            "p999_gap": float(flat.kthvalue(k).values),
            "flip_share": float((flat > 0).float().mean())}


def passed(checks: List[Check]) -> bool:
    return all(v == v and v <= limit for _, v, limit in checks)
