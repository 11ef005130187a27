"""Task facade (counterpart of saunet_tpu/models/segmentation_module.py):
the reference's SegmentationModule surface as three methods.

  train(batch)       -> (loss, (acc, jaccard))   train mode
  predict(image)     -> softmax probs (+ the attention maps)
  infer_loss(batch)  -> (probs, loss)            eval mode

Layouts are the JAX facade's: NHWC images (N, H, W, 3), labels (N, H, W),
edge targets (N, H, W, 1), probabilities and maps NHWC. Where the JAX
facade returns the new batch statistics, `train` leaves them in the
model's BatchNorms. Gradients follow the caller's grad mode, as the JAX
functions are pure and differentiable.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..train.losses import DEFAULT_CLASS_WEIGHTS, dual_loss
from ..train.metrics import pixel_acc


class SegmentationModule:
    def __init__(self, model, num_class: int = 4,
                 class_weights: Sequence[float] = DEFAULT_CLASS_WEIGHTS):
        self.model = model
        self.num_class = num_class
        self.class_weights = tuple(class_weights)

    def _forward(self, image: torch.Tensor, train: bool,
                 return_att: bool = False):
        self.model.train(train)
        out = self.model(image.permute(0, 3, 1, 2), return_att=return_att)
        seg, edge = out[0].permute(0, 2, 3, 1), out[1].permute(0, 2, 3, 1)
        if return_att:
            return seg, edge, [a.permute(0, 2, 3, 1) for a in out[2]]
        return seg, edge

    def _loss(self, seg, edge, batch: Dict[str, torch.Tensor]):
        loss, _ = dual_loss(seg, edge, batch["label"], batch["edge"],
                            self.class_weights)
        return loss

    def train(self, batch: Dict[str, torch.Tensor]):
        """Train-mode forward, the dual loss and the pixel metrics:
        (loss, (acc, jaccard)); the running statistics move."""
        seg, edge = self._forward(batch["image"], train=True)
        loss = self._loss(seg, edge, batch)
        with torch.no_grad():
            acc, jaccard = pixel_acc(seg.argmax(dim=-1), batch["label"],
                                     self.num_class)
        return loss, (acc, jaccard)

    def predict(self, image: torch.Tensor, return_att: bool = False):
        """Eval-mode softmax probabilities, and with `return_att` the 7
        attention and gate maps."""
        if return_att:
            seg, _, atts = self._forward(image, train=False, return_att=True)
            return torch.softmax(seg, dim=-1), atts
        seg, _ = self._forward(image, train=False)
        return torch.softmax(seg, dim=-1)

    def infer_loss(self, batch: Dict[str, torch.Tensor]):
        """Eval-mode (probs, loss)."""
        seg, edge = self._forward(batch["image"], train=False)
        return torch.softmax(seg, dim=-1), self._loss(seg, edge, batch)
