"""Inference step (counterpart of saunet_tpu/train/state.py::make_infer_step).

`InferState` (model + device, plus the dense-block operands folded once)
takes the place of the JAX package's TrainState for serving. The step is
`_fused_forward`'s counterpart: the kernel encoder, then `SAUNet.decode`.
Layouts at the step are the JAX package's: NHWC images in, (N, H, W)
predictions out, NHWC probabilities, edge and attention maps.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.fused_encoder import encoder_apply_fused, fold_encoder


class InferState:
    """A model in eval mode on `device`, with its dense-block kernel
    operands folded once (re-create the state after changing weights)."""

    def __init__(self, model, device: Optional[torch.device | str] = None):
        self.device = torch.device(device if device is not None else "cpu")
        self.model = model.to(self.device).eval()
        self.folded = fold_encoder(self.model.encoder, model.dtype)


def make_infer_step(model, with_probs: bool = False, with_edge: bool = False,
                    with_att: bool = False):
    """Inference: `step(state, images)` -> (probs, preds, edge), plus the 7
    attention/gate maps as a fourth element when `with_att` is set.

    images: (N, H, W, 3). preds: (N, H, W) int64. probs (N, H, W, C) and
    edge (N, H, W, 1) are None unless `with_probs` / `with_edge` is set.
    As in the JAX step, `model` is the computation and `state` holds its
    weights: `state` must have been made from `model`."""

    def step(state: InferState, images: torch.Tensor):
        m = state.model
        if m is not model:
            raise ValueError("make_infer_step: state holds another model")
        with torch.inference_mode():
            x = images.to(state.device)
            _, *taps = encoder_apply_fused(m.encoder, state.folded, x, m.dtype)
            out = m.decode([t.permute(0, 3, 1, 2) for t in taps],
                           x.permute(0, 3, 1, 2), return_att=with_att)
            seg, edge_full = out[0], out[1]
            preds = seg.argmax(dim=1)
            probs = (torch.softmax(seg, dim=1).permute(0, 2, 3, 1)
                     if with_probs else None)
            edge = edge_full.permute(0, 2, 3, 1) if with_edge else None
            if with_att:
                return probs, preds, edge, [a.permute(0, 2, 3, 1)
                                            for a in out[2]]
            return probs, preds, edge

    return step
