"""The inference step by segment (counterpart of tools/profile_infer.py and
tools/profile_infer_seg.py; tools/profile_infer_seg_packed.py's geometry,
512^2 at batch 8, is this mode with `--hw 512 --batch 8`: the port has one
layout, so there is no packed twin).

Three routes of the eval forward, each split into segments inside one
eager pass (`Segments`: CUDA events at the cut points; forward hooks on
the model's own modules, so its code runs unchanged):

  k3:    the infer step's route on the card: the fused encoder with the
         dense-block kernel (K3), then `decode` with the module shape
         stream and Canny (K1), then the argmax;
  cudnn: `model.forward`: the module encoder (cuDNN), the same decode;
  k4:    the K4 route: the fused encoder, `shape_stream_inputs`, the
         shape-stream kernel (K4), `decode(edge_out=...)`.

Segments: stem, block1..block4, trans1..trans3, norm5 (the encoder's
end), the shape stream (or its packed inputs and K4), Canny, the edge
fusion (cw, expand), the dual-attention decoder (center .. dec2), the
head (dec1, dec0, final) and the argmax. XLA fuses across its cut points,
so the JAX tool times cumulative prefixes; eager PyTorch does not, so a
segment here is timed directly, and the whole of each route is timed
apart, uninstrumented, beside the sum of its segments.
"""
from __future__ import annotations

import torch

from ..models.fused_encoder import encoder_apply_fused
from ..ops.cuda import (
    dense_block,
    fold_shape_stream_params,
    shape_stream_fused,
)
from ..train import InferState, make_infer_step
from . import common

TOOL = "tools/profile_infer_seg.py, tools/profile_infer.py"
STEPS = 20
ENCODER = ("stem", "block1", "trans1", "block2", "trans2", "block3",
           "trans3", "block4", "norm5")
DECODE = ("shape_stream", "canny", "edge_fusion", "decoder", "head")
#: each segment -> the row of the JAX tools that holds it
JAX_NAMES = {
    **{n: n for n in ENCODER[:-1]}, "norm5": "encoder",
    "shape_stream": "+ shape stream (packed)",
    "stream_inputs": "+ shape stream (packed)",
    "k4": "+ shape stream (packed)",
    "canny": "+ decoder/tail (packed)",
    "edge_fusion": "+ decoder/tail (packed)",
    "decoder": "+ decoder/tail (packed)",
    "head": "+ decoder/tail (packed)",
    "argmax": "+ packed argmax [CAND]",
    "resizes": "+ decoder/tail (packed)",
}
#: the uninstrumented wholes -> the JAX tools' rows (each route's whole
#: pass: the JAX tool's whole program)
WHOLE_NAMES = {"infer_step": "shipping infer (dense)",
               "encoder_fused": "encoder fused",
               "encoder_cudnn": "encoder XLA",
               "decode": "decode (shape+dec+edge)",
               "route": "full __call__ (XLA enc)"}
#: kernel launches of one pass of each route on the card
LAUNCHES = {"k3": {"canny_edges_cuda": 1, "dense_block": 4},
            "cudnn": {"canny_edges_cuda": 1},
            "k4": {"canny_edges_cuda": 1, "dense_block": 4,
                   "shape_stream_fused": 1}}


def decode_cuts(model, stream: bool = True):
    """Forward hooks of `decode`'s segments: (begin before, begin after)
    {module: segment}. With `stream` the module shape stream begins at d0
    and Canny when `fuse` returns; without, the caller begins Canny."""
    before = {model.cw: "edge_fusion", model.dec1: "head"}
    after = {model.expand: "decoder"}
    if stream:
        before[model.d0] = "shape_stream"
        after[model.fuse] = "canny"
    return before, after


def encoder_cuts(encoder) -> dict:
    """{module: segment} of the module encoder (the cuDNN route)."""
    cuts = {encoder.conv0: "stem", encoder.norm5: "norm5"}
    for i in range(len(encoder.block_config)):
        cuts[getattr(encoder, f"denseblock{i + 1}")] = f"block{i + 1}"
        if i < len(encoder.block_config) - 1:
            cuts[getattr(encoder, f"transition{i + 1}")] = f"trans{i + 1}"
    return cuts


def k3_block(seg, n_blocks: int = 4):
    """The `block` of `encoder_apply_fused`: the dense-block kernel, with
    block i's segment begun before it and the next (trans i, or norm5
    after the last) as it returns."""
    count = [0]

    def block(h, folded):
        count[0] += 1
        i = count[0]
        seg.begin(f"block{i}")
        out = dense_block(h, folded)
        seg.begin(f"trans{i}" if i < n_blocks else "norm5")
        return out

    return block


def fused_taps(model, folded, images, seg=common.NO_SEGMENTS):
    """The fused encoder's taps f2..f5 (NCHW) of NHWC `images`."""
    seg.begin("stem")
    _, *taps = encoder_apply_fused(
        model.encoder, folded, images, model.dtype,
        block=k3_block(seg, len(model.encoder.block_config)))
    return [t.permute(0, 3, 1, 2) for t in taps]


def k3_pass(model, folded, images, seg=common.NO_SEGMENTS):
    """The infer step's route on the card (`_forward_eval` with the fused
    encoder, then the argmax): (logits NCHW, preds)."""
    x = images.permute(0, 3, 1, 2)
    with torch.inference_mode(), seg.at_modules(*decode_cuts(model)):
        taps = fused_taps(model, folded, images, seg)
        logits = model.decode(taps, x)[0]
        seg.begin("argmax")
        preds = logits.argmax(dim=1)
        seg.end()
    return logits, preds


def cudnn_pass(model, images, seg=common.NO_SEGMENTS):
    """`model.forward` (the module encoder), then the argmax."""
    before, after = decode_cuts(model)
    before.update(encoder_cuts(model.encoder))
    with torch.inference_mode(), seg.at_modules(before, after):
        logits = model(images.permute(0, 3, 1, 2))[0]
        seg.begin("argmax")
        preds = logits.argmax(dim=1)
        seg.end()
    return logits, preds


def k4_pass(model, folded, folded_stream, images, seg=common.NO_SEGMENTS):
    """The K4 route: fused encoder, `shape_stream_inputs`, K4,
    `decode(edge_out=...)`, then the argmax."""
    x = images.permute(0, 3, 1, 2)
    with torch.inference_mode(), seg.at_modules(*decode_cuts(model, False)):
        taps = fused_taps(model, folded, images, seg)
        seg.begin("stream_inputs")
        packed = model.shape_stream_inputs(taps, x)
        seg.begin("k4")
        edge = shape_stream_fused(packed, folded_stream)
        seg.begin("canny")
        logits = model.decode(taps, x, edge_out=edge.permute(0, 3, 1, 2))[0]
        seg.begin("argmax")
        preds = logits.argmax(dim=1)
        seg.end()
    return logits, preds


def run(device=None, batch: int = common.PROF_BATCH, hw: int = common.PROF_HW,
        steps: int = STEPS) -> dict:
    device = common.device_of(device)
    gen = torch.Generator().manual_seed(common.SEED)
    model = common.seeded_model(device, hw, gen)
    state = InferState(model, device)
    folded_stream = fold_shape_stream_params(model)
    images = common.synthetic_batch(gen, batch, hw, device)["image"]
    step = make_infer_step(model)

    passes = {
        "k3": lambda seg=common.NO_SEGMENTS: k3_pass(
            model, state.folded, images, seg),
        "cudnn": lambda seg=common.NO_SEGMENTS: cudnn_pass(
            model, images, seg),
        "k4": lambda seg=common.NO_SEGMENTS: k4_pass(
            model, state.folded, folded_stream, images, seg),
    }
    launches = {name: common.check_launches(fn, LAUNCHES[name], device,
                                            f"infer {name} route")
                for name, fn in passes.items()}
    launches["infer_step"] = common.check_launches(
        lambda: step(state, images), LAUNCHES["k3"], device, "infer step")

    rows, routes = common.route_rows(passes, device, steps, JAX_NAMES,
                                     WHOLE_NAMES["route"])
    x = images.permute(0, 3, 1, 2)

    def enc_fused():
        with torch.inference_mode():
            return fused_taps(model, state.folded, images)

    def enc_cudnn():
        with torch.inference_mode():
            return model.encoder(x.to(model.dtype))

    taps = enc_fused()

    def decode():
        with torch.inference_mode():
            return model.decode(taps, x)

    for name, fn in (("infer_step", lambda: step(state, images)),
                     ("encoder_fused", enc_fused),
                     ("encoder_cudnn", enc_cudnn), ("decode", decode)):
        rows.append(common.row(name, common.whole_ms(fn, device, steps),
                               WHOLE_NAMES[name]))
    return common.report("infer", device, TOOL, rows, batch=batch, hw=hw,
                         steps=steps, routes=routes, launches=launches)
