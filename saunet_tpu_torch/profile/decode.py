"""`SAUNet.decode` by segment (counterpart of tools/profile_decode.py): the
shape stream, the edge fusion (Canny and the `cw` conv, then `expand`),
the dual-attention decoder (center .. dec2) and the head (dec1, dec0,
final), with the bilinear resizes inside the stream and the decoder
given a segment of their own. The inputs are the taps of the fused
encoder (models/fused_encoder.py), computed once.

Two routes of the stream: the module stream, and the K4 route's
`shape_stream_inputs` and shape-stream kernel (K4) before
`decode(edge_out=...)`. Each is split inside one eager pass, and timed
whole apart, uninstrumented.
"""
from __future__ import annotations

import contextlib

import torch

from ..models import saunet as saunet_module
from ..ops.cuda import fold_shape_stream_params, shape_stream_fused
from ..train import InferState
from . import common
from .infer import decode_cuts, fused_taps

TOOL = "tools/profile_decode.py"
STEPS = 20
JAX_NAMES = {"shape_stream": "shape stream (full res)",
             "stream_inputs": "shape stream (full res)",
             "k4": "shape stream (full res)",
             "edge_fusion": "edge fusion (canny+cw)",
             "decoder": "dual-att decoder + head",
             "head": "dual-att decoder + head",
             "resizes": "resizes"}
WHOLE_NAMES = {"route": "SAUNet.decode",
               "shape_stream": "shape stream (full res)"}
LAUNCHES = {"module": {"canny_edges_cuda": 1},
            "k4": {"canny_edges_cuda": 1, "shape_stream_fused": 1}}


@contextlib.contextmanager
def resizes_inside(seg):
    """Within the block, every bilinear resize the SAUNet makes is timed
    as the segment 'resizes' (the model module's `resize_bilinear`, which
    its stream, stream inputs and decoder call, wrapped)."""
    real = saunet_module.resize_bilinear

    def timed(*args, **kwargs):
        with seg.inside("resizes"):
            return real(*args, **kwargs)

    saunet_module.resize_bilinear = timed
    try:
        yield
    finally:
        saunet_module.resize_bilinear = real


def _resizes(seg):
    return (contextlib.nullcontext() if seg is common.NO_SEGMENTS
            else resizes_inside(seg))


def module_pass(model, taps, x, seg=common.NO_SEGMENTS):
    """`decode(taps, x)` with the module stream: (logits, edge_out)."""
    before, after = decode_cuts(model)
    # Canny begins as the stream's `fuse` returns; the edge fusion's
    # segment holds Canny and the cw conv, as the JAX tool's row does
    after[model.fuse] = "edge_fusion"
    del before[model.cw]
    with torch.inference_mode(), seg.at_modules(before, after), \
            _resizes(seg):
        out = model.decode(taps, x)
        seg.end()
    return out


def k4_pass(model, taps, x, folded_stream, seg=common.NO_SEGMENTS):
    """`shape_stream_inputs`, K4, then `decode(edge_out=...)`."""
    before, after = decode_cuts(model, stream=False)
    del before[model.cw]
    with torch.inference_mode(), seg.at_modules(before, after), \
            _resizes(seg):
        seg.begin("stream_inputs")
        packed = model.shape_stream_inputs(taps, x)
        seg.begin("k4")
        edge = shape_stream_fused(packed, folded_stream)
        seg.begin("edge_fusion")
        out = model.decode(taps, x, edge_out=edge.permute(0, 3, 1, 2))
        seg.end()
    return out


def run(device=None, batch: int = common.PROF_BATCH, hw: int = common.PROF_HW,
        steps: int = STEPS) -> dict:
    device = common.device_of(device)
    gen = torch.Generator().manual_seed(common.SEED)
    model = common.seeded_model(device, hw, gen)
    state = InferState(model, device)
    folded_stream = fold_shape_stream_params(model)
    images = common.synthetic_batch(gen, batch, hw, device)["image"]
    x = images.permute(0, 3, 1, 2).to(model.dtype)
    with torch.inference_mode():
        taps = fused_taps(model, state.folded, images)

    passes = {
        "module": lambda seg=common.NO_SEGMENTS: module_pass(
            model, taps, x, seg),
        "k4": lambda seg=common.NO_SEGMENTS: k4_pass(
            model, taps, x, folded_stream, seg),
    }
    launches = {name: common.check_launches(fn, LAUNCHES[name], device,
                                            f"decode {name} route")
                for name, fn in passes.items()}
    rows, routes = common.route_rows(passes, device, steps, JAX_NAMES,
                                     WHOLE_NAMES["route"])

    def stream():
        with torch.inference_mode():
            return model.shape_stream(taps, x)

    rows.append(common.row("shape_stream", common.whole_ms(
        stream, device, steps), WHOLE_NAMES["shape_stream"]))
    return common.report("decode", device, TOOL, rows, batch=batch, hw=hw,
                         steps=steps, routes=routes, launches=launches)
