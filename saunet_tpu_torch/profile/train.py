"""The train step by segment (counterpart of tools/profile_train.py, and,
in `output_layout`, of tools/exp_output_layout.py).

The forward in train mode with its loss is split inside one eager pass
(`Segments`: CUDA events at forward hooks of the model's own modules):
encoder, shape stream, Canny, edge fusion, decoder (center .. dec2), head
(dec1, dec0, final), loss. Autograd keeps no forward ranges in the
backward, so the backward is attributed as the JAX tool attributes the
whole: by cumulative objectives, each timed fwd+bwd (grad of the encoder
alone, of encoder and shape stream, of the full loss, then the whole
step); the backward of a part is its fwd+bwd delta less its forward
segments. With `decoder` the decoder's stages get cumulative objectives
of their own (resizes + center, dec5 .. dec2; then Canny + edge fusion,
dec1, dec0, head), mirroring `SAUNet.decode`.

Options are the port's own knobs: `concat` ('chain', 'buffer', 'fused')
and `remat` of models/densenet.py, and `augment`, the step's augmentation
(the warp on K5) in front of it. The step is `make_train_step` with
radam(1e-4), as the JAX tool's.
"""
from __future__ import annotations

import statistics
import time

import torch

from ..data import make_augment_fn
from ..models.blocks import max_pool_2x2
from ..ops.edge import image_to_gray255
from ..ops.resize import resize_bilinear
from ..train import create_train_state, dual_loss, make_train_step, radam
from ..train.metrics import pixel_acc
from . import common

TOOL = ("tools/profile_train.py", "tools/profile_augment.py")
STEPS = 10
FORWARD = ("encoder", "shape_stream", "canny", "edge_fusion", "decoder",
           "head", "loss")
#: the forward segments each fwd+bwd delta holds
DELTAS = {"encoder": ("encoder",), "stream": ("shape_stream",),
          "decoder_edge_loss": ("canny", "edge_fusion", "decoder", "head",
                                "loss")}
DECODER_STAGES = ("resizes+center", "dec5", "dec4", "dec3", "dec2")
TAIL_STAGES = ("canny+edge fusion", "dec1", "dec0", "head")
LR = 1e-4


def forward_cuts(model):
    """(begin before, begin after) {module: segment} of the train forward."""
    before = {model.encoder.conv0: "encoder", model.d0: "shape_stream",
              model.cw: "edge_fusion", model.dec1: "head"}
    after = {model.fuse: "canny", model.expand: "decoder"}
    return before, after


def loss_of(model, batch):
    """The step's objective: the train-mode forward and the dual loss."""
    seg, edge = model(batch["image"].permute(0, 3, 1, 2))
    return dual_loss(seg.permute(0, 2, 3, 1), edge.permute(0, 2, 3, 1),
                     batch["label"], batch["edge"])


def forward_pass(model, batch, seg=common.NO_SEGMENTS):
    """The train-mode forward and loss, split into FORWARD's segments."""
    with seg.at_modules(*forward_cuts(model)):
        s, edge = model(batch["image"].permute(0, 3, 1, 2))
        seg.begin("loss")
        total, _ = dual_loss(s.permute(0, 2, 3, 1), edge.permute(0, 2, 3, 1),
                             batch["label"], batch["edge"])
        seg.end()
    return total


def encoder_objective(model, x):
    """tools/profile_train.py's `enc_loss`: the mean square of every tap."""
    taps = model.encoder(x)
    return sum(t.float().square().mean() for t in taps)


def stream_objective(model, x):
    """`ss_loss`: the taps' mean squares and the shape stream's mean."""
    taps = model.encoder(x)
    edge_out, _ = model.shape_stream(taps[1:], x)
    return sum(t.float().square().mean() for t in taps) + edge_out.mean()


def decoder_stages(model, x, stage: int) -> list:
    """The outputs of `SAUNet.decode`'s trunk up to `stage` (0: the skip
    resizes and center; 1-4: dec5 .. dec2; 5: Canny and the edge fusion;
    6: dec1; 7: dec0; 8: the head's logits, last), after the encoder and
    the shape stream (whose edge map is the first output); `x` is the
    NCHW input in the model's dtype. Mirrors `decode` without a 'space'
    axis."""
    conv2, conv3, conv4, conv5 = taps = model.encoder(x)[1:]
    edge_out, _ = model.shape_stream(taps, x)

    def up2(t):
        return resize_bilinear(t, (t.shape[2] * 2, t.shape[3] * 2))

    conv2u, conv3u, conv4u = (up2(c) for c in (conv2, conv3, conv4))
    d = model.center(max_pool_2x2(conv5))
    outs = [edge_out, conv2u, conv3u, conv4u, d]
    for blk, skip in ((model.dec5, conv5), (model.dec4, conv4u),
                      (model.dec3, conv3u), (model.dec2, conv2u))[:stage]:
        d, _ = blk(d, skip)
        outs.append(d)
    if stage >= 5:
        dt = model.dtype
        canny = model._canny(image_to_gray255(x.permute(0, 2, 3, 1)))
        acts = torch.sigmoid(model.cw(torch.cat(
            [edge_out.to(dt), canny.to(dt).permute(0, 3, 1, 2)], 1)))
        edge = model.expand(acts)
        outs.append(edge)
    if stage >= 6:
        d = model.dec1(d)
        outs.append(d)
    if stage >= 7:
        d = model.dec0(torch.cat([d, edge], dim=1))
        outs.append(d)
    if stage >= 8:
        outs.append(model.final(d).float())
    return outs


def step_body(model, state, batch, radam: bool = True,
              metrics: bool = True):
    """`make_train_step`'s math on a batch that needs no augmentation:
    the train-mode forward, the dual loss, backward, then (`radam`) the
    update and (`metrics`) the argmax and `pixel_acc`; returns (loss
    parts, acc, jaccard), the last two None without `metrics`."""
    model.train()
    s, edge = model(batch["image"].permute(0, 3, 1, 2))
    s = s.permute(0, 2, 3, 1)
    total, parts = dual_loss(s, edge.permute(0, 2, 3, 1), batch["label"],
                             batch["edge"])
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    if radam:
        state.optimizer.step()
    acc = jaccard = None
    if metrics:
        with torch.no_grad():
            acc, jaccard = pixel_acc(s.argmax(dim=-1), batch["label"], 4)
    return {k: v.detach() for k, v in parts.items()}, acc, jaccard


def setup(device, batch: int, hw: int, concat: str = "chain",
          remat: bool = False, augment: bool = False):
    """(model in train mode, state, step, the step's batch, the fixed
    batch the objectives take, the augmentation's generator)."""
    gen = torch.Generator().manual_seed(common.SEED)
    model = common.seeded_model(device, hw, gen, encoder_concat=concat,
                                remat=remat).train()
    tx = radam(LR)
    state = create_train_state(model, tx, device)
    data = common.synthetic_batch(gen, batch, hw, device)
    augment_fn = make_augment_fn() if augment else None
    dgen = torch.Generator(device=device).manual_seed(common.SEED + 1)
    step_batch = data
    if augment:
        step_batch = {"image": data["image"][..., 0].contiguous(),
                      "label": data["label"]}
        data = augment_fn(dgen, step_batch)
    step = make_train_step(model, tx, augment_fn=augment_fn)
    return model, state, step, step_batch, data, dgen


def fwd_bwd(model, objective):
    """One fwd+bwd of `objective()`, gradients cleared first as the step
    clears them."""
    def run():
        model.zero_grad(set_to_none=True)
        objective().backward()
    return run


def run(device=None, batch: int = common.PROF_BATCH, hw: int = common.PROF_HW,
        steps: int = STEPS, concat: str = "chain",
        remat: bool = False, augment: bool = False,
        decoder: bool = False) -> dict:
    device = common.device_of(device)
    model, state, step, step_batch, data, dgen = setup(
        device, batch, hw, concat, remat, augment)
    x = data["image"].permute(0, 3, 1, 2).to(model.dtype)
    launches = common.check_launches(
        lambda: step(state, step_batch, dgen),
        {"canny_edges_cuda": 1, "warp_image_label": int(augment)}, device,
        "train step")

    fwd, _ = common.segment_ms(lambda seg: forward_pass(model, data, seg),
                               device, steps)
    rows = [common.row(f"fwd/{s}", ms, "fwd only (train mode, loss)")
            for s, ms in fwd.items()]
    t = {}
    for name, fn, jax in (
            ("forward_loss", lambda: forward_pass(model, data),
             "fwd only (train mode, loss)"),
            ("grad_encoder", fwd_bwd(model, lambda: encoder_objective(
                model, x)), "grad: encoder only"),
            ("grad_encoder_stream", fwd_bwd(model, lambda: stream_objective(
                model, x)), "grad: encoder+shape stream"),
            ("grad_full", fwd_bwd(model, lambda: loss_of(model, data)[0]),
             "grad: full loss"),
            ("step", lambda: step(state, step_batch, dgen),
             "train step (grad+RAdam)")):
        t[name] = common.whole_ms(fn, device, steps)
        rows.append(common.row(name, t[name], jax))
    if augment:
        aug = make_augment_fn()
        t["augment"] = common.whole_ms(lambda: aug(dgen, step_batch), device,
                                       steps)
        rows.append(common.row("augment", t["augment"],
                               "FULL augment (deform)"))
    fb = {"encoder": t["grad_encoder"],
          "stream": t["grad_encoder_stream"] - t["grad_encoder"],
          "decoder_edge_loss": t["grad_full"] - t["grad_encoder_stream"]}
    for part, ms in fb.items():
        rows.append(common.row(f"{part}_fwd_bwd", ms,
                               "segment deltas (fwd+bwd)"))
        rows.append(common.row(f"{part}_bwd", ms - sum(
            fwd[s] for s in DELTAS[part]), "segment deltas (fwd+bwd)"))
    rows.append(common.row("optimizer_metrics", t["step"] - t["grad_full"]
                           - t.get("augment", 0.0),
                           "segment deltas (fwd+bwd)"))
    if decoder:
        rows += decoder_rows(model, x, t, device, steps)
    return common.report("train", device, ", ".join(TOOL), rows, batch=batch,
                         hw=hw, steps=steps, concat=concat, remat=remat,
                         augment=augment, launches=launches)


def decoder_rows(model, x, t: dict, device, steps: int) -> list:
    """Cumulative fwd+bwd through each decoder stage (objective: the mean
    of every output so far), and each stage's delta."""
    rows = []
    prev = t["grad_encoder_stream"]
    for stage, name in enumerate(DECODER_STAGES + TAIL_STAGES):
        ms = common.whole_ms(fwd_bwd(model, lambda: sum(
            o.float().mean() for o in decoder_stages(model, x, stage))),
            device, steps)
        rows.append(common.row(f"grad_..+{name}", ms, "grad: ..+"))
        rows.append(common.row(name, ms - prev, name))
        prev = ms
    rows.append(common.row("dual loss", t["grad_full"] - prev,
                           "packed dual loss"))
    return rows


def output_layout(device=None, batch: int = common.PROF_BATCH,
                  hw: int = common.PROF_HW, steps: int = STEPS) -> dict:
    """tools/exp_output_layout.py: the step's math with three return
    structures, timed in turns (A, B, C, C, B, A, ...), host clock to a
    loss read back. Under jit the structure chose XLA's fusion schedule;
    eager PyTorch runs the same kernels whatever it returns, so the three
    should agree within noise: `agree` records whether the spread of the
    medians is within the largest of the variants' own interquartile
    ranges."""
    device = common.device_of(device)
    model, state, step, _, data, dgen = setup(device, batch, hw)

    def rng_arg(st, gen):  # A: an argument it does not use
        parts, acc, jaccard = step_body(model, st, data)
        return parts["loss"], acc, jaccard, st

    def step_plus_1(st):  # C: the step count moved
        parts, acc, jaccard = step_body(model, st, data)
        st.step += 1
        return parts["loss"], acc, jaccard, st

    variants = {  # B: (state, metrics dict), make_train_step's own form
        "A rng-arg": lambda: rng_arg(state, dgen)[0],
        "B dict": lambda: step(state, data)[1]["loss"],
        "C step+1": lambda: step_plus_1(state)[0],
    }
    times = {name: [] for name in variants}
    if device.type == "cuda":
        for fn in variants.values():
            float(fn())
    for i in range(steps):
        order = list(variants) if i % 2 == 0 else list(variants)[::-1]
        for name in order:
            t0 = time.perf_counter()
            float(variants[name]())
            times[name].append((time.perf_counter() - t0) * 1e3)
    medians = {k: statistics.median(v) for k, v in times.items()}

    def iqr(v):
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
        return q[2] - q[0]

    spread = max(medians.values()) - min(medians.values())
    noise = max(iqr(v) for v in times.values())
    rows = [common.row(name, ms, name) for name, ms in medians.items()]
    return common.report("output_layout", device, "tools/exp_output_layout.py",
                         rows, batch=batch, hw=hw, steps=steps,
                         spread_ms=spread, noise_ms=noise,
                         agree=spread <= noise)
