#!/usr/bin/env python3
"""Smoke run of the PyTorch port (saunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device: the card's name and power limit, torch and CUDA versions; TF32
     off for every f32 product, so the plain references are full f32.
  2. build: the four CUDA kernels (canny, dense_block, shape_stream, warp)
     from csrc/ into build/, the nvcc processes in parallel; ptxas's
     registers, shared memory and spills of every kernel.
  3. kernels vs plain, on the tensors the main path gives them: Canny on
     the gray images of 64 slices at 224^2 and on (8, 512, 512), exact (0
     flips), with its device time per call at both sizes; the
     dense block on the inputs of DenseNet-121's four blocks for those 64
     slices, bf16, within 0.05*max|ref| and a median under a tenth of that.
     Median times over 20 runs (CUDA events); each block's time beside its
     own bound and its device time per launch kind (torch.profiler).
  4. main path: full-width bf16 SAUNet with seeded random weights and BN
     statistics calibrated on synthetic slices, `make_infer_step` on 64
     slices at 224^2. The launch counters are zeroed just before and read
     just after: 1 Canny and 4 dense-block launches. The encoder taps are
     held against the all-plain bf16 route within 0.05*max|ref|; the
     logits' argmax agrees on >= 0.95 of pixels, and the kernel route is no
     farther from an f32 plain run than the plain bf16 route is. Slices/s
     of both routes.
  4b. shape-stream kernel (K4) on the main path's tensors: the packed
     (64, 224, 224, 67) input that `SAUNet.shape_stream_inputs` makes from
     the kernel encoder's taps, the kernel against `shape_stream_plain`
     within max|d| 0.04 and median 0.004; where the random model's stream
     is chaotic (rounding flips amplified), p99.9|d| within 0.04, the
     median within 0.004, and the kernel no farther from an f32 stream than
     the plain bf16 version, with the reason logged. Median times of the
     kernel, the plain version and the port's cuDNN `model.shape_stream`,
     and the device time of each of the kernel's three stage launches.
     Then the route `encoder_apply_fused` -> `shape_stream_inputs` ->
     `shape_stream_fused` -> `decode(edge_out=)`, counters zeroed just
     before and read just after: 1 Canny, 4 dense blocks, 1 shape stream;
     its argmax agrees with `make_infer_step`'s preds on >= 0.95 of pixels;
     slices/s of the route beside the step's, timed in turns.
  5. serving: 3 synthetic volumes (256x256x10) through
     `saunet_tpu_torch.cli.test_and_pack` with its defaults: NIfTI outputs
     in the original geometry with labels in {0..3}, a PNG a slice,
     timing.json, and the kernels launched.
     Then `make_infer_step` serves 8 slices at 224^2 from an f32 copy of
     the model: the plain forward, 0 dense-block launches, preds agreeing
     with the model's own forward on >= 0.99 of pixels.
  5a. the infer step's CUDA graphs at 256^2, bf16 and an f32 copy:
     buckets 8/12/16/20 eager, captured, then 16 graphed steps in a
     shuffled order with a new input each call (f32 under cuDNN's
     deterministic algorithms; two eager f32 steps' spread logged), every
     call's probs, preds and edge bit for bit equal to the eager step's (a
     forward hook registered: eager, and the hook fires); outputs
     unchanged through the next call; replays equal to the steps after
     warm-up; the kernel counters' gain a call equal for eager, capturing
     and replayed calls, and one profiled replay a bucket running K1's
     kernel once and K3's `dense_layer_kernel` as often as an eager step,
     by name; a new InferState captures anew; the kernels of each graph,
     and the host and device ms of a replayed and an eager step, logged.
  5b. pretrained-weights ingestion: phase 4's seeded, calibrated encoder
     saved as torchvision's `densenet121-<sha8>.pth` (the `features.`
     prefix, legacy `norm.1` names, a classifier; `<sha8>` its own digest
     prefix) through `saunet_tpu_torch.cli.ingest_pretrained` on the card:
     checksum, .npz, every encoder tensor grafted onto a fresh SAUNet, the
     manifest. The archive loaded into a fresh bf16 model as `cli.train
     --pretrained` loads it: every encoder tensor and folded dense-block
     operand equal to phase 4's. Its infer step on phase 4's slices,
     counters zeroed just before and read just after: 1 Canny and 4 dense
     blocks, each call held against its plain version (K1 exact, K3 within
     0.05*max|ref| and a median under a tenth of that).
  6. warp kernel (K5) vs plain on the train path's tensors, 64 slices at
     224^2: `gather_image` in its three modes, exact; `warp_image_label` on
     coordinates from the port's own augmentation draws, image within
     1e-6*max|ref|, labels exact. Median times of the kernels, their plain
     versions and the library calls (torch.gather, grid_sample), and the
     device times (torch.profiler) of the kernels, grid_sample x2 and
     torch.gather's own kernel.
  6b. paired transforms (data/transforms.py) on 64 slices at 256^2: every
     geometric transform (rotate, on one image and on three channels,
     translate, center and random crop to 224, free scale, a 2x scale of
     the shorter side, whose .5 source rows the mask rounds half to even,
     random-sized crop, random sized) through the resample kernel, K5's
     gather onto a grid of its own shape; counters zeroed just before and
     read just after: one resample launch a resample call; each call exact
     against `resample_plain`. The kernel's median time at (64, 256, 256)
     -> (64, 224, 224) beside its plain version, grid_sample x2 (bilinear
     image, nearest mask) and its bound, and device times.
  7. train step: full-width bf16 SAUNet, 64 slices at 224^2,
     `make_augment_fn` + `make_train_step` with radam(1e-4). Counters zeroed
     just before one step and read just after: 1 warp, 1 Canny, no dense
     block. Every loss part finite; slices/s over 5 steps after 2 warm-up,
     peak memory, CUDA-event time of augmentation, forward+loss, backward
     and optimizer, a torch.profiler window (top operations, device idle
     share); on a fixed batch with lr 1e-3 the loss after 10 steps is below
     the first.
  7b. trajectory gate: `saunet_tpu_torch.cli.fidelity`'s card config, 50
     f32 steps at 64^2, batch 4, radam(1e-3), TF32 off, from the JAX
     package's golden weights (`fill_from_seed_`) on phantom batches,
     against the JAX package's losses (tests/torch_golden/trajectory.npz):
     every step within 0.02 relative, the first within 2e-3; counters
     zeroed just before and read just after: one Canny a step, nothing
     else; K1 exact (0 flips) on every input; the gate's seconds.
  7c. the rest of the fidelity gates (`cli.fidelity`): 'card256', the
     trajectory at 256^2 (20 f32 steps, batch 4 of 8 phantoms) against
     tests/torch_golden/trajectory_256.npz at 7b's bounds, one Canny a
     step; 'stat', the long-run check (300 f32 steps at 64^2, batch 8 of
     64 phantoms, 16 validation slices scored every 30 steps under the
     running statistics and under each batch's own) against
     tests/torch_golden/convergence.npz: tests/test_fidelity.py's floor
     and the bounds `STAT_BOUNDS`, one Canny a train step and an eval
     forward, nothing else. K1 exact (0 flips) on every input of both;
     the seconds of each.
  7d. the serving kernels on trained weights: the full-width bf16 SAUNet
     trained on 64 phantoms at 224^2 (batch 8, radam(1e-3), 300 steps, up
     to 600 until the plain route's validation mIoU passes 0.5; one Canny
     a step); on 16 validation slices the mIoU of an f32 copy's plain
     forward, the bf16 plain route, `make_infer_step` (K1, K3) and the K4
     route, the last two agreeing with the plain route on >= 0.995 of
     pixels and within 0.01 mIoU; K3's taps (phase 4's tolerance, max|ref|
     beside phase 4's) and blocks (phase 3's), K4 (phase 4b's median and
     p99.9 bounds) on those weights.
  8. train CLI: synthetic volumes through `saunet_tpu_torch.cli.train`
     for one epoch at crop 224 on the card: per-class IoU printed, best.json
     and a checkpoint written; counters zeroed just before and read just
     after: 1 warp and 1 Canny per train step, 1 Canny and 4 dense blocks
     per validation batch. The checkpoint is then served by test_and_pack
     (its default --visualize: one PNG a slice).
  8b. train layouts and resume: phase 7's weights and batch (b64 at 224^2,
     bf16, augmentation on), one step each with every dense block in
     'chain', 'buffer', 'fused', 'chain' + remat and 'fused' + remat
     (counters zeroed just before and read just after each: 1 warp and 1
     Canny): loss parts within LAYOUT_LOSS_RTOL of the 'chain' step's, the
     update within LAYOUT_UPDATE_GAP_MAX of its largest update (beside
     'chain' against itself), the running statistics after a remat step
     equal to those without remat, with num_batches_tracked 1; the median
     ms of 5 steps after 2 warm-up and the peak memory of each; one step
     at a larger batch in 'chain', 'chain' + remat and 'fused'
     (HEADROOM: its peak, or out of memory). A JAX-layout train state (the
     tree `utils.msgpack.load` returns, built from numpy) restored onto
     the card (moments f32 on the card) and onto the CPU, one f32 step of
     each at 64^2, batch 4: loss parts within rtol 1e-4, the update within
     DDP_UPDATE_GAP_MAX. Then `cli.train --encoder_concat fused` for one
     epoch on phase 8's volumes and `--resume` for the next (epoch 2 from
     epoch 1's step; each epoch's launches as phase 8's).
  9. saliency: `saunet_tpu_torch.cli.saliency` on that checkpoint and a
     validation slice for each method at the CLI's defaults (256^2,
     f32, n = 50), four PNGs each; counters zeroed just before and read
     just after: 1 Canny per vanilla or guided map, 5 per SmoothGrad-50
     map, nothing else; K1 exact (0 flips) against the plain Canny on
     every input those runs gave it. Then guided SmoothGrad-50 of a phantom slice at
     224^2 in bf16 in batches of 10 (the JAX bench's saliency shape): 5
     Canny launches a map, K1 exact (0 flips) against the plain Canny on
     every noisy batch, maps/s (host clock and synchronise, median of 5
     after a warm-up), peak memory, a torch.profiler window over one map
     (device idle share, top operations) and the vanilla map's time
     beside it; and the f32 map with the Canny kernel within
     1e-3*max|ref| of the map with the plain Canny (TF32 off), beside
     how far two runs of the plain route differ.
  10. data parallel, ranks spawned by package code (parallel.launch), each
     asserting it never imported jax: two ranks of the full-width bf16
     SAUNet at 224^2 (seeded weights, BN statistics calibrated as phase 4's
     are, so K3 on the ranks sees inputs of the infer phase's scale),
     global batch 64 (2 x 32), sharing the card over gloo
     (NCCL over two cards where there are two). Each rank's eval batch
     first (1 Canny and 4 dense-block launches a rank; IoU counts summed
     over the ranks equal to the one-process eval of the same rows), then
     the global-batch step with augmentation from the same weights and
     generator state as a one-process `make_train_step` on the global
     batch: loss parts within the CPU golden test's rtol 1e-4, synced
     running statistics equal on both ranks and close to the one-process
     step's, the parameters within 0.1 of the largest update of the
     one-process step's; counters zeroed just before the step and read
     just after: 1 warp and 1 Canny a rank, no dense block. Every K1, K5
     and K3 call of the ranks' eval and step is recorded and held against
     the plain version on the same inputs (and again on the first 4 rows,
     the train CLI's per-rank batch): K1 exact, K5 and K3 at phases 6 and
     3's tolerances, K3's max|ref| printed and at most
     K3_SCALE_FACTOR_MAX times phase 3's. Step ms, gradient all-reduce
     ms (host window of the DDP buckets) and peak memory per rank; two
     ranks on one card over gloo measure correctness, not scaling. Then
     `cli.train` under torchrun on 2 ranks (2 x 4), one epoch at crop 224
     on phase 8's volumes: per-class IoU printed once, one checkpoint
     and best.json, served by test_and_pack. Then one rank on NCCL: the
     mesh step (DDP, synced BatchNorm) against the plain step in turns at
     b32, and the NCCL kernels' device time; its K1 and K5 calls held
     against the plain versions as above.
  11. the 'space' axis: two ranks as a ('data' 1, 'space' 2) grid share
     the card over gloo, each holding half the rows of every image. The
     f32 eval of 8 slices at 512^2 (one padded; TF32 off; the plain
     encoder, as on every 'space' grid): 1 Canny and no dense block a
     rank; the ranks' predictions against the one-process f32 eval's: at
     most SPACE_EVAL_FLIPS_MAX of the real pixels flipped (f32 last-bit
     differences at near-tied logits), and the IoU counts summed over the
     ranks moved by no more than the flipped pixels. Then the full-width bf16 global-batch step at 512^2, global
     batch 8, with augmentation, from the same weights and generator
     state as a one-process `make_train_step` (run twice: its spread is
     printed beside the ranks' difference): loss parts within
     SPACE_LOSS_RTOL, running statistics equal on both ranks, the update
     within 0.1 of the largest update; counters zeroed just before the
     step and read just after: 1 Canny and 1 warp a rank. Every K1 and K5
     call of the ranks (the Canny bands, the warps of whole images) held
     against the plain versions: K1 exact, K5 exact. Step ms a rank, row
     exchanges and their bytes a step, peak memory a rank, and one more
     step with every exchange timed alone, by buffer shape. Then
     `cli.train --space 2` under torchrun (2 ranks, one epoch at crop 224
     on phase 8's volumes, where H/32 holds 7 rows over 2 ranks): IoU
     printed once, one checkpoint, served by test_and_pack; and the dry
     run on 4 ranks as a 2 x 2 grid at 64^2.
  12. profilers: every mode of `saunet_tpu_torch.cli.profile` at its JAX
     tool's geometry (infer at 224^2 x 64 and at 512^2 x 8, decode, train
     with augmentation and the decoder's stages, opt_metrics, block_train,
     concat, res1, augment, saliency, output_layout, scaling), each table
     printed with the card's name and power limit and its JSON written to
     chiprun_out/profile_<name>.json. Fatal: each mode's kernel launches
     (a pass of the infer step's route 1 Canny and 4 dense blocks, the K4
     route 1 shape stream more; the full augmentation 1 warp; the train
     step 1 warp, 1 Canny, no dense block); in infer and decode each
     route's directly timed segments within 10% of the route timed whole;
     scaling's gradient class equal to phase 10's DDP bucket bytes a step,
     and its row exchanges predicted at 512^2 (8 samples a rank) equal to
     phase 11's count and bytes a step.
Then a {"kernels": [...]} line (with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over the peak rate of their type,
H100 SXM data sheet) and, last, the {"ok": true, "device": ...} line.
Without CUDA, or without the package beside it, it exits non-zero. Long
outputs (the profiler table) go to chiprun_out/.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BATCH, SIZE = 64, 224
CANNY_LARGE = (8, 512, 512)
# the timing helpers and the H100's peaks, shared with the package's
# profilers (saunet_tpu_torch/utils/profiling.py): bound in main() once the
# package is found beside this script
bound = cuda_ms = device_ms_by_kernel = profile_window = None
F32_OPS_PER_S = BF16_OPS_PER_S = None
# Canny's work per pixel, counted from csrc/canny.cu: Sobel 2x17, L1
# magnitude 3, direction 8, non-maximum suppression 4, thresholds 2,
# 8 hysteresis rounds of 14 operations on a 32-pixel word (4 in all),
# scale 1
CANNY_OPS_PER_PIXEL = 56
# the warp's per output pixel: floors and fractions 4, bounds 4, 4 bf16
# roundings, bilinear combine 11, label pick 3
WARP_OPS_PER_PIXEL = 30
OUT_DIR = "chiprun_out"


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def synthetic_labelled(n: int, h: int, w: int, gen, device):
    """(n, h, w) f32 slices, bright ellipses on a ramp plus noise, and their
    int32 labels: the ellipse cut into classes 1..3 by its centre lines."""
    import torch

    yy, xx = torch.meshgrid(torch.linspace(-1, 1, h),
                            torch.linspace(-1, 1, w), indexing="ij")
    cy, cx = (torch.rand(2, n, 1, 1, generator=gen) - 0.5) * 0.6
    ry, rx = 0.2 + 0.3 * torch.rand(2, n, 1, 1, generator=gen)
    blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).float()
    img = 200 * blob + 60 * (xx + 1) + 20 * torch.rand(n, h, w, generator=gen)
    lab = blob * (1 + (xx > cx).float()
                  + 2 * ((yy > cy) & (xx <= cx)).float())
    return img.to(device), lab.to(torch.int32).to(device)


def synthetic_slices(n: int, h: int, w: int, gen, device):
    """(n, h, w) f32 slices: bright ellipses on a ramp plus noise."""
    return synthetic_labelled(n, h, w, gen, device)[0]


def phase_device():
    import torch

    from saunet_tpu_torch.utils.profiling import card as card_of

    card = card_of()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    from saunet_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build(["canny", "dense_block", "shape_stream", "warp"])
    for name, path in paths.items():
        build.load(name)
        log(f"built {name}: {os.path.relpath(path)}")
    log(f"build seconds: {time.perf_counter() - t0:.3f}")
    # registers, shared memory and spills of every kernel, from ptxas
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name in paths:
            f.write(f"== {name}\n" + "\n".join(build.ptxas_info(name))
                    + "\n")
    for name in paths:
        for line in build.ptxas_info(name):
            log(f"ptxas {name}: {line}")


def phase_canny(images, device):
    """Canny on the gray images the main path makes from `images`, and on
    synthetic 512^2 slices (the size where the TPU package switched to its
    row-tiled kernel)."""
    import torch

    from saunet_tpu_torch.ops.cuda import canny_edges_cuda
    from saunet_tpu_torch.ops.edge import canny_edges, image_to_gray255

    gen = torch.Generator().manual_seed(1)
    grays = [image_to_gray255(images.to(torch.bfloat16)).contiguous(),
             synthetic_slices(*CANNY_LARGE, gen, device)[..., None]
             .clamp(0, 255).contiguous()]
    result = {}
    for gray in grays:
        shape = tuple(gray.shape[:3])
        out = canny_edges_cuda(gray)
        ref = canny_edges(gray)
        torch.cuda.synchronize()
        require(out.shape == ref.shape == (*shape, 1),
                f"canny shape {tuple(out.shape)}")
        flips = int((out != ref).sum())
        agree = 1.0 - flips / ref.numel()
        log(f"canny {shape}: flips {flips} of {ref.numel()} "
            f"(agreement {agree:.6f}), edge pixels {int((ref > 0).sum())}")
        require(agree >= 0.999, f"canny kernel disagrees: {flips} flips")
        ms = cuda_ms(lambda: canny_edges_cuda(gray))
        plain_ms = cuda_ms(lambda: canny_edges(gray))
        # device time alone (torch.profiler): the event pair around one
        # call also holds its host work
        dev_ms = sum(device_ms_by_kernel(lambda: canny_edges_cuda(gray),
                                         20).values())
        px = gray.numel()
        bound_ms, bound_by = bound(8 * px, CANNY_OPS_PER_PIXEL * px,
                                   F32_OPS_PER_S)
        log(f"canny {shape}: kernel {ms:.4f} ms, device {dev_ms:.5f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), device {dev_ms / bound_ms:.2f}x bound")
        sized = {"max_abs_err": float((out - ref).abs().max()),
                 "flips": flips, "shape": list(shape), "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
        if not result:
            result = sized
        else:
            result["large"] = sized
    return result


# K3 against its plain version (bf16): each block's max|err| within
# DENSE_BLOCK_TOL of its max|ref| and its median within a tenth of that;
# each encoder tap of the kernel route within TAP_TOL of its max|ref|
DENSE_BLOCK_TOL = TAP_TOL = 0.05
# K4 against its plain version: max|d| and median|d| of the edge map (in
# [0, 1]). A random model's stream is chaotic at the last bit (a rounding
# flip in a 64-channel conv moves a pixel's edge by up to 1), so there
# max|d| may pass SHAPE_STREAM_MAX_D where p99.9|d| does not and the
# kernel is no farther from an f32 stream than the plain bf16 one
SHAPE_STREAM_MAX_D, SHAPE_STREAM_MEDIAN_D = 0.04, 0.004


def check_dense_blocks(model, folded, images, what: str = "dense block"):
    """K3 on each block's input as the encoder gives it (`images` NHWC)
    against `dense_block_plain`, within DENSE_BLOCK_TOL; returns each
    block's (input, folded operands, record with its errors and max|ref|)."""
    import torch

    from saunet_tpu_torch.models.fused_encoder import encoder_apply_fused
    from saunet_tpu_torch.ops.cuda import dense_block, dense_block_plain

    inputs = []

    def capture(x, f):
        inputs.append(x)
        return dense_block_plain(x, f)

    with torch.inference_mode():
        encoder_apply_fused(model.encoder, folded, images, model.dtype,
                            capture)
    checked = []
    for x, f in zip(inputs, folded):
        n, hw, _, c0 = x.shape
        num_layers = f["w1"].shape[0]
        with torch.inference_mode():
            out = dense_block(x, f)
            ref = dense_block_plain(x, f)
        torch.cuda.synchronize()
        require(out.shape == ref.shape
                == (n, hw, hw, c0 + 32 * num_layers),
                f"{what} shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out.float()).all()),
                f"{what} kernel output not finite")
        err = (out.float() - ref.float()).abs()
        scale = float(ref.float().abs().max())
        tol = DENSE_BLOCK_TOL * scale
        rec = {"shape": list(x.shape), "layers": num_layers,
               "max_abs_err": float(err.max()),
               "median_abs_err": float(err.median()), "max_abs_ref": scale}
        log(f"{what} {tuple(x.shape)} x {num_layers}: max|err| "
            f"{rec['max_abs_err']:.6g} median {rec['median_abs_err']:.6g} "
            f"tol {tol:.6g}")
        require(rec["max_abs_err"] <= tol
                and rec["median_abs_err"] < tol / 10,
                f"{what} kernel disagrees with its plain version")
        checked.append((x, f, rec))
    return checked


def phase_dense_block(model, folded, images):
    import torch

    from saunet_tpu_torch.ops.cuda import dense_block, dense_block_plain

    total_ms = total_plain = worst = worst_err = 0.0
    nbytes = ops = 0.0
    blocks = []
    for x, f, rec in check_dense_blocks(model, folded, images):
        n, hw, _, c0 = x.shape
        num_layers, _, hidden = f["w1"].shape
        growth = f["w2"].shape[-1] // 9
        # input read once, output written once (bf16), operands once; two
        # products per layer: 1x1 (c_in -> hidden) and 3x3 (hidden -> growth)
        px = n * hw * hw
        b_bytes = 2 * px * (2 * c0 + growth * num_layers) + sum(
            f[k].numel() * f[k].element_size()
            for k in ("a1", "b1", "w1t", "b2", "w2t"))
        b_ops = sum(2 * px * ((c0 + growth * l) * hidden
                              + 9 * hidden * growth)
                    for l in range(num_layers))
        nbytes += b_bytes
        ops += b_ops
        with torch.inference_mode():
            ms = cuda_ms(lambda: dense_block(x, f))
            plain_ms = cuda_ms(lambda: dense_block_plain(x, f))
            split = device_ms_by_kernel(lambda: dense_block(x, f))
        b_bound, b_by = bound(b_bytes, b_ops, BF16_OPS_PER_S)
        log(f"dense block {tuple(x.shape)} x {num_layers}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_bound:.4f} ms ({b_by}), {ms / b_bound:.2f}x bound; device "
            f"ms per call by launch kind {split}")
        blocks.append({**rec, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_bound, "bound_by": b_by,
                       "device_ms": split})
        total_ms += ms
        total_plain += plain_ms
        worst = max(worst, rec["max_abs_err"]
                    / (DENSE_BLOCK_TOL * rec["max_abs_ref"]))
        worst_err = max(worst_err, rec["max_abs_err"])
    bound_ms, bound_by = bound(nbytes, ops, BF16_OPS_PER_S)
    log(f"dense blocks: kernel {total_ms:.4f} ms in all, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst_err, "max_err_over_tol": worst,
            "max_abs_ref": max(b["max_abs_ref"] for b in blocks),
            "ms": total_ms, "plain_ms": total_plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "blocks": blocks}


def build_model(device):
    """Full-width bf16 SAUNet: seeded random convs, BN statistics taken
    from 8 synthetic slices (random statistics let activations grow
    without bound through 120 layers) with variances floored at 0.1."""
    import torch

    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.init import calibrate_bn_, init_random_

    gen = torch.Generator().manual_seed(0)
    model = init_random_(build_unet(dtype="bfloat16"), gen).to(device)
    calib = normalize_for_eval(synthetic_slices(8, SIZE, SIZE, gen, device))
    return calibrate_bn_(model, calib.permute(0, 3, 1, 2)).eval()


def route(model, folded, images, plain: bool):
    """Encoder taps (NHWC) and logits of the step's route (kernel encoder,
    then decode) with both kernels, or with both replaced by their plain
    versions."""
    import torch

    from saunet_tpu_torch.models.fused_encoder import encoder_apply_fused
    from saunet_tpu_torch.ops.cuda import dense_block, dense_block_plain

    block = dense_block_plain if plain else dense_block
    with torch.inference_mode():
        model.edge_kernel = "plain" if plain else "auto"
        try:
            taps = encoder_apply_fused(model.encoder, folded, images,
                                       model.dtype, block)
            seg = model.decode([t.permute(0, 3, 1, 2) for t in taps[1:]],
                               images.permute(0, 3, 1, 2))[0]
        finally:
            model.edge_kernel = "auto"
    return taps, seg


def check_taps(taps_k, taps_p, what: str = "tap") -> list:
    """Each encoder tap of the kernel route within TAP_TOL*max|ref| of the
    plain route's; returns each tap's max|ref|."""
    scales = []
    for i, (tk, tp) in enumerate(zip(taps_k, taps_p)):
        d = float((tk.float() - tp.float()).abs().max())
        scale = float(tp.float().abs().max())
        log(f"{what} f{i + 1} {tuple(tk.shape)}: max|d| {d:.6g} "
            f"max|ref| {scale:.6g}")
        require(d <= TAP_TOL * scale, f"{what} f{i + 1} disagrees with plain")
        scales.append(scale)
    return scales


def quantile_abs(d, q: float = 0.999) -> float:
    flat = d.flatten().float()
    return float(flat.kthvalue(max(1, int(q * flat.numel()))).values)


def phase_main_path(model, state, images):
    import copy

    import torch

    from saunet_tpu_torch.models.fused_encoder import fold_encoder
    from saunet_tpu_torch.train import make_infer_step

    step = make_infer_step(model, with_probs=True)
    _zero_counts()
    probs, preds, edge = step(state, images)
    torch.cuda.synchronize()
    launches = _counts()
    log(f"infer path launches: {launches}")
    require(launches == {"canny": 1, "dense_block": 4, "warp": 0,
                         "gather": 0, "shape_stream": 0,
                         "resample": 0},
            f"main path did not run each kernel as expected: {launches}")
    require(preds.shape == (BATCH, SIZE, SIZE), f"preds {preds.shape}")
    require(bool(torch.isfinite(probs).all()), "probs not finite")
    require(int(preds.min()) >= 0 and int(preds.max()) < 4, "bad labels")

    taps_k, seg_k = route(model, state.folded, images, plain=False)
    taps_p, seg_p = route(model, state.folded, images, plain=True)
    model32 = copy.deepcopy(model)
    model32.dtype = torch.float32
    _, seg_f = route(model32, fold_encoder(model32.encoder, torch.float32),
                     images, plain=True)
    del model32
    torch.cuda.synchronize()
    require(torch.equal(seg_k.argmax(1), preds),
            "step preds differ from the kernel route's argmax")
    tap_scales = check_taps(taps_k, taps_p)

    def agreement(a, b):
        return float((a.argmax(1) == b.argmax(1)).float().mean())

    agree = agreement(seg_k, seg_p)
    dmax = float((seg_k - seg_p).abs().max())
    scale = float(seg_p.abs().max())
    q_kf = quantile_abs(seg_k - seg_f)
    q_pf = quantile_abs(seg_p - seg_f)
    agree_kf, agree_pf = agreement(seg_k, seg_f), agreement(seg_p, seg_f)
    log(f"logits kernel vs plain: argmax agreement {agree:.6f}, "
        f"max|d| {dmax:.6g}, max|ref| {scale:.6g}")
    log(f"logits vs f32 plain: kernel route p99.9|d| {q_kf:.6g} argmax "
        f"agreement {agree_kf:.6f}; plain bf16 route p99.9|d| {q_pf:.6g} "
        f"argmax agreement {agree_pf:.6f}")
    require(agree >= 0.95, "main path argmax disagrees with the plain route")
    require(q_kf <= 1.1 * q_pf and agree_kf >= agree_pf - 0.005,
            "kernel route is farther from f32 than the plain bf16 route")

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    t_step = timed(lambda: step(state, images))
    t_kernel = timed(lambda: route(model, state.folded, images, False))
    t_plain = timed(lambda: route(model, state.folded, images, True))
    log(f"infer, {BATCH} slices at {SIZE}^2 bf16: step "
        f"{BATCH / t_step:.2f} slices/s ({t_step * 1e3:.3f} ms); forward "
        f"with kernels {BATCH / t_kernel:.2f} slices/s "
        f"({t_kernel * 1e3:.3f} ms), with plain versions "
        f"{BATCH / t_plain:.2f} slices/s ({t_plain * 1e3:.3f} ms)")
    return launches, {"step_slices_per_s": BATCH / t_step,
                      "slices_per_s": BATCH / t_kernel,
                      "plain_slices_per_s": BATCH / t_plain,
                      "logits_argmax_agreement": agree,
                      "logits_max_abs_diff": dmax,
                      "tap_max_abs_ref": tap_scales}


def _stage_ms(fn, calls: int = 5) -> dict:
    """Device ms per call of each stage launch of the shape-stream kernel
    (`stage_kernel<C, ...>`, C = 64, 32, 16), from torch.profiler."""
    return {"C=" + k.split("stage_kernel<")[1].split(",")[0]: v
            for k, v in device_ms_by_kernel(fn, calls).items()
            if "stage_kernel<" in k}


def nchw_taps(model, folded_encoder, images):
    """The encoder's taps f1-f4 (NCHW) of NHWC `images` through the fused
    encoder with K3."""
    from saunet_tpu_torch.models.fused_encoder import encoder_apply_fused

    _, *taps = encoder_apply_fused(model.encoder, folded_encoder, images,
                                   model.dtype)
    return [t.permute(0, 3, 1, 2) for t in taps]


def k4_route(model, folded_encoder, folded_stream, images):
    """The K4 route's logits (NCHW): fused encoder with K3, then
    `shape_stream_inputs`, K4 and `decode(edge_out=...)`."""
    import torch

    from saunet_tpu_torch.ops.cuda import shape_stream_fused

    x = images.permute(0, 3, 1, 2)
    with torch.inference_mode():
        taps = nchw_taps(model, folded_encoder, images)
        edge = shape_stream_fused(model.shape_stream_inputs(taps, x),
                                  folded_stream)
        return model.decode(taps, x, edge_out=edge.permute(0, 3, 1, 2))[0]


def check_shape_stream(packed, folded, ref32=None, what="shape stream"):
    """K4 on `packed` (N, H, W, 67) bf16 against `shape_stream_plain`:
    median|d| within SHAPE_STREAM_MEDIAN_D and max|d| within
    SHAPE_STREAM_MAX_D; given an f32 stream `ref32` (a random model's,
    chaotic at the last bit), a max|d| past it is held instead by p99.9|d|
    and by the distance from `ref32`. Returns the kernel's output and the
    errors."""
    import torch

    from saunet_tpu_torch.ops.cuda import (
        shape_stream_fused,
        shape_stream_plain,
    )

    with torch.inference_mode():
        out = shape_stream_fused(packed, folded)
        ref = shape_stream_plain(packed, folded)
    torch.cuda.synchronize()
    n, h, w, _ = packed.shape
    require(out.shape == ref.shape == (n, h, w, 1),
            f"{what} {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), f"{what} not finite")
    err = (out - ref).abs()
    errs = {"max_abs_err": float(err.max()),
            "median_abs_err": float(err.median()),
            "p999_abs_err": quantile_abs(out - ref)}
    line = (f"{what} {tuple(packed.shape)}: max|d| "
            f"{errs['max_abs_err']:.6g} median {errs['median_abs_err']:.6g}"
            f" p99.9 {errs['p999_abs_err']:.6g}")
    if ref32 is not None:
        q_kf, q_pf = quantile_abs(out - ref32), quantile_abs(ref - ref32)
        line += (f"; against an f32 stream p99.9|d| kernel {q_kf:.6g}, "
                 f"plain bf16 {q_pf:.6g}")
    log(line)
    if ref32 is not None and errs["max_abs_err"] > SHAPE_STREAM_MAX_D:
        log(f"{what}: max|d| {errs['max_abs_err']:.6g} over "
            f"{SHAPE_STREAM_MAX_D} at "
            f"{int((err > SHAPE_STREAM_MAX_D).sum())} of {err.numel()} "
            f"pixels; held instead by p99.9 and by the distance from an "
            f"f32 stream")
        require(errs["p999_abs_err"] <= SHAPE_STREAM_MAX_D
                and q_kf <= 1.1 * q_pf,
                f"{what} kernel disagrees with its plain version")
    else:
        require(errs["max_abs_err"] <= SHAPE_STREAM_MAX_D,
                f"{what} kernel disagrees with its plain version (max)")
    require(errs["median_abs_err"] <= SHAPE_STREAM_MEDIAN_D,
            f"{what} kernel disagrees (median)")
    return out, errs


def phase_shape_stream(model, state, images):
    """K4 at full width on the tensors the K4 route gives it, then the
    route itself against the infer step."""
    import copy

    import torch

    from saunet_tpu_torch.ops.cuda import (
        fold_shape_stream_params,
        shape_stream_fused,
        shape_stream_plain,
    )
    from saunet_tpu_torch.train import make_infer_step

    folded = fold_shape_stream_params(model)
    x = images.permute(0, 3, 1, 2)

    with torch.inference_mode():
        taps = nchw_taps(model, state.folded, images)
        packed = model.shape_stream_inputs(taps, x)
        model32 = copy.deepcopy(model)
        model32.dtype = torch.float32
        ref32 = model32.shape_stream([t.float() for t in taps],
                                     x.float())[0].permute(0, 2, 3, 1)
        del model32
    require(packed.shape == (BATCH, SIZE, SIZE, 67)
            and packed.dtype == torch.bfloat16, f"packed {packed.shape}")
    out, errs = check_shape_stream(packed, folded, ref32)

    with torch.inference_mode():
        ms = cuda_ms(lambda: shape_stream_fused(packed, folded))
        plain_ms = cuda_ms(lambda: shape_stream_plain(packed, folded))
        module_ms = cuda_ms(lambda: model.shape_stream(taps, x))
        inputs_ms = cuda_ms(lambda: model.shape_stream_inputs(taps, x))
        stage_ms = _stage_ms(lambda: shape_stream_fused(packed, folded))
    # one multiply-add per weight per pixel, two FLOP each, on the bf16
    # tensor-core rate: both 3x3 convs of every res block, d_i, the gate's
    # convs with its cue row, fuse
    px = BATCH * SIZE * SIZE
    macs = sum(v.numel() for k, v in folded.items()
               if k.split("/")[-1] in ("r_w1", "r_w2", "d_w", "g_w1_ss",
                                       "g_w1_cue", "g_w2", "g_wg", "fuse_w"))
    nbytes = (packed.numel() * packed.element_size()
              + out.numel() * out.element_size()
              + sum(v.numel() * v.element_size() for v in folded.values()))
    bound_ms, bound_by = bound(nbytes, 2 * macs * px, BF16_OPS_PER_S)
    log(f"shape stream: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN "
        f"module stream {module_ms:.4f} ms, shape_stream_inputs "
        f"{inputs_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{macs} multiply-adds per pixel); device ms per stage launch "
        f"{stage_ms}")

    step = make_infer_step(model)

    def route_k4():
        return k4_route(model, state.folded, folded, images)

    _zero_counts()
    seg = route_k4()
    torch.cuda.synchronize()
    launches = _counts()
    log(f"K4 route launches: {launches}")
    require(launches == {"canny": 1, "dense_block": 4, "warp": 0,
                         "gather": 0, "shape_stream": 1,
                         "resample": 0},
            f"K4 route did not run each kernel as expected: {launches}")
    _, preds, _ = step(state, images)
    agree = float((seg.argmax(1) == preds).float().mean())
    log(f"K4 route vs infer step: argmax agreement {agree:.6f}")
    require(agree >= 0.95, "K4 route disagrees with the infer step")

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    turns = {"step": [], "route": []}
    for name in ("step", "route", "route", "step") * 3:
        turns[name].append(host_ms(
            (lambda: step(state, images)) if name == "step" else route_k4))
    t_step, t_route = (statistics.median(turns["step"]),
                       statistics.median(turns["route"]))
    log(f"K4 route, {BATCH} slices at {SIZE}^2 bf16: {t_route:.3f} ms "
        f"({BATCH / t_route * 1e3:.2f} slices/s); infer step in the same "
        f"turns {t_step:.3f} ms ({BATCH / t_step * 1e3:.2f} slices/s)")
    return launches, {**errs, "ms": ms, "plain_ms": plain_ms,
                      "module_stream_ms": module_ms, "stage_ms": stage_ms,
                      "inputs_ms": inputs_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "route_ms": t_route,
                      "route_slices_per_s": BATCH / t_route * 1e3,
                      "step_ms": t_step,
                      "step_slices_per_s": BATCH / t_step * 1e3,
                      "route_argmax_agreement": agree}


def phase_serving(model, device):
    import numpy as np
    import torch

    from saunet_tpu_torch.cli.test_and_pack import main as pack_main
    from saunet_tpu_torch.data import nifti
    from saunet_tpu_torch.ops.cuda import canny_edges_cuda, dense_block

    rs = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model.pt")
        torch.save(model.state_dict(), ckpt)
        shape = (256, 256, 10)
        for p in (1, 2):
            for fr in (1, 12)[: 2 if p == 1 else 1]:
                pdir = os.path.join(tmp, "data", "testing", f"patient{p:03d}")
                os.makedirs(pdir, exist_ok=True)
                img = (rs.rand(*shape) * 300).astype(np.float32)
                nifti.save(img, os.path.join(
                    pdir, f"patient{p:03d}_frame{fr:02d}.nii.gz"),
                    pixdim=(1.5, 1.5, 10))
        out = os.path.join(tmp, "out")
        c0, d0 = canny_edges_cuda.launches, dense_block.launches
        pack_main(["--id", "smoke", "--checkpoint", ckpt,
                   "--data-root", os.path.join(tmp, "data"),
                   "--crop_size", str(SIZE), "--save_test_path", out,
                   "--result", os.path.join(tmp, "res"),
                   "--device", str(device)])
        pngs = _pngs(os.path.join(tmp, "res", "smoke"))
        require(len(pngs) == 3 * shape[2],
                f"expected {3 * shape[2]} PNGs, got {len(pngs)}")
        volumes = sorted(f for f in os.listdir(out) if f.endswith(".nii.gz"))
        require(len(volumes) == 3, f"expected 3 volumes, got {volumes}")
        for name in volumes:
            pred = nifti.load(os.path.join(out, name)).data
            require(pred.shape == shape, f"{name}: shape {pred.shape}")
            require(set(np.unique(pred)) <= {0, 1, 2, 3},
                    f"{name}: labels {np.unique(pred)}")
        with open(os.path.join(out, "timing.json")) as f:
            timing = json.load(f)
    dc, dd = canny_edges_cuda.launches - c0, dense_block.launches - d0
    log(f"serving: 3 volumes, {timing['ms_per_slice']:.4f} ms/slice, "
        f"launches canny {dc} dense_block {dd}, {len(pngs)} PNGs")
    require(dc == 3 and dd == 12, "serving did not run through the kernels")
    serve_f32(model, device)
    return timing["ms_per_slice"]


def serve_f32(model, device):
    """`make_infer_step` serves an f32 copy of the model: the plain forward,
    no dense-block launch (that kernel takes bf16 only), preds agreeing
    with a second call of the model's own forward (cuBLAS and cuDNN may sum
    in another order from call to call, and the random model's logits tie
    at some pixels; the card test holds them equal at 64^2)."""
    import copy

    import torch

    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.ops.cuda import canny_edges_cuda, dense_block
    from saunet_tpu_torch.train import InferState, make_infer_step

    model32 = copy.deepcopy(model)
    model32.dtype = torch.float32
    state = InferState(model32, device)
    images = normalize_for_eval(synthetic_slices(
        8, SIZE, SIZE, torch.Generator().manual_seed(4), device))
    c0, d0 = canny_edges_cuda.launches, dense_block.launches
    probs, preds, _ = make_infer_step(model32, with_probs=True)(state,
                                                                 images)
    torch.cuda.synchronize()
    dc, dd = canny_edges_cuda.launches - c0, dense_block.launches - d0
    with torch.inference_mode():
        seg, _ = model32(images.permute(0, 3, 1, 2))
    agree = float((preds == seg.argmax(dim=1)).float().mean())
    dp = float((probs - torch.softmax(seg, dim=1).permute(0, 2, 3, 1))
               .abs().max())
    log(f"serving an f32 model: 8 slices at {SIZE}^2, preds "
        f"{tuple(preds.shape)}, launches canny {dc} dense_block {dd}; "
        f"against the model's forward: argmax agreement {agree:.6f}, "
        f"max|d probs| {dp:.6g}")
    require(preds.shape == (8, SIZE, SIZE) and dd == 0 and dc == 1,
            "the f32 model was not served by the plain forward")
    require(bool(torch.isfinite(probs).all()) and int(preds.min()) >= 0
            and int(preds.max()) < 4, "f32 serving: bad probs or labels")
    require(agree >= 0.99, "f32 serving differs from the model's forward")


GRAPH_BUCKETS = (8, 12, 16, 20)  # the serving cells' padded volumes
GRAPH_HW = 256                   # ACDC's crop, as the cells serve it
GRAPH_STEPS = 16                 # graphed steps after warm-up, a dtype
#: K1's and K3's kernels, as the profiler names them
GRAPH_KERNELS = {"canny": "canny_kernel", "dense_layer": "dense_layer_kernel"}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _graph_case(model, device, gen):
    """`phase_infer_graph` for one model (one dtype)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.train import InferState, infer_graph, make_infer_step

    dtype = str(model.dtype).replace("torch.", "")
    per_step = ({"canny": 1, "dense_block": 4}
                if model.dtype == torch.bfloat16 else {"canny": 1})
    state = InferState(model, device)
    step = make_infer_step(model, with_probs=True, with_edge=True)
    fired = []

    def batch(n):
        return normalize_for_eval(synthetic_slices(n, GRAPH_HW, GRAPH_HW,
                                                   gen, device))

    def eager(x):
        """The step on `x` with a forward hook on the model: eager."""
        handle = model.fuse.register_forward_hook(
            lambda *_: fired.append(1))
        try:
            before, n = step.replays, len(fired)
            out = step(state, x)
            require(step.replays == before and len(fired) == n + 1,
                    f"{dtype}: a hooked step replayed or skipped its hook")
            return out
        finally:
            handle.remove()

    def same(a, b, what):
        for name, u, v in zip(("probs", "preds", "edge"), a, b):
            require(torch.equal(u, v), f"{dtype} {what}: {name} differ "
                    f"from the eager step's")

    def counted(x, kind):
        before = _counts()
        out = step(state, x)
        torch.cuda.synchronize()
        got = _delta(before)
        require(got == per_step, f"{dtype} {kind} call launches {got}, "
                f"expected {per_step}")
        return out

    # warm-up: each bucket eager, then captured
    for kind, want in (("eager", "eager_calls"), ("capture", "captures")):
        for n in GRAPH_BUCKETS:
            x = batch(n)
            count = getattr(step, want)
            out = counted(x, kind)
            require(getattr(step, want) == count + 1,
                    f"{dtype} bucket {n}: the {kind} call did not run "
                    f"{kind}")
            same(out, eager(x), f"bucket {n} {kind} call")
    require(sum(isinstance(g, infer_graph._Graph)
                for g in state.graphs.values()) == len(GRAPH_BUCKETS),
            f"{dtype}: graphs on the state {len(state.graphs)}")

    # graphed steps in a shuffled order, a new input each call, each held
    # bit for bit against the eager step; the outputs a step returned stay
    # as they were through the next call
    order = np.random.RandomState(19).permutation(
        np.repeat(GRAPH_BUCKETS, GRAPH_STEPS // len(GRAPH_BUCKETS)))
    replays0, kept = step.replays, None
    for n in order.tolist():
        x = batch(n)
        out = counted(x, "replay")
        if kept is not None:
            same(kept[0], kept[1], "the previous step's outputs after the "
                 "next call:")
        same(out, eager(x), f"bucket {n} replay")
        kept = (out, tuple(t.clone() for t in out))
    replays = step.replays - replays0
    require(replays == GRAPH_STEPS, f"{dtype}: {replays} replays of "
            f"{GRAPH_STEPS} steps after warm-up")

    # a new state captures anew: eager, capture, replay
    fresh = InferState(model, device)
    calls = (step.eager_calls, step.captures, step.replays)
    x = batch(GRAPH_BUCKETS[0])
    outs = [step(fresh, x) for _ in range(3)]
    require((step.eager_calls - calls[0], step.captures - calls[1],
             step.replays - calls[2]) == (1, 1, 1),
            f"{dtype}: a new state did not capture anew")
    for out in outs:
        same(out, eager(x), "new state")
    key = next(iter(fresh.graphs))
    require(fresh.graphs[key] is not state.graphs[key],
            f"{dtype}: the new state replays the old state's graph")
    del fresh, outs

    # kernels of each graph, one replay profiled against one eager step:
    # K1's and K3's kernels by name, since the wrappers' counters are only
    # carried forward on a replay (no wrapper runs); the host and device ms
    # of a step, replayed and eager
    rows = {}
    for n in GRAPH_BUCKETS:
        x = batch(n)
        found, named = {}, {}
        for kind, fn in (("replay", lambda: step(state, x)),
                         ("eager", lambda: eager(x))):
            fn()
            torch.cuda.synchronize()
            replays = step.replays
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            require(step.replays - replays == (kind == "replay"),
                    f"{dtype} bucket {n}: the profiled {kind} step ran as "
                    f"another kind")
            ops = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            found[kind] = (sum("memcpy" not in e.name.lower()
                               and "memset" not in e.name.lower()
                               for e in ops), len(ops))
            named[kind] = {k: sum(name in e.name for e in ops)
                           for k, name in GRAPH_KERNELS.items()}
        require(named["eager"]["canny"] == 1
                and (named["eager"]["dense_layer"] > 0) == ("dense_block"
                                                           in per_step)
                and named["replay"] == named["eager"],
                f"{dtype} bucket {n}: K1's and K3's kernels in a replay "
                f"{named['replay']}, in an eager step {named['eager']}")
        host, device_ms = {}, {}
        for kind, fn in (("replay", lambda: step(state, x)),
                         ("eager", lambda: eager(x))):
            hs, ds = [], []
            for _ in range(10):
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                t0 = time.perf_counter()
                fn()
                hs.append((time.perf_counter() - t0) * 1e3)
                b.record()
                b.synchronize()
                ds.append(a.elapsed_time(b))
            host[kind], device_ms[kind] = (statistics.median(hs),
                                           statistics.median(ds))
        rows[n] = {"graph_kernels": found["replay"][0],
                   "graph_device_ops": found["replay"][1],
                   "eager_kernels": found["eager"][0],
                   "eager_device_ops": found["eager"][1],
                   "graph_k1_k3": named["replay"],
                   "host_ms": host, "step_ms": device_ms}
        log(f"{dtype} bucket {n}: kernels a replay {found['replay'][0]} "
            f"({found['replay'][1]} device ops), an eager step "
            f"{found['eager'][0]} ({found['eager'][1]}); K1, K3 kernels a "
            f"replay {named['replay']}; host ms replay "
            f"{host['replay']:.4f} eager {host['eager']:.4f}; step ms "
            f"replay {device_ms['replay']:.4f} eager "
            f"{device_ms['eager']:.4f}")
    modules = list(model.modules())
    t0 = time.perf_counter()
    for _ in range(1000):
        infer_graph.graphable(x, modules)
    check_ms = (time.perf_counter() - t0) * 1e3 / 1000
    log(f"{dtype}: the hook check over {len(modules)} modules "
        f"{check_ms:.4f} ms a call; counters eager {step.eager_calls}, "
        f"captures {step.captures}, replays {step.replays}")
    return {"buckets": rows, "hook_check_ms": check_ms,
            "eager_calls": step.eager_calls, "captures": step.captures,
            "replays": step.replays}


def phase_infer_graph(model, device):
    """The infer step's CUDA graphs (train/infer_graph.py) at 256^2, for
    the bf16 model and an f32 copy: buckets 8/12/16/20 eager, then
    captured, then GRAPH_STEPS graphed steps in a shuffled order with a new
    input each call (f32 with cuDNN's deterministic algorithms, since two
    eager f32 steps need not repeat: their spread is logged). Every call's
    probs (the logits' softmax), preds and edge equal bit for bit to the
    eager step's on the same input (the step
    with a forward hook registered, which must run eager and fire the
    hook); each step's outputs unchanged through the next call; replays
    equal to the steps after warm-up; the kernel counters' gain a call the
    same for an eager, a capturing and a replayed call (bf16 1 Canny and 4
    dense blocks, f32 1 Canny; on a replay the counters are carried
    forward from the capture, so one replay a bucket is profiled and must
    run `canny_kernel` once and `dense_layer_kernel` as often as the eager
    step, by kernel name); a new InferState captures anew. Logged: the
    kernels of each graph (one replay profiled) beside an eager step's,
    the host and device ms of a replayed and an eager step, and the hook
    check's ms."""
    import copy

    import torch

    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.train import InferState, make_infer_step

    gen = torch.Generator().manual_seed(19)
    out = {"bfloat16": _graph_case(model, device, gen)}
    model32 = copy.deepcopy(model)
    model32.dtype = torch.float32
    # two eager f32 steps on one input differ at the last bit where cuDNN
    # picks an algorithm that sums in another order from call to call; with
    # deterministic algorithms they repeat, and the graph is held to them
    state = InferState(model32, device)
    step = make_infer_step(model32, with_probs=True)
    x = normalize_for_eval(synthetic_slices(GRAPH_BUCKETS[0], GRAPH_HW,
                                            GRAPH_HW, gen, device))
    handle = model32.fuse.register_forward_hook(lambda *_: None)
    a, b = step(state, x)[0], step(state, x)[0]
    handle.remove()
    spread = float((a - b).abs().max())
    log(f"float32: two eager steps on one input, max|d probs| {spread:.6g}")
    del state, step, a, b
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out["float32"] = _graph_case(model32, device, gen)
    finally:
        torch.backends.cudnn.deterministic = flag
    out["float32"]["eager_spread_max_abs_probs"] = spread
    del model32
    return out


def phase_ingest(model, state, images, device):
    """Pretrained-weights ingestion: the main path's seeded, calibrated
    encoder saved as torchvision's `densenet121-<sha8>.pth` (`<sha8>` its
    own digest prefix), taken through `cli.ingest_pretrained` on the card
    (checksum, .npz, graft onto a fresh SAUNet, manifest); its archive
    loaded into a fresh bf16 model as `cli.train --pretrained` loads it,
    every encoder tensor and every folded dense-block operand equal to the
    source's; then that model's infer step on the main path's slices, counters
    zeroed just before and read just after (1 Canny, 4 dense blocks), each
    K1 and K3 call recorded and held against its plain version: K1 exact,
    K3 within 0.05*max|ref| with the median under a tenth of that."""
    import hashlib

    import torch

    from saunet_tpu_torch.cli import ingest_pretrained
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.densenet import (
        load_pretrained_encoder,
        torchvision_state_dict,
    )
    from saunet_tpu_torch.parallel import parity
    from saunet_tpu_torch.train import InferState, make_infer_step

    want = {k: v for k, v in model.encoder.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    with tempfile.TemporaryDirectory() as tmp:
        tmp_pth = os.path.join(tmp, "densenet121.pth")
        torch.save(torchvision_state_dict(model.encoder), tmp_pth)
        with open(tmp_pth, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        src = os.path.join(tmp, f"densenet121-{digest[:8]}.pth")
        os.rename(tmp_pth, src)
        out = os.path.join(tmp, "weights", "densenet121.npz")
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            code = ingest_pretrained.main([src, "--out", out])
        seconds = time.perf_counter() - t0
        for line in printed.getvalue().splitlines():
            log(f"ingest_pretrained: {line}")
        require(code == 0, f"ingest_pretrained exited {code}")
        require(f"(grafted {len(want)} encoder tensors)" in printed.getvalue()
                and f"--pretrained {out}" in printed.getvalue(),
                f"ingestion did not graft the {len(want)} encoder tensors")
        with open(out + ".sha256") as f:
            manifest = f.read()
        require(manifest == f"{digest}  {os.path.basename(src)}\n",
                f"bad manifest {manifest!r}")
        # the archive the CLI wrote, as `cli.train --pretrained` loads it
        g_model = load_pretrained_encoder(
            out, build_unet(dtype="bfloat16")).to(device).eval()
    got = g_model.encoder.state_dict()
    require(all(torch.equal(got[k], v) for k, v in want.items()),
            "a grafted encoder tensor differs from the source's")
    g_state = InferState(g_model, device)
    require(all(torch.equal(a[k], b[k]) for a, b in
                zip(g_state.folded, state.folded) for k in a),
            "the grafted model's dense-block operands differ")
    step = make_infer_step(g_model, with_probs=True)
    with parity.recording_kernel_calls() as seen:
        _zero_counts()
        probs, preds, _ = step(g_state, images)
        torch.cuda.synchronize()
        launches = _counts()
    log(f"ingested model's infer launches: {launches}")
    require(launches == {"canny": 1, "dense_block": 4, "warp": 0,
                         "gather": 0, "shape_stream": 0, "resample": 0},
            f"the ingested model's infer step did not run each kernel as "
            f"expected: {launches}")
    require(preds.shape == (BATCH, SIZE, SIZE)
            and bool(torch.isfinite(probs).all())
            and int(preds.min()) >= 0 and int(preds.max()) < 4,
            "the ingested model's infer step: bad probs or labels")
    checked = parity.kernel_parity(seen)
    flips = sum(c["flips"] for c in checked["canny"])
    k3 = checked["dense_block"]
    require(len(checked["canny"]) == 1 and flips == 0,
            f"K1 on the ingested model: {checked['canny']}")
    require(len(k3) == 4 and all(
        c["max_abs_err"] <= 0.05 * c["scale"]
        and c["median_abs_err"] < 0.005 * c["scale"] for c in k3),
        f"K3 on the ingested model disagrees with its plain version: {k3}")
    worst = max(c["max_abs_err"] / (0.05 * c["scale"]) for c in k3)
    log(f"ingestion: {len(want)} encoder tensors grafted, CLI "
        f"{seconds:.3f} s; infer step K1 flips {flips}, K3 worst "
        f"{worst:.4f} of tolerance ({k3})")
    del g_model, g_state
    return launches, {"cli_seconds": seconds, "tensors": len(want),
                      "k1_flips": flips, "k3_max_err_over_tol": worst,
                      "k3_max_abs_err": max(c["max_abs_err"] for c in k3)}


def phase_warp(device):
    """K5 on the train path's tensors: the gather in its three modes and
    the warp on coordinates from the port's augmentation draws."""
    import torch
    import torch.nn.functional as F

    from saunet_tpu_torch.data.augment import coords_from_draws, draw
    from saunet_tpu_torch.ops.cuda import (
        gather_image,
        gather_image_plain,
        warp_image_label,
        warp_image_label_plain,
    )

    gen = torch.Generator().manual_seed(5)
    img, lab = synthetic_labelled(BATCH, SIZE, SIZE, gen, device)
    dgen = torch.Generator(device=device).manual_seed(6)
    sy, sx, _ = coords_from_draws(h=SIZE, w=SIZE, **draw(
        dgen, BATCH, SIZE, SIZE, True, device))
    px = img.numel()

    out_i, out_l = warp_image_label(img, lab, sy, sx)
    ref_i, ref_l = warp_image_label_plain(img, lab, sy, sx)
    torch.cuda.synchronize()
    err = float((out_i - ref_i).abs().max())
    scale = float(ref_i.abs().max())
    lab_diff = int((out_l != ref_l).sum())
    inside = float(((sy > -1) & (sy < SIZE) & (sx > -1) & (sx < SIZE))
                   .float().mean())
    log(f"warp {tuple(img.shape)}: max|err| {err:.6g} max|ref| {scale:.6g} "
        f"label mismatches {lab_diff}, inside share {inside:.4f}")
    require(err <= 1e-6 * scale and lab_diff == 0,
            "warp kernel disagrees with its plain version")
    # library yardstick (timed only): bilinear grid_sample on the image and
    # a nearest one on the labels, zero padding, pixel-centre corners
    grid = torch.stack([sx / (SIZE - 1) * 2 - 1, sy / (SIZE - 1) * 2 - 1],
                       dim=-1)
    img4, lab4 = img[:, None], lab[:, None].float()

    def library():
        F.grid_sample(img4, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
        F.grid_sample(lab4, grid, mode="nearest", padding_mode="zeros",
                      align_corners=True)

    ms = cuda_ms(lambda: warp_image_label(img, lab, sy, sx))
    plain_ms = cuda_ms(lambda: warp_image_label_plain(img, lab, sy, sx))
    library_ms = cuda_ms(library)
    bound_ms, bound_by = bound(24 * px, WARP_OPS_PER_PIXEL * px,
                               F32_OPS_PER_S)
    # device time alone (torch.profiler): a call of a few tens of us is
    # shorter than its host work, which the event pair above also holds
    dev_ms = sum(device_ms_by_kernel(
        lambda: warp_image_label(img, lab, sy, sx), 20).values())
    library_dev = device_ms_by_kernel(library, 20)
    log(f"warp: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"device ms: kernel {dev_ms:.5f}, grid_sample x2 "
        f"{sum(library_dev.values()):.5f} {library_dev}")
    result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "device_ms": dev_ms,
              "library_device_ms": sum(library_dev.values()), "gather": {}}

    for mode, lim in (("lane", SIZE), ("sublane", SIZE),
                      ("flat", SIZE * SIZE)):
        idx = torch.randint(0, lim, img.shape, generator=dgen,
                            device=device, dtype=torch.int32)
        out = gather_image(img, idx, mode)
        ref = gather_image_plain(img, idx, mode)
        torch.cuda.synchronize()
        require(torch.equal(out, ref), f"gather kernel ({mode}) disagrees")
        g_ms = cuda_ms(lambda: gather_image(img, idx, mode))
        g_plain = cuda_ms(lambda: gather_image_plain(img, idx, mode))
        g_bound, g_by = bound(12 * px, 0, F32_OPS_PER_S)
        # device time of the kernel, and of torch.gather's own kernel on an
        # int64 index made beforehand (the plain version's cast excluded)
        g_dev = sum(device_ms_by_kernel(
            lambda: gather_image(img, idx, mode), 20).values())
        idx64 = idx.long()
        view, dim = ((img.reshape(BATCH, -1), 1) if mode == "flat" else
                     (img, 2 if mode == "lane" else 1))
        i64 = idx64.reshape(view.shape)
        t_dev = sum(device_ms_by_kernel(
            lambda: torch.gather(view, dim, i64), 20).values())
        log(f"gather {mode}: exact; kernel {g_ms:.4f} ms, torch.gather "
            f"{g_plain:.4f} ms, bound {g_bound:.4f} ms ({g_by}); device ms: "
            f"kernel {g_dev:.5f}, torch.gather {t_dev:.5f}")
        # the plain version is the one torch.gather call: it is also the
        # library yardstick
        result["gather"][mode] = {"max_abs_err": 0.0, "ms": g_ms,
                                  "plain_ms": g_plain, "library_ms": g_plain,
                                  "bound_ms": g_bound, "bound_by": g_by,
                                  "device_ms": g_dev,
                                  "library_device_ms": t_dev}
    return result


def _counts():
    from saunet_tpu_torch.ops.cuda import (
        canny_edges_cuda,
        dense_block,
        gather_image,
        resample,
        shape_stream_fused,
        warp_image_label,
    )
    return {"canny": canny_edges_cuda.launches,
            "dense_block": dense_block.launches,
            "warp": warp_image_label.launches,
            "gather": gather_image.launches,
            "shape_stream": shape_stream_fused.launches,
            "resample": resample.launches}


def _zero_counts():
    from saunet_tpu_torch.ops.cuda import KERNELS
    for k in KERNELS:
        k.launches = 0


def phase_train_step(device):
    """The training main path at full width: b64 at 224^2, bf16."""
    import torch

    from saunet_tpu_torch.data import make_augment_fn
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.init import init_random_
    from saunet_tpu_torch.train import (
        create_train_state,
        dual_loss,
        make_train_step,
        radam,
    )

    gen = torch.Generator().manual_seed(7)
    model = init_random_(build_unet(dtype="bfloat16"), gen)
    tx = radam(1e-4)
    state = create_train_state(model, tx, device)
    augment = make_augment_fn()
    step = make_train_step(model, tx, augment_fn=augment)
    img, lab = synthetic_labelled(BATCH, SIZE, SIZE, gen, device)
    batch = {"image": img, "label": lab}
    dgen = torch.Generator(device=device).manual_seed(8)

    _zero_counts()
    state, metrics = step(state, batch, dgen)
    torch.cuda.synchronize()
    launches = _counts()
    log(f"train step launches: {launches}")
    require(launches == {"canny": 1, "dense_block": 0, "warp": 1,
                         "gather": 0, "shape_stream": 0,
                         "resample": 0},
            f"train step did not run each kernel as expected: {launches}")
    parts = {k: float(metrics[k]) for k in ("loss", "ce", "dice", "edge")}
    log(f"train step loss parts: {parts}, acc {float(metrics['acc']):.4f}")
    require(all(map(lambda v: v == v and abs(v) != float("inf"),
                    parts.values())), "a loss part is not finite")

    for _ in range(2):
        state, metrics = step(state, batch, dgen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, dgen)
        float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"train step b{BATCH} {SIZE}^2 bf16: {step_s * 1e3:.3f} ms median "
        f"of 5 ({BATCH / step_s:.2f} slices/s), steps {times}, "
        f"peak memory {peak / 2**30:.3f} GiB")

    # the step's pieces, in its order, timed with CUDA events
    pieces = {"augment": [], "forward_loss": [], "backward": [],
              "optimizer": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        model.train()
        ev[0].record()
        b = augment(dgen, batch)
        ev[1].record()
        seg, edge = model(b["image"].permute(0, 3, 1, 2))
        total, _ = dual_loss(seg.permute(0, 2, 3, 1),
                             edge.permute(0, 2, 3, 1), b["label"], b["edge"])
        ev[2].record()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(pieces):
            pieces[k].append(ev[i].elapsed_time(ev[i + 1]))
        del b, seg, edge, total
    pieces = {k: statistics.median(v) for k, v in pieces.items()}
    log(f"train step pieces (CUDA events, ms, median of 3): {pieces}")

    def one_step():
        nonlocal state
        state, _ = step(state, batch, dgen)

    prof = profile_window(one_step, table_path=os.path.join(
        OUT_DIR, "train_step_profile.txt"))
    log(f"train step profile: window {prof['window_ms']:.3f} ms for "
        f"{prof['steps']} steps, {prof['kernels']} kernels, device busy "
        f"{prof['device_busy_ms']:.3f} ms, idle share "
        f"{prof['device_idle_share']}")
    for name, ms in prof["top_ops_self_device_ms"]:
        log(f"  {ms:10.4f} ms/step  {name}")

    # a fixed batch at lr 1e-3: the loss falls
    fixed = augment(dgen, batch)
    tx_fixed = radam(1e-3)
    state = create_train_state(model, tx_fixed, device)
    fixed_step = make_train_step(model, tx_fixed)
    losses = []
    for _ in range(11):
        state, metrics = fixed_step(state, fixed)
        losses.append(float(metrics["loss"]))
    log(f"fixed-batch losses, lr 1e-3: {losses}")
    require(losses[-1] < losses[0],
            "the loss did not fall over 10 steps on a fixed batch")
    return launches, {"step_ms": step_s * 1e3,
                      "slices_per_s": BATCH / step_s,
                      "peak_memory_bytes": peak, "pieces_ms": pieces,
                      "profile": prof, "first_loss_parts": parts,
                      "fixed_batch_losses": losses}


# the paired transforms' batch: (64, 256, 256) slices, the crops at 224^2
TRANSFORM_HW, CROP = 256, 224
# the resample's work per output pixel (csrc/warp.cu): floors and fractions
# 4, two weights 2, tap bounds 16, offsets 12, combine 9, nearest rounding,
# bounds and offset 12
RESAMPLE_OPS_PER_PIXEL = 55


def resample_bytes(x, m, sy, sx) -> int:
    """The bytes the resample must move on these inputs: sy and sx read
    and both outputs written once an output pixel, and once each input
    pixel that a tap reads: an image pixel under a bilinear tap of nonzero
    weight inside the image, a mask pixel under a nearest tap inside it
    (a crop reads only its window, not the whole plane)."""
    import torch

    n, h, w = m.shape
    c = x.shape[-1] if x.dim() == 4 else 1
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0

    def pixels_read(taps) -> int:
        read = torch.zeros(n, h * w + 1, dtype=torch.bool, device=m.device)
        for yi, xi, used in taps:
            inside = used & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            read.scatter_(1, torch.where(inside, idx, h * w).reshape(n, -1),
                          True)
        return int(read[:, :h * w].sum())

    image = pixels_read([(y0, x0, (fy < 1) & (fx < 1)),
                         (y0, x0 + 1, (fy < 1) & (fx > 0)),
                         (y0 + 1, x0, (fy > 0) & (fx < 1)),
                         (y0 + 1, x0 + 1, (fy > 0) & (fx > 0))])
    mask = pixels_read([(torch.round(sy), torch.round(sx),
                         torch.ones_like(sy, dtype=torch.bool))])
    return 4 * (c * image + mask) + (8 + 4 * c + 4) * sy.numel()


@contextlib.contextmanager
def _record_resample_calls():
    """Record every call the paired transforms make to the resample kernel
    (its inputs and outputs) while the block runs."""
    import saunet_tpu_torch.data.transforms as transforms_mod

    kernel, seen = transforms_mod.resample, []

    def recording(*args):
        out = kernel(*args)
        seen.append((args, out))
        return out

    transforms_mod.resample = recording
    try:
        yield seen
    finally:
        transforms_mod.resample = kernel


def phase_transforms(device):
    """Phase 6b: the paired transforms (data/transforms.py) on a batch of
    BATCH slices at TRANSFORM_HW^2 on the card, every geometric one through
    the resample kernel (K5's gather onto a grid of its own shape): rotate
    (one image and three channels), translate, center and random crop to
    CROP, free scale, a 2x scale of the shorter side (its odd rows and
    columns sample at .5: the mask rounds half to even), random-sized crop
    and random sized. Counters zeroed just before and read just after: one
    resample launch a resample call, nothing else. Each call's image and
    mask exact against `resample_plain` on the same inputs. Then the
    kernel at (BATCH, 256, 256) -> (BATCH, 224, 224) on the random-sized
    crop's coordinates (median of 20, CUDA events), beside its plain
    version and F.grid_sample (bilinear image + nearest mask), its bound,
    and device times (torch.profiler)."""
    import torch
    import torch.nn.functional as F

    from saunet_tpu_torch.data import transforms as T
    from saunet_tpu_torch.ops.cuda import resample, resample_plain

    hw = TRANSFORM_HW
    img, lab = synthetic_labelled(BATCH, hw, hw,
                                  torch.Generator().manual_seed(31), device)
    rgb = torch.stack([img, img.flip(2), 255.0 - img], dim=-1)
    cases = [("random_rotate", T.random_rotate(30.0), img),
             ("random_rotate_rgb", T.random_rotate(180.0), rgb),
             ("random_translate", T.random_translate((16, 16)), img),
             ("center_crop", T.center_crop(CROP), img),
             ("random_crop", T.random_crop(CROP), img),
             ("free_scale", T.free_scale((CROP, CROP)), img),
             ("scale_shorter_side_2x", T.scale_shorter_side(2 * hw,
                                                            (hw, hw)), img),
             ("random_sized_crop", T.random_sized_crop(CROP), img),
             ("random_sized", T.random_sized(CROP), img)]
    gen = torch.Generator(device=device).manual_seed(32)
    torch.cuda.synchronize()
    _zero_counts()
    with _record_resample_calls() as seen:
        outs = {name: t(gen, x, lab) for name, t, x in cases}
    torch.cuda.synchronize()
    launches = _counts()
    log(f"transforms launches: {launches} for {len(seen)} resample calls")
    require(launches == {"canny": 0, "dense_block": 0, "warp": 0,
                         "gather": 0, "shape_stream": 0,
                         "resample": len(seen)} and len(seen) == 10,
            "the transforms did not run the resample kernel as expected")
    mismatches = {}
    for (args, (out_i, out_m)), label in zip(
            seen, [n for n, _, _ in cases] + ["random_sized (crop)"]):
        ref_i, ref_m = resample_plain(*args)
        torch.cuda.synchronize()
        mismatches[label] = (int((out_i != ref_i).sum()),
                             int((out_m != ref_m).sum()))
    log(f"transforms, resample kernel against its plain version (image, "
        f"mask mismatches): {mismatches}")
    require(all(v == (0, 0) for v in mismatches.values()),
            "the resample kernel disagrees with its plain version")
    for name, (oi, om) in outs.items():
        require(bool(torch.isfinite(oi).all()), f"{name}: not finite")
    shapes = {name: [list(oi.shape), list(om.shape)]
              for name, (oi, om) in outs.items()}
    require(shapes["center_crop"] == [[BATCH, CROP, CROP], [BATCH, CROP,
                                                            CROP]]
            and shapes["random_rotate_rgb"][0] == [BATCH, hw, hw, 3],
            f"transform output shapes {shapes}")
    # a 2x upscale: odd output rows read .5 source rows, which the mask
    # rounds to the even neighbour
    sy = seen[6][0][2]
    ties = int((sy - torch.floor(sy) == 0.5).sum())
    log(f"2x scale of the shorter side: {ties} of {sy.numel()} mask taps "
        f"at .5 rows, exact")

    (x, m, sy, sx), _ = seen[7]
    ho, wo = sy.shape[1:]
    px_out = sy.numel()
    nbytes = resample_bytes(x, m, sy, sx)
    ms = cuda_ms(lambda: resample(x, m, sy, sx))
    plain_ms = cuda_ms(lambda: resample_plain(x, m, sy, sx))
    grid = torch.stack([sx / (hw - 1) * 2 - 1, sy / (hw - 1) * 2 - 1],
                       dim=-1)
    x4, m4 = x[:, None], m[:, None].float()

    def library():
        F.grid_sample(x4, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
        F.grid_sample(m4, grid, mode="nearest", padding_mode="zeros",
                      align_corners=True)

    library_ms = cuda_ms(library)
    bound_ms, bound_by = bound(nbytes,
                               RESAMPLE_OPS_PER_PIXEL * px_out,
                               F32_OPS_PER_S)
    dev_ms = sum(device_ms_by_kernel(
        lambda: resample(x, m, sy, sx), 20).values())
    library_dev = sum(device_ms_by_kernel(library, 20).values())
    log(f"resample ({BATCH}, {hw}, {hw}) -> ({BATCH}, {ho}, {wo}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample x2 "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{nbytes} bytes, {nbytes / (16 * px_out + 8 * x.numel()):.4f} of a "
        f"whole-plane read); device "
        f"ms: kernel {dev_ms:.5f}, grid_sample x2 {library_dev:.5f}")
    return launches, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "device_ms": dev_ms,
                      "library_device_ms": library_dev,
                      "shape": [BATCH, hw, hw, ho, wo], "bytes": nbytes,
                      "mismatches": mismatches, "half_ties": ties,
                      "shapes": shapes}


def phase_trajectory(device, config: str = "card"):
    """Phase 7b (config 'card': 50 f32 steps at 64^2, batch 4) and the
    first half of 7c ('card256': 20 f32 steps at 256^2, batch 4): the
    trajectory gate of `saunet_tpu_torch.cli.fidelity` (radam(1e-3), TF32
    off) against the JAX package's losses (the config's golden under
    tests/torch_golden/): the largest per-step relative difference below
    0.02, the first below 2e-3. Counters zeroed just before and read just
    after: one Canny a step, nothing else; K1 exact (0 flips) against the
    plain Canny on every gray batch it was given."""
    import torch

    from saunet_tpu_torch.cli import fidelity as gate

    golden = gate.load_golden(config)
    steps = gate.CONFIGS[config]["steps"]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    with _record_k1_inputs() as seen:
        port = gate.run_trajectory(config, device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    res = gate.compare(port, golden, config)
    for i in range(steps):
        log(f"trajectory {config} step {i + 1}: port {port['loss'][i]:.6f} "
            f"jax {float(golden['loss'][i]):.6f} rel "
            f"{res['rel_diff'][i]:.3e}")
    log(f"trajectory {config} launches: {launches}; {seconds:.3f} s for "
        f"{steps} steps; largest relative loss difference "
        f"{res['max_rel_diff']:.4e}, first {res['first_rel_diff']:.4e}")
    require(launches == {"canny": steps, "dense_block": 0, "warp": 0,
                         "gather": 0, "shape_stream": 0, "resample": 0},
            f"the {config} trajectory did not launch K1 once a step")
    flips = _k1_flips(seen)
    log(f"trajectory {config} K1 against the plain Canny on {len(seen)} "
        f"inputs: {flips} flips")
    require(flips == 0, "K1 disagrees with the plain Canny")
    require(res["ok"], f"the {config} trajectory leaves the JAX package's: "
                       f"largest {res['max_rel_diff']:.4e} (bound "
                       f"{gate.MAX_REL_DIFF[config]}), first "
                       f"{res['first_rel_diff']:.4e} (bound "
                       f"{gate.FIRST_REL_DIFF})")
    return launches, {"steps": steps, "seconds": seconds,
                      "max_rel_diff": res["max_rel_diff"],
                      "first_rel_diff": res["first_rel_diff"],
                      "rel_diff": res["rel_diff"], "loss": port["loss"],
                      "jax_loss": golden["loss"].tolist(), "k1_flips": flips,
                      "step_seconds": port["seconds"]}


def _write_train_volumes(root, rs, patients=3, shape=(256, 256, 6)):
    """Synthetic ACDC training volumes: an ellipse in three classes."""
    import numpy as np

    from saunet_tpu_torch.data import nifti

    h, w, z = shape
    yy, xx = np.mgrid[:h, :w]
    for p in range(1, patients + 1):
        pdir = os.path.join(root, "training", f"patient{p:03d}")
        os.makedirs(pdir, exist_ok=True)
        for fr in (1, 12):
            r = 50 + 10 * p + 5 * (fr % 3)
            inside = (yy - h // 2) ** 2 + (xx - w // 2) ** 2 < r * r
            seg = (inside * (1 + (xx > w // 2) + 2 * ((yy > h // 2)
                                                     & (xx <= w // 2))))
            seg = seg.astype("uint8")[..., None].repeat(z, axis=2)
            img = (60.0 * seg + 40 * rs.rand(h, w, z)).astype("float32")
            base = os.path.join(pdir, f"patient{p:03d}_frame{fr:02d}")
            nifti.save(img, base + ".nii.gz", pixdim=(1.5, 1.5, 10))
            nifti.save(seg, base + "_gt.nii.gz", pixdim=(1.5, 1.5, 10))


def _pngs(directory: str) -> list:
    """The PNG files in `directory`, each checked for the PNG signature."""
    names = sorted(f for f in os.listdir(directory) if f.endswith(".png"))
    for name in names:
        with open(os.path.join(directory, name), "rb") as f:
            require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name}: not a PNG")
    return names


def phase_train_cli(device, tmp):
    """One epoch of `cli.train` on the card in `tmp`, then `test_and_pack`
    serves its checkpoint. Returns the data root and the checkpoint too."""
    import numpy as np
    import torch

    from saunet_tpu_torch.cli.test_and_pack import main as pack_main
    from saunet_tpu_torch.cli.train import main as train_main
    from saunet_tpu_torch.cli.train import parse_args
    from saunet_tpu_torch.data import nifti

    rs = np.random.RandomState(9)
    batch, z = 8, 6
    root = os.path.join(tmp, "data")
    _write_train_volumes(root, rs, shape=(256, 256, z))
    tdir = os.path.join(root, "testing", "patient101")
    os.makedirs(tdir)
    nifti.save((rs.rand(256, 256, z) * 300).astype(np.float32),
               os.path.join(tdir, "patient101_frame01.nii.gz"),
               pixdim=(1.5, 1.5, 10))
    argv = ["--data-root", root, "--ckpt", os.path.join(tmp, "ckpt"),
            "--num_epoch", "1", "--batch_size_per_device", str(batch),
            "--crop_size", str(SIZE), "--device", str(device),
            "--id", "smoke"]
    buf = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    out = buf.getvalue()
    ious = [line for line in out.splitlines() if line.startswith("class [")]
    log("\n".join(ious))
    # 5 training volumes and 1 validation volume of z slices
    steps, val_batches = (5 * z) // batch, -(-z // batch)
    log(f"train CLI: 1 epoch, {steps} steps, {val_batches} validation "
        f"batches, {seconds:.3f} s; launches {launches}")
    require(len(ious) == 3, "per-class IoU not printed")
    require(launches == {"canny": steps + val_batches,
                         "dense_block": 4 * val_batches, "warp": steps,
                         "gather": 0, "shape_stream": 0,
                         "resample": 0},
            f"train CLI did not run each kernel as expected: {launches}")
    run = parse_args(argv).ckpt
    files = sorted(os.listdir(run))
    require("best.json" in files and "state_epoch_1.pt" in files,
            f"train CLI wrote {files}")
    ckpt = os.path.join(run, "state_epoch_1.pt")
    out_dir, res = os.path.join(tmp, "out"), os.path.join(tmp, "res")
    pack_main(["--id", "smoke", "--checkpoint", ckpt, "--data-root", root,
               "--crop_size", str(SIZE), "--save_test_path", out_dir,
               "--result", res, "--device", str(device)])
    pred = nifti.load(os.path.join(out_dir, "patient101_ED.nii.gz")).data
    require(pred.shape == (256, 256, z), f"served shape {pred.shape}")
    require(set(np.unique(pred)) <= {0, 1, 2, 3}, "served labels")
    require(len(_pngs(os.path.join(res, "smoke"))) == z, "served PNGs")
    log(f"served the train checkpoint: {pred.shape}, labels "
        f"{sorted(np.unique(pred).tolist())}, {z} PNGs")
    return launches, {"seconds": seconds, "steps": steps,
                      "val_batches": val_batches}, root, ckpt


# 8b. the dense blocks' train layouts and remat, at phase 7's step: every
# layout computes the same math, and 'fused' takes flax's E[x^2] - E[x]^2
# statistics and rounds to bf16 at its own points, so its loss parts may
# move from 'chain's as the 'space' phase's band convs move them
LAYOUT_LOSS_RTOL = 1e-3
# the update's largest difference from the 'chain' step, as a fraction of
# the 'chain' step's largest update: DDP_UPDATE_GAP_MAX's reasoning (a
# layout that lost a gradient term moves RAdam's first, unadapted update by
# about 1, and two runs of one step differ by ~5e-3)
LAYOUT_UPDATE_GAP_MAX = 0.1
LAYOUTS = {"chain": ("chain", False), "buffer": ("buffer", False),
           "fused": ("fused", False), "chain_remat": ("chain", True),
           "fused_remat": ("fused", True)}
# a JAX train state taken up on the card: f32 at 64^2, batch 4, RAdam at
# count 7 (its adaptive branch), moments drawn to lead the update as in
# tests/torch_port_util.py's fill_opt_state; the card's step against the
# CPU's within DDP_UPDATE_GAP_MAX (a count off by one flips RAdam's branch
# and moves the update by about 1) and the loss parts within the CPU golden
# tests' rtol 1e-4
RESUME_SIZE, RESUME_BATCH, RESUME_COUNT, RESUME_LR = 64, 4, 7, 0.1
# larger batches at 224^2: does a layout that keeps less let the step hold
# more slices on the card? (layout, batch); one step each, its peak memory
HEADROOM = (("chain", 128), ("chain_remat", 256), ("fused", 256))


def _bn_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


def _params_cpu(model) -> dict:
    return {k: p.detach().float().cpu().clone()
            for k, p in model.named_parameters()}


def _layout_step(device, start, batch, mode: str, remat: bool, timed: bool):
    """One train step of phase 7's configuration from `start` with every
    dense block in `mode` (rematerialised with `remat`), its launches,
    loss parts, parameters and BatchNorm state; with `timed`, 2 warm-up
    and 5 timed steps more and the peak memory of those."""
    import torch

    from saunet_tpu_torch.data import make_augment_fn
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.train import create_train_state, make_train_step
    from saunet_tpu_torch.train import radam

    model = build_unet(dtype="bfloat16", encoder_concat=mode, remat=remat)
    model.load_state_dict(start)
    tx = radam(1e-4)
    state = create_train_state(model, tx, device)
    step = make_train_step(model, tx, augment_fn=make_augment_fn())
    dgen = torch.Generator(device=device).manual_seed(8)
    _zero_counts()
    state, metrics = step(state, batch, dgen)
    torch.cuda.synchronize()
    out = {"launches": _counts(),
           "parts": {k: float(metrics[k])
                     for k in ("loss", "ce", "dice", "edge")},
           "params": _params_cpu(model), "bn": _bn_state(model)}
    if timed:
        for _ in range(2):
            state, metrics = step(state, batch, dgen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, dgen)
            float(metrics["loss"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = statistics.median(times)
        out["steps_ms"] = times
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del model, state, step
    torch.cuda.empty_cache()
    return out


def _headroom(device, start) -> dict:
    """One warm-up and one timed train step of each HEADROOM layout and
    batch from `start`: ms and peak GiB, or "out of memory"."""
    import torch

    from saunet_tpu_torch.data import make_augment_fn
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.train import create_train_state, make_train_step
    from saunet_tpu_torch.train import radam

    out = {}
    for name, n in HEADROOM:
        mode, remat = LAYOUTS[name]
        model = build_unet(dtype="bfloat16", encoder_concat=mode, remat=remat)
        model.load_state_dict(start)
        tx = radam(1e-4)
        state = create_train_state(model, tx, device)
        step = make_train_step(model, tx, augment_fn=make_augment_fn())
        img, lab = synthetic_labelled(n, SIZE, SIZE,
                                      torch.Generator().manual_seed(12),
                                      device)
        dgen = torch.Generator(device=device).manual_seed(8)
        try:
            state, _ = step(state, {"image": img, "label": lab}, dgen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            state, metrics = step(state, {"image": img, "label": lab}, dgen)
            float(metrics["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            out[f"{name}_b{n}"] = {"step_ms": ms, "peak_gib": peak}
            log(f"headroom {name} at b{n}, {SIZE}^2 bf16: {ms:.3f} ms a "
                f"step, peak {peak:.3f} GiB")
        except torch.cuda.OutOfMemoryError:
            out[f"{name}_b{n}"] = "out of memory"
            log(f"headroom {name} at b{n}, {SIZE}^2 bf16: out of memory")
        del model, state, step, img, lab
        torch.cuda.empty_cache()
    return out


def _jax_layout(tensors: dict) -> dict:
    """A port state_dict (or any tensors keyed like its parameters) as the
    JAX package's variable tree, numpy leaves: the inverse of
    models/jax_weights.py's map (kernels to HWIO, ConvTranspose kernels
    transposed and flipped, BatchNorm `weight` to `scale`, the running
    statistics under `batch_stats`)."""
    import numpy as np

    tree = {"params": {}, "batch_stats": {}}
    stats = {"running_mean": "mean", "running_var": "var"}
    for key, v in tensors.items():
        *path, field = key.split(".")
        if field == "num_batches_tracked":
            continue
        v = v.detach().float().cpu().numpy()
        if field in stats:
            where, field = "batch_stats", stats[field]
        elif field == "weight" and v.ndim == 4:
            where, field = "params", "kernel"
            v = (v.transpose(2, 3, 0, 1)[::-1, ::-1]
                 if path[-1].startswith("ConvTranspose")
                 else v.transpose(2, 3, 1, 0))
        elif field == "weight":
            where, field = "params", "scale"
        else:
            where = "params"
        node = tree[where]
        for name in path:
            node = node.setdefault(name, {})
        node[field] = np.ascontiguousarray(v)
    return tree


def _resume_on_card(device) -> dict:
    """A JAX-layout train state, built as `utils.msgpack.load` returns a
    checkpoint (the card has no flax), restored onto the card and onto the
    CPU; one f32 step of each on the same batch."""
    import numpy as np
    import torch

    from saunet_tpu_torch.data import edge_ground_truth, normalize_for_eval
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.init import init_random_
    from saunet_tpu_torch.train import (
        create_train_state,
        make_train_step,
        radam,
        restore_jax_train_state,
    )

    gen = torch.Generator().manual_seed(11)
    model = init_random_(build_unet(dtype="float32"), gen)
    rng = np.random.default_rng(11)
    named = dict(model.named_parameters())
    mu = {k: torch.from_numpy(0.3 * rng.standard_normal(
        tuple(p.shape), np.float32)) for k, p in named.items()}
    nu = {k: torch.from_numpy(0.1 * (0.5 + rng.random(
        tuple(p.shape), np.float32))) for k, p in named.items()}
    count = np.array(RESUME_COUNT, np.int32)
    raw = {**_jax_layout(model.state_dict()), "step": count,
           "opt_state": {"0": {"count": count,
                               "mu": _jax_layout(mu)["params"],
                               "nu": _jax_layout(nu)["params"]},
                         "1": {"count": count}}}
    img, lab = synthetic_labelled(RESUME_BATCH, RESUME_SIZE, RESUME_SIZE,
                                  gen, "cpu")
    batch = {"image": normalize_for_eval(img), "label": lab,
             "edge": edge_ground_truth(lab, 4)}
    out = {}
    for where in (device, torch.device("cpu")):
        m = build_unet(dtype="float32")
        tx = radam(RESUME_LR)
        state = create_train_state(m, tx, where)
        restore_jax_train_state(raw, state)
        require(state.step == RESUME_COUNT
                and state.optimizer.state["count"] == RESUME_COUNT,
                f"resumed step {state.step} on {where}")
        moments = [state.optimizer.state[p][k] for p in m.parameters()
                   for k in ("exp_avg", "exp_avg_sq")]
        require(all(t.device.type == where.type
                    and t.dtype == torch.float32 for t in moments),
                f"resumed moments are not f32 on {where}")
        require(all(torch.equal(state.optimizer.state[p]["exp_avg"].cpu(),
                                mu[k]) for k, p in m.named_parameters()),
                f"resumed first moments differ on {where}")
        start = _params_cpu(m)
        state, metrics = make_train_step(m, tx)(state, batch)
        out[where.type] = {
            "parts": {k: float(metrics[k])
                      for k in ("loss", "ce", "dice", "edge")},
            "params": _params_cpu(m), "start": start}
    card, cpu = out[device.type], out["cpu"]
    gap = _update_gap(card["params"], cpu["params"], cpu["start"])
    rel = {k: abs(card["parts"][k] - cpu["parts"][k])
           / max(abs(cpu["parts"][k]), 1e-12) for k in cpu["parts"]}
    log(f"JAX train state resumed at step {RESUME_COUNT} on the card and the "
        f"CPU (f32, {RESUME_BATCH} x {RESUME_SIZE}^2, moments on "
        f"{device.type}): loss parts card {card['parts']}, relative "
        f"difference {rel} (limit 1e-4); update difference {gap:.4e} of "
        f"the largest update (limit {DDP_UPDATE_GAP_MAX})")
    require(all(v <= 1e-4 for v in rel.values()),
            "the resumed step's loss parts differ between the card and the "
            "CPU")
    require(gap <= DDP_UPDATE_GAP_MAX,
            "the resumed step's update differs between the card and the CPU")
    return {"loss_parts": card["parts"], "loss_rel_diff_cpu": rel,
            "update_rel_diff_cpu": gap}


def phase_layouts(device, tmp, root) -> tuple:
    """The dense blocks' train layouts and remat at phase 7's step, a JAX
    train state resumed on the card, and `cli.train --encoder_concat
    fused` for one epoch on phase 8's volumes, then `--resume` for the
    next. Returns (launches, result)."""
    import shutil

    import torch

    from saunet_tpu_torch.cli.train import main as train_main
    from saunet_tpu_torch.cli.train import parse_args
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.init import init_random_

    t_phase = time.perf_counter()
    # phase 7's weights and batch: the same seed, drawn in the same order
    gen = torch.Generator().manual_seed(7)
    model = init_random_(build_unet(dtype="bfloat16"), gen)
    start, start_params = model.state_dict(), _params_cpu(model)
    del model
    img, lab = synthetic_labelled(BATCH, SIZE, SIZE, gen, device)
    batch = {"image": img, "label": lab}
    launches, results = {}, {}
    chain = _layout_step(device, start, batch, "chain", False, timed=True)
    again = _layout_step(device, start, batch, "chain", False, timed=False)
    band_update = _update_gap(again["params"], chain["params"], start_params)
    band_loss = max(abs(again["parts"][k] - chain["parts"][k])
                    / abs(chain["parts"][k]) for k in chain["parts"])
    log(f"layouts: 'chain' against itself: loss parts {band_loss:.3e} "
        f"(relative), update {band_update:.4e} of the largest update")
    plain_bn = {}
    for name, (mode, remat) in LAYOUTS.items():
        r = chain if name == "chain" else _layout_step(
            device, start, batch, mode, remat, timed=True)
        want = {"canny": 1, "dense_block": 0, "warp": 1, "gather": 0,
                "shape_stream": 0,
                "resample": 0}
        require(r["launches"] == want,
                f"layout {name}: launches {r['launches']}")
        rel = {k: abs(r["parts"][k] - chain["parts"][k])
               / abs(chain["parts"][k]) for k in r["parts"]}
        gap = _update_gap(r["params"], chain["params"], start_params)
        log(f"layout {name}: loss parts {r['parts']}, relative to 'chain' "
            f"{rel} (limit {LAYOUT_LOSS_RTOL}); update max|d| {gap:.4e} of "
            f"'chain''s largest update (limit {LAYOUT_UPDATE_GAP_MAX}; "
            f"'chain' against itself {band_update:.4e}); K5 launched "
            f"{r['launches']['warp']}; {r['step_ms']:.3f} ms median of 5 "
            f"after 2 warm-up ({BATCH / r['step_ms'] * 1e3:.2f} slices/s), "
            f"steps {r['steps_ms']}; peak {r['peak_gib']:.3f} GiB")
        require(all(v == v and abs(v) != float("inf")
                    for v in r["parts"].values()),
                f"layout {name}: a loss part is not finite")
        require(all(v <= LAYOUT_LOSS_RTOL for v in rel.values()),
                f"layout {name}: loss parts differ from 'chain'")
        require(gap <= LAYOUT_UPDATE_GAP_MAX,
                f"layout {name}: update differs from 'chain'")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        results[name] = {"loss_parts": r["parts"], "loss_rel_diff": rel,
                         "update_rel_diff": gap, "step_ms": r["step_ms"],
                         "steps_ms": r["steps_ms"],
                         "slices_per_s": BATCH / r["step_ms"] * 1e3,
                         "peak_gib": r["peak_gib"]}
        if not remat:
            plain_bn[name] = r["bn"]
        else:
            # one EMA step, as without remat: the recompute in the
            # backward leaves the running statistics alone
            plain = plain_bn[mode]
            stats_gap = max(float((r["bn"][k].float() - v.float()).abs()
                                  .max()) for k, v in plain.items())
            tracked = {int(v) for k, v in r["bn"].items()
                       if k.endswith("num_batches_tracked")}
            log(f"layout {name}: running statistics against '{mode}' "
                f"without remat: max|d| {stats_gap:.3e}; "
                f"num_batches_tracked {sorted(tracked)}")
            require(tracked == {1}, f"layout {name}: BatchNorm updated "
                    f"{sorted(tracked)} times in one step")
            require(all(torch.allclose(r["bn"][k].float(), v.float(),
                                       rtol=1e-5, atol=1e-6)
                        for k, v in plain.items()),
                    f"layout {name}: running statistics differ from "
                    f"'{mode}' without remat")
            results[name]["running_stats_max_diff"] = stats_gap
        del r
    results["chain_band"] = {"loss_rel_diff": band_loss,
                             "update_rel_diff": band_update}
    del chain, again
    torch.cuda.empty_cache()
    results["headroom"] = _headroom(device, start)

    results["resume"] = _resume_on_card(device)
    torch.cuda.empty_cache()

    # the train CLI in the fused layout: one epoch, then --resume the next
    z, batch_size = 6, 8
    steps, val_batches = (5 * z) // batch_size, -(-z // batch_size)

    def argv(epochs):
        return ["--data-root", root, "--ckpt", os.path.join(tmp, "layouts"),
                "--num_epoch", str(epochs), "--batch_size_per_device",
                str(batch_size), "--crop_size", str(SIZE), "--device",
                str(device), "--id", "fused", "--encoder_concat", "fused"]

    cli = {}
    for epochs in (1, 2):
        args = argv(epochs)
        run = parse_args(args).ckpt
        if epochs == 2:
            os.makedirs(run)
            shutil.copy(os.path.join(parse_args(argv(1)).ckpt,
                                     "state_epoch_1.pt"), run)
            args.append("--resume")
        buf = io.StringIO()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        out = buf.getvalue()
        log(f"train CLI --encoder_concat fused, epoch {epochs}"
            f"{' (--resume)' if epochs == 2 else ''}: {seconds:.3f} s, "
            f"launches {counts}")
        require(counts == {"canny": steps + val_batches,
                           "dense_block": 4 * val_batches, "warp": steps,
                           "gather": 0, "shape_stream": 0,
                           "resample": 0},
                f"fused train CLI launches {counts}")
        require(out.count("class [") == 3, "per-class IoU not printed")
        saved = torch.load(os.path.join(run, f"state_epoch_{epochs}.pt"),
                           map_location="cpu", weights_only=True)
        require(saved["step"] == epochs * steps,
                f"epoch {epochs} saved at step {saved['step']}")
        if epochs == 2:
            require("continuing at epoch 2" in out
                    and "Epoch: [1/2]" not in out,
                    "--resume did not go on at epoch 2")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        cli[f"epoch_{epochs}_s"] = seconds
    results["cli"] = cli
    results["seconds"] = time.perf_counter() - t_phase
    log(f"layouts phase: {results['seconds']:.1f} s")
    return launches, results


def phase_convergence(device):
    """The second half of phase 7c: `saunet_tpu_torch.cli.fidelity`'s
    'stat' long-run check (300 f32 steps at 64^2, batch 8, the 16
    validation slices scored every 30 steps under the running and under
    the batch statistics) against tests/torch_golden/convergence.npz:
    tests/test_fidelity.py's floor and STAT_BOUNDS. Counters zeroed just
    before and read just after: one Canny a train step and one an eval
    forward, nothing else; K1 exact (0 flips) on every input."""
    import torch

    from saunet_tpu_torch.cli import fidelity as gate

    cfg = gate.STAT_CONFIGS["stat"]
    golden = gate.load_golden("stat")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    with _record_k1_inputs() as seen:
        port = gate.run_convergence("stat", device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    res = gate.compare_convergence(port, golden, "stat")
    for line in gate.eval_lines(port, golden):
        log(f"stat {line}")
    evals = len(port["eval_step"]) * 2 * -(-cfg["n_val"] // cfg["batch"])
    flips = _k1_flips(seen)
    log(f"stat launches: {launches}; {seconds:.3f} s (train "
        f"{sum(port['seconds']):.3f} s, eval {sum(port['eval_seconds']):.3f}"
        f" s); checks {res['checks']}; largest relative loss difference "
        f"over the first {res['bounds']['loss_steps']} steps "
        f"{res['max_loss_rel_diff']:.4e}; final mIoU running "
        f"{res['final_miou_running']:.4f} (jax "
        f"{res['jax_final_miou_running']:.4f}), batch statistics "
        f"{res['final_miou_batch']:.4f} (jax "
        f"{res['jax_final_miou_batch']:.4f}); K1 against the plain Canny "
        f"on {len(seen)} inputs: {flips} flips")
    require(launches == {"canny": cfg["steps"] + evals, "dense_block": 0,
                         "warp": 0, "gather": 0, "shape_stream": 0,
                         "resample": 0},
            "the long-run check did not launch K1 once a forward")
    require(flips == 0, "K1 disagrees with the plain Canny")
    require(res["ok"], f"the long-run check fails: {res['checks']}")
    out = {k: v for k, v in res.items() if k != "loss_rel_diff"}
    out.update(seconds=seconds, k1_flips=flips,
               train_seconds=sum(port["seconds"]),
               eval_seconds=sum(port["eval_seconds"]),
               miou_running=port["miou_running"],
               miou_batch=port["miou_batch"],
               iou_pc_running=port["iou_pc_running"])
    return launches, out


TRAINED_STEPS, TRAINED_STEPS_MAX, TRAINED_VAL = 300, 600, 16
TRAINED_AGREE_MIN, TRAINED_MIOU_GAP_MAX = 0.995, 0.01


def phase_trained_serving(device, phase4: dict, k3_scale: float):
    """Phase 7d: the serving kernels on trained weights. The full-width
    bf16 SAUNet from `fill_from_seed_` trained with `make_train_step` on
    the phantom task at 224^2 (64 training slices, batch 8, radam(1e-3),
    TRAINED_STEPS steps, 100 more at a time up to TRAINED_STEPS_MAX while
    the plain route's validation mIoU is 0.5 or less); then on the 16
    validation slices the mIoU of (a) an f32 copy's plain forward (TF32
    off), (b) the bf16 plain route, (c) `make_infer_step` (K1, K3), (d)
    the K4 route; (c) and (d) each agree with (b) on at least
    TRAINED_AGREE_MIN of the pixels and lie within TRAINED_MIOU_GAP_MAX
    mIoU of it; K3's taps within phase 4's tolerance (max|ref| beside
    phase 4's), each block within phase 3's, K4 within phase 4b's max
    and median bounds. Counters zeroed just before and read just after the
    training (one Canny a step), (c) (1 Canny, 4 dense blocks) and (d) (1
    Canny, 4 dense blocks, 1 shape stream)."""
    import copy

    import numpy as np
    import torch

    from saunet_tpu_torch.cli import fidelity as gate
    from saunet_tpu_torch.data import edge_ground_truth, make_phantom_set
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.init import fill_from_seed_
    from saunet_tpu_torch.ops.cuda import fold_shape_stream_params
    from saunet_tpu_torch.train import (
        InferState,
        create_train_state,
        make_infer_step,
        make_train_step,
        radam,
    )

    n_train, batch = 64, 8
    imgs, labels = make_phantom_set(n_train + TRAINED_VAL, hw=SIZE,
                                    seed=gate.PHANTOM_SEED)
    images = torch.from_numpy(np.repeat(imgs[..., None], 3, axis=-1)).to(
        device)
    labels = torch.from_numpy(labels).to(device)
    train = {"image": images[:n_train], "label": labels[:n_train],
             "edge": edge_ground_truth(labels[:n_train])}
    val_x, val_y = images[n_train:], labels[n_train:]

    model = fill_from_seed_(build_unet(dtype="bfloat16"), gate.WEIGHT_SEED,
                            gate.FUSE_SCALE)
    tx = radam(gate.LR)
    state = create_train_state(model, tx, device)
    step = make_train_step(model, tx)

    def plain_miou():
        model.eval()
        _, seg = route(model, InferState(model, device).folded, val_x, True)
        return gate.foreground_miou(seg.argmax(1), val_y)

    order = gate.batches(n_train, batch, TRAINED_STEPS_MAX,
                         gate.SCHEDULE_SEED)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    taken, curve = 0, []
    while True:
        stop = min(taken + 100 if taken else TRAINED_STEPS,
                   TRAINED_STEPS_MAX)
        for sel in order[taken:stop]:
            idx = torch.from_numpy(np.asarray(sel)).to(device)
            state, metrics = step(state, {k: v[idx]
                                          for k, v in train.items()})
        taken = stop
        train_launches = _counts()
        miou = plain_miou()
        curve.append((taken, float(metrics["loss"]), miou))
        log(f"trained model: {taken} steps, loss {float(metrics['loss']):.4f}"
            f", plain-route validation mIoU {miou:.4f}")
        if miou > 0.5 or taken >= TRAINED_STEPS_MAX:
            break
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    log(f"trained model: {taken} steps in {train_s:.3f} s; launches "
        f"{train_launches}")
    require(train_launches == {"canny": taken, "dense_block": 0, "warp": 0,
                               "gather": 0, "shape_stream": 0,
                               "resample": 0},
            "training did not launch K1 once a step")
    require(curve[-1][2] > 0.5, f"the trained model's plain route reaches "
                                f"mIoU {curve[-1][2]:.4f}, not above 0.5")

    model.eval()
    infer = InferState(model, device)
    x = val_x.permute(0, 3, 1, 2)
    model32 = copy.deepcopy(model)
    model32.dtype = torch.float32
    model32.edge_kernel = "plain"
    with torch.inference_mode(), gate.full_f32():
        seg_a = model32(x)[0]
    del model32
    taps_p, seg_b = route(model, infer.folded, val_x, plain=True)
    taps_k, seg_k = route(model, infer.folded, val_x, plain=False)
    infer_step = make_infer_step(model)
    _zero_counts()
    _, preds_c, _ = infer_step(infer, val_x)
    torch.cuda.synchronize()
    launches_c = _counts()
    require(launches_c == {"canny": 1, "dense_block": 4, "warp": 0,
                           "gather": 0, "shape_stream": 0, "resample": 0},
            f"trained infer step launches {launches_c}")
    require(torch.equal(seg_k.argmax(1), preds_c),
            "step preds differ from the kernel route's argmax")
    tap_scales = check_taps(taps_k, taps_p, "trained tap")
    log(f"trained taps max|ref| {[round(v, 4) for v in tap_scales]}; phase "
        f"4's (random weights, calibrated statistics) "
        f"{[round(v, 4) for v in phase4['tap_max_abs_ref']]}")

    # K3 block by block and K4 on the trained operands, held as phases 3
    # and 4b hold them; the trained stream is not chaotic, so K4's max|d|
    # is held too
    blocks = [rec for _, _, rec in check_dense_blocks(
        model, infer.folded, val_x, "trained dense block")]
    k3_ref = max(b["max_abs_ref"] for b in blocks)
    log(f"trained K3 max|ref| {k3_ref:.6g}; phase 3's {k3_scale:.6g}")
    folded = fold_shape_stream_params(model)
    with torch.inference_mode():
        packed = model.shape_stream_inputs(
            nchw_taps(model, infer.folded, val_x), x)
    _, k4 = check_shape_stream(packed, folded, what="trained shape stream")
    _zero_counts()
    seg_d = k4_route(model, infer.folded, folded, val_x)
    torch.cuda.synchronize()
    launches_d = _counts()
    require(launches_d == {"canny": 1, "dense_block": 4, "warp": 0,
                           "gather": 0, "shape_stream": 1, "resample": 0},
            f"trained K4 route launches {launches_d}")

    preds = {"a_f32_plain": seg_a.argmax(1), "b_bf16_plain": seg_b.argmax(1),
             "c_infer_step": preds_c, "d_k4_route": seg_d.argmax(1)}
    miou = {k: gate.foreground_miou(p, val_y) for k, p in preds.items()}
    ref = preds["b_bf16_plain"]
    agree = {k: float((preds[k] == ref).float().mean())
             for k in ("a_f32_plain", "c_infer_step", "d_k4_route")}
    log(f"trained routes, {TRAINED_VAL} validation slices at {SIZE}^2: "
        f"mIoU {miou}; argmax agreement with the bf16 plain route {agree}")
    for k in ("c_infer_step", "d_k4_route"):
        require(agree[k] >= TRAINED_AGREE_MIN,
                f"{k} agrees with the plain route on {agree[k]:.6f}")
        require(abs(miou[k] - miou["b_bf16_plain"]) <= TRAINED_MIOU_GAP_MAX,
                f"{k} mIoU {miou[k]:.4f} against the plain route's "
                f"{miou['b_bf16_plain']:.4f}")
    launches = {k: train_launches[k] + launches_c[k] + launches_d[k]
                for k in train_launches}
    return launches, {"steps": taken, "train_seconds": train_s,
                      "curve": curve, "miou": miou, "agreement": agree,
                      "tap_max_abs_ref": tap_scales,
                      "phase4_tap_max_abs_ref": phase4["tap_max_abs_ref"],
                      "k3_blocks": blocks, "k3_max_abs_ref": k3_ref,
                      "phase3_k3_max_abs_ref": k3_scale, "k4": k4}


SALIENCY_METHODS = {"vanilla": 1, "guided": 1, "smoothgrad": 5,
                    "smoothgrad-guided": 5}  # method -> Canny launches
SMOOTHGRAD_N, SMOOTHGRAD_BATCH = 50, 10
# the SmoothGrad map with the Canny kernel against the plain Canny, f32:
# the forward is the same; the backward's atomics (bilinear upsampling)
# may sum in another order (the phase prints how far two runs of the plain
# route differ)
SALIENCY_TOL = 1e-3


@contextlib.contextmanager
def _record_k1_inputs():
    """Record a copy of every gray image the model hands K1 while the
    block runs; the kernel itself is called once per call, as before."""
    import saunet_tpu_torch.models.saunet as saunet_mod

    kernel, seen = saunet_mod.canny_edges_cuda, []

    def recording(gray, *args, **kwargs):
        seen.append((gray.detach().clone(), args, kwargs))
        return kernel(gray, *args, **kwargs)

    saunet_mod.canny_edges_cuda = recording
    try:
        yield seen
    finally:
        saunet_mod.canny_edges_cuda = kernel


def _k1_flips(seen) -> int:
    """K1 against the plain Canny on recorded inputs: differing pixels."""
    from saunet_tpu_torch.ops.cuda import canny_edges_cuda
    from saunet_tpu_torch.ops.edge import canny_edges

    return sum(int((canny_edges_cuda(g, *a, **k) != canny_edges(g, *a, **k))
                   .sum()) for g, a, k in seen)


def phase_saliency(device, root, ckpt, tmp):
    """`cli.saliency` on the train CLI's checkpoint and a validation slice
    for every method at its defaults (256^2, f32, n = 50), counters zeroed
    just before and read just after; then guided SmoothGrad-50 of a phantom
    slice at 224^2 in bf16, batches of 10 (the JAX bench's saliency shape).
    K1 is held against the plain Canny on every input the CLI runs and the
    phantom's noisy batches gave it; the f32 map from the kernel against
    the plain Canny's, beside two runs of the plain route; maps/s and peak
    memory."""
    import numpy as np
    import torch

    from saunet_tpu_torch.cli.saliency import main as saliency_main
    from saunet_tpu_torch.data import make_phantom_set, normalize_for_eval
    from saunet_tpu_torch.interpret import (
        guided_model,
        smooth_grad,
        vanilla_gradients,
    )
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.ops.cuda import canny_edges_cuda
    from saunet_tpu_torch.train import restore_params_only

    _zero_counts()
    seconds = {}
    cli_inputs = []
    for method, canny in SALIENCY_METHODS.items():
        out = os.path.join(tmp, "saliency", method)
        c0 = canny_edges_cuda.launches
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                _record_k1_inputs() as seen:
            saliency_main(["--checkpoint", ckpt, "--data-root", root,
                           "--method", method, "--out", out,
                           "--device", str(device)])
        torch.cuda.synchronize()
        seconds[method] = time.perf_counter() - t0
        cli_inputs += seen
        pngs = _pngs(out)
        require(len(pngs) == 4 and all(p.endswith(s) for p, s in zip(
            pngs, ("_color.png", "_gray.png", "_neg.png", "_pos.png"))),
            f"saliency {method} wrote {pngs}")
        require(canny_edges_cuda.launches - c0 == canny,
                f"saliency {method}: {canny_edges_cuda.launches - c0} "
                f"Canny launches, expected {canny}")
    launches = _counts()
    log(f"saliency CLI, 256^2 f32, n = {SMOOTHGRAD_N}: seconds {seconds}; "
        f"launches {launches}")
    require(launches == {"canny": sum(SALIENCY_METHODS.values()),
                         "dense_block": 0, "warp": 0, "gather": 0,
                         "shape_stream": 0,
                         "resample": 0},
            f"saliency did not run each kernel as expected: {launches}")
    cli_flips = _k1_flips(cli_inputs)
    log(f"saliency CLI K1: {len(cli_inputs)} inputs of shapes "
        f"{sorted({tuple(g.shape) for g, _, _ in cli_inputs})}, flips "
        f"{cli_flips}")
    require(cli_flips == 0, "canny kernel disagrees on the saliency CLI's "
            "inputs")

    imgs, labels = make_phantom_set(1, hw=SIZE, seed=0)
    image = normalize_for_eval(torch.from_numpy(imgs).to(device))[0]
    target = torch.from_numpy(labels[0].astype(np.int64)).to(device)

    def load(dtype):
        model = restore_params_only(ckpt, build_unet(dtype=dtype))
        return guided_model(model.to(device).eval())

    def smoothgrad_map(model, grad_fn=None):
        gen = torch.Generator(device=device).manual_seed(0)
        return smooth_grad(
            grad_fn or (lambda b: vanilla_gradients(model, b, target)), gen,
            image, n=SMOOTHGRAD_N, batch_size=SMOOTHGRAD_BATCH)

    model = load("bfloat16")
    _zero_counts()
    with _record_k1_inputs() as batches:
        sg = smoothgrad_map(model)
        torch.cuda.synchronize()
    warm = _counts()
    require(warm["canny"] == SMOOTHGRAD_N // SMOOTHGRAD_BATCH
            and sum(warm.values()) == warm["canny"],
            f"guided SmoothGrad launches {warm}")
    require(sg.shape == (SIZE, SIZE, 3) and bool(torch.isfinite(sg).all())
            and float(sg.abs().max()) > 0, "guided SmoothGrad map")
    # K1 on the gray of each noisy batch, as the path gave it
    flips = _k1_flips(batches)
    n_batches = len(batches)
    log(f"saliency K1: {n_batches} noisy batches of "
        f"{tuple(batches[0][0].shape[:3])}, flips {flips}")
    require(flips == 0, "canny kernel disagrees on the saliency path")

    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        smoothgrad_map(model)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    map_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"guided SmoothGrad-{SMOOTHGRAD_N}, {SIZE}^2 bf16, batches of "
        f"{SMOOTHGRAD_BATCH}: {map_s * 1e3:.3f} ms a map median of 5 "
        f"({1 / map_s:.4f} maps/s), maps {times}, peak memory "
        f"{peak / 2**30:.3f} GiB")
    prof = profile_window(lambda: smoothgrad_map(model), steps=1,
                          table_path=os.path.join(OUT_DIR,
                                                  "saliency_profile.txt"))
    log(f"guided SmoothGrad profile: window {prof['window_ms']:.3f} ms, "
        f"{prof['kernels']} kernels, device busy "
        f"{prof['device_busy_ms']:.3f} ms, idle share "
        f"{prof['device_idle_share']}")
    for name, ms in prof["top_ops_self_device_ms"]:
        log(f"  {ms:10.4f} ms/map  {name}")
    # the same map with the model's own ReLU (vanilla SmoothGrad)
    relu_model = restore_params_only(ckpt, build_unet(dtype="bfloat16"))
    relu_model = relu_model.to(device).eval()
    vanilla_times = []
    for _ in range(4):
        t0 = time.perf_counter()
        smoothgrad_map(relu_model)
        torch.cuda.synchronize()
        vanilla_times.append(time.perf_counter() - t0)
    vanilla_s = statistics.median(vanilla_times[1:])
    log(f"vanilla SmoothGrad-{SMOOTHGRAD_N}, same shapes: "
        f"{vanilla_s * 1e3:.3f} ms a map median of 3 after a warm-up, "
        f"maps {vanilla_times}")
    del model, relu_model, batches

    model32 = load("float32")
    ref = smoothgrad_map(model32)
    model32.edge_kernel = "plain"
    plain = smoothgrad_map(model32)
    plain_again = smoothgrad_map(model32)
    torch.cuda.synchronize()
    err = float((ref - plain).abs().max() / plain.abs().max())
    rerun = float((plain_again - plain).abs().max() / plain.abs().max())
    log(f"guided SmoothGrad f32, Canny kernel vs plain: max|d| / max|ref| "
        f"{err:.3g} (tolerance {SALIENCY_TOL}); plain vs plain run again "
        f"{rerun:.3g}")
    require(err <= SALIENCY_TOL, "SmoothGrad with the Canny kernel "
            "disagrees with the plain Canny's")
    return launches, {"cli_seconds": seconds, "map_ms": map_s * 1e3,
                      "maps_per_s": 1 / map_s, "map_times_s": times,
                      "peak_memory_bytes": peak, "profile": prof,
                      "vanilla_map_ms": vanilla_s * 1e3,
                      "k1_flips": cli_flips + flips,
                      "k1_inputs": len(cli_inputs) + n_batches,
                      "kernel_vs_plain_f32": err,
                      "plain_vs_plain_f32": rerun}


DDP_RANKS = 2
# the CPU golden test's tolerance on the loss parts (tests/test_torch_*)
DDP_LOSS_RTOL = 1e-4
# synced running statistics against the one-process step's: both are 0.9
# of the same start plus 0.1 of batch statistics of bf16 activations,
# which the two routes compute with other algorithms and sum orders
DDP_STATS_RTOL, DDP_STATS_ATOL = 1e-2, 1e-3
# the ranks' largest update difference from the one-process step, as a
# fraction of the largest update: two runs of the one-process step differ
# by ~5e-3, a gradient off by a factor of 2 (a missing 1/world, SUM for
# AVG) moves RAdam's first, unadapted update by ~1
DDP_UPDATE_GAP_MAX = 0.1
_PARITY_NAMES = {"canny_edges_cuda": "canny", "dense_block": "dense_block",
                 "warp_image_label": "warp", "gather_image": "gather",
                 "shape_stream_fused": "shape_stream",
                 "resample": "resample"}


def _by_kernel(counts: dict) -> dict:
    return {_PARITY_NAMES[k]: v for k, v in counts.items()}


# K3's inputs on the ranks come from calibrated weights (phase 10 builds its
# model as `build_model` does): their max|ref| must be of the infer phase's
# order, at most this factor above phase 3's
K3_SCALE_FACTOR_MAX = 10.0


def _ddp_kernel_parity(runs, k3_scale=None) -> dict:
    """Every K1, K5 and K3 result that ranks recorded on their eval batch
    and train step (`parity.timed_case`; `runs`: [(label, result)]), and
    the kernel again on the first rows of each input, against the plain
    version on the same inputs: K1 exact (0 flips, as in phase 9), K5
    within 1e-6 max|ref| with exact labels (phase 6), K3 within 0.05
    max|ref| with the median below a tenth of that (phase 3), on inputs
    whose max|ref| is at most K3_SCALE_FACTOR_MAX times phase 3's
    `k3_scale` (None where the ranks run no K3). Each rank must have
    recorded as many calls as its counters read. Returns, a kernel, the
    shapes, calls and worst errors."""
    calls = {"canny": [], "warp": [], "dense_block": []}
    for label, x in runs:
        parts = [("eval", x["eval"])] if "eval" in x else []
        for part, got in parts + [("train step", x)]:
            launched = _by_kernel(got["launches"])
            for name in calls:
                n = len(got["parity"][name])
                require(n == launched[name],
                        f"{label} {part}: {n} {name} calls recorded, "
                        f"{launched[name]} launched")
                calls[name] += got["parity"][name] + got["parity_rows"][name]
    out = {}
    for name, checked in calls.items():
        if not checked:  # K3 on the 'space' axis: the plain encoder
            out[name] = {"calls": 0, "shapes": []}
            continue
        shapes = sorted({tuple(c["shape"]) for c in checked})
        if name == "canny":
            flips = sum(c["flips"] for c in checked)
            require(flips == 0, f"K1 on the ranks: {flips} flips against "
                                f"the plain Canny")
            worst = {"max_abs_err": 255.0 * (flips > 0), "flips": flips}
        elif name == "warp":
            require(all(c["max_abs_err"] <= 1e-6 * c["scale"]
                        and c["label_mismatches"] == 0 for c in checked),
                    f"K5 on the ranks disagrees with the plain warp: "
                    f"{checked}")
            worst = {"max_abs_err": max(c["max_abs_err"] for c in checked),
                     "label_mismatches": sum(c["label_mismatches"]
                                             for c in checked)}
        else:
            require(all(c["max_abs_err"] <= 0.05 * c["scale"]
                        and c["median_abs_err"] < 0.005 * c["scale"]
                        for c in checked),
                    f"K3 on the ranks disagrees with the plain dense "
                    f"block: {checked}")
            scale = max(c["scale"] for c in checked)
            require(k3_scale is not None
                    and scale <= K3_SCALE_FACTOR_MAX * k3_scale,
                    f"K3 on the ranks at max|ref| {scale:.6g}, beyond "
                    f"{K3_SCALE_FACTOR_MAX} x the infer phase's "
                    f"{k3_scale}: are the weights calibrated?")
            worst = {"max_abs_err": max(c["max_abs_err"] for c in checked),
                     "max_abs_ref": scale,
                     "infer_phase_max_abs_ref": k3_scale,
                     "max_err_over_tol": max(c["max_abs_err"]
                                             / (0.05 * c["scale"])
                                             for c in checked)}
        out[name] = {"calls": len(checked),
                     "shapes": [list(x) for x in shapes], **worst}
        log(f"{name} on the ranks against its plain version: "
            f"{out[name]}")
    return out


def _update_gap(new, ref, start) -> float:
    """max |new - ref| over the parameters, as a fraction of the largest
    update of `ref` from `start`."""
    scale = max(float((ref[k] - start[k]).abs().max()) for k in ref)
    return max(float((new[k] - ref[k]).abs().max()) for k in ref) / scale


def _ddp_reference(device, wpath, batch, eval_batch, per_rank):
    """The one-process eval (of each rank's rows, and of the whole batch)
    and train step from the weights in `wpath`, on the card."""
    import torch

    from saunet_tpu_torch.data import make_augment_fn
    from saunet_tpu_torch.parallel.parity import (
        bn_buffers,
        build_model,
        iou_counts,
    )
    from saunet_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
        radam,
    )

    model = build_model(wpath, "bfloat16")
    tx = radam(1e-4)
    state = create_train_state(model, tx, device)
    eval_step = make_eval_step(model)

    def run_eval(rows):
        b = {k: torch.from_numpy(v[rows]).to(device)
             for k, v in eval_batch.items()}
        _, preds, metrics = eval_step(state, b)
        return preds.cpu().numpy(), {k: float(v) for k, v in metrics.items()
                                     if v.dim() == 0}

    inter = union = 0
    for r in range(DDP_RANKS):
        rows = slice(r * per_rank, (r + 1) * per_rank)
        preds, _ = run_eval(rows)
        i_, u_ = iou_counts(preds, eval_batch["label"][rows],
                            eval_batch["valid"][rows])
        inter, union = inter + i_, union + u_
    whole_preds, whole_metrics = run_eval(slice(None))
    step = make_train_step(model, tx, augment_fn=make_augment_fn())
    dgen = torch.Generator(device=device).manual_seed(8)
    state, metrics = step(state, {k: torch.from_numpy(v).to(device)
                                  for k, v in batch.items()}, dgen)
    torch.cuda.synchronize()
    ref = {"inter": inter, "union": union, "whole_preds": whole_preds,
           "whole_metrics": whole_metrics,
           "metrics": {k: float(metrics[k])
                       for k in ("loss", "ce", "dice", "edge")},
           "buffers": bn_buffers(model),
           "params": {k: v.detach().cpu()
                      for k, v in model.named_parameters()}}
    del model, state, step, eval_step
    torch.cuda.empty_cache()
    return ref


def phase_data_parallel(device, tmp, root, k3_scale: float):
    """Phase 10: the data-parallel step, eval and train CLI on ranks, from
    seeded weights calibrated as `build_model` calibrates them (K3 is held
    on the ranks' inputs at the infer phase's scale, `k3_scale`)."""
    import numpy as np
    import torch

    from saunet_tpu_torch.data import edge_ground_truth, normalize_for_eval
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.init import calibrate_bn_, init_random_
    from saunet_tpu_torch.parallel.launch import run_ranks

    cards = torch.cuda.device_count()
    per_rank = BATCH // DDP_RANKS
    log(f"data parallel: {DDP_RANKS} ranks x {per_rank} slices at {SIZE}^2 "
        f"bf16 on {cards} card(s); "
        + ("both ranks share one card over gloo: this measures "
           "correctness, not scaling (gloo stages every all-reduce "
           "through the host)" if cards < DDP_RANKS else
           "NCCL, a card a rank"))
    gen = torch.Generator().manual_seed(11)
    model = init_random_(build_unet(dtype="bfloat16"), gen).to(device)
    calib = normalize_for_eval(synthetic_slices(8, SIZE, SIZE, gen, device))
    calibrate_bn_(model, calib.permute(0, 3, 1, 2))
    wpath = os.path.join(tmp, "ddp_weights.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, wpath)
    start = {k: v.detach().cpu().clone()
             for k, v in model.named_parameters()}
    del model, calib
    torch.cuda.empty_cache()
    img, lab = synthetic_labelled(BATCH, SIZE, SIZE,
                                  torch.Generator().manual_seed(12), "cpu")
    batch = {"image": img.numpy(), "label": lab.numpy()}
    eimg, elab = synthetic_labelled(BATCH, SIZE, SIZE,
                                    torch.Generator().manual_seed(13), "cpu")
    n_real = BATCH - 4  # a padded last validation batch
    eval_batch = {"image": normalize_for_eval(eimg).numpy(),
                  "label": elab.numpy(),
                  "edge": edge_ground_truth(elab).numpy(),
                  "valid": (np.arange(BATCH) < n_real).astype(np.float32)}

    ref = _ddp_reference(device, wpath, batch, eval_batch, per_rank)
    # the one-process step against itself: its backward's atomics sum in
    # another order from run to run
    again = _ddp_reference(device, wpath, batch, eval_batch, per_rank)
    spread = _update_gap(again["params"], ref["params"], start)
    log(f"one-process step run twice: loss parts "
        f"{'equal' if again['metrics'] == ref['metrics'] else 'differ'}, "
        f"largest update difference {spread:.4e} of the largest update")
    del again
    t0 = time.perf_counter()
    res = run_ranks(DDP_RANKS, "saunet_tpu_torch.parallel.parity:timed_case",
                    dict(weights=wpath, batch=batch, eval_batch=eval_batch,
                         augment_seed=8, timed_steps=3),
                    device=device.type, timeout=500)
    log(f"ranks ran in {time.perf_counter() - t0:.3f} s, backend "
        f"{res[0]['backend']}, devices {[r['device'] for r in res]}")

    # eval: launches, IoU counts, masked loss
    for r, x in enumerate(res):
        got = _by_kernel(x["eval"]["launches"])
        log(f"rank {r} eval launches: {got}")
        require(got == {"canny": 1, "dense_block": 4, "warp": 0,
                        "gather": 0, "shape_stream": 0,
                        "resample": 0},
                f"rank {r} eval did not run each kernel as expected")
    inter = sum(x["eval"]["inter"] for x in res)
    union = sum(x["eval"]["union"] for x in res)
    log(f"eval IoU counts, ranks: inter {inter.tolist()} union "
        f"{union.tolist()}; one process: inter {ref['inter'].tolist()} "
        f"union {ref['union'].tolist()}")
    require(np.array_equal(inter, ref["inter"])
            and np.array_equal(union, ref["union"]),
            "the ranks' IoU counts differ from the one-process eval's")
    preds = np.concatenate([x["eval"]["preds"] for x in res])
    whole_agree = float((preds == ref["whole_preds"]).mean())
    eval_loss = float(res[0]["eval"]["metrics"]["loss"])
    log(f"eval masked loss: ranks {eval_loss}, one process (whole batch) "
        f"{ref['whole_metrics']['loss']}; preds agree with the whole-batch "
        f"eval on {whole_agree:.6f} of pixels")

    # train step: launches, loss parts, statistics, update
    for r, x in enumerate(res):
        got = _by_kernel(x["launches"])
        log(f"rank {r} train step launches: {got}")
        require(got == {"canny": 1, "dense_block": 0, "warp": 1,
                        "gather": 0, "shape_stream": 0,
                        "resample": 0},
                f"rank {r} train step did not run each kernel as expected")
    parts = {k: float(res[0]["metrics"][k])
             for k in ("loss", "ce", "dice", "edge")}
    rel = {k: abs(parts[k] - ref["metrics"][k]) / abs(ref["metrics"][k])
           for k in parts}
    log(f"loss parts, ranks {parts}; one process {ref['metrics']}; "
        f"relative difference {rel}")
    require(all(v <= DDP_LOSS_RTOL for v in rel.values()),
            f"loss parts differ from the one-process step by more than "
            f"rtol {DDP_LOSS_RTOL}")
    for k in parts:
        require(float(res[1]["metrics"][k]) == parts[k],
                f"{k} differs between the ranks")
    b0, b1 = res[0]["buffers"], res[1]["buffers"]
    require(all(torch.equal(b0[k], b1[k]) for k in b0),
            "running statistics differ between the ranks")
    require(torch.equal(res[0]["digest"], res[1]["digest"]),
            "parameters differ between the ranks")
    stats_err = max(float(((b0[k] - ref["buffers"][k]).abs()
                           - DDP_STATS_RTOL * ref["buffers"][k].abs())
                          .max()) for k in b0)
    stats_rel = max(float((b0[k] - ref["buffers"][k]).abs().max()
                          / ref["buffers"][k].abs().max()) for k in b0)
    log(f"running statistics: equal on both ranks; largest difference "
        f"from the one-process step {stats_rel:.3e} of its layer's "
        f"largest")
    require(stats_err <= DDP_STATS_ATOL,
            f"running statistics differ from the one-process step beyond "
            f"rtol {DDP_STATS_RTOL} atol {DDP_STATS_ATOL}")
    update_gap = _update_gap(res[0]["params"], ref["params"], start)
    log(f"largest update difference, ranks vs one process: "
        f"{update_gap:.4e} of the largest update (one process against "
        f"itself: {spread:.4e}; limit {DDP_UPDATE_GAP_MAX})")
    require(update_gap <= DDP_UPDATE_GAP_MAX,
            f"the ranks' update differs from the one-process step's by "
            f"{update_gap:.4e} of the largest update")

    ranks = []
    for r, x in enumerate(res):
        step_ms = statistics.median(x["step_ms"])
        ar_ms = statistics.median(x["allreduce_window_ms"])
        log(f"rank {r}: step {step_ms:.3f} ms median of "
            f"{len(x['step_ms'])} {x['step_ms']}, gradient all-reduce "
            f"window {ar_ms:.3f} ms a step over {x['buckets']} buckets "
            f"of {x['bucket_bytes'][-1]} bytes "
            f"({x['allreduce_window_ms']}), peak memory "
            f"{x['peak_memory_bytes'] / 2**30:.3f} GiB")
        ranks.append({"step_ms": step_ms, "steps_ms": x["step_ms"],
                      "allreduce_window_ms": ar_ms,
                      "buckets": x["buckets"],
                      "bucket_bytes": x["bucket_bytes"],
                      "peak_memory_bytes": x["peak_memory_bytes"]})
    ddp_launches = {k: sum(_by_kernel(x["launches"])[k]
                           + _by_kernel(x["eval"]["launches"])[k]
                           for x in res)
                    for k in _PARITY_NAMES.values()}

    cli = _ddp_train_cli(device, tmp, root)
    one = run_ranks(1, "saunet_tpu_torch.parallel.parity:timed_case",
                    dict(weights=wpath,
                         batch={k: v[:per_rank] for k, v in batch.items()},
                         augment_seed=8, timed_steps=3, plain_turns=4),
                    device=device.type, timeout=300)[0]
    require(one["backend"] == "nccl", f"one rank ran on {one['backend']}")
    parity = _ddp_kernel_parity([(f"rank {r}", x) for r, x in enumerate(res)]
                                + [("the NCCL rank", one)], k3_scale)
    turn = {k: statistics.median(v) for k, v in one["turns_ms"].items()}
    log(f"one rank on NCCL, b{per_rank}, in turns {one['turns_ms']}: mesh "
        f"step {turn['mesh']:.3f} ms, the plain step with synced BatchNorm "
        f"{turn['synced']:.3f} ms, the plain step {turn['plain']:.3f} ms: "
        f"synced BatchNorm (plain tensor ops, an all-reduce a layer) "
        f"{turn['synced'] - turn['plain']:.3f} ms, DDP's own cost "
        f"{turn['mesh'] - turn['synced']:.3f} ms; NCCL kernels "
        f"{one['nccl_device_ms']:.4f} ms of device time a step")
    return ddp_launches, {
        "ranks": DDP_RANKS, "per_rank": per_rank, "cards": cards,
        "backend": res[0]["backend"], "kernel_parity": parity,
        "loss_parts": parts,
        "loss_rel_diff": rel, "stats_rel_diff": stats_rel,
        "update_rel_diff": update_gap,
        "update_rel_diff_one_process_rerun": spread,
        "eval_iou_inter": inter.tolist(),
        "eval_iou_union": union.tolist(), "eval_loss": eval_loss,
        "eval_loss_one_process": ref["whole_metrics"]["loss"],
        "eval_whole_batch_agreement": whole_agree, "per_rank_timing": ranks,
        "train_cli": cli,
        "one_rank_nccl": {"median_ms": turn,
                          "synced_bn_cost_ms": turn["synced"] - turn["plain"],
                          "ddp_cost_ms": turn["mesh"] - turn["synced"],
                          "turns_ms": one["turns_ms"],
                          "nccl_device_ms": one["nccl_device_ms"],
                          "step_ms": one["step_ms"],
                          "peak_memory_bytes": one["peak_memory_bytes"]}}


def _ddp_train_cli(device, tmp, root, space: int = 1):
    """`cli.train` under torchrun on DDP_RANKS ranks (as a (DDP_RANKS /
    space) x space grid), one epoch at crop 224 on phase 8's volumes; its
    checkpoint served by test_and_pack."""
    import numpy as np

    from saunet_tpu_torch.cli.test_and_pack import main as pack_main
    from saunet_tpu_torch.data import nifti

    here = os.path.dirname(os.path.abspath(__file__))
    name = "smoke_ddp" if space == 1 else "smoke_space"
    ckpt = os.path.join(tmp, f"ckpt_{name}")
    # a global batch of 8 either way
    per_device = 8 * space // DDP_RANKS
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(DDP_RANKS), "-m",
           "saunet_tpu_torch.cli.train", "--data-root", root, "--ckpt", ckpt,
           "--num_epoch", "1", "--batch_size_per_device", str(per_device),
           "--crop_size", str(SIZE), "--id", name, "--space", str(space),
           "--device", device.type]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH", "")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=500,
                          env=env, cwd=here)
    seconds = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}_train_cli.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    require(proc.returncode == 0,
            f"torchrun cli.train failed ({proc.returncode}): "
            f"{proc.stderr[-3000:]}")
    ious = [line for line in proc.stdout.splitlines()
            if line.startswith("class [")]
    log("\n".join(ious))
    require(len(ious) == 3, f"per-class IoU printed {len(ious)} times, "
                            f"not once for each of 3 classes")
    runs = os.listdir(ckpt)
    require(len(runs) == 1 and f"-ndev{DDP_RANKS}-batchSize8-" in runs[0],
            f"torchrun cli.train wrote runs {runs}")
    run = os.path.join(ckpt, runs[0])
    files = sorted(os.listdir(run))
    require(files == ["best.json", "history_epoch_1.json",
                      "state_epoch_1.pt"], f"torchrun cli.train wrote {files}")
    require(f"('data' {DDP_RANKS // space}, 'space' {space})"
            in proc.stdout, "torchrun cli.train did not lay out its grid")
    log(f"torchrun cli.train: {DDP_RANKS} ranks, 'space' {space}, one "
        f"epoch in {seconds:.3f} s; {runs[0]}: {files}")
    out_dir, res = (os.path.join(tmp, f"out_{name}"),
                    os.path.join(tmp, f"res_{name}"))
    pack_main(["--id", name, "--checkpoint",
               os.path.join(run, "state_epoch_1.pt"), "--data-root", root,
               "--crop_size", str(SIZE), "--save_test_path", out_dir,
               "--result", res, "--device", str(device)])
    pred = nifti.load(os.path.join(out_dir, "patient101_ED.nii.gz")).data
    require(set(np.unique(pred)) <= {0, 1, 2, 3}, "served labels")
    log(f"served the torchrun checkpoint: {pred.shape}, labels "
        f"{sorted(np.unique(pred).tolist())}")
    return {"seconds": seconds, "run": runs[0], "files": files,
            "served_shape": list(pred.shape)}


SPACE_RANKS, SPACE_HW, SPACE_BATCH = 2, 512, 8
# the 'space' step's loss parts against the one-process step, relative: in
# bf16 the ranks' band convs may take other cuDNN algorithms than the whole
# image's, their resizes and squeeze-and-excite means sum in f32 in
# another order, and the synced BatchNorm takes E[x^2] - E[x]^2; phase
# 10's same-shape ranks stayed within 6.74e-5 (PERF.md)
SPACE_LOSS_RTOL = 1e-3
# the 'space' eval's predictions against the one-process eval's, f32: the
# ranks' band convs (cuDNN picks algorithms by shape) and their squeeze-
# and-excite means (a sum over each rank's rows, then over the ranks) round
# differently in the last bit, which flips pixels whose top two logits are
# that close; a halo defect flips a border row of every image (512 of the
# 7 * 512^2 real pixels, 2.8e-4, at each border), 28 times this bound
SPACE_EVAL_FLIPS_MAX = 1e-5


def _space_reference(device, wpath, batch, eval_batch):
    """The one-process f32 eval (the plain encoder, TF32 off) of the whole
    eval batch and the bf16 train step with augmentation, from the
    weights in `wpath`, twice: (first, second)."""
    import torch

    from saunet_tpu_torch.data import make_augment_fn
    from saunet_tpu_torch.parallel.parity import (
        bn_buffers,
        build_model,
        iou_counts,
    )
    from saunet_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
        radam,
    )

    model = build_model(wpath, "float32")
    state = create_train_state(model, radam(0.0), device)
    _, preds, metrics = make_eval_step(model)(
        state, {k: torch.from_numpy(v).to(device)
                for k, v in eval_batch.items()})
    preds = preds.cpu().numpy()
    inter, union = iou_counts(preds, eval_batch["label"], eval_batch["valid"])
    evaluation = {"preds": preds, "inter": inter, "union": union,
                  "loss": float(metrics["loss"])}
    del model, state
    runs = []
    for _ in range(2):
        model = build_model(wpath, "bfloat16")
        tx = radam(1e-4)
        state = create_train_state(model, tx, device)
        step = make_train_step(model, tx, augment_fn=make_augment_fn())
        dgen = torch.Generator(device=device).manual_seed(8)
        state, m = step(state, {k: torch.from_numpy(v).to(device)
                                for k, v in batch.items()}, dgen)
        torch.cuda.synchronize()
        runs.append({"metrics": {k: float(m[k])
                                 for k in ("loss", "ce", "dice", "edge")},
                     "buffers": bn_buffers(model),
                     "params": {k: v.detach().cpu()
                                for k, v in model.named_parameters()}})
        del model, state, step
        torch.cuda.empty_cache()
    return evaluation, runs


def phase_space(device, tmp, root):
    """Phase 11: the 'space' axis: the eval, the step, `cli.train --space
    2` under torchrun and the 2 x 2 dry run on ranks."""
    import numpy as np
    import torch

    from saunet_tpu_torch.data import edge_ground_truth, normalize_for_eval
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.models.init import calibrate_bn_, init_random_
    from saunet_tpu_torch.parallel.dryrun import run_mesh_step
    from saunet_tpu_torch.parallel.launch import run_ranks

    log(f"space: {SPACE_RANKS} ranks as ('data' 1, 'space' {SPACE_RANKS}) "
        f"share one card over gloo, each holding {SPACE_HW // SPACE_RANKS} "
        f"of the {SPACE_HW} rows of every image: this measures "
        f"correctness, not scaling")
    gen = torch.Generator().manual_seed(21)
    model = init_random_(build_unet(dtype="float32"), gen).to(device)
    calib = normalize_for_eval(synthetic_slices(4, SPACE_HW, SPACE_HW, gen,
                                                device))
    calibrate_bn_(model, calib.permute(0, 3, 1, 2))
    wpath = os.path.join(tmp, "space_weights.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, wpath)
    start = {k: v.detach().cpu().clone()
             for k, v in model.named_parameters()}
    del model, calib
    torch.cuda.empty_cache()
    img, lab = synthetic_labelled(SPACE_BATCH, SPACE_HW, SPACE_HW,
                                  torch.Generator().manual_seed(22), "cpu")
    batch = {"image": img.numpy(), "label": lab.numpy()}
    eimg, elab = synthetic_labelled(SPACE_BATCH, SPACE_HW, SPACE_HW,
                                    torch.Generator().manual_seed(23), "cpu")
    eval_batch = {"image": normalize_for_eval(eimg).numpy(),
                  "label": elab.numpy(),
                  "edge": edge_ground_truth(elab).numpy(),
                  "valid": (np.arange(SPACE_BATCH) < SPACE_BATCH - 1).astype(
                      np.float32)}
    evaluation, (ref, again) = _space_reference(device, wpath, batch,
                                                eval_batch)
    spread = _update_gap(again["params"], ref["params"], start)
    spread_loss = max(abs(again["metrics"][k] - ref["metrics"][k])
                      / abs(ref["metrics"][k]) for k in ref["metrics"])
    log(f"one-process step run twice: loss parts differ by {spread_loss:.3e} "
        f"(relative), largest update difference {spread:.4e} of the "
        f"largest update")
    t0 = time.perf_counter()
    res = run_ranks(SPACE_RANKS,
                    "saunet_tpu_torch.parallel.parity:timed_case",
                    dict(weights=wpath, batch=batch, eval_batch=eval_batch,
                         augment_seed=8, timed_steps=3, space=SPACE_RANKS,
                         eval_dtype="float32"),
                    device=device.type, timeout=600)
    log(f"ranks ran in {time.perf_counter() - t0:.3f} s, backend "
        f"{res[0]['backend']}, devices {[r['device'] for r in res]}")

    for r, x in enumerate(res):
        got = _by_kernel(x["eval"]["launches"])
        log(f"space rank {r} eval launches: {got}")
        require(got == {"canny": 1, "dense_block": 0, "warp": 0,
                        "gather": 0, "shape_stream": 0,
                        "resample": 0},
                f"space rank {r} eval did not run each kernel as expected")
    preds = np.concatenate([x["eval"]["preds"] for x in res], axis=1)
    flips = int((preds != evaluation["preds"]).sum())
    inter = sum(x["eval"]["inter"] for x in res)
    union = sum(x["eval"]["union"] for x in res)
    log(f"space eval (f32) IoU counts, ranks: inter {inter.tolist()} union "
        f"{union.tolist()}; one process: inter "
        f"{evaluation['inter'].tolist()} union "
        f"{evaluation['union'].tolist()}; preds differ on {flips} pixels; "
        f"masked loss ranks {float(res[0]['eval']['metrics']['loss'])}, one "
        f"process {evaluation['loss']}")
    real = preds[eval_batch["valid"] > 0]
    flips_real = int((real != evaluation["preds"][
        eval_batch["valid"] > 0]).sum())
    moved = max(np.abs(inter - evaluation["inter"]).max(),
                np.abs(union - evaluation["union"]).max())
    log(f"space eval: {flips_real} of {real.size} real pixels flipped "
        f"({flips_real / real.size:.3e}; limit {SPACE_EVAL_FLIPS_MAX}); "
        f"the IoU counts moved by at most {moved}")
    require(flips_real <= SPACE_EVAL_FLIPS_MAX * real.size
            and moved <= flips_real,
            "the space ranks' predictions differ from the one-process "
            "eval's beyond f32 rounding")

    for r, x in enumerate(res):
        got = _by_kernel(x["launches"])
        log(f"space rank {r} train step launches: {got}")
        require(got == {"canny": 1, "dense_block": 0, "warp": 1,
                        "gather": 0, "shape_stream": 0,
                        "resample": 0},
                f"space rank {r} train step did not run each kernel as "
                f"expected")
    parts = {k: float(res[0]["metrics"][k])
             for k in ("loss", "ce", "dice", "edge")}
    rel = {k: abs(parts[k] - ref["metrics"][k]) / abs(ref["metrics"][k])
           for k in parts}
    log(f"space loss parts, ranks {parts}; one process {ref['metrics']}; "
        f"relative difference {rel} (limit {SPACE_LOSS_RTOL}; one process "
        f"against itself {spread_loss:.3e})")
    require(all(v <= SPACE_LOSS_RTOL for v in rel.values()),
            f"space loss parts differ from the one-process step by more "
            f"than rtol {SPACE_LOSS_RTOL}")
    for k in parts:
        require(float(res[1]["metrics"][k]) == parts[k],
                f"{k} differs between the space ranks")
    b0, b1 = res[0]["buffers"], res[1]["buffers"]
    require(all(torch.equal(b0[k], b1[k]) for k in b0),
            "running statistics differ between the space ranks")
    require(torch.equal(res[0]["digest"], res[1]["digest"]),
            "parameters differ between the space ranks")
    stats_rel = max(float((b0[k] - ref["buffers"][k]).abs().max()
                          / ref["buffers"][k].abs().max()) for k in b0)
    update_gap = _update_gap(res[0]["params"], ref["params"], start)
    log(f"space running statistics equal on both ranks, largest difference "
        f"from the one-process step {stats_rel:.3e} of its layer's largest; "
        f"largest update difference {update_gap:.4e} of the largest update "
        f"(one process against itself {spread:.4e}; limit "
        f"{DDP_UPDATE_GAP_MAX})")
    require(update_gap <= DDP_UPDATE_GAP_MAX,
            f"the space ranks' update differs from the one-process step's by "
            f"{update_gap:.4e} of the largest update")
    parity = _ddp_kernel_parity([(f"space rank {r}", x)
                                 for r, x in enumerate(res)])
    ranks = []
    for r, x in enumerate(res):
        step_ms = statistics.median(x["step_ms"])
        calls, nbytes = x["exchanges"][-1]
        log(f"space rank {r}: step {step_ms:.3f} ms median of "
            f"{len(x['step_ms'])} {x['step_ms']}, {calls} row exchanges "
            f"({nbytes / 2**20:.3f} MiB of buffers) a step, gradient "
            f"all-reduce window "
            f"{statistics.median(x['allreduce_window_ms']):.3f} ms, peak "
            f"memory {x['peak_memory_bytes'] / 2**30:.3f} GiB")
        ranks.append({"step_ms": step_ms, "steps_ms": x["step_ms"],
                      "exchanges_a_step": calls,
                      "exchange_bytes_a_step": nbytes,
                      "allreduce_window_ms": statistics.median(
                          x["allreduce_window_ms"]),
                      "peak_memory_bytes": x["peak_memory_bytes"]})
    # the halo cost by exchange: one step of rank 0 with every exchange
    # timed alone (after a device synchronise), grouped by buffer shape
    # (ranks, N, C, rows, W): one shape a layer kind and level
    by_shape = {}
    for shape, nbytes, sec in res[0]["exchange_trace"]:
        entry = by_shape.setdefault(shape, [0, 0, 0.0])
        entry[0] += 1
        entry[1] += nbytes
        entry[2] += sec * 1e3
    halo = sorted(([list(k), *v] for k, v in by_shape.items()),
                  key=lambda e: -e[3])
    halo_ms = sum(e[3] for e in halo)
    log(f"space rank 0, one step with every exchange timed alone: "
        f"{len(res[0]['exchange_trace'])} exchanges, {halo_ms:.3f} ms; by "
        f"buffer shape (ranks, N, C, rows, W): calls, bytes, ms:")
    for shape, calls, nbytes, ms in halo[:10]:
        log(f"  {shape}: {calls} calls, {nbytes / 2**20:.3f} MiB, "
            f"{ms:.3f} ms")
    launches = {k: sum(_by_kernel(x["launches"])[k]
                       + _by_kernel(x["eval"]["launches"])[k] for x in res)
                for k in _PARITY_NAMES.values()}

    cli = _ddp_train_cli(device, tmp, root, space=SPACE_RANKS)
    t0 = time.perf_counter()
    dry_loss = run_mesh_step(4, 64, device.type, timeout=300)
    dry_s = time.perf_counter() - t0
    return launches, {
        "ranks": SPACE_RANKS, "hw": SPACE_HW, "batch": SPACE_BATCH,
        "backend": res[0]["backend"], "kernel_parity": parity,
        "loss_parts": parts, "loss_rel_diff": rel,
        "loss_rel_diff_one_process_rerun": spread_loss,
        "stats_rel_diff": stats_rel, "update_rel_diff": update_gap,
        "update_rel_diff_one_process_rerun": spread,
        "eval_iou_inter": inter.tolist(), "eval_iou_union": union.tolist(),
        "eval_iou_inter_one_process": evaluation["inter"].tolist(),
        "eval_iou_union_one_process": evaluation["union"].tolist(),
        "eval_pred_flips": flips, "eval_real_pixel_flips": flips_real,
        "eval_real_pixels": int(real.size),
        "per_rank": ranks, "exchange_ms_timed_alone": halo_ms,
        "exchange_by_shape": halo, "train_cli": cli,
        "dryrun_2x2_loss": dry_loss, "dryrun_2x2_seconds": dry_s}


# phase 12: every profiler mode (saunet_tpu_torch/profile/, through the
# CLI's own argument parser) at its JAX tool's geometry, and infer at
# 512^2 x 8, most with fewer timed runs than their tools (20 or 10) to
# keep the phase short (the train-family deltas want 5: with 3 they moved
# by +-25 ms). scaling's link rate is NVLink's on the H100 SXM,
# 900 GB/s a card both ways (NVIDIA data sheet), 450 each way: a stated
# rate, not a measured one
PROFILES = (
    ("infer", ("--what", "infer", "--steps", "10")),
    ("infer_512", ("--what", "infer", "--hw", "512", "--batch", "8",
                   "--steps", "10")),
    ("decode", ("--what", "decode", "--steps", "10")),
    ("train", ("--what", "train", "--augment", "--decoder", "--steps", "5")),
    ("opt_metrics", ("--what", "opt_metrics", "--steps", "5")),
    ("block_train", ("--what", "block_train", "--steps", "5")),
    ("concat", ("--what", "concat", "--steps", "3")),
    ("res1", ("--what", "res1", "--steps", "10")),
    ("augment", ("--what", "augment")),
    ("saliency", ("--what", "saliency", "--steps", "3")),
    ("output_layout", ("--what", "output_layout", "--steps", "3")),
    ("scaling", ("--what", "scaling", "--link_gbps", "450")))
# the directly timed forward segments of a pass against the same route
# timed whole, uninstrumented
SEGMENT_SUM_RTOL = 0.1


def phase_profilers(card: str, ddp: dict, space: dict):
    """Every profiler mode on the card: its table printed (with the card's
    name and power limit) and its JSON written to OUT_DIR; each mode checks
    its own kernel launches and raises on a count that differs. Then, in
    infer and decode, each route's segments within SEGMENT_SUM_RTOL of the
    route timed whole; in scaling, the gradient class equal to phase 10's
    DDP bucket bytes a step and the row exchanges predicted at 512^2 (8
    samples a rank) equal in count and bytes to phase 11's a step."""
    import torch

    from saunet_tpu_torch.cli import profile as cli
    from saunet_tpu_torch.profile.common import print_table

    out, seconds = {}, {}
    for name, argv in PROFILES:
        t0 = time.perf_counter()
        res = cli.run(cli.parse_args(argv))
        seconds[name] = time.perf_counter() - t0
        print_table(res)
        log(f"profile {name}: {seconds[name]:.1f} s")
        require(res["card"] == card, f"profile {name} ran on {res['card']}")
        if "launches" in res:
            require(res["launches"] is not None,
                    f"profile {name} checked no launches")
        with open(os.path.join(OUT_DIR, f"profile_{name}.json"), "w") as f:
            json.dump(res, f)
        for route, r in res.get("routes", {}).items():
            log(f"profile {name} {route}: segments {r['segments_ms']:.3f} ms, "
                f"whole {r['whole_ms']:.3f} ms")
            require(abs(r["ratio"] - 1) <= SEGMENT_SUM_RTOL,
                    f"profile {name} {route}: the segments sum to "
                    f"{r['ratio']:.3f} of the whole")
        out[name] = res
        torch.cuda.empty_cache()

    from saunet_tpu_torch.profile.scaling import by_class

    inv = out["scaling"]["inventories"]
    buckets = ddp["per_rank_timing"][0]["bucket_bytes"][-1]
    for grid in inv:
        grads = by_class(inv[grid]["collectives"])["gradients"]["bytes"]
        log(f"scaling {grid}: gradient class {grads} bytes a step, phase "
            f"10's DDP buckets {buckets}")
        require(grads == buckets, f"scaling {grid}: gradients {grads} bytes, "
                                  f"phase 10's buckets {buckets}")
    rows = out["scaling"]["predicted"]["2x2"]["512^2 b8"]["classes"][
        "row_exchanges"]
    measured = space["per_rank"][0]
    log(f"scaling: row exchanges predicted at 512^2 b8 {rows['count']} "
        f"({rows['bytes'] / 2**20:.3f} MiB), phase 11 "
        f"{measured['exchanges_a_step']} "
        f"({measured['exchange_bytes_a_step'] / 2**20:.3f} MiB)")
    require(rows["count"] == measured["exchanges_a_step"]
            and rows["bytes"] == measured["exchange_bytes_a_step"],
            "scaling's row exchanges at 512^2 differ from phase 11's")
    log(f"profilers: {sum(seconds.values()):.1f} s; {seconds}")
    return {"seconds": seconds, "results": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import saunet_tpu_torch
    except ImportError:
        saunet_tpu_torch = None
    if saunet_tpu_torch is None or os.path.dirname(os.path.dirname(
            os.path.abspath(saunet_tpu_torch.__file__))) != here:
        print("chip_smoke: saunet_tpu_torch not found beside this script; "
              "run it from the root of the repository", file=sys.stderr)
        return 1
    global bound, cuda_ms, device_ms_by_kernel, profile_window
    global F32_OPS_PER_S, BF16_OPS_PER_S
    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.train import InferState
    from saunet_tpu_torch.utils.profiling import (
        BF16_OPS_PER_S,
        F32_OPS_PER_S,
        bound,
        cuda_ms,
        device_ms_by_kernel,
        profile_window,
    )

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    model = build_model(device)
    state = InferState(model, device)
    images = normalize_for_eval(synthetic_slices(
        BATCH, SIZE, SIZE, torch.Generator().manual_seed(3), device))
    canny = phase_canny(images, device)
    dense = phase_dense_block(model, state.folded, images)
    infer_launches, rates = phase_main_path(model, state, images)
    k4_launches, k4 = phase_shape_stream(model, state, images)
    ms_per_slice = phase_serving(model, device)
    graphs = phase_infer_graph(model, device)
    ingest_launches, ingest = phase_ingest(model, state, images, device)
    del model, state, images
    torch.cuda.empty_cache()
    warp = phase_warp(device)
    transform_launches, transforms = phase_transforms(device)
    torch.cuda.empty_cache()
    train_launches, train = phase_train_step(device)
    torch.cuda.empty_cache()
    trajectory_launches, trajectory = phase_trajectory(device)
    torch.cuda.empty_cache()
    trajectory_256_launches, trajectory_256 = phase_trajectory(device,
                                                               "card256")
    convergence_launches, convergence = phase_convergence(device)
    torch.cuda.empty_cache()
    trained_launches, trained = phase_trained_serving(
        device, rates, dense["max_abs_ref"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, train_cli, root, ckpt = phase_train_cli(device, tmp)
        torch.cuda.empty_cache()
        layout_launches, layouts = phase_layouts(device, tmp, root)
        torch.cuda.empty_cache()
        saliency_launches, saliency = phase_saliency(device, root, ckpt,
                                                     tmp)
        torch.cuda.empty_cache()
        ddp_launches, ddp = phase_data_parallel(device, tmp, root,
                                                dense["max_abs_ref"])
        torch.cuda.empty_cache()
        space_launches, space = phase_space(device, tmp, root)
    torch.cuda.empty_cache()
    profilers = phase_profilers(card, ddp, space)
    require("jax" not in sys.modules, "the port imported jax")

    by_path = {"infer": infer_launches, "k4_route": k4_launches,
               "ingest": ingest_launches,
               "transforms": transform_launches,
               "train_step": train_launches,
               "trajectory": trajectory_launches,
               "trajectory_256": trajectory_256_launches,
               "convergence": convergence_launches,
               "trained_serving": trained_launches, "train_cli": cli_launches,
               "layouts": layout_launches,
               "saliency": saliency_launches, "ddp": ddp_launches,
               "space": space_launches}

    def launches(name):
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        return sum(counts.values()), counts

    kernels = []
    for name, source, replaces, res, extra in (
            ("canny", "canny.cu", "saunet_tpu/ops/pallas/canny.py:230",
             canny, {"also_replaces": "saunet_tpu/ops/pallas/canny.py:189",
                     "flips": canny["flips"], "shape": canny["shape"],
                     "device_ms": canny["device_ms"],
                     "large": canny["large"],
                     "saliency_flips": saliency["k1_flips"],
                     "trajectory_256_flips": trajectory_256["k1_flips"],
                     "convergence_flips": convergence["k1_flips"],
                     "saliency_inputs": saliency["k1_inputs"],
                     "ddp": ddp["kernel_parity"]["canny"],
                     "space": space["kernel_parity"]["canny"]}),
            ("dense_block", "dense_block.cu",
             "saunet_tpu/ops/pallas/dense_block.py:256", dense,
             {"max_err_over_tol": dense["max_err_over_tol"],
              "shape": f"4 DenseNet-121 blocks, {BATCH} slices at "
                       f"{SIZE}^2", "blocks": dense["blocks"],
              "trained": {"blocks": trained["k3_blocks"],
                          "max_abs_ref": trained["k3_max_abs_ref"]},
              "ddp": ddp["kernel_parity"]["dense_block"]}),
            ("shape_stream", "shape_stream.cu",
             "saunet_tpu/ops/pallas/shape_stream.py:290", k4,
             {"shape": [BATCH, SIZE, SIZE, 67],
              "median_abs_err": k4["median_abs_err"],
              "p999_abs_err": k4["p999_abs_err"],
              "module_stream_ms": k4["module_stream_ms"],
              "stage_ms": k4["stage_ms"], "trained": trained["k4"]}),
            ("warp", "warp.cu", "tools/exp_gather.py:166", warp,
             {"shape": [BATCH, SIZE, SIZE], "device_ms": warp["device_ms"],
              "library_device_ms": warp["library_device_ms"],
              "gather": warp["gather"],
              "ddp": ddp["kernel_parity"]["warp"],
              "space": space["kernel_parity"]["warp"]}),
            ("resample", "warp.cu", "tools/exp_gather.py:166", transforms,
             {"shape": transforms["shape"],
              "device_ms": transforms["device_ms"],
              "library_device_ms": transforms["library_device_ms"],
              "mismatches": transforms["mismatches"],
              "half_ties": transforms["half_ties"]})):
        total, counts = launches(name)
        require(total > 0, f"{name} was not launched on the main paths")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"saunet_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": total,
            "launches_by_path": counts, "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms"), **extra})
    log(f"infer slices/s: kernels {rates['slices_per_s']:.3f}, plain "
        f"{rates['plain_slices_per_s']:.3f}; serving "
        f"{ms_per_slice:.4f} ms/slice; train {train['slices_per_s']:.3f} "
        f"slices/s; guided SmoothGrad-{SMOOTHGRAD_N} "
        f"{saliency['maps_per_s']:.4f} maps/s; trajectory "
        f"{trajectory['seconds']:.1f} s, largest relative loss difference "
        f"{trajectory['max_rel_diff']:.4e}; 256^2 trajectory "
        f"{trajectory_256['max_rel_diff']:.4e}; long-run check final mIoU "
        f"{convergence['final_miou_running']:.4f} (jax "
        f"{convergence['jax_final_miou_running']:.4f}); trained "
        f"routes mIoU {trained['miou']}; total "
        f"{time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"infer": rates, "k4_route": {
        k: k4[k] for k in ("route_ms", "route_slices_per_s", "step_ms",
                           "step_slices_per_s", "route_argmax_agreement",
                           "inputs_ms")},
        "serving_ms_per_slice": ms_per_slice, "infer_graph": graphs,
        "ingest": ingest,
        "train": train,
        "transforms": {k: transforms[k] for k in ("shapes", "mismatches")},
        "trajectory": trajectory, "trajectory_256": trajectory_256,
        "convergence": convergence,
        "trained_serving": trained,
        "train_cli": train_cli, "layouts": layouts, "saliency": saliency,
        "data_parallel": ddp, "space": space,
        "profiler_seconds": profilers["seconds"]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
