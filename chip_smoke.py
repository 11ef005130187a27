#!/usr/bin/env python3
"""Smoke run of the PyTorch port (saunet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device: the card's name and power limit, torch and CUDA versions; TF32
     off for every f32 product, so the plain references are full f32.
  2. build: both CUDA kernels from csrc/ into build/, nvcc runs in parallel.
  3. kernels vs plain, on the tensors the main path gives them: Canny on
     the gray images of 64 slices at 224^2 and on (8, 512, 512), exact; the
     dense block on the inputs of DenseNet-121's four blocks for those 64
     slices, bf16, within 0.05*max|ref| and a median under a tenth of that.
     Median times over 20 runs (CUDA events).
  4. main path: full-width bf16 SAUNet with seeded random weights and BN
     statistics calibrated on synthetic slices, `make_infer_step` on 64
     slices at 224^2. The launch counters are zeroed just before and read
     just after: 1 Canny and 4 dense-block launches. The encoder taps are
     held against the all-plain bf16 route within 0.05*max|ref|; the
     logits' argmax agrees on >= 0.95 of pixels, and the kernel route is no
     farther from an f32 plain run than the plain bf16 route is. Slices/s
     of both routes.
  5. serving: 3 synthetic volumes (256x256x10) through
     `saunet_tpu_torch.cli.test_and_pack`: NIfTI outputs in the original
     geometry with labels in {0..3}, timing.json, and the kernels launched.
Then a {"kernels": [...]} line and, last, the {"ok": true, "device": ...}
line. Without CUDA, or without the package beside it, it exits non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BATCH, SIZE = 64, 224
CANNY_LARGE = (8, 512, 512)
TIMED_RUNS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` over `runs` CUDA-event timings."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def synthetic_slices(n: int, h: int, w: int, gen, device):
    """(n, h, w) f32 slices: bright ellipses on a ramp plus noise."""
    import torch

    yy, xx = torch.meshgrid(torch.linspace(-1, 1, h),
                            torch.linspace(-1, 1, w), indexing="ij")
    cy, cx = (torch.rand(2, n, 1, 1, generator=gen) - 0.5) * 0.6
    ry, rx = 0.2 + 0.3 * torch.rand(2, n, 1, 1, generator=gen)
    blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).float()
    img = 200 * blob + 60 * (xx + 1) + 20 * torch.rand(n, h, w, generator=gen)
    return img.to(device)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    from saunet_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build(["canny", "dense_block"])
    for name, path in paths.items():
        build.load(name)
        log(f"built {name}: {os.path.relpath(path)}")
    log(f"build seconds: {time.perf_counter() - t0:.3f}")


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
        log(f"canny {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not result:
            result = {"max_abs_err": float((out - ref).abs().max()),
                      "flips": flips, "shape": list(shape), "ms": ms,
                      "plain_ms": plain_ms}
    return result


def phase_dense_block(model, folded, images):
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
    total_ms = total_plain = worst = worst_err = 0.0
    for x, f in zip(inputs, folded):
        n, hw, _, c0 = x.shape
        num_layers = f["w1"].shape[0]
        with torch.inference_mode():
            out = dense_block(x, f)
            ref = dense_block_plain(x, f)
        torch.cuda.synchronize()
        require(out.shape == ref.shape
                == (n, hw, hw, c0 + 32 * num_layers),
                f"dense block shape {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = 0.05 * float(ref.float().abs().max())
        max_err, med = float(err.max()), float(err.median())
        log(f"dense block {tuple(x.shape)} x {num_layers}: "
            f"max|err| {max_err:.6g} median {med:.6g} tol {tol:.6g}")
        require(bool(torch.isfinite(out.float()).all()),
                "dense block kernel output not finite")
        require(max_err <= tol and med < tol / 10,
                "dense block kernel disagrees with its plain version")
        with torch.inference_mode():
            ms = cuda_ms(lambda: dense_block(x, f))
            plain_ms = cuda_ms(lambda: dense_block_plain(x, f))
        log(f"dense block {tuple(x.shape)} x {num_layers}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        total_ms += ms
        total_plain += plain_ms
        worst = max(worst, max_err / tol)
        worst_err = max(worst_err, max_err)
    return {"max_abs_err": worst_err, "max_err_over_tol": worst,
            "ms": total_ms, "plain_ms": total_plain}


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


def quantile_abs(d, q: float = 0.999) -> float:
    flat = d.flatten().float()
    return float(flat.kthvalue(max(1, int(q * flat.numel()))).values)


def phase_main_path(model, state, images):
    import copy

    import torch

    from saunet_tpu_torch.models.fused_encoder import fold_encoder
    from saunet_tpu_torch.ops.cuda import KERNELS, canny_edges_cuda, dense_block
    from saunet_tpu_torch.train import make_infer_step

    step = make_infer_step(model, with_probs=True)
    for k in KERNELS:
        k.launches = 0
    probs, preds, edge = step(state, images)
    torch.cuda.synchronize()
    launches = {"canny": canny_edges_cuda.launches,
                "dense_block": dense_block.launches}
    log(f"main path launches: {launches}")
    require(launches == {"canny": 1, "dense_block": 4},
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
    for i, (tk, tp) in enumerate(zip(taps_k, taps_p)):
        d = float((tk.float() - tp.float()).abs().max())
        scale = float(tp.float().abs().max())
        log(f"tap f{i + 1} {tuple(tk.shape)}: max|d| {d:.6g} "
            f"max|ref| {scale:.6g}")
        require(d <= 0.05 * scale, f"tap f{i + 1} disagrees with plain")

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
                      "logits_max_abs_diff": dmax}


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
                   "--crop_size", str(SIZE), "--no-visualize",
                   "--save_test_path", out, "--result",
                   os.path.join(tmp, "res"), "--device", str(device)])
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
        f"launches canny {dc} dense_block {dd}")
    require(dc == 3 and dd == 12, "serving did not run through the kernels")
    return timing["ms_per_slice"]


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
    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.train import InferState

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
    launches, rates = phase_main_path(model, state, images)
    ms_per_slice = phase_serving(model, device)
    require("jax" not in sys.modules, "the port imported jax")

    kernels = [
        {"name": "canny", "route": "cuda",
         "source": "saunet_tpu_torch/csrc/canny.cu",
         "replaces": "saunet_tpu/ops/pallas/canny.py:230",
         "also_replaces": "saunet_tpu/ops/pallas/canny.py:189",
         "launches": launches["canny"], "max_abs_err": canny["max_abs_err"],
         "flips": canny["flips"], "shape": canny["shape"],
         "ms": canny["ms"], "plain_ms": canny["plain_ms"]},
        {"name": "dense_block", "route": "cuda",
         "source": "saunet_tpu_torch/csrc/dense_block.cu",
         "replaces": "saunet_tpu/ops/pallas/dense_block.py:256",
         "launches": launches["dense_block"],
         "max_abs_err": dense["max_abs_err"],
         "max_err_over_tol": dense["max_err_over_tol"],
         "shape": f"4 DenseNet-121 blocks, {BATCH} slices at {SIZE}^2",
         "ms": dense["ms"], "plain_ms": dense["plain_ms"]},
    ]
    log(f"infer slices/s: kernels {rates['slices_per_s']:.3f}, plain "
        f"{rates['plain_slices_per_s']:.3f}; serving "
        f"{ms_per_slice:.4f} ms/slice; total {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"infer": rates, "serving_ms_per_slice": ms_per_slice}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
