"""Closed-loop serving of whole volumes by one client, as the port's
`cli/test_and_pack.py` serves a study: each request is one volume of
short-axis slices, padded on the host to a multiple of `z_bucket`; its
time runs from handing the host array over (copy to the card,
`normalize_for_eval`, `make_infer_step`) to having its labels on the host.

The pool holds `pool_volumes` volumes whose slice counts are spread evenly
over z_min .. z_max, the same counts for every seed; the seed makes the
slices and the order, a new permutation of the pool each pass. BatchNorm's
running statistics come from the reference's float32 forward over
`calibration_slices` further phantoms (the batch's statistics of each
layer), made in set-up; the benchmark hands the same tensors to the
program and, after the window, to the reference. Set-up serves each bucket
size of the pool `warmup_rounds` times. Once the window has closed and
the program is freed, the reference runs a seeded sample of the window's volumes, always one of the largest
among them, and the gaps of the served labels' logits below the
reference's best are compared (reference/judge.py). Both sides are built
from the configuration's widths (common.model_kwargs) and must hold its
`parameters`. Set-up leaves out the seconds that the reference's
calibration forward takes (`reference_setup_s`).

Mix keys: pool_volumes, z_min, z_max, z_bucket, calibration_slices,
warmup_rounds, checked_volumes, profile_volumes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import phantoms, weights
from ..reference import judge
from ..reference import model as ref_model
from ..trace import Marks, profile
from .common import (
    check_parameters,
    dtype_of,
    model_kwargs,
    peak_bytes,
    peak_reset,
    plain_float32,
    release,
    seeds,
    sync,
)

SPANS = {"encoder": ("start", "stream_start"),
         "stream": ("stream_start", "stream_end"),
         "decoder": ("stream_end", "end")}


def slice_counts(mix: dict) -> list:
    n, lo, hi = mix["pool_volumes"], mix["z_min"], mix["z_max"]
    return [lo + (i * (hi - lo + 1)) // n for i in range(n)]


def run(cell) -> dict:
    from saunet_tpu_torch.data import normalize_for_eval
    from saunet_tpu_torch.models import build_unet
    from saunet_tpu_torch.train import InferState, make_infer_step

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    s = seeds(cell.seed)
    hw, bucket = cfg["crop_size"], mix["z_bucket"]
    zs = slice_counts(mix)
    calib = mix["calibration_slices"]
    images, _ = phantoms.make(calib + sum(zs), hw, s["data"], dev)
    volumes, at = [], calib
    for z in zs:
        zb = -(-z // bucket) * bucket
        padded = np.zeros((zb, hw, hw), np.float32)
        padded[:z] = images[at:at + z]
        volumes.append(padded)
        at += z

    params, buffers, reference_s = _calibrated(cfg, images[:calib],
                                               s["weights"], dev)
    kept = {n: b.cpu() for n, b in buffers.items()}
    kwargs = model_kwargs(cfg)
    with torch.device(dev):
        model = build_unet(num_class=kwargs.pop("num_classes"),
                           dtype=cfg["dtype"], **kwargs)
    check_parameters(cfg, model, "program")
    weights.load(model, params, buffers)
    del params, buffers
    state = InferState(model, dev)
    infer = make_infer_step(model)
    marks = Marks(dev.type == "cuda")
    hooks = []
    if cell.trace:
        hooks = [model.d0.register_forward_pre_hook(
                     lambda *_: marks.mark("stream_start")),
                 model.fuse.register_forward_hook(
                     lambda *_: marks.mark("stream_end"))]

    def serve(i):
        """One request: (seconds, labels of its real slices as uint8)."""
        tic = time.perf_counter()
        x = torch.from_numpy(volumes[i]).to(dev)
        batch = normalize_for_eval(x)
        marks.mark("start")
        out = infer(state, batch)
        marks.mark("end")
        preds = out[1][:zs[i]].cpu().numpy()
        seconds = time.perf_counter() - tic
        return seconds, preds.astype(np.uint8)

    rng = np.random.RandomState(s["order"])
    queue = []

    def next_volume():
        if not queue:
            queue.extend(rng.permutation(len(volumes)).tolist())
        return queue.pop(0)

    firsts = {}
    for i, v in enumerate(volumes):
        firsts.setdefault(len(v), i)
    for _ in range(mix["warmup_rounds"]):
        for i in firsts.values():
            serve(i)

    sync(dev)
    peak_reset(dev)
    served = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        i = next_volume()
        if cell.trace:
            marks.new_step()
        seconds, labels = serve(i)
        served.append((i, seconds, labels))
    t_end = time.perf_counter()
    peak = peak_bytes(dev)
    record = prof = None
    if cell.trace:
        marks.active = False
        prof = profile(lambda: [serve(next_volume())
                                for _ in range(mix["profile_volumes"])])
        record = {"spans": marks.spans(SPANS),
                  "slices": [zs[i] for i, _, _ in served],
                  "batch_slices": [len(volumes[i]) for i, _, _ in served],
                  "window_s": t_end - t0, "hw": hw, "dtype": cfg["dtype"],
                  "num_filters": cfg["num_filters"],
                  "num_classes": cfg["num_classes"],
                  "device": dev.type,
                  "peak_bytes": peak, "profile": prof}
    for h in hooks:
        h.remove()
    del state, model, infer
    release(dev)

    slices = sum(zs[i] for i, _, _ in served)
    lat_ms = np.array([sec for _, sec, _ in served]) * 1e3
    readings = _reference(cell, s, volumes, zs, served, kept)
    checks = [(k, readings[k], limit) for k, limit in cell.limits.items()]
    return {"attempted": len(served), "failed": 0, "window_start": t0,
            "reference_setup_s": reference_s,
            "e2e": {"serve_slices_per_s": slices / (t_end - t0),
                    "serve_volume_ms_p95": float(np.percentile(lat_ms, 95))},
            "peak_bytes": peak, "record": record, "profile": prof,
            "checks": checks, "readings": readings}


def _reference_model(cfg, dev):
    ref = ref_model.SAUNet(**model_kwargs(cfg)).to(dev)
    check_parameters(cfg, ref, "reference")
    return ref


def _calibrated(cfg, slices, seed, dev):
    """The seeded weights, BatchNorm's running statistics from the
    reference's float32 forward over `slices` (each layer's batch
    statistics), and the seconds the reference took, making the weights
    left out."""
    tic = time.perf_counter()
    ref = _reference_model(cfg, dev)
    sync(dev)
    reference_s = time.perf_counter() - tic
    params = weights.make_state(ref, seed, dev)
    sync(dev)
    tic = time.perf_counter()
    weights.load(ref, params)
    ref_model.set_mode(ref, bn="calibrate", input_dtype=dtype_of(cfg))
    with torch.no_grad(), plain_float32():
        ref(ref_model.eval_input(torch.from_numpy(slices).to(dev)))
    buffers = {n: b.detach().clone() for n, b in ref.named_buffers()
               if not n.endswith("num_batches_tracked")}
    del ref
    release(dev)
    return params, buffers, reference_s + time.perf_counter() - tic


def _reference(cell, s, volumes, zs, served, buffers) -> dict:
    """The gaps of the served labels of a seeded sample of the window's
    requests (always one of the largest volumes among them) under the
    float32 reference; with a control, also those of the labels that the
    control puts first."""
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    rng = np.random.RandomState(s["sample"])
    largest = max(range(len(served)), key=lambda k: zs[served[k][0]])
    rest = [k for k in range(len(served)) if k != largest]
    take = min(mix["checked_volumes"] - 1, len(rest))
    sample = [largest] + (sorted(rng.choice(rest, take, replace=False)
                                 .tolist()) if take else [])
    ref = _reference_model(cfg, dev)
    weights.load(ref, weights.make_state(ref, s["weights"], dev), buffers)
    ref_model.set_mode(ref, bn="eval", input_dtype=dtype_of(cfg))
    gaps, slices = [], 0
    control_gaps = {cast: [] for cast in cell.controls()}
    with torch.no_grad(), plain_float32():
        for k in sample:
            i, _, labels = served[k]
            x = ref_model.eval_input(
                torch.from_numpy(volumes[i][:zs[i]]).to(dev))
            ref_model.set_mode(ref, cast=None)
            logits = ref(x)[0]
            gaps.append(judge.pixel_gaps(
                logits, torch.from_numpy(labels).to(dev)).flatten())
            for cast, found in control_gaps.items():
                ref_model.set_mode(ref, cast=cast)
                found.append(judge.pixel_gaps(
                    logits, ref(x)[0].argmax(dim=1)).flatten())
            slices += zs[i]
            del logits, x
    return dict(judge.serve_readings(torch.cat(gaps)),
                checked_volumes=len(sample), checked_slices=slices,
                controls={cast: judge.serve_readings(torch.cat(found))
                          for cast, found in control_gaps.items()})

