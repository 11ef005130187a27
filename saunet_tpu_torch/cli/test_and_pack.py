"""Inference driver: `python -m saunet_tpu_torch.cli.test_and_pack <flags>`
(counterpart of saunet_tpu/cli/test_and_pack.py, same flags).

Load a checkpoint, run the ACDC test set with all z-slices of a volume as
one batch (padded to a `--z_bucket` multiple), repack the argmax into the
original 3D geometry (undo crop + nearest resample), save NIfTI volumes,
and optionally write side-by-side PNGs (utils/png.py: no imaging package
needed). `--checkpoint` is a checkpoint of the port's train CLI
(`state_epoch_<N>.pt`), a `torch.save`d port state_dict, or a JAX package
checkpoint (`state_epoch_<N>.msgpack`); all are read by
`train.checkpoint.restore_params_only`. It runs on the card (`--device
cuda`, the default; a missing card is an error) unless another device is
named. The port has one stream layout: `--stream_impl` is accepted and runs
the same math.

Each volume is served by `train.serve_volume`; `timing.json` in
`--save_test_path` holds the mean host-clock ms a real slice from handing
the padded volume over to having its labels. To trace a study, pass
`--trace_dir DIR`: the volume loop then runs under torch.profiler (host
and card), its trace is written to DIR (TensorBoard's format), and
`spans.json` beside `timing.json` holds, for each of the program's spans
(`saunet.serve` > `saunet.copy_in`, `saunet.normalize`, `saunet.step` >
`saunet.encoder`, `saunet.stream`, `saunet.canny`, `saunet.decoder`,
`saunet.head`; `saunet.labels_out`), its count, parent, median and p95
host ms and, on the card, the median device ms of the kernels it
launched and the ms the card idled while it was the innermost span open,
with the idle outside every span as "(outside the spans)"
(utils/profiling.py::span_summary), and under "(infer step)" how the infer
step ran: its `eager_calls`, `captures` and `replays` (the step replays a
CUDA graph on the card; under a replay the card's kernels fall under
`saunet.step`, not under the spans inside it).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np

from ..data import ACDCTestDataset, nifti, resample_to_orig
from ..models import build_unet
from ..train import (
    InferState,
    make_infer_step,
    restore_params_only,
    serve_volume,
)
from ..train.state import resolve_device
from ..utils import AverageMeter, profiling
from ..utils.png import write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SAUNet (PyTorch) test + pack")
    p.add_argument("--id", required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--arch_unet", default="saunet")
    p.add_argument("--num_class", default=4, type=int)
    p.add_argument("--data-root", dest="data_root", type=str,
                   default=os.getenv("DATA_ROOT", ""))
    p.add_argument("--series-file", dest="series_file", type=str, default="")
    p.add_argument("--crop_size", default=256, type=int)
    p.add_argument("--stream_impl", default="auto",
                   choices=["auto", "xla", "packed"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--visualize", action="store_true", default=True)
    p.add_argument("--no-visualize", dest="visualize", action="store_false")
    p.add_argument("--result", default="./result")
    p.add_argument("--save_test_path", default="./test_files")
    p.add_argument("--attention_map", action="store_true",
                   help="also export the decoder attention + shape-stream "
                        "gate maps per volume as PNGs under "
                        "<result>/<id>/attention/")
    p.add_argument("--z_bucket", default=4, type=int,
                   help="slice-batch bucket granularity")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    p.add_argument("--trace_dir", default="",
                   help="profile the volume loop into this directory and "
                        "write spans.json beside timing.json")
    args = p.parse_args(argv)
    args.result = os.path.join(args.result, args.id)
    return args


def visualize_result(img2d: np.ndarray, pred2d: np.ndarray, out_path: str):
    """Side-by-side grayscale image | prediction*85 PNG."""
    img = img2d.astype(np.float64)
    rng = img.max() - img.min()
    img = ((img - img.min()) / rng * 255.0 if rng > 0
           else np.zeros_like(img)).astype(np.uint8)
    pred = (pred2d * 85).astype(np.uint8)
    write_png(out_path, np.concatenate([img, pred], axis=1))


def save_attention_maps(atts, vol_name: str, z: int, out_dir: str):
    """The decoder attention maps (att2..att5, upsampled) and the three
    shape-stream gate maps as per-slice grayscale PNGs."""
    os.makedirs(out_dir, exist_ok=True)
    names = ["att2", "att3", "att4", "att5", "gate1", "gate2", "gate3"]
    for k, amap in enumerate(atts):
        name = names[k] if k < len(names) else f"att{k}"
        a = amap.float().cpu().numpy()[:z, :, :, 0]
        lo, hi = a.min(), a.max()
        a8 = ((a - lo) / (hi - lo) * 255.0 if hi > lo
              else np.zeros_like(a)).astype(np.uint8)
        for zz in range(z):
            write_png(os.path.join(out_dir, f"{vol_name}_{name}_z{zz}.png"),
                      a8[zz])


def main(argv=None):
    args = parse_args(argv)
    print("Input arguments:")
    for k, v in sorted(vars(args).items()):
        print(f"  {k:20} {v}")

    device = resolve_device(args.device)
    model = build_unet(num_class=args.num_class, arch=args.arch_unet,
                       dtype=args.dtype)
    restore_params_only(args.checkpoint, model)
    state = InferState(model, device)
    infer = make_infer_step(model, with_att=args.attention_map)

    ds = ACDCTestDataset(args.data_root,
                         series_file=args.series_file or None,
                         target_size=args.crop_size)
    os.makedirs(args.save_test_path, exist_ok=True)
    if args.visualize:
        os.makedirs(args.result, exist_ok=True)

    time_meter = AverageMeter()
    profiling.clear_spans()
    with (profiling.trace(args.trace_dir) if args.trace_dir
          else contextlib.nullcontext()) as prof:
        for i in range(len(ds)):
            vol = ds.load_volume(i)
            z = vol.image.shape[2]
            preds, out, seconds = serve_volume(
                state, infer, np.moveaxis(vol.image, 2, 0), args.z_bucket)
            time_meter.update(seconds / z, weight=z)

            pred_volume = np.moveaxis(preds, 0, 2).astype(np.uint8)
            pv_resized = resample_to_orig(pred_volume, vol)
            out_path = os.path.join(args.save_test_path,
                                    vol.name + ".nii.gz")
            nifti.save(pv_resized.astype(np.uint8), out_path)
            print(f"Saved {vol.name}! ({z} slices, "
                  f"{time_meter.average() * 1e3:.2f} ms/slice avg)")

            if args.visualize:
                orig = _orig_volume(ds, i)
                for zz in range(vol.orig_shape[2]):
                    visualize_result(
                        orig[:, :, zz], pv_resized[:, :, zz],
                        os.path.join(args.result, f"{vol.name}{zz}.png"))
            if args.attention_map:
                save_attention_maps(out[3], vol.name, z,
                                    os.path.join(args.result, "attention"))

    with open(os.path.join(args.save_test_path, "timing.json"), "w") as f:
        json.dump({"ms_per_slice": float(time_meter.average() * 1e3),
                   "device": str(device)}, f)
    if args.trace_dir:
        spans = profiling.span_summary(events=prof.events())
        spans["(infer step)"] = {k: getattr(infer, k) for k in
                                 ("eager_calls", "captures", "replays")}
        with open(os.path.join(args.save_test_path, "spans.json"), "w") as f:
            json.dump(spans, f, indent=1)
    print("Evaluation Done!")


def _orig_volume(ds: ACDCTestDataset, index: int) -> np.ndarray:
    patient, frame = ds.series[index]
    base = os.path.join(ds.test_dir, f"patient{patient:03d}",
                        f"patient{patient:03d}_frame{frame:02d}")
    path = base + ".nii.gz"
    if not os.path.exists(path):
        path = base + ".nii"
    return np.asarray(nifti.load(path).data)


if __name__ == "__main__":
    main()
