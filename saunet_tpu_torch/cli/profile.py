"""Profiler entry point: `python -m saunet_tpu_torch.cli.profile --what
<mode>` (counterpart of the JAX package's tools/profile_*.py,
tools/exp_output_layout.py and tools/predict_scaling.py, whose PROF_BATCH,
PROF_HW and PROF_STEPS defaults it keeps).

Modes (saunet_tpu_torch/profile/): infer, decode, train, opt_metrics,
block_train, concat, res1, augment, saliency, output_layout, scaling.
Each prints a table (segment, ms, the JAX tool's row it answers to) with
the card's name and power limit, and one JSON line. It runs on the card
(`--device cuda`, the default; a missing card is an error) unless another
device is named; on the CPU the times are the host clock's.
"""
from __future__ import annotations

import argparse
import sys

from ..profile import (
    augment,
    blocks,
    common,
    decode,
    infer,
    opt_metrics,
    saliency,
    scaling,
    train,
)

MODES = ("infer", "decode", "train", "opt_metrics", "block_train", "concat",
         "res1", "augment", "saliency", "output_layout", "scaling")
#: each mode's default steps (PROF_STEPS of its JAX tool)
STEPS = {"infer": infer.STEPS, "decode": decode.STEPS, "train": train.STEPS,
         "opt_metrics": train.STEPS, "augment": augment.STEPS,
         "saliency": saliency.STEPS, "output_layout": train.STEPS,
         **blocks.STEPS}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--what", required=True, choices=MODES)
    p.add_argument("--batch", type=int, default=common.PROF_BATCH)
    p.add_argument("--hw", type=int, default=None,
                   help=f"image size (default {common.PROF_HW}; scaling: "
                        f"the ranks' size, {scaling.CHILD_HW})")
    p.add_argument("--steps", type=int, default=None,
                   help="timed runs (default: the JAX tool's)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    p.add_argument("--concat", default="chain",
                   choices=["chain", "buffer", "fused"],
                   help="train: the dense blocks' train layout")
    p.add_argument("--remat", action="store_true",
                   help="train: rematerialise the dense blocks")
    p.add_argument("--augment", action="store_true",
                   help="train: the step augments its batch (K5)")
    p.add_argument("--decoder", action="store_true",
                   help="train: cumulative grads through each decoder stage")
    p.add_argument("--sg_n", type=int, default=saliency.SG_N,
                   help="saliency: SmoothGrad's noisy copies")
    p.add_argument("--sg_batch", type=int, default=saliency.SG_BATCH,
                   help="saliency: copies a forward and backward")
    p.add_argument("--link_gbps", type=float, default=None,
                   help="scaling (required there): each card's link rate, "
                        "GB/s")
    args = p.parse_args(argv)
    if args.what == "scaling" and args.link_gbps is None:
        p.error("--what scaling needs --link_gbps")
    return args


def run(args) -> dict:
    """The mode's report (profile/common.py)."""
    what, device = args.what, args.device
    if what == "scaling":
        return scaling.run(device, hw=args.hw or scaling.CHILD_HW,
                           link_gbps=args.link_gbps)
    kw = dict(device=device, hw=args.hw or common.PROF_HW,
              steps=args.steps or STEPS[what])
    if what == "saliency":
        return saliency.run(sg_n=args.sg_n, sg_batch=args.sg_batch, **kw)
    kw["batch"] = args.batch
    if what == "train":
        return train.run(concat=args.concat, remat=args.remat,
                         augment=args.augment, decoder=args.decoder, **kw)
    fn = {"infer": infer.run, "decode": decode.run,
          "opt_metrics": opt_metrics.run, "augment": augment.run,
          "output_layout": train.output_layout,
          "block_train": blocks.block_train, "concat": blocks.concat,
          "res1": blocks.res1}[what]
    return fn(**kw)


def main(argv=None) -> int:
    common.print_report(run(parse_args(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
