"""Write a 'patient frame' series file from an ACDC directory layout
(counterpart of tools/make_series.py): the role of the reference's
committed data_series.txt / test_series.txt listings, derived from the
dataset instead of shipped.

    python -m saunet_tpu_torch.cli.make_series <acdc-root>
        [--split training|testing] [--out data_series.txt]

'training' lists the frames with ground truth under <root>/training;
'testing' lists the frame images under <root>/testing/testing (as the
archive unpacks), else <root>/testing. The file feeds `--series-file` of
`cli.train` and `cli.test_and_pack`.
"""
from __future__ import annotations

import argparse
import os
import sys

from ..data.acdc import scan_testing_dir, scan_training_dir, testing_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root")
    p.add_argument("--split", default="training",
                   choices=["training", "testing"])
    p.add_argument("--out", default="data_series.txt")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.split == "training":
        pairs = scan_training_dir(os.path.join(args.root, "training"))
    else:
        pairs = scan_testing_dir(testing_dir(args.root))
    with open(args.out, "w") as f:
        for patient, frame in pairs:
            f.write(f"{patient} {frame}\n")
    print(f"wrote {len(pairs)} entries to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
