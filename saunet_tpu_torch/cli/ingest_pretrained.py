"""Checksummed ingestion of torchvision's ImageNet DenseNet-121 weights
(counterpart of tools/ingest_pretrained.py).

    python -m saunet_tpu_torch.cli.ingest_pretrained \\
        /path/to/densenet121-a639ec97.pth --out weights/densenet121.npz \\
        [--sha256 DIGEST|SKIP] [--no_smoke_graft] [--device cuda|cpu]

The reference warm-starts its encoder from torchvision's checkpoint
(`densenet121(pretrained=True)`, which downloads `densenet121-a639ec97.pth`);
with no network the file is supplied by hand, and this tool takes it to a
`--pretrained`-ready archive:
1) checks the file's SHA-256 against the torch-hub checksum in its name
   (the hex digits after the last '-') or against `--sha256` (a digest or
   a prefix; SKIP bypasses the check);
2) converts it to a name-preserving .npz (`convert`: every tensor as named
   in the state_dict, as tools/convert_torchvision.py writes it; the name
   and layout mapping belongs to `models.densenet.load_pretrained_encoder`);
3) grafts the .npz onto a fresh `SAUNet(num_classes=4)` on the device
   (the card unless `--device` names another) through
   `load_pretrained_encoder`, which raises on a missing or unexpected
   encoder tensor and on any shape mismatch;
4) writes `<out>.sha256` so that later loads can check the source again.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import re
import sys
from typing import Optional

import numpy as np
import torch

from ..models import SAUNet
from ..models.densenet import load_pretrained_encoder
from ..train.state import resolve_device

#: canonical torch-hub file name -> the prefix of its sha256
_HUB_SUFFIX = re.compile(r"-([0-9a-f]{8,64})\.pth$")


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_checksum(src: str, expected: Optional[str]) -> str:
    """Return the file's digest. `expected` is a digest, a prefix of one
    (torch-hub puts the first 8 hex digits in the file name), 'SKIP', or
    None, and then the file name's prefix is required."""
    if expected is None:
        m = _HUB_SUFFIX.search(os.path.basename(src))
        if not m:
            raise SystemExit(
                f"{src}: no torch-hub checksum suffix in the file name and "
                "no --sha256 given; refusing unverified ingestion. Pass "
                "--sha256 <digest-or-prefix> (torchvision's densenet121 is "
                "a639ec97...) or --sha256 SKIP to ingest anyway.")
        expected = m.group(1)
    digest = sha256_file(src)
    if expected != "SKIP" and not digest.startswith(expected.lower()):
        raise SystemExit(
            f"{src}: sha256 {digest} does not match the expected "
            f"{expected!r}: wrong or corrupted checkpoint.")
    return digest


def convert(src: str, dst: str) -> int:
    """Write the tensors of the torch checkpoint `src` (a state_dict, or a
    dict holding one under 'state_dict') to the .npz `dst` under their
    names; returns their number. Only tensors and plain containers are
    unpickled (`weights_only`)."""
    obj = torch.load(src, map_location="cpu", weights_only=True)
    if "state_dict" in obj:
        obj = obj["state_dict"]
    arrays = {}
    for name, v in obj.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        arrays[name] = np.asarray(v)
    np.savez(dst, **arrays)
    return len(arrays)


def ingest(src: str, out: str, sha256: Optional[str] = None,
           smoke_graft: bool = True,
           device: Optional[torch.device | str] = None) -> dict:
    """Check, convert and (with `smoke_graft`) graft `src`; the result
    names the digest, the tensors written, the encoder tensors grafted and
    the grafted model (None without the graft)."""
    if not out.endswith(".npz"):
        raise SystemExit(f"{out}: the archive's name must end in .npz")
    device = resolve_device(device) if smoke_graft else None
    digest = verify_checksum(src, sha256)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    n = convert(src, out)
    model, grafted = None, 0
    if smoke_graft:
        model = SAUNet(num_classes=4).to(device)
        load_pretrained_encoder(out, model)
        with np.load(out) as archive:
            grafted = sum(k.startswith("features.") for k in archive.files)
    with open(out + ".sha256", "w") as f:
        f.write(f"{digest}  {os.path.basename(src)}\n")
    return {"src_sha256": digest, "tensors": n, "grafted_tensors": grafted,
            "out": out, "model": model}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="torchvision densenet121 .pth checkpoint "
                               "(canonical: densenet121-a639ec97.pth)")
    p.add_argument("--out", default="weights/densenet121_imagenet.npz")
    p.add_argument("--sha256", default=None,
                   help="expected digest or prefix; default: the torch-hub "
                        "suffix in the file name; SKIP to bypass")
    p.add_argument("--no_smoke_graft", action="store_true",
                   help="skip the graft onto a fresh model")
    p.add_argument("--device", default=None,
                   help="device of the graft (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    info = ingest(args.src, args.out, args.sha256,
                  smoke_graft=not args.no_smoke_graft, device=args.device)
    print(f"verified sha256={info['src_sha256'][:16]}...  "
          f"{info['tensors']} tensors -> {info['out']}"
          + (f"  (grafted {info['grafted_tensors']} encoder tensors)"
             if info["model"] is not None else ""))
    print(f"train with: python -m saunet_tpu_torch.cli.train --data-root "
          f"<ACDC> --pretrained {info['out']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
