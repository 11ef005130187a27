"""What the drivers share: the seeds of a run, the builders' keywords
from the configuration (and the check that it states the model they
build), the reference's float32 settings, freeing the program before the
reference runs."""
from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

SEED_NAMES = ("weights", "data", "order", "sample")


@dataclass
class Cell:
    """One run of one cell: its configuration, traffic mix and limits (the
    files' contents), the seed, the window's seconds, whether it is the
    traced run, the device, and, for the calibration tool alone, the
    controls' operand casts to read beside the program ('fp8', 'bf16')."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool = False
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    control: Optional[str] = None

    def controls(self) -> list:
        return self.control.split(",") if self.control else []


def seeds(seed: int) -> dict:
    """Independent 32-bit seeds for each use, from any whole number."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(SEED_NAMES))
    return {n: int(w) for n, w in zip(SEED_NAMES, words)}


#: (group, key) of a configuration that the program's `build_unet` and
#: the reference's `SAUNet` both take, as a keyword of the same name
PASSED = ((None, "num_classes"), (None, "num_filters"),
          ("shape_stream", "canny_low"), ("shape_stream", "canny_high"))


def model_kwargs(config: dict) -> dict:
    """The builders' keywords from `config`. Raises where `config` leaves
    out a key of the architecture, or states a width or setting that the
    builders neither take nor build (reference/model.py ARCHITECTURE)."""
    from ..reference.model import ARCHITECTURE

    wrong = []
    for key, built in ARCHITECTURE.items():
        stated = config.get(key)
        if not isinstance(built, dict):
            if stated != built:
                wrong.append(f"{key}: {stated!r}, built {built!r}")
            continue
        stated = stated if isinstance(stated, dict) else {}
        passed = {k for g, k in PASSED if g == key}
        for k in sorted(set(stated) | set(built)):
            if k in passed:
                continue
            if k not in built:
                wrong.append(f"{key}.{k}: not a key the builders take")
            elif stated.get(k) != built[k]:
                wrong.append(f"{key}.{k}: {stated.get(k)!r}, built "
                             f"{built[k]!r}")
    if wrong:
        raise ValueError("the configuration is not the model the "
                         "builders make: " + "; ".join(wrong))
    return {k: (config if g is None else config[g])[k] for g, k in PASSED}


def check_parameters(config: dict, model: torch.nn.Module,
                     side: str) -> None:
    """Raises unless `model` holds the configuration's `parameters`."""
    count = sum(p.numel() for p in model.parameters())
    if count != config["parameters"]:
        raise ValueError(f"the {side} holds {count} parameters, the "
                         f"configuration states {config['parameters']}")


def dtype_of(config: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        config["dtype"]]


@contextlib.contextmanager
def plain_float32():
    """TF32 off for cuDNN and cuBLAS inside the block (the reference's
    float32), the settings before it restored after."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def release(device: torch.device) -> None:
    """Return freed memory to the device before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def peak_reset(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
